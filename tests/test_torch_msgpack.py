"""The port's msgpack codec (utils/msgpack.py), its JAX-layout converters
(utils/torch_io.py `*_to_jax`, `adam_state_from_jax`) and its checkpoint
files (utils/checkpoint.py) against flax and the JAX package, on the CPU.

- The reader against flax's `msgpack_restore` on bytes flax wrote: maps,
  lists (as {'0': ...} dicts), ints of every width, floats, str, bytes,
  None, bools, complex, numpy scalars, float32 / int / uint8 / bool arrays
  bit-equal, bfloat16 bit-equal (a torch tensor), and chunked arrays (flax's
  MAX_CHUNK_SIZE and the port's set small).
- The writer: its bytes equal flax's `to_bytes` of the same tree, chunked
  too, so flax reads them back equal.
- Files: the port's `save_pytree` read by the JAX `load_pytree` and the
  reverse; a footer-less (legacy) JAX file read; a flipped byte or a cut
  file raises the port's CheckpointCorruptError; `verify_state_file` and
  `find_resume_state` take a JAX .state as intact by its bytes.
- Converters: each `*_to_jax` is the exact inverse of its `*_from_jax`
  on the JAX init tree (bit-equal round trip), and the JAX
  `load_network_variables` on a port-written net_g.msgpack gives the
  port's forward within 1e-5.
- Adam: an optax state after two updates (adam, and Adam with weight_decay:
  the add_decayed_weights chain) becomes a torch Adam state whose third
  update equals optax's within 1e-6.
"""

import functools

import numpy as np
import pytest
import torch

import flax.serialization as fs
import jax
import jax.numpy as jnp
import optax

from satlas_sr_tpu.archs import build_arch
from satlas_sr_tpu.models.base import build_optimizer as jax_build_optimizer
from satlas_sr_tpu.utils import checkpoint as jax_ckpt
from satlas_sr_tpu_torch.archs import RRDBNet
from satlas_sr_tpu_torch.train import find_resume_state
from satlas_sr_tpu_torch.utils import checkpoint, msgpack, torch_io
from torch_threads import two_torch_threads  # noqa: F401


def _tree(rng):
    return {"f32": rng.randn(3, 4).astype(np.float32),
            "nested": {"i64": np.arange(5, dtype=np.int64), "u8": np.arange(7, dtype=np.uint8),
                       "flag": np.array([True, False]), "scalar": np.float32(2.5),
                       "i32": np.int32(-9), "empty": {}},
            "bf16": jnp.asarray(rng.randn(4, 3), jnp.bfloat16),
            "ints": [0, 127, 128, -32, -33, 255, 65536, 2 ** 40, -2 ** 33, -2 ** 63],
            "floats": [1.5, -0.0, 1e300], "strs": ["", "x" * 40, "y" * 300],
            "blob": b"\x00\x01" * 40000, "none": None, "yes": True, "cx": 1 + 2j,
            "f64": rng.randn(40, 30)}


def _same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(got, torch.Tensor):  # bfloat16
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        assert np.array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        assert np.array_equal(got, want)
    elif isinstance(want, np.generic):
        assert type(got) is type(want) and got == want
    else:
        assert type(got) is type(want) and got == want


def _host(tree):
    """The tree as the port writes it: numpy leaves, bfloat16 as torch."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, jax.Array) and tree.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(tree).view(np.int16).copy()).view(torch.bfloat16)
    if isinstance(tree, jax.Array):
        return np.asarray(tree)
    return tree


@pytest.mark.parametrize("chunk", [None, 64], ids=["whole", "chunked"])
def test_reader_matches_flax_restore(rng, monkeypatch, chunk):
    if chunk:
        monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", chunk)
    data = fs.to_bytes(_tree(rng))
    if chunk:
        assert b"__msgpack_chunked_array__" in data
    _same(msgpack.restore(data), fs.msgpack_restore(data))


@pytest.mark.parametrize("chunk", [None, 64], ids=["whole", "chunked"])
def test_writer_bytes_equal_flax(rng, monkeypatch, chunk):
    if chunk:
        monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", chunk)
    tree = _tree(rng)
    ours = msgpack.to_bytes(_host(tree))
    assert ours == fs.to_bytes(tree)
    _same(msgpack.restore(ours), fs.msgpack_restore(ours))


def test_malformed_bytes_raise():
    with pytest.raises(msgpack.MsgpackError):
        msgpack.restore(b"\x81\xa1a")  # a map cut short
    with pytest.raises(msgpack.MsgpackError):
        msgpack.restore(fs.to_bytes({"a": 1}) + b"\x00")  # trailing bytes


def test_files_cross_between_the_packages(tmp_path, rng):
    tree = {"params": {"w": rng.randn(4, 4).astype(np.float32)}, "step": np.int32(7)}
    ours, theirs, legacy = (str(tmp_path / n) for n in ("a.msgpack", "b.msgpack", "c.msgpack"))
    checkpoint.save_pytree(ours, tree)
    jax_ckpt.save_pytree(theirs, tree)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    _same(jax_ckpt.load_pytree(ours), tree)
    _same(checkpoint.load_pytree(theirs), tree)
    with open(legacy, "wb") as f:
        f.write(fs.to_bytes(tree))
    _same(checkpoint.load_pytree(legacy), tree)
    blob = bytearray(open(ours, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(ours, "wb").write(bytes(blob))
    with pytest.raises(checkpoint.CheckpointCorruptError, match="crc mismatch"):
        checkpoint.load_pytree(ours)
    with pytest.raises(checkpoint.CheckpointCorruptError):
        checkpoint.load_network_variables("SSR_RRDBNet", ours)
    open(ours, "wb").write(open(theirs, "rb").read()[:-30])
    with pytest.raises(checkpoint.CheckpointCorruptError):
        checkpoint.load_pytree(ours)


def test_jax_states_are_found_and_verified_by_their_bytes(tmp_path):
    states = tmp_path / "training_states"
    jax_ckpt.save_pytree(str(states / "4.state"), {"epoch": 0, "iter": 4,
                                                   "state": {"step": np.int32(4)}})
    checkpoint.save_state(str(states / "2.state"), {"epoch": 0, "iter": 2, "state": {"step": 2}})
    with open(states / "6.state", "wb") as f:  # a footer-less JAX state, first round
        f.write(fs.to_bytes({"epoch": 0, "iter": 6, "state": {"step": np.int32(6)}}))
    (states / "8.state").write_bytes(open(states / "4.state", "rb").read()[:-9])
    assert [checkpoint.verify_state_file(str(states / f"{i}.state")) for i in (2, 4, 6, 8)] == [
        True, True, True, False]
    assert checkpoint.read_state(str(states / "4.state"))[0] == "msgpack"
    assert checkpoint.read_state(str(states / "2.state"))[0] == "torch"
    found = find_resume_state({"auto_resume": True, "path": {"training_states": str(states)}})
    assert found == str(states / "6.state")


# -- converters ------------------------------------------------------------------

SMALL_RRDB = {"type": "SSR_RRDBNet", "num_in_ch": 6, "num_out_ch": 3, "num_feat": 8,
              "num_block": 2, "num_grow_ch": 4}
ARCHS = {
    "SSR_RRDBNet": (SMALL_RRDB, (1, 32, 32, 6), torch_io.rrdbnet_from_jax,
                    torch_io.rrdbnet_to_jax),
    "SSR_UNetDiscriminatorSN": ({"type": "SSR_UNetDiscriminatorSN", "num_in_ch": 3,
                                 "num_feat": 4}, (1, 32, 32, 3), torch_io.unet_disc_from_jax,
                                torch_io.unet_disc_to_jax),
    "OSMObjDiscriminator": ({"type": "OSMObjDiscriminator", "num_in_ch": 3, "num_feat": 4},
                            (1, 128, 128, 3), torch_io.osm_disc_from_jax,
                            torch_io.osm_disc_to_jax),
    "SRCNN": ({"type": "SRCNN", "in_channels": 3, "mask_channels": 0, "revisits": 2,
               "hidden_channels": 16, "out_channels": 3, "kernel_size": 3, "residual_layers": 2,
               "output_size": 128, "zoom_factor": 4, "sr_kernel_size": 1},
              (1, 2, 32, 32, 3), torch_io.srcnn_from_jax, torch_io.srcnn_to_jax),
    "HighResNet": ({"type": "HighResNet", "in_channels": 3, "mask_channels": 0, "revisits": 4,
                    "hidden_channels": 16, "out_channels": 3, "kernel_size": 3,
                    "residual_layers": 1, "output_size": 128, "zoom_factor": 4,
                    "sr_kernel_size": 1}, (1, 4, 32, 32, 3), torch_io.highresnet_from_jax,
                   torch_io.highresnet_to_jax),
}


@functools.lru_cache(maxsize=None)
def _init(arch):
    cfg, shape, _, _ = ARCHS[arch]
    net = build_arch(dict(cfg))
    args = [jnp.zeros(shape)]
    if arch == "OSMObjDiscriminator":
        args.append(jnp.zeros((2, 32, 32, 3)))
    return jax.device_get(jax.jit(net.init)(jax.random.PRNGKey(0), *args))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_to_jax_inverts_from_jax_exactly(arch):
    variables = _init(arch)
    _, _, from_jax, to_jax = ARCHS[arch]
    back = to_jax(from_jax(variables))

    def same(a, b, path="") -> None:
        if isinstance(b, dict):
            assert set(a) == set(b), (path, sorted(a), sorted(b))
            for k in b:
                same(a[k], b[k], f"{path}.{k}")
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), path

    same(back, {k: v for k, v in variables.items() if k in ("params", "spectral")})


def test_jax_package_loads_a_port_written_msgpack(tmp_path, rng):
    cfg = {k: v for k, v in SMALL_RRDB.items() if k != "type"}
    port = RRDBNet(seed=5, device="cpu", **cfg)
    path = str(tmp_path / "net_g.msgpack")
    params = torch_io.rrdbnet_to_jax(port.state_dict())["params"]
    checkpoint.save_pytree(path, {"params": params, "params_ema": params})
    variables = jax_ckpt.load_network_variables("SSR_RRDBNet", path, SMALL_RRDB, "params_ema")
    x = rng.rand(2, 32, 32, 6).astype(np.float32)
    want = jax.jit(build_arch(dict(SMALL_RRDB)).apply)({"params": variables["params"]},
                                                         jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01], ids=["adam", "adam_l2_chain"])
def test_optax_adam_state_continues_in_torch(rng, weight_decay):
    variables = _init("SSR_RRDBNet")
    params = variables["params"]
    tx = jax_build_optimizer({"type": "Adam", "lr": 1e-3, "betas": [0.9, 0.99],
                              "weight_decay": weight_decay}, lambda count: 1e-3)
    state = tx.init(params)
    update = jax.jit(tx.update)
    grads = [jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32), params)
             for _ in range(3)]
    for g in grads[:2]:
        updates, state = update(g, state, params)
        params = optax.apply_updates(params, updates)
    port = RRDBNet(device="cpu", **{k: v for k, v in SMALL_RRDB.items() if k != "type"})
    port.load_state_dict(torch_io.rrdbnet_from_jax({"params": jax.device_get(params)}))
    opt = torch.optim.Adam(port.parameters(), lr=1e-3, betas=(0.9, 0.99),
                           weight_decay=weight_decay)
    saved = fs.msgpack_restore(fs.to_bytes(state))  # as a .state file holds it
    layout = ["0", "1", "2"] if weight_decay else ["0", "1"]
    assert list(saved) == layout
    opt.load_state_dict(torch_io.adam_state_from_jax(
        saved, lambda t: torch_io.rrdbnet_from_jax({"params": t}),
        list(port.named_parameters()), opt.state_dict()["param_groups"]))
    assert all(float(s["step"]) == 2 for s in opt.state_dict()["state"].values())
    updates, _ = update(grads[2], state, params)
    want = torch_io.rrdbnet_from_jax({"params": jax.device_get(
        optax.apply_updates(params, updates))})
    g3 = torch_io.rrdbnet_from_jax({"params": grads[2]})
    for name, p in port.named_parameters():
        p.grad = g3[name].clone()
    opt.step()
    for name, p in port.named_parameters():
        torch.testing.assert_close(p.detach(), want[name], rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ["SSR_RRDBNet", "SRCNN", "HighResNet"])
def test_entry_points_read_msgpack_weights_as_the_pth(tmp_path, arch):
    """The infer-path loader (infer, infer_grid, serve, export, warmup,
    profile) and acceptance's preflight read a JAX-layout .msgpack of a
    generator exactly as the same weights' reference .pth."""
    from satlas_sr_tpu_torch.acceptance import _load_and_introspect
    from satlas_sr_tpu_torch.infer import load_infer_variables

    cfg = ARCHS[arch][0]
    sd = ARCHS[arch][2](_init(arch))
    pth, mp = str(tmp_path / "net_g.pth"), str(tmp_path / "net_g.msgpack")
    torch_io.save_torch_state_dict(pth, sd, "params_ema")
    checkpoint.save_pytree(mp, {"params_ema": ARCHS[arch][3](sd)["params"]})
    opt = {"network_g": dict(cfg), "path": {"pretrain_network_g": mp}}
    got = load_infer_variables(opt, None)
    assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    (a, info_a), (b, info_b) = _load_and_introspect(mp, "params_ema"), _load_and_introspect(
        pth, "params_ema")
    assert info_a == info_b and all(torch.equal(a[k], b[k]) for k in b)
