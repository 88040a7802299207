"""The port's pretrained-tower surfaces against the JAX package's, on the CPU
in float32: `ops/resize.resize_nearest`, the CLIP/SigLIP/EVA/RN towers
(`metrics/clip_encoder.py`), their torch state-dict importers, LPIPS,
CLIPScore and CLIPLoss.

Held:
- resize_nearest at 128 -> 256 and 128 -> 384 equal to the JAX resize, bit
  for bit, and in the input's dtype;
- every MODEL_SPECS entry equal to the JAX spec; the seeded random params
  equal to the JAX package's with no conversion;
- each tiny tower's embeddings within 1e-5 of their max of the JAX
  encoder's, built on each side from its own random draw, and with the JAX
  params carried across by `tower_from_params`;
- each importer family on a synthetic state dict (OpenAI CLIP, timm SigLIP
  with and without `visual.trunk.`, timm Eva both ways, CLIP RN, LPIPS vgg
  and alex): the same params as the JAX importer and the same embeddings;
  `TowerImportError` on a missing file, a file of no family, a near-matching
  one and the SwiGLU/RoPE Eva trunk;
- calculate_lpips and calculate_clipscore within 1e-5 absolute; CLIPLoss and
  its gradient into the input within 1e-4 of their max;
- the towers are frozen and built once per device; asking for the card
  where there is none raises instead of computing on the CPU.
The full-width towers are never built here: EVA02-E, bigG and SO400M only
have their geometry checked.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satlas_sr_tpu.losses.clip import clip_loss as jax_clip_loss
from satlas_sr_tpu.metrics import clip_encoder as J
from satlas_sr_tpu.metrics import clipscore as jax_clipscore
from satlas_sr_tpu.metrics import lpips as jax_lpips
from satlas_sr_tpu.ops.resize import resize_nearest as jax_resize_nearest
from satlas_sr_tpu_torch.losses.clip import clip_loss
from satlas_sr_tpu_torch.metrics import clip_encoder as P
from satlas_sr_tpu_torch.metrics import clipscore, lpips
from satlas_sr_tpu_torch.ops.resize import resize_nearest
from test_tower_import import _eva_state, _lpips_state, _openai_state, _rn_state, _t
from torch_threads import two_torch_threads  # noqa: F401

TINY = ["test-tiny", "test-tiny-openai", "test-tiny-siglip", "test-tiny-eva", "test-tiny-rn"]


def _jax_params(params):
    return jax.tree.map(lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v, params)


def _jax_encode(name, params, x):
    spec = J.MODEL_SPECS[name]
    encode = J._rn_encode if isinstance(spec, J.ResNetSpec) else J._vit_encode
    params = _jax_params(params)  # closed over: RN blocks hold static int strides
    return np.asarray(jax.jit(lambda v: encode(params, spec, v))(jnp.asarray(x)))


def _port_encode(tower, x):
    with torch.no_grad():
        return tower(torch.from_numpy(x)).numpy()


def _assert_close_to_max(got, want, tol=1e-5):
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _assert_trees_equal(a, b, path="params"):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in b:
            _assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}.{i}")
    elif isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=path)
    else:
        assert a == b, path


def _timm_vit_state(rng, prefix="visual.trunk.", w=32, layers=2, patch=8, n_patches=16):
    """timm VisionTransformer naming with a MAP head (open_clip SigLIP under
    `visual.trunk.`, or bare timm)."""
    mlp = 4 * w
    p = lambda k: prefix + k
    state = {
        p("patch_embed.proj.weight"): _t(rng, w, 3, patch, patch),
        p("patch_embed.proj.bias"): _t(rng, w, scale=0.05),
        p("pos_embed"): _t(rng, 1, n_patches, w),
        p("norm.weight"): 1 + _t(rng, w, scale=0.05),
        p("norm.bias"): _t(rng, w, scale=0.05),
        p("attn_pool.latent"): _t(rng, 1, 1, w),
        p("attn_pool.q.weight"): _t(rng, w, w), p("attn_pool.q.bias"): _t(rng, w, scale=0.05),
        p("attn_pool.kv.weight"): _t(rng, 2 * w, w),
        p("attn_pool.kv.bias"): _t(rng, 2 * w, scale=0.05),
        p("attn_pool.proj.weight"): _t(rng, w, w),
        p("attn_pool.proj.bias"): _t(rng, w, scale=0.05),
        p("attn_pool.norm.weight"): 1 + _t(rng, w, scale=0.05),
        p("attn_pool.norm.bias"): _t(rng, w, scale=0.05),
        p("attn_pool.mlp.fc1.weight"): _t(rng, mlp, w),
        p("attn_pool.mlp.fc1.bias"): _t(rng, mlp, scale=0.05),
        p("attn_pool.mlp.fc2.weight"): _t(rng, w, mlp),
        p("attn_pool.mlp.fc2.bias"): _t(rng, w, scale=0.05),
    }
    for i in range(layers):
        b = f"blocks.{i}"
        state.update({
            p(f"{b}.norm1.weight"): 1 + _t(rng, w, scale=0.05),
            p(f"{b}.norm1.bias"): _t(rng, w, scale=0.05),
            p(f"{b}.attn.qkv.weight"): _t(rng, 3 * w, w),
            p(f"{b}.attn.qkv.bias"): _t(rng, 3 * w, scale=0.05),
            p(f"{b}.attn.proj.weight"): _t(rng, w, w),
            p(f"{b}.attn.proj.bias"): _t(rng, w, scale=0.05),
            p(f"{b}.norm2.weight"): 1 + _t(rng, w, scale=0.05),
            p(f"{b}.norm2.bias"): _t(rng, w, scale=0.05),
            p(f"{b}.mlp.fc1.weight"): _t(rng, mlp, w),
            p(f"{b}.mlp.fc1.bias"): _t(rng, mlp, scale=0.05),
            p(f"{b}.mlp.fc2.weight"): _t(rng, w, mlp),
            p(f"{b}.mlp.fc2.bias"): _t(rng, w, scale=0.05),
        })
    return state


# -- resize --------------------------------------------------------------------------


@pytest.mark.parametrize("out", [256, 384])
def test_resize_nearest_matches_jax(rng, out):
    x = rng.rand(2, 128, 128, 3).astype(np.float32)
    got = resize_nearest(torch.from_numpy(x), (out, out))
    want = np.asarray(jax_resize_nearest(jnp.asarray(x), (out, out)))
    np.testing.assert_array_equal(got.numpy(), want)
    # the index where 128/384 is inexact in float32, and the dtype kept
    src = np.floor(np.arange(out, dtype=np.float32) * np.float32(128 / out)).astype(int)
    np.testing.assert_array_equal(got[0, :, 0, 0].numpy(), x[0, src, 0, 0])
    bf = resize_nearest(torch.from_numpy(x).bfloat16(), (out, out))
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf.float().numpy(), resize_nearest(
        torch.from_numpy(x).bfloat16().float(), (out, out)).numpy())


# -- specs and random towers -----------------------------------------------------------


@pytest.mark.parametrize("name", sorted(J.MODEL_SPECS))
def test_specs_match_jax(name):
    got, want = P.MODEL_SPECS[name], J.MODEL_SPECS[name]
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_full_width_geometry():
    """The shipped towers' geometry, checked without building them."""
    siglip = P.MODEL_SPECS["ViT-B-16-SigLIP-256"]
    assert (siglip.width, siglip.layers, siglip.heads, siglip.pool) == (768, 12, 12, "map")
    assert (siglip.image_size // siglip.patch_size) ** 2 == 256
    so400m = P.MODEL_SPECS["siglip-ViT-SO400M-14"]
    assert (so400m.width, so400m.layers, P._mlp_dim(so400m)) == (1152, 27, 4304)
    assert (so400m.image_size // so400m.patch_size) ** 2 == 729 and so400m.pool == "map"
    eva = P.MODEL_SPECS["EVA02-E-14-plus"]
    assert (eva.width, eva.layers, eva.heads, P._mlp_dim(eva)) == (1792, 64, 16, 15360)
    assert eva.post_norm and eva.pool == "cls" and eva.embed_dim == 1024


@pytest.mark.parametrize("name", TINY)
def test_random_towers_are_equal_with_no_conversion(name):
    spec, jax_spec = P.MODEL_SPECS[name], J.MODEL_SPECS[name]
    init_p = P._init_rn_params if isinstance(spec, P.ResNetSpec) else P._init_vit_params
    init_j = J._init_rn_params if isinstance(jax_spec, J.ResNetSpec) else J._init_vit_params
    _assert_trees_equal(init_p(spec), init_j(jax_spec))


@pytest.mark.parametrize("name", TINY)
def test_tower_matches_jax(rng, name):
    x = rng.rand(3, 32, 32, 3).astype(np.float32)
    encode, pretrained = J.get_encoder(name)
    want = np.asarray(jax.jit(encode)(jnp.asarray(x)))
    tower, port_pretrained = P.get_encoder(name, device="cpu")
    assert not pretrained and not port_pretrained
    _assert_close_to_max(_port_encode(tower, x), want)  # each side's own random draw
    spec = J.MODEL_SPECS[name]
    jax_params = (J._init_rn_params if isinstance(spec, J.ResNetSpec) else J._init_vit_params)(spec)
    carried = P.tower_from_params(P.MODEL_SPECS[name], jax_params, device="cpu")
    _assert_close_to_max(_port_encode(carried, x), want)


def test_towers_are_frozen_and_cached():
    tower, _ = P.get_encoder("test-tiny-siglip", device="cpu")
    assert not tower.training
    assert all(not p.requires_grad for p in tower.parameters())
    assert all(p.dtype == torch.float32 for p in tower.parameters())
    assert P.get_encoder("test-tiny-siglip", device="cpu")[0] is tower


# -- importers ---------------------------------------------------------------------------


def _import_both(state, name, tmp_path):
    path = str(tmp_path / "tower.pth")
    torch.save(state, path)
    spec_p, spec_j = P.MODEL_SPECS[name], J.MODEL_SPECS[name]
    if isinstance(spec_p, P.ResNetSpec):
        return P._import_clip_rn(state, spec_p), J._import_clip_rn(state, spec_j), path
    return P.load_vit_from_torch(path, spec_p), J.load_vit_from_torch(path, spec_j), path


@pytest.mark.parametrize("family,name", [
    ("openai", "test-tiny-openai"), ("siglip-trunk", "test-tiny-siglip"),
    ("siglip-bare", "test-tiny-siglip"), ("eva-trunk", "test-tiny-eva"),
    ("eva-bare", "test-tiny-eva"), ("rn", "test-tiny-rn")])
def test_importer_matches_jax(tmp_path, rng, family, name):
    prefix = "" if family.endswith("bare") else "visual.trunk."
    state = {"openai": lambda: _openai_state(rng), "rn": lambda: _rn_state(rng),
             "siglip-trunk": lambda: _timm_vit_state(rng, prefix),
             "siglip-bare": lambda: _timm_vit_state(rng, prefix),
             "eva-trunk": lambda: _eva_state(rng, prefix=prefix),
             "eva-bare": lambda: _eva_state(rng, prefix=prefix)}[family]()
    got, want, path = _import_both(state, name, tmp_path)
    assert got is not None and want is not None
    _assert_trees_equal(got, want)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    tower, pretrained = P.get_encoder(name, path, device="cpu")
    assert pretrained and P.is_pretrained(name, path)
    _assert_close_to_max(_port_encode(tower, x), _jax_encode(name, want, x))


def test_supplied_weights_never_become_a_random_tower(tmp_path, rng):
    with pytest.raises(P.TowerImportError, match="does not exist"):
        P.get_encoder("test-tiny", str(tmp_path / "nope.pth"), device="cpu")
    path = str(tmp_path / "garbage.pth")
    torch.save({"some.unrelated.weight": _t(rng, 4, 4)}, path)
    with pytest.raises(P.TowerImportError, match="no known naming family"):
        P.get_encoder("test-tiny", path, device="cpu")


def test_near_matching_and_rope_towers_raise(tmp_path, rng):
    spec = P.MODEL_SPECS["test-tiny-openai"]
    state = _openai_state(rng)
    for k in list(state):
        if ".attn.in_proj_" in k:
            state[k.replace("in_proj_weight", "q_proj.weight")
                   .replace("in_proj_bias", "q_proj.bias")] = state.pop(k)
    torch.save(state, tmp_path / "eva_like.pth")
    with pytest.raises(P.TowerImportError):
        P.load_vit_from_torch(str(tmp_path / "eva_like.pth"), spec)
    torch.save(_openai_state(rng, layers=1), tmp_path / "short.pth")
    with pytest.raises(P.TowerImportError, match="missing block 1"):
        P.load_vit_from_torch(str(tmp_path / "short.pth"), spec)
    eva = _eva_state(rng)
    eva["visual.trunk.blocks.0.mlp.fc1_g.weight"] = _t(rng, 64, 32)
    torch.save(eva, tmp_path / "eva02_l.pth")
    with pytest.raises(P.TowerImportError, match="SwiGLU/RoPE"):
        P.load_vit_from_torch(str(tmp_path / "eva02_l.pth"), P.MODEL_SPECS["test-tiny-eva"])


# -- metrics and the loss ------------------------------------------------------------------


def _pair(rng, hw=64):
    a = (rng.rand(hw, hw, 3) * 255).astype(np.uint8)
    b = np.clip(a.astype(np.int32) + (rng.rand(hw, hw, 3) * 60 - 30).astype(np.int32),
                0, 255).astype(np.uint8)
    return a, b


@pytest.mark.parametrize("flavor", ["vgg", "alex"])
@pytest.mark.parametrize("weights", [False, True], ids=["random", "weights"])
def test_lpips_matches_jax(tmp_path, rng, flavor, weights):
    path = None
    if weights:
        path = str(tmp_path / f"lpips_{flavor}.pth")
        torch.save(_lpips_state(rng, flavor), path)
    a, b = _pair(rng)
    got = lpips.calculate_lpips(a, b, lpips_model=flavor, lpips_weights_path=path, device="cpu")
    want = jax_lpips.calculate_lpips(a, b, lpips_model=flavor, lpips_weights_path=path)
    assert got > 0 and abs(got - want) <= 1e-5, (got, want)
    assert lpips.tower_pretrained(flavor, path) is weights is jax_lpips.tower_pretrained(flavor, path)


@pytest.mark.parametrize("name", TINY + ["siglip-weights"])
def test_clipscore_matches_jax(tmp_path, rng, name):
    path = None
    if name == "siglip-weights":
        name, path = "test-tiny-siglip", str(tmp_path / "siglip.pth")
        torch.save(_timm_vit_state(rng), path)
    a, b = _pair(rng, hw=48)  # 48 -> 32: a nearest downscale
    got = clipscore.calculate_clipscore(a, b, clip_model=name, clip_weights_path=path,
                                        device="cpu")
    want = jax_clipscore.calculate_clipscore(a, b, clip_model=name, clip_weights_path=path)
    assert abs(got - want) <= 1e-5, (got, want)
    assert clipscore.tower_pretrained(name, path) is (path is not None)
    assert abs(clipscore.calculate_clipscore(a, a, clip_model=name, clip_weights_path=path,
                                             device="cpu") - 1.0) < 1e-5


@pytest.mark.parametrize("name", ["test-tiny-siglip", "test-tiny-rn"])
def test_clip_loss_and_its_input_gradient_match_jax(rng, name):
    x = rng.rand(2, 48, 48, 3).astype(np.float32)
    gt = rng.rand(2, 48, 48, 3).astype(np.float32)
    jfn = jax_clip_loss(name, loss_weight=0.7)
    want, want_grad = jax.jit(jax.value_and_grad(lambda v: jfn(v, jnp.asarray(gt))))(
        jnp.asarray(x))
    fn = clip_loss(name, loss_weight=0.7)
    xt = torch.from_numpy(x).requires_grad_(True)
    gt_t = torch.from_numpy(gt).requires_grad_(True)
    got = fn(xt, gt_t)
    got.backward()
    assert got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= 1e-4 * abs(float(want))
    _assert_close_to_max(xt.grad.numpy(), np.asarray(want_grad), tol=1e-4)
    assert gt_t.grad is None  # the GT's embedding takes no gradient


def test_clip_loss_promotes_a_bf16_output(rng):
    """A bfloat16 G output is promoted to float32 by the normalisation, as in
    the JAX loss: the value equals the float32 loss of the bf16-rounded image."""
    x = torch.from_numpy(rng.rand(2, 48, 48, 3).astype(np.float32))
    gt = torch.from_numpy(rng.rand(2, 48, 48, 3).astype(np.float32))
    fn = clip_loss("test-tiny-siglip")
    got = fn(x.bfloat16(), gt)
    assert got.dtype == torch.float32
    assert got.item() == fn(x.bfloat16().float(), gt).item()
    want = jax.jit(jax_clip_loss("test-tiny-siglip"))(
        jnp.asarray(x.numpy()).astype(jnp.bfloat16), jnp.asarray(gt.numpy()))
    assert abs(got.item() - float(want)) <= 1e-4 * abs(float(want))


def test_no_cpu_fallback_without_a_card(rng):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    a, b = _pair(rng, hw=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lpips.calculate_lpips(a, b)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        clipscore.calculate_clipscore(a, b, clip_model="test-tiny")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.get_encoder("test-tiny")
