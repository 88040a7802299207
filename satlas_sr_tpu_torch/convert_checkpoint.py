"""Convert checkpoints between the JAX package's msgpack and the reference
.pth format (the JAX package's scripts/convert_checkpoint.py, on the port's
codecs).

    python -m satlas_sr_tpu_torch.convert_checkpoint to_pth   <in.msgpack> <out.pth> <arch_type>
    python -m satlas_sr_tpu_torch.convert_checkpoint from_pth <in.pth> <out.msgpack> <arch_type>
        [param_key] [num_block]
    (either takes --device cuda|cpu; default cuda, which raises without a card)

arch_type: SSR_RRDBNet | SSR_UNetDiscriminatorSN | SRCNN | HighResNet | OSMObjDiscriminator

to_pth writes `params` and `params_ema` (whichever the msgpack holds; a
bare variables dict becomes `params`) under the reference's names: the U-Net
SN discriminator's conv{1..8}.weight_orig / weight_u / weight_v, the OSM
discriminator's U-Net convs at the top level. from_pth reads `param_key`
(default params_ema, falling back to params) and writes the JAX variables
({"params", "spectral"}, the RRDB trunk stacked over its first `num_block`
blocks, 23 by default) through the port's msgpack codec, with its crc
footer. Both read the written file back and check every tensor against
what was converted, bit for bit, on `--device`.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict

import numpy as np
import torch

from .device import resolve_device
from .utils import torch_io
from .utils.checkpoint import FROM_JAX, jax_variables_to_port, load_pytree, save_pytree


def _rrdbnet_to_jax(state, num_block):
    missing = [i for i in range(num_block) if f"body.{i}.rdb1.conv1.weight" not in state]
    if missing:
        raise KeyError(f"num_block={num_block} but the checkpoint has no body.{missing[0]}.*")
    return torch_io.rrdbnet_to_jax({k: v for k, v in state.items() if not k.startswith("body.")
                                    or int(k.split(".")[1]) < num_block})


#: arch type -> (reference state dict, num_block) -> JAX variables
TO_JAX = {
    "SSR_RRDBNet": _rrdbnet_to_jax,
    "SSR_UNetDiscriminatorSN": lambda s, n: torch_io.unet_disc_to_jax(s),
    "SRCNN": lambda s, n: torch_io.srcnn_to_jax(s),
    "HighResNet": lambda s, n: torch_io.highresnet_to_jax(torch_io.drop_shared_fusion_levels(s)),
    "OSMObjDiscriminator": lambda s, n: torch_io.osm_disc_to_jax(
        torch_io.osm_disc_from_reference(s)),
}


def export_reference_state(arch: str, variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX variables -> the reference .pth state dict of `arch`."""
    state = jax_variables_to_port(arch, variables)
    if arch == "OSMObjDiscriminator":
        state = torch_io.osm_disc_to_reference(state)
    return {k: v.contiguous() for k, v in state.items()}


def to_pth(src: str, dst: str, arch: str) -> Dict[str, Dict[str, torch.Tensor]]:
    variables = load_pytree(src)
    out = {}
    for key in ("params", "params_ema"):
        if key in variables:
            sub = {"params": variables[key]}
            if "spectral" in variables:
                sub["spectral"] = variables["spectral"]
            out[key] = export_reference_state(arch, sub)
    if not out:  # a bare variables dict
        out["params"] = export_reference_state(arch, variables)
    torch.save(out, dst)
    return out


def from_pth(src: str, dst: str, arch: str, param_key: str = "params_ema",
             num_block: int = 23) -> Dict[str, Any]:
    variables = TO_JAX[arch](torch_io.load_torch_state_dict(src, param_key), num_block)
    save_pytree(dst, variables)
    return variables


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, f"{prefix}/{key}")
    else:
        yield prefix, tree


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def verify(written, wanted, device) -> int:
    """Every leaf of `written` equal to `wanted`'s, bit for bit, compared
    on `device`; the count of tensors. Raises on a difference."""
    got, want = dict(_leaves(written)), dict(_leaves(wanted))
    if set(got) != set(want):
        raise AssertionError(f"written keys differ: {sorted(set(got) ^ set(want))[:4]}")
    for name, value in want.items():
        a, b = (_tensor(x).to(device) for x in (got[name], value))
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{name}: the written tensor differs from the converted one")
    return len(want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["to_pth", "from_pth"])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("arch_type")
    ap.add_argument("param_key", nargs="?", default="params_ema", help="from_pth: the .pth key")
    ap.add_argument("num_block", nargs="?", type=int, default=23,
                    help="from_pth, SSR_RRDBNet: the trunk's blocks")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.arch_type not in FROM_JAX:
        print(f"unknown arch_type {args.arch_type!r}; supported: {' | '.join(sorted(FROM_JAX))}")
        return 1

    if args.mode == "to_pth":
        out = to_pth(args.src, args.dst, args.arch_type)
        n = verify(torch.load(args.dst, map_location="cpu", weights_only=True), out, device)
        print(f"wrote {args.dst} with keys {sorted(out)} ({n} tensors verified on {device})")
    else:
        variables = from_pth(args.src, args.dst, args.arch_type, args.param_key, args.num_block)
        n = verify(load_pytree(args.dst), variables, device)
        print(f"wrote {args.dst} ({n} tensors verified on {device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
