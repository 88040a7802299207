"""satlas_sr_tpu_torch — the PyTorch/CUDA port of satlas_sr_tpu for one NVIDIA H100.

The JAX package `satlas_sr_tpu` stays the reference; this package mirrors its
structure and names and imports nothing from it. The slices ported so far:
GT-free batched inference (`python -m satlas_sr_tpu_torch.infer -opt <yml>`
and `python -m satlas_sr_tpu_torch.infer_grid -opt <yml>`) with the
SSR_RRDBNet, SRCNN and HighResNet generators, and evaluation against
ground truth (`python -m satlas_sr_tpu_torch.test -opt <yml>`: the S2-NAIP
dataset, the ordered eval loader, PSNR/SSIM/cPSNR and model validation).
The RRDBNet trunk runs a hand-written Hopper kernel for the
ResidualDenseBlock (`ops/cuda/rdb.py`, `csrc/rdb.cu`); PNG IO runs the
port's own zlib-based codec (`utils/native_png.py`, `csrc/pngio.cpp`).

Every entry point takes `device`, defaulting to "cuda", and raises when no
card is present; it runs on the CPU only when the caller passes
device="cpu".
"""

from .device import resolve_device

__all__ = ["resolve_device"]
