"""The port and chip_smoke.py import no JAX, flax, optax or satlas_sr_tpu module,
and never name the JAX package's native library (satlas_sr_tpu/utils/_pngio.so):
the port builds and loads its own codec from build/."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "satlas_sr_tpu"}


def _port_files():
    return sorted((ROOT / "satlas_sr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_port_files_exist():
    files = _port_files()
    assert all(p.exists() for p in files)
    assert len(files) > 10


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [(mod, line) for mod, line in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


SLICE_MODULES = ("registry", "data/__init__", "data/loader", "data/s2naip", "metrics/__init__",
                 "metrics/utils", "metrics/psnr_ssim", "metrics/cpsnr", "metrics/fast_eval",
                 "models/__init__", "models/base", "models/esrgan", "models/osm_esrgan",
                 "models/l2", "test", "utils/logger", "utils/options",
                 "ops/usm", "ops/spectral_norm", "archs/discriminator", "losses/__init__",
                 "losses/basic", "losses/vgg", "losses/perceptual", "data/sampler",
                 "utils/checkpoint", "train", "ops/ssim", "ops/crop", "losses/regularizers",
                 "archs/osm_discriminator", "ops/resize", "utils/torch_io",
                 "metrics/clip_encoder", "metrics/lpips", "metrics/clipscore", "losses/clip",
                 "serve", "export", "__main__", "utils/lint", "utils/imgio", "inference",
                 "ops/warp", "archs/blocks", "utils/torch_oracles", "fetch", "ckpt", "scan_data",
                 "doctor", "warmup", "profile", "acceptance", "tune", "prepare", "tower_dryrun",
                 "utils/msgpack", "parallel/__init__", "parallel/mesh", "parallel/halo",
                 "utils/orbax_io", "device", "infer", "infer_grid", "train_evidence",
                 "dtype_train_equiv", "band_order_search", "convert_checkpoint")


def test_slice_modules_are_checked():
    checked = {p.relative_to(ROOT / "satlas_sr_tpu_torch").with_suffix("").as_posix()
               for p in _port_files() if p.is_relative_to(ROOT / "satlas_sr_tpu_torch")}
    assert set(SLICE_MODULES) <= checked


def test_importing_the_port_loads_no_jax(tmp_path):
    """In a fresh interpreter: import every port module, run the codec, and
    find no JAX, flax, optax or satlas_sr_tpu module loaded, and no
    satlas_sr_tpu/utils/_pngio.so mapped into the process."""
    code = f"""
import importlib, pathlib, sys
import numpy as np
root = pathlib.Path({str(ROOT)!r})
sys.path.insert(0, str(root))
for p in sorted((root / "satlas_sr_tpu_torch").rglob("*.py")):
    mod = ".".join(p.relative_to(root).with_suffix("").parts)
    importlib.import_module(mod[:-len(".__init__")] if mod.endswith(".__init__") else mod)
from satlas_sr_tpu_torch.utils import imgio
imgio.write_png({str(tmp_path / "x.png")!r}, np.zeros((4, 4, 3), np.uint8))
assert imgio.read_png({str(tmp_path / "x.png")!r}).shape == (4, 4, 3)
bad = sorted(m for m in sys.modules if m.split(".")[0] in {sorted(FORBIDDEN)!r})
assert not bad, bad
maps = pathlib.Path("/proc/self/maps")
assert not maps.exists() or "_pngio.so" not in maps.read_text()
print("clean", imgio.codec())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2] == "clean"


def test_checker_matches_module_names_exactly(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import satlas_sr_tpu_torch.ops\nfrom satlas_sr_tpu.utils import imgio\n"
                 "import jax.numpy as jnp\n")
    assert [m for m, _ in _imported_roots(f) if m in FORBIDDEN] == ["satlas_sr_tpu", "jax"]


def _names_jax_native_lib(path):
    return "_pngio" in path.read_text()


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_native_library(path):
    assert not _names_jax_native_lib(path), \
        f"{path.relative_to(ROOT)} names the JAX package's _pngio library"


def test_native_lib_checker_catches_a_reference(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import ctypes\nctypes.CDLL('satlas_sr_tpu/utils/_pngio.so')\n")
    assert _names_jax_native_lib(f)


def test_loaded_codec_lies_under_build():
    from satlas_sr_tpu_torch.utils import imgio, native_png

    if not native_png.zlib_present():
        pytest.skip("zlib's header (zlib.h) is not installed: the codec cannot build")
    native_png.lib()
    path = native_png.loaded_path()
    assert path is not None and path.is_relative_to(ROOT / "build")
    assert path.name.startswith("libpngio-")
    assert imgio.codec() == "native"
