"""The port's benchmark: run one cell once on one machine.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints its checks on standard error and one
JSON line, the result, as the last line of standard output. Exits 2 without
a result when the cell's CUDA devices are missing, 3 when the run loaded
JAX or the JAX package.

Build and kernel caches stay inside the checkout at fixed paths: the port
builds its kernels under build/torch_kernels; Triton, torch extensions and
the CUDA driver's JIT cache are pointed under build/portbench/.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "portbench"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda_jit")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0, root=ROOT))
