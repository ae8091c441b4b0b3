"""The benchmark of the PyTorch and CUDA port, one cell a run:

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  It puts the port (``src``) and the benchmark on
the import path, keeps every build and kernel cache in fixed directories
inside the checkout, keeps libraries from loading JAX, and holds the host's
math libraries to one thread, so that one process with few threads offers the
load.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".portbench_cache"


def _environment() -> None:
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        sys.exit(f"portbench: no port at {src / 'repro_torch'}: run from a "
                 "checkout of the repository")
    sys.path[:0] = [str(src), str(ROOT)]
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(src), str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for threads in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                    "OPENBLAS_NUM_THREADS"):
        os.environ[threads] = "1"


if __name__ == "__main__":
    _environment()
    from portbench.harness.main import main
    sys.exit(main(sys.argv[1:], T_START))
