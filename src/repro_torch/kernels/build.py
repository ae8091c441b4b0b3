"""The one place that compiles and loads the CUDA kernels (no counterpart in
``src/repro``, whose Pallas kernels are compiled by JAX).

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process for ``sm_90a``,
all started together, and the objects are linked into one shared library with
a plain C interface, loaded with ``ctypes``.  The library is built at first
use into ``_build/`` beside this file (ignored by git), in a directory keyed
by a hash of the sources, from the sources in the repository and nothing
else.  If ``nvcc`` fails, the build raises with the compiler's output.

Each wrapper counts the launches it makes into the registry of
``repro_torch.obs`` (`count_launch`, read by `launches`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch import obs

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> argtypes (every pointer and the stream is c_void_p)
SIGNATURES = {
    "rt_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _F, _F, _P],
    "rt_flash_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "rt_flash_decode_tile": [],
    "rt_ssd_intra": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _I, _I, _P],
    "rt_ssd_intra_tc": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _P],
    "rt_moe_grouped": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                       _P],
    "rt_mla_decode": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _F,
                      _P],
}

# the wrappers that count their launches (`count_launch`), by their names
KERNELS = ("flash_attention", "flash_decode", "ssd_intra", "grouped_mlp",
           "mla_decode")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
info: Dict[str, object] = {}     # filled by the build: path, seconds, cached


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH and /usr/local/cuda/bin): "
        "the CUDA kernels can only be built where the CUDA toolkit is")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path, verbose: bool) -> Path:
    nvcc = _nvcc()
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    procs = []
    for src in _sources():                    # one nvcc per source, together
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *flags, "-c", str(src), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, logs = [], []
    failed = None
    for cmd, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = (cmd, out)
        objs.append(str(obj))
    if failed is not None:
        raise RuntimeError("nvcc failed: %s\n%s" % (" ".join(failed[0]),
                                                    failed[1]))
    lib = out_dir / "librepro_torch_kernels.so"
    cmd = [nvcc, "-shared", "-o", str(lib), *objs]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed: %s\n%s" % (" ".join(cmd),
                                                         res.stdout))
    info["compiler_output"] = "".join(logs) + res.stdout
    return lib


def load(*, verbose: bool = False) -> ctypes.CDLL:
    """Build (if this hash of the sources has not been built) and load."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        final_dir = BUILD_ROOT / source_hash()
        lib_path = final_dir / "librepro_torch_kernels.so"
        cached = lib_path.exists()
        if not cached:
            BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            # build into a scratch directory and rename: a build that is cut
            # off never leaves a half-written library under the final name
            tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
            try:
                _compile(tmp, verbose)
                try:
                    tmp.rename(final_dir)
                except OSError:           # another process built it meanwhile
                    if not lib_path.exists():
                        raise
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        info.update(path=str(lib_path), cached=cached,
                    seconds=time.perf_counter() - t0,
                    sources=[str(p.relative_to(CSRC.parent.parent.parent.parent))
                             for p in _sources()])
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point did not return 0 (cudaSuccess)."""
    if err == 0:
        return
    if err < 0:
        raise RuntimeError(f"{what}: the kernel does not take these sizes "
                           f"or this dtype (code {err})")
    raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def count_launch(kernel: str) -> None:
    """Count one launch by the wrapper ``kernel`` (a grouped product's: its
    up and down pair) into the registry's ``kernels.<kernel>.launches``.
    The count is of what the host issued: a replayed CUDA graph counts
    again what its capture counted (`obs.CountRecord`)."""
    obs.metrics().count(f"kernels.{kernel}.launches")


def launches() -> Dict[str, int]:
    """Each wrapper's launches counted so far in this process."""
    reg = obs.metrics()
    return {k: int(reg.value(f"kernels.{k}.launches") or 0) for k in KERNELS}
