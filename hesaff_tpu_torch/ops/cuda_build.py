"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is a plain-C shared library: nvcc compiles it
for sm_90a at first use into ``build/hesaff_tpu_torch/`` at the root of
the checkout, under a name keyed by a hash of the source and the flags,
and ``ctypes`` loads it.  Nothing is built when the package is imported.
A failed build raises; there is no fallback.

Flags: ``--fmad=false`` keeps nvcc from contracting a*b+c into one
fused multiply-add, for every source.  The kernels' plain PyTorch
versions round every product and sum separately.  The detect walk must
agree with its plain version bit for bit (an ulp in the 3x3 solve can
flip a walk decision), and the patch kernel's sample coordinates and
their floor decide its bad flags, which must equal the plain version's:
a contracted coordinate can flip a floor at a border.  Per-source flags
would not separate those from the arithmetic that may contract, so the
patch kernel takes its contraction from explicit ``fmaf()`` in its two
products only (the patch is not bit-equal to its plain version anyway:
that one multiplies with ``torch.bmm``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "hesaff_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple[str, str], ctypes._CFuncPtr] = {}
# per-kernel build record: seconds spent compiling (0 when the cached
# library was reused) and ptxas' register / shared-memory report
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset and no "
                           "nvcc on PATH): cannot build the kernels")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; cached per process."""
    if name in _libs:
        return _libs[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{name}-{digest}.so"
    info = {"seconds": 0.0, "ptxas": ""}
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        info["seconds"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
        info["ptxas"] = "\n".join(
            ln for ln in proc.stderr.splitlines()
            if "registers" in ln or "bytes stack" in ln)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    BUILD_INFO[name] = info
    _libs[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C function `symbol` of csrc/<name>.cu, returning an int (a
    CUDA error code), with its argument types bound once per process."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _entries[(name, symbol)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current stream on `device`, the device of the tensors a
    kernel launches on (not the process's current device)."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
