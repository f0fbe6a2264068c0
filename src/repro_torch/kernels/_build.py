"""Build the CUDA kernels at first use and load them through ctypes.

``nvcc`` compiles ``csrc/hosting.cu`` (plain C entry points, no PyTorch
headers, so the build takes seconds) into ``build/kernels/`` at the root of
the checkout, under a name keyed by a hash of the source and the flags: a
changed source builds anew, an unchanged one loads the library already
there.  Nothing here runs at import time; the CPU tests never build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argtypes of every C entry point in hosting.cu (pointers and the stream
# are c_void_p: ctypes would otherwise pass them as 32-bit ints)
_SIGNATURES = {
    "launch_slot_uniform": (_P, _P, _P, _I, _I, _L, _I, _P),
    "launch_dp_minplus": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "launch_sim_alpha_rr": (_P,) * 14 + (_I,) * 5 + (_P,) * 7,
}

_LIBS: dict = {}
#: seconds the last ``nvcc`` call took (None when the library was cached)
BUILD_SECONDS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str = "hosting") -> Path:
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"{name}_{digest}.so"


def build(name: str = "hosting") -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists."""
    out = library_path(name)
    if out.exists():
        BUILD_SECONDS[name] = None
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)                 # atomic: no half-written library
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return out


def library(name: str = "hosting") -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
