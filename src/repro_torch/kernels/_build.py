"""Build the CUDA kernels at first use and load them through ctypes.

Each library is one source ``csrc/<name>.cu`` with plain C entry points (no
PyTorch headers, so a build takes seconds), compiled by ``nvcc`` into
``build/kernels/`` at the root of the checkout under a name keyed by a
hash of the source and its flags: a changed source builds anew, an
unchanged one loads the library already there.  Every library has its own
flags and its own table of entry points (``LIBRARIES``).  Nothing here runs
at import time; the CPU tests never build.  The checks every wrapper runs
before a launch (``check_tensor``, ``raise_on``, ``stream``) live here too.

Flags per library:

* ``hosting`` (kernel P's stream variants, the ARMA, Poisson and Model-2
  service kernels, D (fused, under both service models, and on a finished
  w), S (alpha-RR and the table variant, under both), B (the DP's
  backtrack) and E (schedule pricing)):
  ``--fmad=false``, because those kernels
  are held bit for bit against the reference, which fixes which
  multiply-adds are one FMA (written as ``__fmaf_rn``) and which are two
  rounded operations; ``-lineinfo``, line tables that leave the code as
  it is and let ``nvdisasm -gi`` name each instruction's source lines
  (``chip_smoke.py`` counts Hormann's round in ``poisson_kernel``'s SASS
  that way).
* ``flash_attention`` (F: the wgmma and the FMA kernel) and ``ssd_scan``
  (M: the mma.sync and the FMA kernel): nvcc's default contraction; they
  are held to a stated tolerance, not to bits.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
_COMMON = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# per library: its nvcc flags and the argtypes of every C entry point
# (pointers and the stream are c_void_p: ctypes would otherwise pass them
# as 32-bit ints)
LIBRARIES = {
    "hosting": (_COMMON + ("--fmad=false", "-lineinfo"), {
        # kind, keys, tids, a, b, flip, out, R, chunk, salt,
        # partitionable, stream
        "launch_counter_stream": (_I,) + (_P,) * 6 + (_I,) * 4 + (_P,),
        # keys, tids, s_in, p_hl, p_lh, rate_h, rate_l, s_out, states, x,
        # R, chunk, partitionable, stream
        "launch_ge_chain": (_P,) * 10 + (_I,) * 3 + (_P,),
        # key, out, n, partitionable, stream
        "launch_shaped_uniform": (_P, _P, _I, _I, _P),
        # keys, tids, hist_in, eps_in, phi, th, sigma, mean, c_min, c_max,
        # hist_out, eps_out, c, R, chunk, P, Q, partitionable, stream
        "launch_arma_rents": (_P,) * 13 + (_I,) * 5 + (_P,),
        "launch_dp_minplus": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
        # J, c, x, g, svc, cols (x / g or svc / cols NULL), lv, kmask,
        # fetch, T_len, Jout, args (or NULL), R, chunk, K, Kf, t0, stream
        "launch_dp_fwd": (_P,) * 12 + (_I,) * 5 + (_P,),
        # levels, mask, policy M, lv, g, M, T_len, r, S, age, sums, counts,
        # x, c, svc, cols (g / x or svc / cols NULL), t0, chunk, R, K, Kf,
        # include_final_fetch, r_out, S_out, age_out, sums_out, counts_out,
        # r_hist, stream
        "launch_sim_alpha_rr": (_P,) * 16 + (_I,) * 6 + (_P,) * 7,
        # pi, thr, lv, g, M, T_len, r, sums, counts, x, c, o, svc, cols
        # (thr / g / x / o / svc / cols NULL where unused), obs, S, t0,
        # chunk, R, K, Kf, include_final_fetch, r_out, sums_out,
        # counts_out, r_hist, stream
        "launch_sim_table": (_P,) * 14 + (_I,) * 8 + (_P,) * 5,
        # keys, tids, lam, lam_h, states, out, work, R, chunk, salt,
        # partitionable, stream
        "launch_poisson": (_P,) * 7 + (_I,) * 4 + (_P,),
        # keys, tids, x, g, out, R, chunk, K, n_max, partitionable, stream
        "launch_model2_service": (_P,) * 5 + (_I,) * 5 + (_P,),
        # k_in, args, k_out, r, R, chunk, K, stream
        "launch_dp_backtrack": (_P,) * 4 + (_I,) * 3 + (_P,),
        # lv, g, M, T_len, prev, sums, counts, r, c, x, svc, cols (g / x or
        # svc / cols NULL), prev_out, sums_out, counts_out, R, chunk, K,
        # Kf, t0, fma (bit 0 the rent, bit 1 the fetch), stream
        "launch_schedule": (_P,) * 15 + (_I,) * 6 + (_P,),
        # B's and E's layout: words a slot, chunk, box; none; words
        "be_tile_slots": (_I,) * 3, "be_ring_stages": (),
        "be_row_stride": (_I,),
        # S's table variant's layout at K: tile, cooked stages (K, svc);
        # D's tile (K), the argmin table's stages (K, svc)
        "sim_tile_slots": (_I,) * 2, "sim_ring_stages": (_I,) * 2,
        "dp_tile_slots": (_I,), "dp_args_stages": (_I,) * 2,
        # D's tile on a finished w (K)
        "dp_minplus_tile_slots": (_I,),
    }),
    "flash_attention": (_COMMON, {
        # q, k, v, out, B, Sq, Skv, Hq, Hkv, hd, causal, q_offset, stream
        "launch_flash_attention_wgmma": (_P,) * 4 + (_I,) * 8 + (_P,),
        # the same, then is_bf16, stream
        "launch_flash_attention_fma": (_P,) * 4 + (_I,) * 9 + (_P,),
    }),
    "ssd_scan": (_COMMON, {
        # x, dt, A, B, C, h0 (or NULL), y, hT, b, s, nh, dh, ng, ds, chunk,
        # stream
        "launch_ssd_scan_mma": (_P,) * 8 + (_I,) * 7 + (_P,),
        # the same, then is_bf16, stream
        "launch_ssd_scan_fma": (_P,) * 8 + (_I,) * 8 + (_P,),
    }),
}

_LIBS: dict = {}
#: seconds each library's ``nvcc`` call took (None when it was cached)
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


def library_path(name: str) -> Path:
    flags = LIBRARIES[name][0]
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"{name}_{digest}.so"


def build_all(names=None) -> dict:
    """Compile every named library (all by default) whose hashed file is
    missing, one ``nvcc`` each, all started together; returns their paths."""
    names = list(LIBRARIES) if names is None else list(names)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            BUILD_SECONDS[name] = None
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *LIBRARIES[name][0], "-o", str(tmp),
               str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{err}")
            continue
        os.replace(tmp, out)             # atomic: no half-written library
        BUILD_SECONDS[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists."""
    return build_all([name])[name]


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in LIBRARIES[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


# ----------------------------------------------------------------------
# What every wrapper checks around a launch.
# ----------------------------------------------------------------------

def check_tensor(name, t, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device`` of
    ``shape`` (None: any shape)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on(err: int, kernel: str):
    """Raise if a C entry point returned a CUDA error (a refused launch)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {err}")


def stream(device) -> int:
    """The handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
