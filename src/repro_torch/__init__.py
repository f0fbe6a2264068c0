"""repro_torch: the hosting engine and the LM serving path of ``repro``
ported to PyTorch and CUDA.

The JAX package ``repro`` stays the reference; this package mirrors its
module paths (``core/costs.py``, ``core/fleet.py``, ``models/mamba2.py``,
``serve/engine.py``, ``kernels/hosting.py``, ...) so each port module sits
where its counterpart does.  It imports ``torch`` and numpy, never ``jax``
and nothing of ``repro``.

Entry points (``run_fleet``, ``offline_opt_fleet``, the stream and grid
constructors, ``ServingEngine``, ``HostingController``) run on the CUDA
card unless the caller passes ``device="cpu"``; on the card the hot loops
go through the hand-written kernels of ``kernels/csrc/`` (P, D, S for the
fleet, F and M for the model), on the CPU through their plain PyTorch
versions.  The fleet path is float32 (the x64 path is not ported); the
model runs in its config's dtype (bf16 at full size).
"""
from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
