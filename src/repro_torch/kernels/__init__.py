"""Hand-written CUDA kernels of the port (``csrc/``), their ctypes build
(``_build``), the wrappers with their plain PyTorch versions
(``hosting``) and the batched entry points the engine calls (``ops``).

Kernels of the JAX package not ported yet (flash attention, the Mamba2
SSD scan) are listed in ROADMAP.md, Queue 2.
"""
