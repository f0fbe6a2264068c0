"""Hand-written CUDA kernels of the port (``csrc/``), their ctypes build
(``_build``), the wrappers with their plain PyTorch versions (``hosting``:
P, D, S; ``flash_attention``: F; ``ssd_scan``: M), the plain oracles
(``ref``) and the public entry points (``ops``)."""
