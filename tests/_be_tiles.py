"""Kernels B's (the DP's backtrack) and E's (schedule pricing) tiles, in
slots, as the hosting library sizes them (``hosting.cu``: ``be_tile``),
and the tiles in their ring: the tests put their edge shapes a slot
either side of these.  ``test_torch_cuda.py::
test_be_tiles_fit_the_kernels_ring`` holds the library to them on the
card."""
STAGES = 4                 # tiles in the ring
B_TILE = {1: 256, 3: 104, 32: 8}                       # B's, by K
E_TILE = 100               # E's under Model 1
E_TILE_SLAB32 = 4          # E's on a Model-2 slab of 32 levels
