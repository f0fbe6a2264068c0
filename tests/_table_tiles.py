"""Kernels S's (the table variant) and D's (the fused DP's ARGS route,
and D on a finished w) tiles, in slots, and the stages of their rings, as
the hosting library sizes them (``hosting.cu``: ``SimSmem``, ``DpSmem``,
``dpm_tile``): the tests put their
edge shapes a slot either side of these.  ``test_torch_cuda.py::
test_table_and_args_tiles_are_the_librarys`` holds the library to them on
the card."""
# S's table variant: (K, service) -> slots a tile, cooked stages in the ring
SIM_TILE = {(3, "model1"): 64, (3, "model2"): 64, (5, "model2"): 32,
            (16, "model2"): 16, (16, "model1"): 64}
SIM_STAGES = {(3, "model1"): 3, (3, "model2"): 2, (5, "model2"): 3,
              (16, "model2"): 3, (16, "model1"): 3}
# D: K -> slots a tile; (K, service) -> argmin-table stages in the ring
DP_TILE = {3: 64, 5: 32, 16: 16}
DP_ARGS_STAGES = {(3, "model1"): 3, (3, "model2"): 3, (5, "model1"): 3,
                  (16, "model1"): 3, (16, "model2"): 1}
# D on a finished w: K -> slots a tile (hosting.cu: dpm_tile, the largest
# multiple of 4 with TILE * K <= 252 and TILE * K % 8 == 0, at most 128)
DPM_TILE = {1: 128, 2: 124, 3: 80, 4: 60, 5: 48, 8: 28, 9: 24, 16: 12,
            17: 8, 31: 8, 32: 4}
