"""Shapes shared by the dispatch tests on the CPU (tests/test_torch_dispatch.py,
against JAX) and on the card (tests/test_torch_kernel_cuda.py, kernel
against plain).  Imports nothing of jax or torch.

The rows kernel writes half a row a thread, two rows a thread 128 apart,
256 rows a block (csrc/dispatch.cu kRowThreads, kRowsPerThread): row
counts n on either side of those multiples and far below the 128-row
padding, with and without a permutation and a slot map (its state by
slot, "slots", or by lane), stride-0 ("stride0") or array tmin and tmax,
and tmin' as tmin, tcur or past tcur ("step").

The keys kernel takes one lane a thread, 128 a block, and reads a lane's
words before its active flag decides the key: lane counts on either side
of a block, with and without a slot map (its state by slot or by lane),
the flags all set ("live"), none set ("dead"), some ("mixed") or absent
("none"), the origins recentred or not.
"""

RAGGED_ROWS = [
    (1, "all", False, "stride0", "none"),
    (3, "by_lane", False, "arrays", "step"),
    (127, "all", True, "arrays", "tcur"),
    (129, "by_lane", True, "arrays", "step"),
    (255, "slots", True, "stride0", "step"),
    (256, "by_lane", False, "stride0", "tcur"),
    (257, "all", True, "arrays", "none"),
    (511, "slots", True, "arrays", "tcur"),
    (513, "by_lane", True, "stride0", "none"),
]

RAGGED_KEYS = [
    (1, "all", "dead", True),
    (127, "slots", "mixed", True),
    (129, "by_lane", "mixed", False),
    (257, "slots", "dead", False),
    (383, "by_lane", "live", True),
    (500, "all", "none", False),
]
