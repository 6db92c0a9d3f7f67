"""Shapes shared by the dispatch tests on the CPU (tests/test_torch_dispatch.py,
against JAX) and on the card (tests/test_torch_kernel_cuda.py, kernel
against plain).  Imports nothing of jax or torch, only numpy.

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

The slot selection's kernel tests 16 lanes a thread, 4,096 a tile, and
writes the slots past the lanes in need in blocks of 4,096
(csrc/lookback.cuh kTile, csrc/dispatch.cu kFillSlots): SELECT_CASES
over `base` lanes (8,192 on the CPU, a 262,144-lane band on the card),
select_case the seeded inputs of one.
"""

import numpy as np

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


# The lanes in need of each selection case, given the slots: none, every
# lane, as many as the slots, 77 past them (dropped), only the last lane,
# and half the slots over base + 4,133 lanes, no multiple of the kernel's
# 16-lane words or 4,096-lane tiles.
SELECT_CASES = {"none": lambda s: 0, "all": None, "equal": lambda s: s,
                "past": lambda s: s + 77, "last": "last",
                "ragged": lambda s: s // 2}


def select_case(case, base, seed, slots_of, with_tcur):
    """Seeded numpy inputs of a slot selection over `base` lanes (base +
    4,133 for "ragged"), the slots slots_of(lanes): (need, slots, hit
    (t, prim_id, u, v), tcur or None), the lanes in need spread at random
    over the lanes, as many as the case asks."""
    n = base + (4133 if case == "ragged" else 0)
    slots = slots_of(n)
    want = SELECT_CASES[case]
    rs = np.random.RandomState(seed)
    need = np.zeros(n, dtype=bool)
    if want is None:
        need[:] = True
    elif want == "last":
        need[-1] = True
    else:
        need[rs.permutation(n)[:want(slots)]] = True
    hit = (rs.uniform(0, 9, n).astype(np.float32),
           rs.randint(-1, 500, n).astype(np.int32),
           rs.rand(n).astype(np.float32), rs.rand(n).astype(np.float32))
    tcur = rs.uniform(0, 9, n).astype(np.float32) if with_tcur else None
    return need, slots, hit, tcur
