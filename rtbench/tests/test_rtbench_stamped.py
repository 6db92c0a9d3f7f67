"""The stamped readings (rtbench/stamped.py) on synthetic traces: the loop
log's calibration onto the profiler's clock, the union of the device
events with the calibrated loops, the rule that decides whether the log
and the trace account for each other, and the host arithmetic of the
span-only frames."""

import pytest

from rtbench import profile, stamped

US = 1_000
OFFSET = 7_000_000 * US      # the profiler's clock less the card's timer


def _loops():
    """Three loops on the card's timer: (entry, exit, rounds, loop id)."""
    return [(100 * US, 100 * US + 2 * US, 1, 0),
            (300 * US, 340 * US, 4, 1),
            (600 * US, 700 * US, 9, 1)]


def _entries(jitter=(0, 1 * US, -1 * US)):
    """The traced entry launches, 3 us long, starting at the calibrated
    stamp give or take `jitter`."""
    return [(t0 + OFFSET + j, t0 + OFFSET + j + 3 * US)
            for (t0, _, _, _), j in zip(_loops(), jitter)]


def test_calibration_is_the_median_offset_with_residuals():
    offset, res = stamped.calibrate(_loops(), _entries())
    assert offset == OFFSET
    assert res == [0, 1 * US, 0]
    offset, res = stamped.calibrate(_loops(), _entries((5 * US,) * 3))
    assert offset == OFFSET + 5 * US and res == [0, 0, 0]
    assert stamped.calibrate([], []) is None
    assert stamped.calibrate(_loops(), []) is None
    # Pairing is by time, whatever order the log holds.
    assert stamped.calibrate(_loops()[::-1], _entries())[0] == OFFSET


def test_calibration_skips_traced_first_passes():
    """The profiler traces a loop's first pass, flag kernel included: the
    pass's launch, inside the loop, pairs with no record."""
    passes = [(OFFSET + 320 * US, OFFSET + 322 * US),
              (OFFSET + 650 * US, OFFSET + 652 * US)]
    offset, res = stamped.calibrate(_loops(), sorted(_entries() + passes))
    assert offset == OFFSET and res == [0, 1 * US, 0]
    # Two records nearest one launch: no pairing.
    assert stamped.calibrate(_loops(), _entries()[:1] + passes[:1]) is None


def _dev():
    """The traced device events: the loops' entry launches, a walk before
    the second loop, its first pass (a walk and the flag kernel) inside
    it, and a walk after the third."""
    return [(OFFSET + 100 * US, OFFSET + 103 * US, "set_conditional"),
            (OFFSET + 200 * US, OFFSET + 230 * US, "stream_traverse_kernel"),
            (OFFSET + 300 * US, OFFSET + 303 * US, "set_conditional"),
            (OFFSET + 310 * US, OFFSET + 330 * US, "stream_traverse_kernel"),
            (OFFSET + 331 * US, OFFSET + 333 * US, "set_conditional"),
            (OFFSET + 600 * US, OFFSET + 603 * US, "set_conditional"),
            (OFFSET + 720 * US, OFFSET + 760 * US, "stream_traverse_kernel")]


def test_union_with_loop_intervals():
    """A loop's untraced passes fill the trace's hole; device events
    inside the loop count once."""
    dev = _dev()
    ivs = stamped.loop_intervals(_loops(), OFFSET)
    assert ivs[1] == (OFFSET + 300 * US, OFFSET + 340 * US, "loop")
    w = (OFFSET, OFFSET + 1000 * US)
    assert profile.busy_ns(dev, *w) == (3 + 30 + 3 + 20 + 2 + 3 + 40) * US
    assert profile.busy_ns(dev + ivs, *w) == (3 + 30 + 40 + 100 + 40) * US
    # Walks counted: 2 outside the loops, 1 + 2 + 7 inside (each body's
    # run a walk, rounds - 1 runs), of which the first pass's is traced.
    ctx = dict(frames=1, window_ns=1000 * US)
    ctx.update(stamped.context(
        dev, w, _loops(), 0,
        {("stream_traverse", "closest_hit_instanced"): 3 + 8}, [],
        {"stream_traverse_kernel": 2 + 11}))
    assert ctx["calibration"] == (OFFSET, [0, 0, 0])
    assert ctx["traced_outside"] == {"stream_traverse_kernel": 2}
    assert ctx["stamped_busy_ns"] == (3 + 30 + 40 + 100 + 40) * US
    assert ctx["sound_loops"]
    assert stamped.loop_ms_retrace(ctx) == pytest.approx((2 + 40 + 100)
                                                         / 1000)
    assert stamped.device_idle_pct_stamped(ctx) == pytest.approx(78.7)


def test_traced_outside_counts_launches_between_loops():
    ivs = stamped.loop_intervals(_loops(), OFFSET)
    assert stamped.traced_outside(_dev(), ivs, ["stream_traverse_kernel",
                                                "khit_kernel"]) == {
        "stream_traverse_kernel": 2, "khit_kernel": 0}
    assert stamped.traced_outside(_dev(), [], ["stream_traverse_kernel"]) \
        == {"stream_traverse_kernel": 3}


@pytest.mark.parametrize("fault", [None, "lost", "unpaired", "backwards",
                                   "untraced", "inside"])
def test_sound_loops_rule(fault):
    """Sound: nothing lost, each record paired with its traced entry
    launch, no loop ending before it began, and each traversal launch
    counted outside WHILE bodies traced outside the loops."""
    loops, lost, paired = _loops(), 0, True
    outside = {"khit_kernel": 5, "stream_traverse_kernel": 7}
    counted = {"khit_kernel": 5, "stream_traverse_kernel": 10}
    inside = {"khit_kernel": 0, "stream_traverse_kernel": 3}
    if fault == "lost":
        lost = 1
    elif fault == "unpaired":
        paired = False
    elif fault == "backwards":
        loops[1] = (340 * US, 300 * US, 4, 1)
    elif fault == "untraced":
        outside = dict(outside, khit_kernel=4)
    elif fault == "inside":
        inside = dict(inside, stream_traverse_kernel=2)
    assert stamped.is_sound(loops, lost, paired, outside, counted,
                            inside) == (fault is None)


def test_inside_launches_sum_the_walks():
    body = {("stream_traverse", "closest_hit_instanced"): 6,
            ("stream_traverse", "any_hit_instanced"): 2,
            ("khit", "khit"): 3, ("dispatch", "dispatch_rows"): 11,
            ("mask_stats", "rounds"): 11}
    assert stamped.inside_launches(body) == {"khit_kernel": 3,
                                             "stream_traverse_kernel": 8}


def _span(name, parent, frame, t0, t1):
    return (name, parent, frame, t0 * US, t1 * US)


def test_enqueue_is_the_frame_less_its_waits():
    spans = [_span("wait:collect", "select", 4, 10, 30),
             _span("select", None, 4, 5, 40),
             _span("wait:counts", "frame", 4, 80, 95),
             _span("frame", None, 4, 0, 100),
             _span("band", "frame", 5, 2, 50),
             _span("wait:counts", "frame", 5, 60, 62),
             _span("frame", None, 5, 0, 70),
             _span("wait:counts", None, None, 0, 500)]    # no frame's
    assert stamped.host_frames(spans) == [(100 * US, 35 * US, 2),
                                          (70 * US, 2 * US, 1)]
    ctx = dict(spans=spans)
    assert stamped.host_enqueue_ms(ctx) == pytest.approx((65 + 68) / 2 / 1e3)
    assert stamped.host_syncs_per_frame(ctx) == 1.5
    assert stamped.host_enqueue_ms(dict(spans=[])) is None


def test_idle_gaps_named_by_program_spans():
    dev = [(0, 10 * US, "k"), (30 * US, 40 * US, "k")]
    host = [(0, 50 * US, "imba::frame", 1),
            (12 * US, 28 * US, "imba::wait:collect", 1),
            (13 * US, 27 * US, "cudaMemcpyAsync", 1),
            (41 * US, 49 * US, "aten::add", 1)]
    ivs = [(40 * US, 45 * US, "loop")]
    gaps = dict(stamped.idle_by_span(dev, ivs, host, 0, 50 * US))
    assert gaps == {"imba::wait:collect": 20 * US, "imba::frame": 5 * US}
