"""The timed window's arithmetic, on the host clock.

`frame_ms` is the window's wall time over the frames completed in it:
the window opens before the first frame and closes when the frame that
crossed `seconds` has synchronised, so every frame in it is whole and
no time is left out.  `frame_ms_p90` is the 90th percentile of every
frame's own wall time in the window (Python's `statistics.quantiles`,
inclusive method), each frame timed from its start to the
synchronisation after it, as the renderer's own loop does.
"""

from __future__ import annotations

import statistics


def frame_ms(window_s: float, frames: int) -> float:
    if frames <= 0:
        raise ValueError("no frame completed in the window")
    return 1e3 * window_s / frames


def frame_ms_p90(frame_times_ms) -> float:
    ms = list(frame_times_ms)
    if len(ms) < 2:
        raise ValueError("the p90 needs two frames or more")
    return statistics.quantiles(ms, n=10, method="inclusive")[8]


def tail_count(frame_times_ms) -> int:
    """Frames beyond the p90: the samples that the percentile rests on."""
    p = frame_ms_p90(frame_times_ms)
    return sum(1 for x in frame_times_ms if x > p)
