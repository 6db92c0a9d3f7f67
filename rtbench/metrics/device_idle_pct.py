"""Share of the traced frames' wall time in which no device event runs:
1 - the union of the device events' intervals over the traced window
(rtbench/profile.py busy_intervals).  Layer: the device, one H100.
Moves frame_ms: idle time is time the host holds the card back.  Read
only from a trace whose launches agree with the program's counters: the
profiler leaves out the kernels that run inside a graph's WHILE
conditional bodies (the masked re-trace's rounds past the first), which
an instanced frame runs by the hundred."""


def read(ctx):
    if not ctx["sound"]:
        return None
    return 100.0 * (1.0 - ctx["busy_ns"] / ctx["window_ns"])
