"""Frames of the timed window rendered a second time on the eager route
because the graphed frame's masked re-trace overflowed its slots or its
rounds' cap (render/graphs.py GRAPH_STATS["reruns"]), over the window's
frames.  Layer: the integrators and their graphs.  Moves frame_ms_p90:
a rerun is a frame that takes its graphed and its eager time."""


def read(ctx):
    return ctx["graph_reruns"] / ctx["window_frames"]
