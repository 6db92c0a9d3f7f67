"""Host calls a traced frame makes that put work on the device: kernel
and graph launches, asynchronous copies and memsets, counted in the
trace's host events (profile.LAUNCH_CALLS).  Layer: the integrators and
their graphs (render/integrators/pt.py, vcm.py, render/graphs.py), whose
captured bounces and phases replace launches by graph launches.  Moves
frame_ms: on a frame the card leaves idle, each launch is host time."""


def read(ctx):
    return ctx["launches"] / ctx["frames"]
