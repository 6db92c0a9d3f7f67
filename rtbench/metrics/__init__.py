"""Per-layer metrics: one file each, `<metric name>.py`, holding its
reader `read(ctx) -> value or None` and, for a kernel group, the table
of kernel names (`KERNELS`, regular expressions on the trace's device
event names) that it sums.  `ctx` is the traced segment's reduction
(rtbench/run.py `traced_segment`): frames traced, the traced window and
the device's busy time in ns, device time and count by kernel name,
whether the trace agrees with the program's launch counters, the host
calls that put work on the device, the window's frames and graph
reruns, the traced frames' rays (PT, else None), the scene's bytes and
the paths' longest length.  A
reader that finds nothing to read returns None, and the metric is left
out of the line."""
