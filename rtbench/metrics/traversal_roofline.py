"""The traversal's share of its bound: the least time the card could
take to move the bytes a frame's traversal needs, over the published
3.35 TB/s (rtbench/peaks.py), as a share of kernel_ms.traversal.

The bytes: every live ray the frame's paths trace (closest-hit and
shadow rays, the count render_pt_frame(..., with_stats=True) returns;
no padded or dead lanes) reads its ray row and writes its hit row, 32
bytes each as the traversal kernels' contract fixes them ((R, 8) float32
rays in, (R, 8) float32 rows [t u v id ...] out); and the scene's
triangles (the scene kind's `scene_bytes`: three float32 vertices a
unique triangle, and an instance's two 3x4 matrices) are read once a
bounce and ray kind.  These are what any traversal of these rays needs,
whatever implements it.  Nothing to read without the ray count, which
only the PT frame gives.  Moves frame_ms."""

from rtbench import peaks, spec

RAY_BYTES = 32
HIT_BYTES = 32


def bytes_per_frame(rays_per_frame: float, scene_bytes: int,
                    max_len: int) -> float:
    return (rays_per_frame * (RAY_BYTES + HIT_BYTES)
            + 2 * max_len * scene_bytes)


def read(ctx):
    if ctx["rays"] is None:
        return None
    kernel_ms = spec.metric_reader("kernel_ms.traversal").read(ctx)
    if not kernel_ms:
        return None
    b = bytes_per_frame(ctx["rays"] / ctx["frames"], ctx["scene_bytes"],
                        ctx["max_len"])
    return 100.0 * (b / peaks.HBM_BYTES_PER_S) / (kernel_ms / 1e3)
