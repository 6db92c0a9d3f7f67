"""Device time a traced frame of the shading kernels: the PT bounce's
two (ops/shade.py, csrc/pt_shade.cu) and the VCM family's light start,
light bounce, camera bounce and finish (ops/vcm_shade.py,
csrc/vcm_shade.cu).  Read only from a trace whose launches agree with
the program's counters.  Moves frame_ms."""

from rtbench import profile

KERNELS = (r"\bpt_shade_kernel\b", r"\bpt_shade_finish_kernel\b",
           r"\bvcm_light_start_kernel\b", r"\bvcm_light_shade_kernel\b",
           r"\bvcm_camera_shade_kernel\b", r"\bvcm_finish_kernel\b")


def read(ctx):
    if not ctx["sound"]:
        return None
    ns, n = profile.group_ns(ctx["dtot"], KERNELS)
    return ns / 1e6 / ctx["frames"] if n else None
