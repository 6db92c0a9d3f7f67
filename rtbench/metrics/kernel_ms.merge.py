"""Device time a traced frame of the light cache and the merge: the
collect append and the light splat (render/light_cache.py,
ops/light_tail.py, csrc/light_tail.cu), the selection (ops/select.py,
csrc/select.cu), the photon grid (csrc/grid_build.cu) and the merge with
its query preparation (ops/merge.py, csrc/merge_kernel.cu).  The
library sorts between them are not named apart from the dispatch's and
stay unclaimed.  Read only from a trace whose launches agree with the
program's counters; nothing to read in a PT frame.  Moves frame_ms."""

from rtbench import profile

KERNELS = (r"\bcollect_append_kernel\b", r"\bsplat_kernel\b",
           r"\bselect_keys_kernel\b", r"\bselect_gather_kernel\b",
           r"\bgrid_keys_kernel\b", r"\bgrid_tiles_kernel\b",
           r"\bmerge_kernel\b", r"\bmerge_sort_key_kernel\b",
           r"\bmerge_inverse_kernel\b", r"\bmerge_query_rows_kernel\b")


def read(ctx):
    if not ctx["sound"]:
        return None
    ns, n = profile.group_ns(ctx["dtot"], KERNELS)
    return ns / 1e6 / ctx["frames"] if n else None
