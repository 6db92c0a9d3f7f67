"""Device time a traced frame of the traversal's kernels: the stream and
k-hit walks, the sorted dispatch's keys, rows and resolves, the masked
re-trace's slot kernels and WHILE condition, and the instanced pair
route (render/traverse.py, ops/dispatch.py, ops/khit.py,
ops/stream_traverse.py, ops/pairs.py; csrc/khit_traverse.cu,
stream_traverse.cu, dispatch.cu, pairs_kernel.cu, graph_cond.cu).  The
library sorts of the dispatch are not named apart from the merge's and
stay unclaimed.  Read only from a trace whose launches agree with the
program's counters.  Moves frame_ms."""

from rtbench import profile

KERNELS = (r"\bkhit_kernel\b", r"\bstream_traverse_kernel\b",
           r"\bdispatch_keys_kernel\b", r"\bdispatch_rows_kernel\b",
           r"\bkhit_resolve_kernel\b", r"\bstream_resolve_kernel\b",
           r"\bslot_gather_kernel\b", r"\bslot_finish_kernel\b",
           r"\bset_conditional\b", r"\bpairs_kernel\b",
           r"\bpair_candidates_kernel\b", r"\bpair_queue_scan_kernel\b",
           r"\bpair_queue_scatter_kernel\b", r"\bpair_resolve_kernel\b")


def read(ctx):
    if not ctx["sound"]:
        return None
    ns, n = profile.group_ns(ctx["dtot"], KERNELS)
    return ns / 1e6 / ctx["frames"] if n else None
