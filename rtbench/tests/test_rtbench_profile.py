"""The trace reduction on a small recorded trace: two frames' device
events on one stream (with an overlap from a second one) and the host
events that launched them."""

import pytest

from rtbench import profile, spec

MS = 1_000_000
DEV = [
    (0 * MS, 4 * MS, "void khit_kernel<4, imba::NoWork>(float const*)"),
    (3 * MS, 5 * MS, "khit_resolve_kernel(float const*)"),   # overlaps
    (6 * MS, 7 * MS, "(anonymous namespace)::pt_shade_kernel(Args)"),
    (7 * MS, 8 * MS, "void at_cuda_detail::cub::DeviceRadixSortOnesweep"),
    (10 * MS, 14 * MS, "void khit_kernel<4, imba::NoWork>(float const*)"),
    (15 * MS, 16 * MS, "pt_shade_finish_kernel(float*)"),
]
HOST = [
    (0, 20 * MS, "frame", 1),
    (1 * MS, 2 * MS, "cudaGraphLaunch", 1),
    (5 * MS, 6 * MS, "aten::bitwise_and", 1),
    (5 * MS + MS // 5, 5 * MS + MS // 5 + 100, "cudaLaunchKernel", 1),
    (8 * MS, 10 * MS, "aten::sort", 1),
    (8 * MS + MS // 5, 8 * MS + MS // 5 + 10, "cudaMemsetAsync", 1),
    (14 * MS, 15 * MS, "cudaStreamSynchronize", 1),
    (0, 20 * MS, "python thread", 2),
]


def test_busy_is_the_union_of_device_intervals():
    assert profile.busy_intervals(DEV) == [(0, 5 * MS), (6 * MS, 8 * MS),
                                           (10 * MS, 14 * MS),
                                           (15 * MS, 16 * MS)]
    assert profile.busy_ns(DEV, 0, 20 * MS) == 12 * MS
    assert profile.busy_ns(DEV, 2 * MS, 11 * MS) == 6 * MS


def test_idle_share_reader():
    ctx = dict(busy_ns=profile.busy_ns(DEV, 0, 20 * MS), window_ns=20 * MS,
               sound=True)
    idle = spec.metric_reader("device_idle_pct").read(ctx)
    assert idle == pytest.approx(40.0)


def test_kernel_group_sums():
    dtot, _ = profile.totals(DEV, HOST)
    ctx = dict(dtot=dtot, frames=2, sound=True)
    trav = spec.metric_reader("kernel_ms.traversal").read(ctx)
    shade = spec.metric_reader("kernel_ms.shading").read(ctx)
    assert trav == pytest.approx((4 + 2 + 4) / 2)
    assert shade == pytest.approx((1 + 1) / 2)
    assert spec.metric_reader("kernel_ms.merge").read(ctx) is None
    assert spec.metric_reader("kernel_ms.traversal").read(
        dict(ctx, sound=False)) is None
    assert profile.count_matching(dtot, r"\bkhit_kernel\b") == 2


def test_host_totals_and_launch_calls():
    _, htot = profile.totals(DEV, HOST)
    assert htot["frame"][0] == 20 * MS - (MS + MS + 2 * MS + MS)
    assert htot["aten::bitwise_and"][0] == MS - 100
    assert profile.launch_calls(HOST) == 3
    ctx = dict(launches=profile.launch_calls(HOST), frames=2)
    assert spec.metric_reader("host_launches_per_frame").read(ctx) == 1.5


def test_idle_gaps_by_host_event():
    gaps = dict((k, v) for k, v in profile.idle_gaps(DEV, HOST, 0, 20 * MS))
    assert gaps["aten::bitwise_and"] == MS          # 5-6 ms
    assert gaps["aten::sort"] == 2 * MS             # 8-10 ms
    assert gaps["cudaStreamSynchronize"] == MS      # 14-15 ms
    assert gaps["frame"] == 4 * MS                  # 16-20 ms
    assert sum(gaps.values()) == 8 * MS
