"""The yardstick's arithmetic: the bound, the union of busy intervals,
the window's seeds and rates."""

import pytest

from portbench import readers, roofline, trace, window


def test_block_bound_pcawg_headline():
    ms, kind = roofline.block_bound(100, 96, 5, 192, 10)
    assert kind == "operations"
    assert ms == pytest.approx(0.00859, rel=2e-3)  # 5.75e8 FLOP at 67 TFLOP/s


def test_block_bound_cohort_lane_rereads_nothing():
    # one lane's X of 96 x 200,000 with its factors fits on chip (PERF.md)
    ms, kind = roofline.block_bound(10, 96, 5, 200_000, 10, per_lane_x=True)
    assert kind == "operations"
    assert ms == pytest.approx(0.8913, rel=1e-3)


def test_lanes_bound_sums_each_lanes_blocks():
    one = roofline.block_bound(1, 96, 5, 192, 10)[0] / 1e3
    assert roofline.lanes_bound_s(96, 192, [(5, 5000)] * 100, False) == \
        pytest.approx(500 * 100 * one)
    assert roofline.lanes_bound_s(96, 192, [(5, 0)], False) == 0.0


def test_union_of_intervals():
    assert trace.union_seconds([]) == 0.0
    assert trace.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.union_seconds([(0, 10), (2, 3), (4, 5)]) == 10
    assert trace.union_seconds([(3, 4), (0, 1)]) == 2


def test_idle_gaps_and_open_host_event():
    gaps = trace.idle_gaps([(2, 4), (3, 5), (7, 8)], (0, 10))
    assert gaps == [(0, 2), (5, 7), (8, 10)]
    host = [("outer", 0, 10), ("inner", 4, 6), ("late", 9, 12)]
    assert trace.open_at(host, 5)[0] == "inner"
    assert trace.open_at(host, 1)[0] == "outer"
    assert trace.open_at(host, 11)[0] == "late"
    assert trace.open_at(host, 20) is None


def test_summarize_splits_jobs_and_names_gaps():
    device = [("mu_block_resident_kernel", 10, 20), ("copy", 15, 25),
              ("mu_block_resident_kernel", 110, 120)]
    host = [(trace.JOB_SPAN, 0, 100), (trace.JOB_SPAN, 100, 150),
            ("aten::sum", 20, 60)]
    out = trace.summarize(device, host)
    first, second = out["jobs"]
    assert first["busy_s"] == pytest.approx(15e-9)
    assert first["kernel_s"] == pytest.approx(10e-9)
    assert first["kernel_count"] == 1 and second["kernel_count"] == 1
    assert out["device_ops"][0][0] in ("mu_block_resident_kernel", "copy")
    assert out["idle_gaps"][0] == ["aten::sum", pytest.approx(75e-9)]


def test_job_seeds_fixed_and_in_range():
    seeds = [window.job_seed(2**31 + 5, i) for i in range(50)]
    assert seeds == [window.job_seed(2**31 + 5, i) for i in range(50)]
    assert len(set(seeds)) == 50
    assert all(0 <= s < 2**31 for s in seeds)


def test_closed_loop_counts_all_time_and_failures():
    ticks = iter(range(100))
    calls = []

    def job(seed):
        calls.append(seed)
        if len(calls) == 2:
            raise RuntimeError("planted failure")
        return {"work": {"n": 3}}

    records, window_s = window.closed_loop(job, 7, 8, clock=lambda: next(ticks))
    # each job and each look at the clock takes one tick; jobs start while
    # fewer than 8 have passed since the first started
    assert [r["failed"] for r in records] == [False, True, False]
    assert window_s == records[-1]["end"] - records[0]["start"]
    ctx = {"jobs": records, "window_s": window_s, "setup_s": 1.0}
    assert readers.rate(ctx, "n") == pytest.approx(6 / window_s)
    assert readers.mean_work(ctx, "n") == 3


def test_shares_need_something_to_read():
    ctx = {"jobs": [], "window_s": 1.0, "traced": None}
    assert readers.kernel_roofline(ctx) is None
    assert readers.work_roofline(ctx) is None
    assert readers.idle_share(ctx) is None
    job = {"untraced": {"wall_s": 2.0, "work": {"bound_s": 0.1}},
           "busy_s": 1.0, "kernel_s": 0.5, "kernel_count": 3}
    ctx["traced"] = [job]
    assert readers.kernel_roofline(ctx) == pytest.approx(20.0)
    assert readers.work_roofline(ctx) == pytest.approx(10.0)
    assert readers.idle_share(ctx) == pytest.approx(50.0)
