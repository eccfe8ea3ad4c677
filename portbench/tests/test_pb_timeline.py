"""The trace arithmetic on a hand-made timeline: busy and idle time,
breakdown, kernel attribution held to launch counters."""

import pytest

from portbench import timeline as TL
from portbench.attribution import AttributionError, family_seconds, roofline_pct
from portbench.manifest import HERE, load_reader


def ev(name, cat, ts_us, dur_us):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts_us, "dur": dur_us}


def events():
    return [
        ev("pb:traced", "user_annotation", 0, 100),
        ev("pb:train_step", "user_annotation", 0, 60),
        ev("pb:block_sync", "user_annotation", 60, 40),
        ev("void csr_spmm_kernel<__nv_bfloat16, __nv_bfloat16, true, 32, true>(int const*)",
           "kernel", 5, 10),
        ev("void csr_spmm_hub_kernel<float, true>(int const*)", "kernel", 12, 8),  # overlaps
        ev("void tc::split_kvs_kernel<float>(float const*)", "kernel", 30, 10),
        ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 80, 10),
        ev("pb:train_step", "gpu_user_annotation", 0, 60),  # not device work
        ev("void csr_spmm_kernel<float, float, true, 32, true>(int const*)", "kernel", 95, 20),
        ev("aten::mm", "cpu_op", 0, 50),
    ]


def test_window_busy_and_idle():
    tl = TL.from_events(events())
    assert tl.window_s == pytest.approx(100e-6)
    # [5, 20] + [30, 40] + [80, 90] + [95, 100] (clipped) = 15 + 10 + 10 + 5
    assert TL.busy_seconds(tl) == pytest.approx(40e-6)
    assert TL.idle_share(tl) == pytest.approx(0.6)


def test_idle_gaps_are_named_by_the_host_span():
    gaps = TL.idle_gaps(TL.from_events(events()))
    named = {(g.name, round(g.seconds * 1e6, 6)) for g in gaps}
    assert named == {("train_step", 5.0), ("train_step", 10.0), ("train_step", 20.0),
                     ("block_sync", 20.0), ("block_sync", 5.0)}
    b = TL.breakdown(TL.from_events(events()))
    assert b["idle_gaps"][0] == ["train_step", pytest.approx(35e-6)]
    assert dict((k, v) for k, v in b["device_ops"])["csr_spmm_kernel"] == pytest.approx(15e-6)


def test_kernel_ids():
    assert TL.kernel_id("void csr_spmm_kernel<float>(int)") == "csr_spmm_kernel"
    assert TL.kernel_id("void tc::split_kvs_kernel<float>(float const*)") == "split_kvs_kernel"
    assert TL.kernel_id("nvjet_tst_128x64_64x8") == "nvjet_tst_128x64_64x8"
    # as CUPTI names the port's kernels on the card
    assert TL.kernel_id("void (anonymous namespace)::csr_spmm_kernel<__nv_bfloat16, "
                        "__nv_bfloat16, true, 32, true>(int const*, int)") == "csr_spmm_kernel"
    assert TL.kernel_id("(anonymous namespace)::la_finish_kernel(float const*, float*)") \
        == "la_finish_kernel"
    assert TL.kernel_id("(anonymous namespace)::la_reduce_wgmma_kernel(__nv_bfloat16 const*, "
                        "CUtensorMap_st tc::RdMaps)") == "la_reduce_wgmma_kernel"


def test_one_window_span_is_required():
    with pytest.raises(ValueError):
        TL.from_events([e for e in events() if e["name"] != "pb:traced"])


def test_attribution_matches_or_raises():
    tl = TL.from_events(events())
    group = ("csr_spmm_kernel", "csr_spmm_hub_kernel")
    anchors = {"csr_spmm": ("csr_spmm_kernel",)}
    # two csr_spmm_kernel launches in the window (one clipped), one hub pass
    assert family_seconds(tl, group, anchors, {"csr_spmm": 2}) == pytest.approx(23e-6)
    with pytest.raises(AttributionError):
        family_seconds(tl, group, anchors, {"csr_spmm": 3})
    assert family_seconds(tl, ("la_apply_kernel",), {"linear_attention_apply": ()}, {}) is None
    assert roofline_pct(1.0, 4.0) == 25.0
    assert roofline_pct(1.0, None) is None and roofline_pct(1.0, 0.0) is None


def _reader(name):
    return load_reader(name)


class _Run:
    model = dict(hidden_channels=256, out_channels=40, trans_num_layers=1, gnn_num_layers=3)
    dtype = "bf16"
    in_channels = 128
    graph = {}


def test_spmm_roofline_reader_on_a_timeline():
    from portbench.harness import MetricContext, Window
    from portbench.yardstick import spmm_least_s

    n, e = 1000, 5000
    evs = [ev("pb:traced", "user_annotation", 0, 10_000)]
    evs += [ev("void csr_spmm_kernel<bf16>(int)", "kernel", 100 * i, 50) for i in range(6)]
    # the measured window: 100 steps of n nodes in 50 ms
    steps = [{"nodes": n, "edges": e, "ms": 0.5}] * 100
    ctx = MetricContext(_Run(), Window(0.05, steps, [], 100, 0), TL.from_events(evs),
                        [{"kind": "train", "nodes": n, "edges": e}], {"csr_spmm": 6})
    want = 100 * 6 * spmm_least_s(n, e, 256, "bf16") / (6 * 50e-6)
    assert _reader("spmm_roofline.train")(ctx) == pytest.approx(want)
    # the card busy 300 us a step of the trace, a step of the window 500 us
    assert _reader("device_idle_pct.train")(ctx) == pytest.approx(40.0)
    # a forward aggregates once a layer: half a step's least time
    ctx.traced = [{"kind": "forward", "nodes": n, "edges": e}]
    assert _reader("spmm_roofline.serve")(ctx) == pytest.approx(want / 2)
    ctx.launches = {"csr_spmm": 5}
    with pytest.raises(AttributionError):
        _reader("spmm_roofline.train")(ctx)


def test_serving_idle_leaves_out_the_wait_for_arrivals():
    from portbench.harness import MetricContext, Window

    evs = [ev("pb:traced", "user_annotation", 0, 100_000),
           ev("pb:wait_arrival", "user_annotation", 9_000, 91_000),
           ev("void csr_spmm_kernel<bf16>(int)", "kernel", 0, 8_000)]
    # requests served in 10 ms each, whatever they waited for their arrival
    reqs = [{"latency_ms": 30.0, "late_ms": 20.0, "service_ms": 10.0, "graph_nodes": 10,
             "graph_edges": 20}] * 4
    ctx = MetricContext(_Run(), Window(1.0, [], reqs, 4, 0), TL.from_events(evs),
                        [{"kind": "forward", "nodes": 10, "edges": 20}], {})
    assert _reader("device_idle_pct.serve")(ctx) == pytest.approx(20.0)
    assert TL.idle_share(ctx.timeline) == pytest.approx(0.92)


def test_attention_roofline_counts_the_backward_in_train_steps_only():
    from portbench.harness import MetricContext, Window
    from portbench.yardstick import attention_least_s

    evs = [ev("pb:traced", "user_annotation", 0, 10_000),
           ev("void la_reduce_wgmma_kernel(int)", "kernel", 0, 100),
           ev("void la_apply_wgmma_kernel(int)", "kernel", 200, 100)]
    launches = {"linear_attention_reduce": 1, "linear_attention_apply": 1}
    for kind, backward in (("forward", False), ("train", True)):
        ctx = MetricContext(_Run(), Window(1.0, [], [], 0, 0), TL.from_events(evs),
                            [{"kind": kind, "nodes": 5000, "edges": 0}], launches)
        want = 100 * attention_least_s(5000, 256, 256, "bf16", backward) / 200e-6
        assert _reader(f"attention_roofline.{kind}")(ctx) == pytest.approx(want)


def test_a_metric_without_a_file_of_its_own_is_read_by_its_family():
    assert not (HERE / "metrics" / "mfu.serve.py").exists()
    assert load_reader("mfu.serve").__code__.co_filename == str(HERE / "metrics" / "mfu.py")
    with pytest.raises(FileNotFoundError):
        load_reader("no_such_metric.train")


def test_window_readers():
    from portbench.harness import MetricContext, Window

    steps = [{"nodes": 100, "edges": 10, "ms": float(i), "build_ms": 2.0} for i in range(1, 101)]
    ctx = MetricContext(_Run(), Window(2.0, steps, [], 100, 0, mem_peak_bytes=3 * 2 ** 20))
    assert _reader("train_nodes_per_s")(ctx) == pytest.approx(5000.0)
    assert _reader("train_step_ms_p95")(ctx) == pytest.approx(95.05)
    assert _reader("batch_build_ms")(ctx) == pytest.approx(2.0)
    assert _reader("peak_mem_mib")(ctx) == pytest.approx(3.0)
    reqs = [{"latency_ms": float(i), "service_ms": 1.0, "graph_nodes": 10, "graph_edges": 20}
            for i in range(1, 21)]
    ctx = MetricContext(_Run(), Window(1.0, [], reqs, 20, 0))
    assert _reader("request_ms_p50")(ctx) == pytest.approx(10.5)
    assert _reader("request_ms_p95")(ctx) == pytest.approx(19.05)
    assert _reader("train_nodes_per_s")(ctx) is None
