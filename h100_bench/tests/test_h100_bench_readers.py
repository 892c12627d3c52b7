"""The per-layer readers on synthetic traces: what a complete trace gives,
and that an incomplete one gives nothing."""
import pytest

from h100_bench import flops, run
from h100_bench import trace as tr


def k1_name(kind="gn_cluster"):
    return f"void (anonymous namespace)::{kind}<__nv_bfloat16>(...)"


def readings(k1_kernels=2, k2_kernels=3, sentinels=tr.SENTINELS, launched=None):
    k1 = ("k1", (8, 64, 32, 32), "bfloat16", (1, 1))
    calls = [k1, k1, ("k2", (8, 256, 256), "bfloat16", 2)]
    kernels = [(k1_name(), 0.0, 1e-4), (k1_name(), 2e-4, 3e-4)][:k1_kernels]
    kernels += [("x::gemm_bias<...>", 4e-4, 5e-4), ("x::attention_core<...>", 5e-4, 7e-4),
                ("x::gemm_bias<...>", 7e-4, 8e-4)][:k2_kernels]
    kernels += [("cudnn::conv_fprop", 1e-3, 2e-3)]
    trace = tr.Trace(kernels, 0.0, 4e-3, sentinels, [0.0, 4e-3])
    return {"trace": trace, "stretch": trace, "sentinels_ok": sentinels == tr.SENTINELS,
            "calls": calls, "launched": launched or {"k1": 2, "k2": 1},
            "window": {"units": 80, "window_s": 10.0}, "flops_a_unit": 1e12,
            "peak_flops": 989e12, "unet_host_s": [0.01, 0.02],
            "stats_before": {"requests": 10, "batches": 2},
            "stats_after": {"requests": 40, "batches": 7}}


def test_complete_trace_gives_each_metric():
    r = readings()
    k1 = run.reader("k1_roofline.batch")(r)
    assert k1 == pytest.approx(100 * 2 * flops.k1_bound_s((8, 64, 32, 32), 2) / 2e-4)
    k2 = run.reader("k2_roofline.batch")(r)
    assert k2 == pytest.approx(100 * flops.k2_bound_s(8, 256, 256, "bfloat16") / 4e-4)
    assert run.reader("device_idle_pct.batch")(r) == pytest.approx(100 * (1 - 1.6e-3 / 4e-3))
    assert run.reader("mfu.batch")(r) == pytest.approx(100 * 8e12 / 989e12)
    assert run.reader("unet_host_ms.batch")(r) == pytest.approx(15.0)
    assert run.reader("serve_requests_per_batch")(r) == pytest.approx(6.0)


@pytest.mark.parametrize("broken", [dict(k1_kernels=1), dict(k2_kernels=2), dict(sentinels=15),
                                    dict(launched={"k1": 3, "k2": 1})])
def test_incomplete_trace_gives_no_roofline(broken):
    r = readings(**broken)
    assert run.reader("k1_roofline.batch")(r) is None or run.reader("k2_roofline.batch")(r) is None


def test_trace_busy_gaps_and_labels():
    t = tr.Trace([("a", 1.0, 2.0), ("b", 1.5, 3.0), ("c", 4.0, 5.0)], 0.0, 6.0, tr.SENTINELS)
    assert t.busy_s() == pytest.approx(3.0)
    assert t.gaps() == [(0.0, 1.0), (3.0, 4.0), (5.0, 6.0)]
    spans = [("unet", 0, 2.9, 4.1)]
    assert tr.label_gaps(t, spans, ("unet",)) == {"host outside the model": 2.0, "unet": 1.0}
    n = t.narrowed(1.8, 4.5)
    assert n.busy_s() == pytest.approx(1.2 + 0.5) and n.window_s == pytest.approx(2.7)
