"""Helpers of the per-layer metric readers (``metrics/<name>.py``).

A reader is ``read(r) -> float | None``: ``r`` holds what the run recorded
(the window, the trace, spans, counters, call shapes). A reader that finds
nothing to read returns None, and the harness leaves its metric out.
"""
from __future__ import annotations

from . import flops
from . import trace as tr


def mfu_pct(r: dict):
    """Model FLOPs of the window's completed work over the window, against the peak."""
    win = r.get("window")
    if not win or "flops_a_unit" not in r:
        return None
    return 100.0 * win["units"] * r["flops_a_unit"] / win["window_s"] / r["peak_flops"]


def idle_pct(r: dict):
    """Share of the traced stretch's steady part in which no kernel ran."""
    stretch = r.get("stretch")
    if stretch is None or not r.get("sentinels_ok") or not stretch.kernels:
        return None
    return 100.0 * (1.0 - stretch.busy_s() / stretch.window_s)


def roofline_pct(r: dict, kernel: str):
    """A kernel's roofline share in the traced stretch: the sum of its calls'
    bound times over the sum of its kernels' device time. Only a complete
    trace counts: every sentinel kept, one recorded call a launch, and the
    kernels a launch (K1: the port's plan of that call; K2: 3) all there."""
    trace = r.get("trace")
    if trace is None or not r.get("sentinels_ok"):
        return None
    calls = [c for c in r.get("calls", []) if c[0] == kernel]
    if not calls or r["launched"].get(kernel) != len(calls):
        return None
    if kernel == "k1":
        per = [c[3][1] for c in calls]
        if any(k is None for k in per):
            return None
        expected = sum(per)
        bound = sum(flops.k1_bound_s(c[1], 2 if c[2] == "bfloat16" else 4) for c in calls)
        seconds, count = trace.seconds(tr.is_k1)
    else:
        expected = 3 * len(calls)
        bound = sum(flops.k2_bound_s(*c[1], c[2]) for c in calls)
        seconds, count = trace.seconds(tr.is_k2)
    if count != expected or seconds <= 0:
        return None
    return 100.0 * bound / seconds
