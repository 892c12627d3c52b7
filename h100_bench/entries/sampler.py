"""Batch cells: one sampler call of the port after another on fresh inputs.

Set-up: the weights and a pool of volumes on the device from the seed, the
predictor, and ``warmup_calls`` calls at the cell's shapes. The window:
calls back to back with at most two queued (``core.timed_calls``); each
takes ``batch`` rows of the pool, drawn afresh, and fresh initial latents.
The end-to-end metric that the traffic file names (``metric``; each cell
its own, so that each has a bound of its own): volumes of calls completed
in the window over the window.
After it, one completed call drawn from the seed is recomputed by the plain
reference twice on the same inputs: in float32 with TF32 off, and with its
nets under bfloat16 autocast. The compared number, ``rel_l2_over_bf16``, is
the call's ||port - reference|| / ||reference|| over all its volumes, in
units of the same for the reference's own bfloat16 run: the rounding that a
bf16 computation of this call cannot avoid, which the seed's weights scale
for the program and the control alike. The call's own ``rel_l2`` and the
worst volume's are printed beside it.
With ``--trace 1`` hooks time each UNet forward on the host during the
window, then ``trace_calls`` more calls run under the profiler.
"""
from __future__ import annotations

import json

import torch

from .. import core, flops, port, traffic, weights
from .. import trace as tr
from ..reference import sampler as ref

WARMUP_KEY = 10 ** 9  # call indices of the warm-up calls start here
KEYS = frozenset({"entry", "sampler", "steps", "order", "batch", "metric", "pool",
                  "warmup_calls", "trace_calls", "why"})


class Cell:
    """The port's sampler on a pool of volumes, a call at a time."""

    def __init__(self, cfg, wl, seed, device, w=None):
        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        self.w = weights.make(cfg, seed, device) if w is None else w
        self.pred = port.predictor(cfg, self.w, device)
        self.pool = traffic.sampler_pool(cfg, wl["pool"], seed, device)
        self.fn = port.sampler_fn(self.pred, wl["sampler"], wl["steps"], wl.get("order", 2))

    def reseed(self, seed: int) -> None:
        """The same predictor with another seed's weights and pool."""
        self.seed = seed
        self.w = weights.make(self.cfg, seed, self.device)
        port.load(self.pred, self.w)
        self.pool = traffic.sampler_pool(self.cfg, self.wl["pool"], seed, self.device)

    def inputs(self, k: int) -> tuple:
        rows = traffic.call_rows(self.wl["pool"], self.wl["batch"], self.seed, k, self.device)
        img, v2d = (t.index_select(0, rows) for t in self.pool)
        return img, v2d, traffic.call_noise(self.cfg, self.wl["batch"], self.seed, k, self.device)

    def call(self, k: int, fn=None):
        return (fn or self.fn)(*self.inputs(k))


def reference_calls(cfg, wl, seed, k, device, w=None) -> tuple:
    """The plain reference's outputs of call ``k`` from the seed alone: (float32,
    bfloat16 autocast)."""
    w = weights.make(cfg, seed, device) if w is None else w
    pool = traffic.sampler_pool(cfg, wl["pool"], seed, device)
    rows = traffic.call_rows(wl["pool"], wl["batch"], seed, k, device)
    img, v2d = (t.index_select(0, rows) for t in pool)
    noise = traffic.call_noise(cfg, wl["batch"], seed, k, device)
    return tuple(ref.predict(w, cfg, img, v2d, noise, wl["sampler"], wl["steps"], dtype=d).cpu()
                 for d in (torch.float32, torch.bfloat16))


def readings(got: torch.Tensor, want: tuple) -> dict:
    """The compared number ``rel_l2_over_bf16`` of ``got`` against ``want``
    (``reference_calls``), with the call's ``rel_l2``, the reference's own
    bf16 one and the worst volume's."""
    ref32, ref16 = want
    err, err16 = core.rel_l2(got, ref32), core.rel_l2(ref16, ref32)
    return {"rel_l2_over_bf16": err / err16, "rel_l2": err, "ref_bf16_rel_l2": err16,
            "worst_volume": max(core.rel_l2(got[i], ref32[i]) for i in range(got.shape[0]))}


def calibration(cfg, wl, seeds, control_seeds, fault_seeds, seconds, device) -> list:
    """The compared numbers of the program and of the control (the port's own
    int8 path, both flags) on the same call of each seed, one dict a reading."""
    out = []
    cell = None
    for seed in sorted(set(seeds) | set(control_seeds)):
        if cell is None:
            cell = Cell(cfg, wl, seed, device)
            ctl = port.sampler_fn(port.int8(cell.pred), wl["sampler"], wl["steps"],
                                  wl.get("order", 2))
            for fn in (cell.fn, ctl):
                cell.call(WARMUP_KEY, fn)
        else:
            cell.reseed(seed)
        k = int(seed % 97)
        want = reference_calls(cfg, wl, seed, k, device, w=cell.w)
        for side, group, fn in (("program", seeds, cell.fn), ("control", control_seeds, ctl)):
            if seed in group:
                out.append({"seed": seed, "side": side, **readings(cell.call(k, fn).cpu(), want)})
                print(json.dumps(out[-1]), flush=True)
    return out


def run(ctx: core.Ctx) -> dict:
    cfg, wl = ctx.cfg, ctx.wl
    cell = Cell(cfg, wl, ctx.seed, ctx.device)
    for j in range(wl["warmup_calls"]):
        cell.call(WARMUP_KEY + j)
    spans = tr.Spans()
    if ctx.trace:
        for name, m in port.unet_modules(cell.pred).items():
            spans.hook(m, name)
    ctx.mark_setup()

    sample = core.Reservoir(1, ctx.seed, 11)
    win = core.timed_calls(cell.call, ctx.seconds, wl["batch"],
                           keep=lambda k, out: sample.offer((k, out)))
    evals = flops.evaluations(wl["sampler"], wl["steps"], cfg["num_timesteps"])
    ctx.readings.update(window=win, flops_a_unit=flops.sampler_call(cfg, 1, evals),
                        peak_flops=flops.PEAK_FLOPS[cfg["compute_dtype"]])
    if ctx.trace:
        ctx.readings["unet_host_s"] = [b - a for a, b in spans.between(
            "unet", win["t0"], win["t0"] + win["window_s"])]
        traced(ctx, cell, spans)
    spans.remove()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
        ctx.device_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated()

    (k, out), = sample.items
    got = out.cpu()
    del cell, out, sample
    core.free(ctx.device)
    got = readings(got, reference_calls(cfg, wl, ctx.seed, k, ctx.device))
    checks = {"rel_l2_over_bf16": (got["rel_l2_over_bf16"], ctx.limits["rel_l2_over_bf16"])}
    return {"metrics": {wl["metric"]: (win["rate"], "volumes/s")},
            "attempted": win["dispatched"] * wl["batch"], "failed": 0, "checks": checks,
            "rel_l2": got["rel_l2"], "ref_bf16_rel_l2": got["ref_bf16_rel_l2"],
            "worst_volume_rel_l2": got["worst_volume"], "checked_call": k}


def traced(ctx: core.Ctx, cell: Cell, spans: tr.Spans) -> None:
    """``trace_calls`` calls under the profiler, queued as in the window (at
    most two); retaken (up to 3 times) while the trace lost a sentinel. The
    K1/K2 calls' shapes (the same in every call) are recorded by hooks in
    one call before, so the traced calls run without them. Idle share and
    breakdown are read between the end of the first traced call and the end
    of the last (steady, none draining)."""
    shapes = tr.Spans()
    gn, attn = port.kernel_modules(cell.pred)
    for m in gn:
        shapes.shape_hook(m, "k1", lambda x, m=m: (
            m.num_groups, port.k1_kernels_a_call(x, m.num_groups, m.act) if x.is_cuda else None))
    for m in attn:
        shapes.shape_hook(m, "k2", lambda x, m=m: m.num_heads)
    k0 = 2 * WARMUP_KEY
    cell.call(k0 - 1)
    shapes.remove()
    n = ctx.wl["trace_calls"]
    for attempt in range(3):
        traces = []
        before = port.launches()
        with tr.profiled(traces) as block:
            queued_calls(lambda j: cell.call(k0 + attempt * 100 + j), n, block)
        after = port.launches()
        trace = traces[0]
        if trace.sentinels_kept == tr.SENTINELS:
            break
    record_trace(ctx, trace, spans, ("unet", "vae.encode_2d", "vae.decode_3d"))
    ctx.readings.update(calls=shapes.calls * n,
                        launched={k: after[k] - before[k] for k in after})


def queued_calls(call, n: int, block) -> None:
    """``n`` calls, at most two queued on the device, a delimiter after each."""
    events = []
    for j in range(n):
        if len(events) >= 2:
            events[-2].synchronize()
        call(j)
        block.delimit()
        events.append(torch.cuda.Event())
        events[-1].record()


def record_trace(ctx: core.Ctx, trace: tr.Trace, spans: tr.Spans, order: tuple) -> None:
    """The readings and the result's device fields of a traced stretch: the
    whole trace for the rooflines; between its first and last delimiters
    (where it has them) for busy, idle and the breakdown."""
    d = trace.delimiters
    steady = trace.narrowed(d[0], d[-1]) if len(d) >= 2 else trace
    ctx.readings.update(trace=trace, stretch=steady,
                        sentinels_ok=trace.sentinels_kept == tr.SENTINELS)
    ctx.device_info.update(busy_s=steady.busy_s(), window_s=steady.window_s)
    ctx.breakdown = {
        "device_ops": sorted(steady.by_kind().items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(tr.label_gaps(steady, spans.spans, order).items(),
                            key=lambda kv: -kv[1])[:10]}
