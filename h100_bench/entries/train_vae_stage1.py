"""Training cell: the port's stage-1 VAE train step (E3D + D3D), microbatch after microbatch.

Set-up builds one trainer (``make_steps`` over ``Stage1VAE`` and
``AccumAdam``) from the seed's weights and drives it through its first
``CHECKED_STEPS`` accumulation cycles: ``grad_accum`` microbatches each, of
the window's own call, on rows of a seed-made pool that all differ, the last
of each cycle taking an optimizer step. Those cycles are the check: each
microbatch's loss, the first gradient as Adam got it (its first moment
after one step, / (1 - beta1)), and the parameters after the last checked
step are kept. The window then goes on with the same object.
``train_samples_per_s``: samples of microbatches completed in the window
over the window.

After the window the plain reference runs the same cycles from the same
weights, data and noise, as the configuration states (TF32 convolutions,
float32 matmuls), and three numbers are held to the cell's limits (each by
the worst leaf, against the larger of the reference's norm of that leaf and
of the median leaf): ``loss_gap`` (the worst microbatch's |loss -
reference| / reference), ``grad_gap`` (the gap of the norms of the first
gradient) and ``update_gap`` (of the norms of the parameters' change over
the checked steps; from the second step on Adam's update depends on the
gradients' size, not only their sign). Leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone and are
left out of ``update_gap``.
"""
from __future__ import annotations

import json
import time

import torch

from .. import core, flops, port, traffic, weights
from .. import trace as tr
from . import sampler
from ..reference import train_vae as ref

SPAN_ORDER = ("vae.encode_3d", "vae.decode_3d", "train_step")
KEYS = frozenset({"entry", "pool", "trace_calls", "why"})
CHECKED_STEPS = 2   # optimizer steps the check follows


def batch(pool: dict, perm: torch.Tensor, b: int, step: int) -> dict:
    n = perm.shape[0]
    start = (step * b) % n
    rows = perm[start:start + b]
    return {k: v.index_select(0, rows) for k, v in pool.items()}


class Trainer:
    """The port's trainer on the seed's pool, a microbatch a call."""

    def __init__(self, cfg, wl, seed, device):
        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        self.b = cfg["train"]["batch_size"]
        self.accum = cfg["train"]["grad_accum"]
        w = weights.make(cfg, seed, device)
        self.vae, self.opt, self.step_fn = port.stage1(cfg, w, device)
        del w
        self.pool = traffic.train_pool(cfg, wl["pool"], seed, device)
        self.perm = traffic.pool_order(wl["pool"], seed, device)

    def call(self, k: int):
        m = self.step_fn(batch(self.pool, self.perm, self.b, k), self.cfg["train"]["kl_coeff"],
                         (k + 1) % self.accum == 0,
                         noise=traffic.train_noise(self.cfg, self.seed, k, self.device))
        return m["recons"] + self.cfg["train"]["kl_coeff"] * m["kl"]

    def checked_cycles(self) -> dict:
        """The check's cycles: losses, the first gradient, and the parameters
        after the last checked step."""
        b1 = self.cfg["train"]["adam_betas"][0]
        names = self.opt.names
        state = self.opt.adam.state
        losses = [self.call(k) for k in range(self.accum)]
        # a step that left Adam untouched has no moment: the gradient it applied is nought
        grad = {n: (state[p]["exp_avg"] / (1 - b1)).cpu() if "exp_avg" in state.get(p, {})
                else torch.zeros(p.shape) for n, p in zip(names, self.opt.params)}
        losses += [self.call(k) for k in range(self.accum, CHECKED_STEPS * self.accum)]
        params = {n: p.detach().to("cpu", copy=True) for n, p in zip(names, self.opt.params)}
        return {"losses": [float(x) for x in losses], "first_grad": grad, "params": params}


def reference_cycles(cfg, wl, seed, device, dtype=torch.float32, fault: str = "") -> tuple:
    """(weights, the reference's checked cycles) for the seed."""
    w = weights.make(cfg, seed, device)
    pool = traffic.train_pool(cfg, wl["pool"], seed, device)
    perm = traffic.pool_order(wl["pool"], seed, device)
    b, n = cfg["train"]["batch_size"], CHECKED_STEPS * cfg["train"]["grad_accum"]
    batches = [batch(pool, perm, b, k) for k in range(n)]
    noises = [traffic.train_noise(cfg, seed, k, device) for k in range(n)]
    return w, ref.train(w, cfg, batches, noises, dtype=dtype, fault=fault)


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def gaps(w: dict, got: dict, want: dict) -> dict:
    """The three compared numbers of ``got`` (the side judged) against ``want``."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    g_ref = _norms(want["first_grad"])
    g_got = _norms(got["first_grad"])
    med_g = sorted(g_ref.values())[len(g_ref) // 2]
    grad = max(abs(g_got[k] - g_ref[k]) / max(g_ref[k], med_g) for k in g_ref)
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * med_g]
    d_ref = {k: float(torch.linalg.vector_norm((want["params"][k].cpu() - w[k].cpu()).double()))
             for k in moved}
    d_got = {k: float(torch.linalg.vector_norm((got["params"][k].cpu() - w[k].cpu()).double()))
             for k in moved}
    med_d = sorted(d_ref.values())[len(d_ref) // 2]
    update = max(abs(d_got[k] - d_ref[k]) / max(d_ref[k], med_d) for k in moved)
    return {"loss_gap": loss, "grad_gap": grad, "update_gap": update,
            "left_out": len(g_ref) - len(moved)}


def precision(cfg) -> None:
    """The configuration's precision: TF32 convolutions where it says so."""
    torch.backends.cudnn.allow_tf32 = cfg["tf32_convs"]
    torch.backends.cuda.matmul.allow_tf32 = False


def calibration(cfg, wl, seeds, control_seeds, fault_seeds, seconds, device) -> list:
    """The compared numbers of the program, of the control (the reference
    under bfloat16 autocast) and of the half-batch fault (the reference
    taking its loss over half of each microbatch), one dict a reading; a
    state left unchanged reads 1 by construction."""
    precision(cfg)
    out = []
    for seed in sorted(set(seeds) | set(control_seeds) | set(fault_seeds)):
        cycles = None
        if seed in seeds:
            trainer = Trainer(cfg, wl, seed, device)
            cycles = trainer.checked_cycles()
            del trainer
            core.free(device)
        w, want = reference_cycles(cfg, wl, seed, device)
        if cycles is not None:
            out.append({"seed": seed, "side": "program", **gaps(w, cycles, want)})
            print(json.dumps(out[-1]), flush=True)
        for side, group, kw in (("control", control_seeds, {"dtype": torch.bfloat16}),
                                ("half_batch", fault_seeds, {"fault": "half_batch"})):
            if seed in group:
                _, got = reference_cycles(cfg, wl, seed, device, **kw)
                out.append({"seed": seed, "side": side, **gaps(w, got, want)})
                print(json.dumps(out[-1]), flush=True)
                del got
                core.free(device)
        del w, want
        core.free(device)
    return out


def run(ctx: core.Ctx) -> dict:
    cfg, wl = ctx.cfg, ctx.wl
    precision(cfg)
    trainer = Trainer(cfg, wl, ctx.seed, ctx.device)
    cycles = trainer.checked_cycles()
    spans = tr.Spans()
    if ctx.trace:
        spans.hook(trainer.vae.encoder_3d, "vae.encode_3d")
        spans.hook(trainer.vae.decoder_3d, "vae.decode_3d")
    ctx.mark_setup()

    k0 = CHECKED_STEPS * trainer.accum
    win = core.timed_calls(lambda k: trainer.call(k0 + k), ctx.seconds, trainer.b)
    ctx.readings.update(window=win, flops_a_unit=flops.train_step(cfg, 1),
                        peak_flops=flops.PEAK_FLOPS["tf32" if cfg["tf32_convs"] else "float32"])
    if ctx.trace:
        traces = []
        k1 = k0 + win["dispatched"]

        def call(j):
            t_a = time.perf_counter()
            trainer.call(k1 + j)
            spans.spans.append(("train_step", 0, t_a, time.perf_counter()))

        with tr.profiled(traces) as block:
            sampler.queued_calls(call, wl["trace_calls"], block)
        sampler.record_trace(ctx, traces[0], spans, SPAN_ORDER)
    spans.remove()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
        ctx.device_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated()

    del trainer
    core.free(ctx.device)
    w, want = reference_cycles(cfg, wl, ctx.seed, ctx.device)
    got = gaps(w, cycles, want)
    checks = {k: (got[k], ctx.limits[k]) for k in ("loss_gap", "grad_gap", "update_gap")}
    return {"metrics": {"train_samples_per_s": (win["rate"], "samples/s")},
            "attempted": win["dispatched"] * cfg["train"]["batch_size"], "failed": 0,
            "checks": checks, "left_out_leaves": got["left_out"]}
