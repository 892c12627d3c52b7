"""Serve cells: the port's ``InferenceServer`` behind ``build_http_server``, under an open loop.

Set-up: the weights from the seed, the predictor, the server with the
cell's ladder, ``max_wait_ms`` and ``max_pending`` (geometry pinned, every
ladder size warmed by the server's own ``warmup``), and the load
generator (``entries/loadgen.py``, a process of its own) with every frame
encoded. The window: Poisson arrivals at the cell's fixed ``rate`` for
``--seconds``. ``request_p95_ms``: the nearest-rank 95th percentile of every
request due in the window, from its due time to its decoded reply; a
request that failed, was refused or got no reply counts as missing (its
latency is the whole wait, and ``correct`` is false). After it,
``keep`` requests drawn from the seed are recomputed alone by the plain
reference from their payload and their seed's noise, in float32 and under
bfloat16 autocast, and ``rel_l2_over_bf16`` over all of them, as the
sampler cells take it, is held to the cell's limit (the worst reply's
``rel_l2`` is printed beside it). With ``--trace 1`` the middle
``trace_seconds`` of the window run under the profiler.
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .. import core, port, traffic, weights
from .. import trace as tr
from ..reference import sampler as ref
from . import loadgen, sampler

ROOT = Path(__file__).resolve().parents[2]
KEYS = frozenset({"entry", "sampler", "steps", "ladder", "max_wait_ms", "max_pending", "rate",
                  "pool", "check_requests", "wait_s", "workers", "trace_seconds", "why"})


def start_server(cfg, wl, w, device, int8: bool = False):
    pred = port.predictor(cfg, w, device)
    if int8:
        pred = port.int8(pred)
    vol = cfg["volume"]
    srv = port.server(pred, wl, (vol["slices"], vol["height"], vol["width"]))
    srv.warmup()
    httpd = port.http_server(srv)
    th = threading.Thread(target=httpd.serve_forever, name="bench-http", daemon=True)
    th.start()
    return pred, srv, httpd, th


def stop_server(srv, httpd, th) -> None:
    httpd.shutdown()
    httpd.server_close()
    th.join()
    srv.close()


class LoadGen:
    """The load generator's process: started, readied, released, read."""

    def __init__(self, cfg, wl, seed, seconds, keep):
        job = {"cfg": cfg, "seed": seed, "rate": wl["rate"],
               "seconds": seconds, "wait_s": wl["wait_s"], "pool": wl["pool"],
               "workers": wl["workers"], "keep": [int(i) for i in keep]}
        env = dict(os.environ, OMP_NUM_THREADS="2")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "h100_bench.entries.loadgen", json.dumps(job)],
            cwd=str(ROOT), stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)

    def wait_ready(self) -> None:
        line = self.proc.stdout.readline()
        if line.strip() != b"READY":
            self.proc.kill()
            self.proc.wait()
            raise RuntimeError(f"load generator did not start: {line!r}")

    def go(self, port_: int) -> float:
        self.proc.stdin.write(f"{port_}\n".encode())
        self.proc.stdin.flush()
        return time.perf_counter()

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()

    def result(self) -> dict:
        head = self.proc.stdout.readline().split()
        if not head or head[0] != b"RESULT":
            self.proc.wait()
            raise RuntimeError(f"load generator failed (exit {self.proc.returncode})")
        blob = self.proc.stdout.read(int(head[1]))
        self.proc.wait()
        return pickle.loads(blob)


def kept_requests(wl, seed, seconds) -> list:
    n = len(loadgen.schedule(wl["rate"], seconds, seed))
    return sorted(traffic.permutation(n, seed, traffic.PICK, 7)[:wl["check_requests"]].tolist())


def reference_replies(cfg, wl, seed, idx: list, device, w=None) -> dict:
    """The plain reference of each kept request, computed alone: (float32,
    bfloat16 autocast), as ``sampler.reference_calls`` gives them."""
    w = weights.make(cfg, seed, device) if w is None else w
    img, v2d = loadgen.payload_pool(cfg, wl["pool"], seed)
    vol = cfg["volume"]
    shape = (vol["slices"], cfg["vae"]["latent_channels"], vol["height"] // 4, vol["width"] // 4)
    out = {}
    for i in idx:
        k = i % len(img)
        noise = ref.request_noise(loadgen.request_seed(seed, i), shape)
        out[i] = tuple(ref.predict(w, cfg, torch.from_numpy(img[k][None]).to(device),
                                   torch.from_numpy(v2d[k][None]).to(device), noise.to(device),
                                   wl["sampler"], wl["steps"], dtype=d)[0].cpu()
                       for d in (torch.float32, torch.bfloat16))
    return out


def window(trace: bool, cfg, wl, seed, seconds, srv, httpd, keep, ready=None, gen=None) -> tuple:
    """One open-loop window against a running server: (the load generator's
    result, stats before, stats at the window's close, stats after the last
    reply, traces). ``gen``: a load generator started earlier (else one is
    started here); ``ready()`` runs once it holds every payload, just
    before the window opens."""
    gen = gen or LoadGen(cfg, wl, seed, seconds, keep)
    try:
        gen.wait_ready()
        if ready is not None:
            ready()
        before = srv.stats()
        traces = []
        t0 = gen.go(httpd.server_address[1])
        if trace:
            lead = max(0.0, 0.5 * (seconds - wl["trace_seconds"]))
            time.sleep(max(0.0, t0 + lead - time.perf_counter()))
            with tr.profiled(traces, idle_device=False):
                time.sleep(wl["trace_seconds"])
        time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
        at_close = srv.stats()
        res = gen.result()
    finally:
        gen.stop()
    return res, before, at_close, srv.stats(), traces


def readings(replies: dict, want: dict) -> dict:
    """The compared number (``rel_l2_over_bf16`` over every kept reply, as the
    sampler cells take it) and the worst reply's ``rel_l2``."""
    idx = sorted(want)
    if not idx:
        return {"rel_l2_over_bf16": float("inf"), "worst_reply": float("inf"), "compared": 0}
    got = torch.stack([torch.as_tensor(np.asarray(replies[i])) for i in idx])
    ref32, ref16 = (torch.stack([want[i][j] for i in idx]) for j in (0, 1))
    r = sampler.readings(got, (ref32, ref16))
    r["worst_reply"] = r.pop("worst_volume")
    return {**r, "compared": len(idx)}


def judge(res: dict, seconds: float, wait_s: float) -> dict:
    lat = [x if x is not None else seconds + wait_s for x in res["latency"]]
    failed = sum(x is None for x in res["latency"])
    return {"p95_ms": 1e3 * core.percentile(lat, 0.95), "attempted": len(lat), "failed": failed,
            "late_s": max((x for x in res["lag"] if x is not None), default=0.0)}


def calibration(cfg, wl, seeds, control_seeds, fault_seeds, seconds, device) -> list:
    """The compared numbers of the program and of the control (the port's own
    int8 path, both flags, behind its own server) over a ``seconds`` window
    of each seed, one dict a reading."""
    out = []
    for side, group in (("program", seeds), ("control", control_seeds)):
        if not group:
            continue
        w = weights.make(cfg, group[0], device)
        pred, srv, httpd, th = start_server(cfg, wl, w, device, int8=side == "control")
        try:
            for seed in group:
                w = weights.make(cfg, seed, device)
                port.load(pred, w)
                keep = kept_requests(wl, seed, seconds)
                res, _, _, _, _ = window(False, cfg, wl, seed, seconds, srv, httpd, keep)
                want = reference_replies(cfg, wl, seed, sorted(res["replies"]), device, w=w)
                j = judge(res, seconds, wl["wait_s"])
                out.append({"seed": seed, "side": side, **readings(res["replies"], want),
                            "failed": j["failed"], "p95_ms": j["p95_ms"]})
                print(json.dumps(out[-1]), flush=True)
                del w
                core.free(device)
        finally:
            stop_server(srv, httpd, th)
        del pred, srv
        core.free(device)
    return out


def run(ctx: core.Ctx) -> dict:
    cfg, wl = ctx.cfg, ctx.wl
    keep = kept_requests(wl, ctx.seed, ctx.seconds)
    gen = LoadGen(cfg, wl, ctx.seed, ctx.seconds, keep)   # builds its payloads meanwhile
    try:
        w = weights.make(cfg, ctx.seed, ctx.device)
        pred, srv, httpd, th = start_server(cfg, wl, w, ctx.device)
    except BaseException:
        gen.stop()
        raise
    del w
    spans = tr.Spans()
    if ctx.trace:
        for name, m in port.unet_modules(pred).items():
            spans.hook(m, name)
    try:
        res, before, _, after, traces = window(ctx.trace, cfg, wl, ctx.seed, ctx.seconds, srv,
                                               httpd, keep, ready=ctx.mark_setup, gen=gen)
    finally:
        stop_server(srv, httpd, th)
    spans.remove()
    j = judge(res, ctx.seconds, wl["wait_s"])
    ctx.readings.update(stats_before=before, stats_after=after)
    if traces:
        sampler.record_trace(ctx, traces[0], spans, ("unet", "vae.encode_2d", "vae.decode_3d"))
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
        ctx.device_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    del pred, srv, httpd, th
    core.free(ctx.device)

    replies = res["replies"]
    want = reference_replies(cfg, wl, ctx.seed, [i for i in keep if i in replies], ctx.device)
    got = readings(replies, want)
    checks = {"rel_l2_over_bf16": (got["rel_l2_over_bf16"], ctx.limits["rel_l2_over_bf16"]),
              "failed": (j["failed"], 0)}
    return {"metrics": {"request_p95_ms": (j["p95_ms"], "ms")},
            "attempted": j["attempted"], "failed": j["failed"], "checks": checks,
            "send_lag_max_s": j["late_s"], "rel_l2": got["rel_l2"],
            "ref_bf16_rel_l2": got["ref_bf16_rel_l2"], "worst_reply_rel_l2": got["worst_reply"],
            "compared": got["compared"]}
