"""Throughput of the exported sampler (``utils/export.py``) against the
eager predictor, on one card (the port's counterpart of the root
``scripts/perf_serving.py``).

Exports the published-scale sampler (B, 256^2 x 11, DDIM-N, bf16 compute,
random seeded weights) with ``export_sampler`` on the device in every run,
loads the archive back from memory with ``load_sampler``, checks that the
loaded program's first call equals the eager ``predict_ddim`` on the same
inputs (within 1e-5 of max|eager|), then times both at the same batch and
steps, each over ITERS chained calls: each call's noise depends on the
previous output, so no call can be skipped or reordered. Prints the export
and load seconds, the archive's bytes (about 1.3 GB: the predictor's
float32 weights), each variant's volumes/s, and one JSON line (also written
to ``--out``).

    python -m diffusion_model_project_tpu_torch.scripts.perf_serving [--device cuda]

Env: BENCH_BATCH (8), BENCH_STEPS (50), BENCH_ITERS (5).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .perf_serve_daemon import REPO, H, S, W, published_predictor, write_json


def _chained(f, img, v2d, noise0, iters: int, device) -> float:
    """Seconds a call over ``iters`` calls, each call's noise shifted by the
    previous output's mean."""
    out = f(img, v2d, noise0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = f(img, v2d, noise0 + 1e-6 * out.mean())
    float(out.mean())
    return (time.perf_counter() - t0) / iters


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "perf_serving.json"))
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    batch = int(os.environ.get("BENCH_BATCH", "8"))
    steps = int(os.environ.get("BENCH_STEPS", "50"))
    iters = int(os.environ.get("BENCH_ITERS", "5"))

    from ..utils.device import resolve_device
    from ..utils.export import export_sampler, load_sampler

    device = resolve_device(args.device)
    pred = published_predictor(device)
    t0 = time.perf_counter()
    blob = export_sampler(pred, batch=batch, num_steps=steps, image_hw=(H, W), num_slices=S)
    export_s = time.perf_counter() - t0
    print(f"export: {export_s:.1f}s, {len(blob)} bytes", flush=True)
    t0 = time.perf_counter()
    f = load_sampler(blob)
    load_s = time.perf_counter() - t0

    gen = torch.Generator().manual_seed(0)
    img = (torch.rand((batch, S, 1, H, W), generator=gen) > 0.3).float()
    img[:, :, :, 0, 0] = 0.0
    v2d = torch.randn((batch, S, 3, H, W), generator=gen) * 1e-2
    noise0 = torch.randn((batch * S, pred.latent_channels, H // 4, W // 4), generator=gen)
    img, v2d, noise0 = img.to(device), v2d.to(device), noise0.to(device)

    eager = lambda i, v, n: pred.predict_ddim(i, v, num_steps=steps, noise=n)  # noqa: E731
    want = eager(img, v2d, noise0)
    err = float((f(img, v2d, noise0) - want).abs().max())
    scale = float(want.abs().max())
    print(f"exported vs eager: max|diff| {err:.3e} of max|eager| {scale:.3e}", flush=True)
    if not (scale > 0 and err <= 1e-5 * scale):
        raise SystemExit(f"the exported program disagrees with eager: {err} > 1e-5 * {scale}")
    times = {"exported": _chained(f, img, v2d, noise0, iters, device),
             "eager": _chained(eager, img, v2d, noise0, iters, device)}
    row = {"metric": "exported_sampler_volumes_per_sec",
           "config": f"DDIM-{steps} {H}^2x{S}, B={batch}, bf16",
           "exported_vps": batch / times["exported"], "eager_vps": batch / times["eager"],
           "exported_s": times["exported"], "eager_s": times["eager"],
           "export_s": export_s, "load_s": load_s, "archive_bytes": len(blob),
           "max_abs_err": err,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    print(json.dumps(row), flush=True)
    write_json(args.out, row)
    return row


if __name__ == "__main__":
    main()
