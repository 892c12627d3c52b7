"""Serving-daemon throughput at the published scale (the port's copy of the
root ``scripts/perf_serve_daemon.py``).

Measures ``utils/serving.InferenceServer`` end to end THROUGH the HTTP front
end: concurrent clients (each its own thread and connection) POST distinct
single-volume npz requests with per-request seeds; the daemon coalesces
them into device batches. The number includes everything a deployment
pays: npz decode and encode, queueing, padding, batching, the sampler, the
result's copy to the host and the response.

The predictor is the published configuration (``PUBLISHED_UNET_KWARGS``,
VAE latent 8 at 128/256/512, 256^2 x 11, T=1000) with random seeded weights
(``final_conv`` and the attention blocks' ``proj_out`` nonzero). Reported:
steady volumes/s over HTTP after a warm-up request, and the daemon's
batching stats, as one JSON line, also written to ``--out``.

    python -m diffusion_model_project_tpu_torch.scripts.perf_serve_daemon [--device cuda]

Env: SERVE_BATCH (8), SERVE_STEPS (50), SERVE_CLIENTS (8), SERVE_REQUESTS
(32 total, after the warm-up), SERVE_SAMPLER (ddim), SERVE_DTYPE (bfloat16),
SERVE_OUT (output path; default chiprun_out/serve_daemon.json).
"""
from __future__ import annotations

import argparse
import io
import json
import math
import os
import threading
import time
import urllib.request

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
S, H, W = 11, 256, 256
NORM_OUTPUT = [2.1e-2, 1.6e-2, 7.9e-3]


def published_predictor(device, dtype=torch.bfloat16, seed: int = 0):
    """The published configuration with random seeded weights; the JAX init
    zeroes ``final_conv`` and ``proj_out`` (output identically 0, attention
    path dead), so both get random weights too."""
    from ..diffusion.predictor import LatentDiffusionPredictor
    from ..models.layers import uniform_
    from ..models.unet import SelfAttention2D
    from ..utils.config import PUBLISHED_LATENT_CHANNELS, PUBLISHED_UNET_KWARGS

    pred = LatentDiffusionPredictor.create(
        dict(PUBLISHED_UNET_KWARGS), seed=seed, device="cpu", compute_dtype=dtype,
        num_timesteps=1000, latent_channels=PUBLISHED_LATENT_CHANNELS)
    gen = torch.Generator().manual_seed(seed + 1)
    unet = pred.model
    uniform_(unet.final_conv.weight, 1.0 / math.sqrt(unet.final_conv.weight[0].numel()), gen)
    uniform_(unet.final_conv.bias, 0.05, gen)
    for m in unet.modules():
        if isinstance(m, SelfAttention2D):
            uniform_(m.proj_out.weight, 1.0 / math.sqrt(m.proj_out.weight.shape[1]), gen)
            uniform_(m.proj_out.bias, 0.05, gen)
    pred.set_normalizer({"input": [1.0], "output": NORM_OUTPUT})
    return pred.to(device)


def volume(i: int, base: int):
    """A request's (img, v2d), float32, from ``default_rng(base + i)``."""
    r = np.random.default_rng(base + i)
    img = (r.random((S, 1, H, W)) > 0.3).astype(np.float32)
    img[:, :, 0, 0] = 0.0
    v2d = (r.standard_normal((S, 3, H, W)) * 1e-2).astype(np.float32)
    return img, v2d


def _request_payload(i):
    img, v2d = volume(i, 1000)
    buf = io.BytesIO()
    np.savez(buf, img=img, v2d=v2d, seed=i)
    return buf.getvalue()


def write_json(path: str, doc) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.environ.get(
        "SERVE_OUT", os.path.join(REPO, "chiprun_out", "serve_daemon.json")))
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    batch = int(os.environ.get("SERVE_BATCH", "8"))
    steps = int(os.environ.get("SERVE_STEPS", "50"))
    clients = int(os.environ.get("SERVE_CLIENTS", "8"))
    requests = int(os.environ.get("SERVE_REQUESTS", "32"))
    sampler = os.environ.get("SERVE_SAMPLER", "ddim")
    dtype = getattr(torch, os.environ.get("SERVE_DTYPE", "bfloat16"))

    from ..utils.device import resolve_device
    from ..utils.serving import InferenceServer, build_http_server

    pred = published_predictor(resolve_device(args.device), dtype)
    server = InferenceServer(pred, sampler=sampler, num_steps=steps,
                             max_batch=batch, max_wait_ms=50.0)
    httpd = build_http_server(server, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    def post(body):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/predict", data=body)
        with urllib.request.urlopen(req, timeout=1800) as resp:
            out = np.load(io.BytesIO(resp.read()))["velocity"]
        assert out.shape == (S, 3, H, W), out.shape

    try:
        print("warm-up request ...", flush=True)
        t0 = time.time()
        post(_request_payload(10_000))
        print(f"warm-up done in {time.time() - t0:.1f}s", flush=True)

        # every payload is made OUTSIDE the timed window: the measurement
        # boundary is the server (npz decode -> queue -> batch -> sampler ->
        # npz encode -> response)
        payloads = [_request_payload(i) for i in range(requests)]
        errors = []
        idx_lock = threading.Lock()
        next_idx = iter(range(requests))

        def client():
            while True:
                with idx_lock:
                    i = next(next_idx, None)
                if i is None:
                    return
                try:
                    post(payloads[i])
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                    return

        threads = [threading.Thread(target=client) for _ in range(clients)]
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.time() - t0
        if errors:
            raise RuntimeError(f"{len(errors)} requests failed: {errors[0]!r}")
        stats = server.stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
    row = {
        "metric": "serve_daemon_volumes_per_sec_http",
        "value": requests / dt,
        "unit": "volumes/s",
        "clients": clients,
        "sampler": f"{sampler}-{steps}",
        "dtype": str(dtype).replace("torch.", ""),
        "max_batch": batch,
        "batches": stats["batches"] - 1,  # minus the warm-up
        "padded_slots": stats["padded_slots"],
        "queued_while_busy": stats["queued_while_busy"],
        "device": torch.cuda.get_device_name(pred.device) if pred.device.type == "cuda"
        else "cpu",
    }
    print(json.dumps(row), flush=True)
    write_json(args.out, row)
    return row


if __name__ == "__main__":
    main()
