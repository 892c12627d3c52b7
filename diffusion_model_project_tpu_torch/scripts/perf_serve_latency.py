"""Per-request serving latency through the HTTP daemon (the port's copy of
the root ``scripts/perf_serve_latency.py``).

Measures what a CLIENT sees — p50 / p90 / p99 per-request wall latency
through ``utils/serving.InferenceServer``'s HTTP front end — at each
concurrency, sampler and payload, at the published scale (256^2 x 11, bf16,
the ladder of ``SERVE_LAT_SIZES``). Each request carries fresh seeded
inputs, and every request pays npz (or MFR1) decode, queueing, padding and
batching, the sampler, the copy to the host, encode and transfer.

Every sampler is measured at every level ADJACENT IN TIME: all servers are
built and warmed up front and the loop runs (concurrency -> payload ->
sampler), so a drift of the machine lands on a pair rather than between two
far-apart windows. A host<->device copy probe re-runs at each concurrency
and is stamped into its rows. Payloads: 'f32' (float32 npz both ways),
'f16z' (float16 compressed npz request, float16 compressed response), 'raw'
(the MFR1 frame).

The JAX script's ``with_latent_sharding`` projection (a GSPMD mesh of TPU
chips) has no counterpart here.

    python -m diffusion_model_project_tpu_torch.scripts.perf_serve_latency [--device cuda]

Env: SERVE_LAT_OUT (output path; default chiprun_out/serve_latency.json),
SERVE_LAT_CONCURRENCY ("1,4,8,16"), SERVE_LAT_CONFIGS ("ddim:50,dpm:10"),
SERVE_LAT_BATCH (8), SERVE_LAT_PAYLOADS ("f32,f16z,raw"), SERVE_LAT_SIZES
("1,8"), SERVE_LAT_REQUESTS (per level; default max(2 x batch, 2 x
concurrency)).
"""
from __future__ import annotations

import argparse
import io
import json
import os
import threading
import time
import urllib.request

import numpy as np
import torch

from .perf_serve_daemon import REPO, H, S, W, published_predictor, volume, write_json


def _payload(i, mode="f32"):
    from ..utils.serving import encode_raw_request

    img, v2d = volume(i, 5000)
    if mode == "raw":
        return encode_raw_request(img, v2d, seed=i)
    buf = io.BytesIO()
    if mode == "f16z":
        np.savez_compressed(buf, img=img.astype(np.float16),
                            v2d=v2d.astype(np.float16), seed=i,
                            resp_dtype="float16", resp_compress=1)
    else:
        np.savez(buf, img=img, v2d=v2d, seed=i)
    return buf.getvalue()


def _run_level(port, payloads, concurrency):
    """Fire len(payloads) requests from ``concurrency`` client threads;
    return per-request latencies (s) in completion order, and the wall time."""
    from ..utils.serving import decode_raw_response

    latencies, errors = [], []
    lock = threading.Lock()
    it = iter(range(len(payloads)))

    def client():
        while True:
            with lock:
                i = next(it, None)
            if i is None:
                return
            t0 = time.perf_counter()
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/v1/predict", data=payloads[i])
                with urllib.request.urlopen(req, timeout=1800) as resp:
                    body = resp.read()
                if body[:4] == b"MFR1":
                    out = decode_raw_response(body)
                else:
                    out = np.load(io.BytesIO(body))["velocity"]
                assert out.shape == (S, 3, H, W)
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)
                return
            with lock:
                latencies.append(time.perf_counter() - t0)

    threads = [threading.Thread(target=client) for _ in range(concurrency)]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.time() - t0
    if errors:
        raise RuntimeError(f"{len(errors)} requests failed: {errors[0]!r}")
    return latencies, wall


def _transfer_bandwidth(device):
    """Host<->device copy rate of 100 MB from pageable memory, as the server
    copies a batch's inputs."""
    mb = 100
    arr = torch.from_numpy(np.random.default_rng(0).random(
        (mb * 1024 * 1024 // 4,), dtype=np.float32))
    arr[:1024].to(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    dev = arr.to(device)
    float(dev.sum())
    h2d = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev.cpu()
    d2h = time.perf_counter() - t0
    return {"h2d_MBps": mb / h2d, "d2h_MBps": mb / d2h}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.environ.get(
        "SERVE_LAT_OUT", os.path.join(REPO, "chiprun_out", "serve_latency.json")))
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    batch = int(os.environ.get("SERVE_LAT_BATCH", "8"))
    concurrency = [int(c) for c in
                   os.environ.get("SERVE_LAT_CONCURRENCY", "1,4,8,16").split(",")]
    configs = [(s.split(":")[0], int(s.split(":")[1])) for s in
               os.environ.get("SERVE_LAT_CONFIGS", "ddim:50,dpm:10").split(",")]
    payload_modes = os.environ.get("SERVE_LAT_PAYLOADS", "f32,f16z,raw").split(",")
    sizes = [int(x) for x in os.environ.get("SERVE_LAT_SIZES", f"1,{batch}").split(",")]
    n_fixed = os.environ.get("SERVE_LAT_REQUESTS")

    from ..utils.device import resolve_device
    from ..utils.serving import InferenceServer, build_http_server

    device = resolve_device(args.device)
    bw = _transfer_bandwidth(device)
    print("host<->device copy:", json.dumps(bw), flush=True)
    pred = published_predictor(device)  # one predictor, shared by the servers
    results, servers = [], []
    try:
        for sampler, steps in configs:
            server = InferenceServer(pred, sampler=sampler, num_steps=steps,
                                     max_wait_ms=20.0, batch_sizes=sizes,
                                     expected_shape=(S, H, W))
            httpd = build_http_server(server, host="127.0.0.1", port=0)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            servers.append((sampler, steps, server, httpd))
            t0 = time.time()
            server.warmup()
            print(f"[{sampler}-{steps}] warm-up of sizes {server.batch_sizes} "
                  f"{time.time() - t0:.1f}s", flush=True)

        for conc in concurrency:
            bw_row = _transfer_bandwidth(device)
            for mode in payload_modes:
                for sampler, steps, server, httpd in servers:
                    n_req = int(n_fixed) if n_fixed else max(2 * batch, 2 * conc)
                    payloads = [_payload(i + 1000 * conc, mode) for i in range(n_req)]
                    before = server.stats()
                    lats, wall = _run_level(httpd.server_address[1], payloads, conc)
                    after = server.stats()
                    lats_ms = np.asarray(sorted(lats)) * 1e3
                    entry = {
                        "sampler": f"{sampler}-{steps}",
                        "payload": mode,
                        "request_bytes": len(payloads[0]),
                        "batch_sizes": list(server.batch_sizes),
                        "concurrency": conc,
                        "requests": n_req,
                        "p50_ms": float(np.percentile(lats_ms, 50)),
                        "p90_ms": float(np.percentile(lats_ms, 90)),
                        "p99_ms": float(np.percentile(lats_ms, 99)),
                        "mean_ms": float(lats_ms.mean()),
                        "max_ms": float(lats_ms.max()),
                        "throughput_vps": n_req / wall,
                        "batches": after["batches"] - before["batches"],
                        "padded_slots": after["padded_slots"] - before["padded_slots"],
                        "h2d_MBps_at_group": bw_row["h2d_MBps"],
                        "d2h_MBps_at_group": bw_row["d2h_MBps"],
                    }
                    results.append(entry)
                    print(json.dumps(entry), flush=True)
    finally:
        for _, _, server, httpd in servers:
            httpd.shutdown()
            httpd.server_close()
            server.close()
    doc = {
        "generated_unix": time.time(),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "scale": {"batch_max": batch, "volume": [S, 3, H, W], "dtype": "bfloat16"},
        "transfer_bandwidth": bw,
        "results": results,
    }
    write_json(args.out, doc)
    print(f"wrote {args.out}")
    return doc


if __name__ == "__main__":
    main()
