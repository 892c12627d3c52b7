"""The serve cells' load generator: a process of its own that sends MFR1 requests
to the daemon on an open-loop schedule.

    python -m h100_bench.entries.loadgen '<json job>'

The job names the configuration, the seed, the rate, the window and the
requests whose replies to keep. It builds the payload pool (volumes made
from the seed on the host, as ``traffic.sampler_pool`` makes them) and
encodes every payload, prints READY, and starts the schedule when the
server's port arrives as a line on its standard input. Request i is due at the sum of the first i
gaps (``traffic.arrival_gaps``) and is sent then whatever is outstanding;
its latency runs from that due time to its decoded reply. Every request due
in the window is sent; the generator waits for replies until
``wait_s`` past the window's close. The result (a pickled dict: each
request's due time, send lag, latency or error, and the kept replies) is
written to standard output after a RESULT line.
"""
from __future__ import annotations

import http.client
import json
import pickle
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def request_seed(seed: int, i: int) -> int:
    from .. import traffic

    return traffic.seed_int(seed, traffic.NOISE, 1_000_000 + i) % (2 ** 62)


def payload_pool(cfg: dict, n: int, seed: int):
    from .. import traffic

    img, v2d = traffic.sampler_pool(cfg, n, seed, "cpu")
    return img.numpy(), v2d.numpy()


def schedule(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of every request due in the window."""
    from .. import traffic

    n = int(rate * seconds * 2) + 64
    due = np.cumsum(traffic.arrival_gaps(n, rate, seed))
    due = due - due[0]
    return due[due < seconds]


def _post(port: int, body: bytes, timeout: float):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/predict", body=body,
                     headers={"Content-Type": "application/x-mfr1"})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, data
    finally:
        conn.close()


def main(argv=None) -> None:
    from .. import mfr1

    import torch

    torch.set_num_threads(2)  # few: the server's process keeps the cores
    job = json.loads((argv or sys.argv[1:])[0])
    cfg, seed = job["cfg"], job["seed"]
    img, v2d = payload_pool(cfg, job["pool"], seed)
    due = schedule(job["rate"], job["seconds"], seed)
    bodies = [mfr1.request_body(a, b) for a, b in zip(img, v2d)]
    shape = (img.shape[1], img.shape[3], img.shape[4])
    keep = set(job["keep"])
    out = {"due": due.tolist(), "lag": [None] * len(due), "latency": [None] * len(due),
           "error": [None] * len(due), "replies": {}}
    lock = threading.Lock()
    print("READY", flush=True)
    port = int(sys.stdin.readline())
    t0 = time.perf_counter()
    close = t0 + job["seconds"] + job["wait_s"]

    def send(i: int) -> None:
        sent = time.perf_counter()
        try:
            frame = mfr1.request_header(shape, request_seed(seed, i)) + bodies[i % len(bodies)]
            status, body = _post(port, frame, max(1.0, close - sent))
            if status != 200:
                raise RuntimeError(f"HTTP {status}: {body[:200]!r}")
            vel = mfr1.decode_response(body)
            t = time.perf_counter()
            with lock:
                out["latency"][i] = t - (t0 + due[i])
                out["lag"][i] = sent - (t0 + due[i])
                if i in keep:
                    out["replies"][i] = np.array(vel)
        except Exception as exc:  # noqa: BLE001 - every failure is the request's
            with lock:
                out["error"][i] = repr(exc)[:300]

    with ThreadPoolExecutor(max_workers=job["workers"]) as pool:
        futures = []
        for i, d in enumerate(due):
            delay = t0 + d - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            futures.append(pool.submit(send, i))
        for f in futures:
            f.result()
    blob = pickle.dumps(out)
    sys.stdout.write(f"RESULT {len(blob)}\n")
    sys.stdout.flush()
    sys.stdout.buffer.write(blob)
    sys.stdout.buffer.flush()


if __name__ == "__main__":
    main()
