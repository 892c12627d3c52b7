"""The knee of a serve cell: open-loop windows at a list of fixed rates, one server.

    python -m h100_bench.sweep --workload <serve cell> --seed S --seconds 20 --rates 6 8 10

For each rate: requests due in the window, those answered by its close,
the backlog at the close (requests in the server's queue, not yet in a
batch), p50 and p95 from due time to reply, requests a device batch. The
knee is the highest rate whose backlog at the close is at most one batch
(the ladder's top) with no request failed; the cell's file takes about
four fifths of it as a number.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import core, weights
from .entries import serve
from .run import benchmark, cell_entry


def sweep(cfg: dict, wl: dict, seed: int, seconds: float, rates, device) -> list:
    """One row a rate, all against one server."""
    w = weights.make(cfg, seed, device)
    pred, srv, httpd, th = serve.start_server(cfg, wl, w, device)
    rows = []
    try:
        for rate in rates:
            wl = dict(wl, rate=rate)
            res, a, close, b, _ = serve.window(False, cfg, wl, seed, seconds, srv, httpd, [])
            due, lat = res["due"], res["latency"]
            answered = [bool(d + x <= seconds) for d, x in zip(due, lat) if x is not None]
            ok = [float(x) for x in lat if x is not None]
            row = {"rate": rate, "due": len(due), "answered_by_close": sum(answered),
                   "backlog_at_close": int(close["queue_depth"]), "failed": len(due) - len(ok),
                   "p50_ms": 1e3 * core.percentile(ok, 0.5) if ok else None,
                   "p95_ms": 1e3 * core.percentile(ok, 0.95) if ok else None,
                   "requests_per_batch": (b["requests"] - a["requests"])
                   / max(1, b["batches"] - a["batches"]),
                   "max_send_lag_s": max((float(x) for x in res["lag"] if x is not None),
                                         default=None)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        serve.stop_server(srv, httpd, th)
    return rows


def knee(rows: list, top: int):
    fit = [r["rate"] for r in rows if r["backlog_at_close"] <= top and not r["failed"]]
    return max(fit) if fit else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 2
    cell = cell_entry(benchmark(), args.workload)
    cfg = core.load_json("configs", cell["config"] + ".json")
    wl = core.load_json("workloads", cell["traffic"] + ".json")
    rows = sweep(cfg, wl, args.seed, args.seconds, args.rates, torch.device("cuda"))
    print(json.dumps({"knee": knee(rows, max(wl["ladder"])),
                      "card": torch.cuda.get_device_name(0), "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
