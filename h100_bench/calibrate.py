"""Readings that a cell's limits are set from: the program's, the control's and planted faults'.

    python -m h100_bench.calibrate --workload <cell> --seeds S [S ...]
        [--control-seeds S ...] [--fault-seeds S ...] [--seconds 8] [--out FILE]

For each seed the compared numbers of the program (the run's own check,
without the timed window) and, on the control and fault seeds, of the
control and the planted faults that the cell's entry reads
(``entries/<entry>.py``'s ``calibration``, found by name as ``run`` finds
the entry's ``run``). One JSON line a reading; the whole as JSON to
``--out``. Needs a CUDA device unless ``device`` is given to ``readings``
directly (the tests do).
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from . import core
from .run import benchmark, cell_entry


def readings(cfg, wl, seeds, control_seeds=(), fault_seeds=(), seconds=8.0,
             device="cuda") -> list:
    entry = importlib.import_module(f"h100_bench.entries.{wl['entry']}")
    core.check_keys(wl, entry.KEYS)
    return entry.calibration(cfg, wl, list(seeds), list(control_seeds), list(fault_seeds),
                             seconds, torch.device(device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = cell_entry(benchmark(), args.workload)
    cfg = core.load_json("configs", cell["config"] + ".json")
    wl = core.load_json("workloads", cell["traffic"] + ".json")
    t0 = time.perf_counter()
    rows = readings(cfg, wl, args.seeds, args.control_seeds, args.fault_seeds, args.seconds)
    doc = {"workload": args.workload, "card": torch.cuda.get_device_name(0), "rows": rows,
           "seconds": time.perf_counter() - t0}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
