"""Run one cell of the port's benchmark and print its result as the last line of stdout.

    python -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up in ``BENCHMARK.json`` at the checkout's root; its
configuration, traffic mix, limits and per-layer readers are the files
``h100_bench/configs/<config>.json``, ``workloads/<traffic>.json``,
``limits/<cell>.json`` and ``metrics/<metric>.py``, found by name. The
traffic file names the entry (``entries/<entry>.py``) that runs it. With
``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the device's busy and traced
seconds. Each number that decides ``correct`` is printed beside its limit,
last on stderr and last in the result. Needs as many CUDA devices as the
cell asks for; exits 2 without printing a result otherwise, and 3 if a JAX
module was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

from h100_bench import core  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "diffusion_model_project_tpu"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(name: str):
    path = core.HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("h100_bench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def finite(x: float) -> float:
    return x if math.isfinite(x) else 1e300


def make_ctx(args, bench: dict, device) -> core.Ctx:
    cell = cell_entry(bench, args.workload)
    return core.Ctx(cell=args.workload, cfg=core.load_json("configs", cell["config"] + ".json"),
                    wl=core.load_json("workloads", cell["traffic"] + ".json"), seed=args.seed,
                    seconds=args.seconds, trace=bool(args.trace), device=torch.device(device),
                    t_start=T_START, limits=core.load_json("limits", args.workload + ".json"))


def result(bench: dict, ctx: core.Ctx, out: dict) -> dict:
    checks = {k: {"value": finite(float(v)), "limit": float(lim)}
              for k, (v, lim) in out["checks"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if not ctx.trace:
        e2e = {**out["metrics"], "setup_s": (ctx.setup_s, "s")}
        for m in bench["end_to_end"]:
            if applies(m, ctx.cell):
                value, unit = e2e[m["name"]]
                metrics[m["name"]] = {"value": value, "unit": unit}
    else:
        for m in bench["per_layer"]:
            if applies(m, ctx.cell):
                value = reader(m["name"])(ctx.readings)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "count": 1}
    if ctx.device.type == "cuda":
        device["kind"] = torch.cuda.get_device_name(ctx.device)
    device.update(ctx.device_info)
    res = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
           "metrics": metrics, "device": device}
    if ctx.trace and ctx.breakdown:
        res["breakdown"] = {k: [[n, s] for n, s in v] for k, v in ctx.breakdown.items()}
    res["checks"] = checks
    return res


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi not read: {exc}"


def main(argv=None) -> int:
    args = parse_args(argv)
    bench = benchmark()
    cell = cell_entry(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"h100_bench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    print(f"[card] {card_line()}", file=sys.stderr, flush=True)
    ctx = make_ctx(args, bench, "cuda")
    res = execute(bench, ctx)
    if res is None:
        return 3
    print(json.dumps(res), flush=True)
    return 0


def execute(bench: dict, ctx: core.Ctx):
    """Run the cell's entry on ``ctx``; print the checks on stderr and return
    the result (None, with the reason on stderr, if a JAX module got loaded)."""
    entry = importlib.import_module(f"h100_bench.entries.{ctx.wl['entry']}")
    core.check_keys(ctx.wl, entry.KEYS)
    out = entry.run(ctx)
    bad = loaded_forbidden()
    if bad:
        print(f"h100_bench: forbidden modules loaded: {bad}", file=sys.stderr)
        return None
    res = result(bench, ctx, out)
    extra = {k: v for k, v in out.items() if k not in ("metrics", "checks", "attempted", "failed")}
    print(f"[run] setup_s {ctx.setup_s:.3f} {json.dumps(extra, default=float)}", file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return res


if __name__ == "__main__":
    sys.exit(main())
