"""Tiny configurations and contexts of the benchmark's cells, for CPU tests."""
from __future__ import annotations

import time

import torch

from h100_bench import core

SEED = 2 ** 31 + 4321   # past 32 signed bits, as the driver's seeds are


def ldm() -> dict:
    cfg = core.load_json("configs", "ldm-published.json")
    cfg["unet"].update(features=[8, 16], attention="2..2")
    cfg["vae"].update(features=[32, 32, 32])
    cfg["volume"] = {"slices": 3, "height": 32, "width": 32}
    cfg["microstructure"]["fibre_radius_px"] = [1.5, 3.0]
    cfg["compute_dtype"] = "float32"
    return cfg


def vae() -> dict:
    cfg = core.load_json("configs", "vae-published.json")
    cfg["vae"].update(features=[32, 32, 32])
    cfg["volume"] = {"slices": 3, "height": 32, "width": 32}
    cfg["microstructure"]["fibre_radius_px"] = [1.5, 3.0]
    cfg["train"]["grad_accum"] = 3
    return cfg


def workload(traffic: str) -> dict:
    wl = core.load_json("workloads", traffic + ".json")
    if wl["entry"] == "sampler":
        wl.update(steps=3, batch=2, pool=4, warmup_calls=1)
    elif wl["entry"] == "serve":
        wl.update(steps=3, pool=4, rate=6.0, check_requests=2, wait_s=30.0, workers=8)
    else:
        wl.update(pool=12)
    return wl


def ctx(cell: str, seconds: float = 1.5, seed: int = SEED) -> core.Ctx:
    """A CPU context of ``cell`` at the tiny sizes, with the cell's own limits."""
    import json

    with open(core.HERE.parent / "BENCHMARK.json") as f:
        entry = next(w for w in json.load(f)["workloads"] if w["name"] == cell)
    cfg = ldm() if entry["config"] == "ldm-published" else vae()
    return core.Ctx(cell=cell, cfg=cfg, wl=workload(entry["traffic"]), seed=seed,
                    seconds=seconds, trace=False, device=torch.device("cpu"),
                    t_start=time.perf_counter(), limits=core.load_json("limits", cell + ".json"))
