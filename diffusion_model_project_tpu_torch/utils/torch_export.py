"""Run-dir converters: native msgpack checkpoints -> the reference's ``.pt``
files (the port's copy of ``export_diffusion_dir`` / ``export_vae_dir`` of
the JAX ``utils/torch_export.py``), on the port's layout transforms
(``utils/weights.py``) and msgpack reader (``utils/flax_msgpack.py``).

A run dir written by either package's trainers converts in place (or into
another dir) to files the reference's torch loaders, and the port's own
``.pt`` loaders, read with ``strict=True``. ``log.json`` / ``vae_log.json``
already follow the reference's contract, so no metadata is converted.
"""
from __future__ import annotations

import json
import os.path as osp
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..diffusion.scheduler import schedule_tables
from . import flax_msgpack
from .weights import StateDict, export_dual_vae, export_predictor_parts


def save_torch_state_dict(sd: StateDict, path: str) -> None:
    # a copy of each array: the msgpack reader's arrays are read-only views
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)


def export_vae_dir(run_dir: str, out_dir: Optional[str] = None) -> list:
    """Convert every native msgpack VAE checkpoint of a stage-1 / stage-2
    run dir to its reference ``.pt`` twin (vae.msgpack -> vae.pt,
    best_model.msgpack -> best_model.pt, model.msgpack -> model.pt)."""
    out_dir = out_dir or run_dir
    written = []
    for stem in ("vae", "best_model", "model"):
        src = osp.join(run_dir, f"{stem}.msgpack")
        if not osp.exists(src):
            continue
        dst = osp.join(out_dir, f"{stem}.pt")
        save_torch_state_dict(export_dual_vae(flax_msgpack.load(src)), dst)
        written.append(dst)
    if not written:
        raise FileNotFoundError(f"No native VAE checkpoints (*.msgpack) in {run_dir}")
    return written


def export_diffusion_dir(run_dir: str, out_dir: Optional[str] = None) -> list:
    """Convert a diffusion run dir's native checkpoints to reference ``.pt``
    files (model.msgpack -> model.pt etc., each a full predictor state dict).
    Works on the raw msgpack trees, with no model build or device: the
    scheduler tables are made from log.json's num_timesteps, as both
    packages make them."""
    with open(osp.join(run_dir, "log.json")) as f:
        pk = json.load(f)["params"]["training"]["predictor"]
    scheduler = SimpleNamespace(**schedule_tables(pk.get("num_timesteps", 1000)))

    out_dir = out_dir or run_dir
    written = []
    for stem in ("best_model", "model", "ema_model"):
        src = osp.join(run_dir, f"{stem}.msgpack")
        if not osp.exists(src):
            continue
        state = flax_msgpack.load(src)
        sd = export_predictor_parts(
            unet_params=state["unet_params"], vae_params=state["vae_params"],
            scheduler=scheduler, norm_input=state["norm_input"],
            norm_output=state["norm_output"],
            distance_transform=pk.get("distance_transform", True),
        )
        dst = osp.join(out_dir, f"{stem}.pt")
        save_torch_state_dict(sd, dst)
        written.append(dst)
    if not written:
        raise FileNotFoundError(f"No native diffusion checkpoints (*.msgpack) in {run_dir}")
    return written
