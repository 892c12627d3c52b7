"""Evaluation helpers of the reference Diffusion_model/src/helper.py (the
port's copy of two functions of the JAX package's ``training/helper.py``):
  - get_norm_params: statistics.json -> per-component (max_u, max_v, max_w)
    output scales, preferring U_per_component (helper.py:38-102)
  - select_input_output: batch dict -> ((img, U_2d), U) (helper.py:151-176)
"""
from __future__ import annotations

import json
from typing import Dict


def get_norm_params(file: str, option: str = "latent-diffusion") -> dict:
    with open(file) as f:
        stats = json.load(f)
    if option != "latent-diffusion":
        raise ValueError(f"Unknown option: {option}")

    if "U_per_component" in stats:
        pc = stats["U_per_component"]
        max_u = pc["max_u"]
        max_v = pc["max_v"]
        max_w = pc.get("max_w", max_u)
        return {"input": None, "output": (max_u, max_v, max_w)}

    if "U" in stats:
        max_velocity = stats["U"]["max"]
    elif "velocity" in stats:
        max_velocity = stats["velocity"]["max"]
    elif "U_2d" in stats and "U_3d" in stats:
        max_velocity = max(stats["U_2d"]["max"], stats["U_3d"]["max"])
    elif "U_2d" in stats:
        max_velocity = stats["U_2d"]["max"]
    elif "U_3d" in stats:
        max_velocity = stats["U_3d"]["max"]
    else:
        max_velocity = 1.0
    return {"input": None, "output": (max_velocity,) * 3}


def select_input_output(data: Dict, option: str = "latent-diffusion"):
    if option != "latent-diffusion":
        raise ValueError(f"Unknown option: {option}")
    return (data["microstructure"], data["velocity_input"]), data["velocity"]
