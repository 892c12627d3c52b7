"""Device time of K2 a DDIM-50 request at the published UNet's attention shapes.

    python3 diffusion_model_project_tpu_torch/scripts/k2_device_time.py [--root DIR]

The published UNet (``PUBLISHED_UNET_KWARGS``, latent 64^2) calls K2 at
three shapes, twice a shape a UNet evaluation, so 100 calls a shape a
DDIM-50 request: bf16 at N = 22 (B=2, the slice ``chip_smoke.py`` drives)
and float32 at N = 11 (B=1, the inference CLI). Each shape's time is
``chip_smoke.py``'s ``device_ms`` rule from this checkout: K2's three
kernels of 10 calls in one torch.profiler trace that holds every one of
them, split into QKV GEMM, core and output GEMM. ``--root`` takes the port's
package from another checkout (an older commit unpacked with ``git
archive``, say), so two versions of K2 are read by one rule on the same
card. Inputs are made on the card from a fixed seed. Needs a CUDA card.
Prints one line a shape and one JSON line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
CALLS = 100  # K2 calls a shape a DDIM-50 request: 2 a UNet evaluation, 50 evaluations
SHAPES = {"bf16 B=2": ("bfloat16", [(22, 256, 256), (22, 64, 512), (22, 16, 1024)]),
          "float32 B=1": ("float32", [(11, 256, 256), (11, 64, 512), (11, 16, 1024)])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose K2 is timed")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    from diffusion_model_project_tpu_torch.ops.cuda import _lib
    from diffusion_model_project_tpu_torch.ops.cuda import attention as k2

    if not torch.cuda.is_available():
        raise SystemExit("k2_device_time: needs a CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _lib.build()
    gen = torch.Generator(device="cuda").manual_seed(12)
    out = {"root": str(root), "card": torch.cuda.get_device_name(0), "requests": {}}
    for label, (dtype, shapes) in SHAPES.items():
        dt = getattr(torch, dtype)
        request = {"device_ms": 0.0, "shapes": {}}
        for n, t, e in shapes:
            x = torch.randn((n, t, e), generator=gen, device="cuda").to(dt)
            w_qkv = (torch.randn((3 * e, e), generator=gen, device="cuda") / math.sqrt(e)).to(dt)
            w_out = (torch.randn((e, e), generator=gen, device="cuda") / math.sqrt(e)).to(dt)
            b_qkv = torch.zeros(3 * e, dtype=dt, device="cuda")
            b_out = torch.zeros(e, dtype=dt, device="cuda")
            iters = 10
            kernels = smoke.device_kernels(
                lambda: k2.fused_attention(x, w_qkv.t(), b_qkv, w_out.t(), b_out, 2), iters,
                keep=smoke.is_k2_kernel, counter=lambda: k2.LAUNCHES, per_launch=3)
            split = {k: v / iters for k, v in smoke.k2_split(kernels).items()}
            ms = sum(split.values())
            request["shapes"][str((n, t, e))] = {"device_ms": ms, **split}
            request["device_ms"] += CALLS * ms
            print(f"{label} {(n, t, e)}: device ms a call {ms:.5f} ("
                  + ", ".join(f"{k} {v:.5f}" for k, v in split.items()) + ")", flush=True)
        print(f"{label}: device ms a DDIM-50 request {request['device_ms']:.3f}", flush=True)
        out["requests"][label] = request
    out["clocks"] = smoke.clocks()
    out["profiler"] = dict(smoke.PROFILER)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
