"""Export a run dir's sampling pipeline as a ``torch.export`` archive (the
port's copy of the root ``scripts/export_sampler.py``).

The archive (``utils/export.py``) holds the whole pipeline (EDT ->
conditioning encode -> the sampler's steps -> decode -> denormalize -> mask)
and the weights. A serving host needs torch and this package, which
registers K1's and K2's ops (the kernels build on their first launch):

    from diffusion_model_project_tpu_torch.utils.export import load_sampler_file
    sample = load_sampler_file("sampler_b8.pt2")
    velocity = sample(img, velocity_2d, noise)   # tensors on the traced device

Usage:
    python -m diffusion_model_project_tpu_torch.scripts.export_sampler \\
        --model-dir <run dir> --out sampler.pt2 [--batch 8] [--steps 50] \\
        [--size 256] [--slices 11] [--sampler ddim|dpm] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import time

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model-dir", required=True,
                    help="training run directory (log.json + model .pt/.msgpack)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--slices", type=int, default=11)
    ap.add_argument("--platforms", default=None,
                    help="device type the program is for; a torch program runs on the "
                         "device it is traced on, so this may only name --device's type")
    ap.add_argument("--bake-weights", type=lambda s: s.lower() == "true", default=False,
                    help="true is refused: an archive always carries its weights as the "
                         "program's state")
    ap.add_argument("--sampler", default="ddim", choices=["ddim", "dpm"],
                    help="dpm = DPM-Solver++(2M), about DDIM-50 quality in about 10 steps")
    ap.add_argument("--compute-dtype", default="float32", choices=("float32", "bfloat16"),
                    help="dtype of the networks' conv and matmul compute")
    ap.add_argument("--device", default="cuda",
                    help="device the program is traced on and runs on (default cuda)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from ..diffusion.predictor import LatentDiffusionPredictor
    from ..utils.export import save_sampler

    pred = LatentDiffusionPredictor.from_directory(args.model_dir, device=args.device)
    pred.compute_dtype = getattr(torch, args.compute_dtype)
    platforms = None
    if args.platforms:
        platforms = tuple(p.strip() for p in args.platforms.split(",") if p.strip())
    t0 = time.perf_counter()
    save_sampler(args.out, pred, batch=args.batch, num_steps=args.steps,
                 image_hw=(args.size, args.size), num_slices=args.slices,
                 platforms=platforms, bake_weights=args.bake_weights, sampler=args.sampler)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes) in "
          f"{time.perf_counter() - t0:.1f} s: {args.sampler} batch={args.batch} "
          f"steps={args.steps} {args.size}^2x{args.slices}, {args.compute_dtype}, "
          f"{pred.device}")


if __name__ == "__main__":
    main()
