"""Seconds a train step at the published width, and where its device time goes.

    python3 diffusion_model_project_tpu_torch/scripts/train_step_time.py [--root DIR] [--steps N]

Builds the predictor at ``PUBLISHED_UNET_KWARGS`` with the published VAE
(latent 8, widths 128/256/512) from random seeded weights, and Adam at lr
1e-4 (``training/train_diffusion.py::make_optimizer``). On a batch of 2
volumes of 256^2 x 11 it times, on the host clock with the device
synchronized before and after each step, ``--steps`` train steps after 2
warm-up steps (timed as well: the first step of a process pays for cuDNN's
and K1's first calls at each shape) in each variant: plain float32 (cuDNN's default TF32
convolutions), heavy float32 (the physics and velocity losses of
``chip_smoke.py``'s training phase (b)) and plain bfloat16, with the peak
memory and the K1 / K2 launches of one step; before them, the frozen E3D
encode of the batch twice, under ``torch.no_grad()``. Then one plain float32 step
runs under ``torch.profiler``, its device time summed by kind of kernel
(K1, convolutions and GEMMs, elementwise, reductions, layout copies,
optimizer, other).

``--root`` takes the port's package from another checkout (an older commit
unpacked with ``git archive``), so two versions are timed by one rule on
the same card. Prints one line a variant, the profile, and one JSON line.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
B, S, HW = 2, 11, 256
PHYSICS = dict(lambda_div=0.1, lambda_flow=0.1, lambda_smooth=0.01, lambda_laplacian=0.01)
SENTINELS = 16  # torch.profiler may leave a trace's first kernels out
KINDS = (("k1", ("gn_cluster", "gn_partial", "gn_apply")),
         ("k2", ("attention", "dm_gemm")),
         ("conv_gemm", ("xmma", "gemm", "conv", "dgrad", "wgrad", "fprop", "cutlass")),
         ("layout", ("nchwToNhwc", "nhwcToNchw")),
         ("optimizer", ("multi_tensor_apply", "Adam")),
         ("reduction", ("reduce_kernel",)),
         ("elementwise", ("elementwise_kernel",)))


def kind(name: str) -> str:
    for k, keys in KINDS:
        if any(s in name for s in keys):
            return k
    return "other"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose port is timed")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diffusion_model_project_tpu_torch.diffusion.predictor import LatentDiffusionPredictor
    from diffusion_model_project_tpu_torch.losses.physics import PhysicsLoss
    from diffusion_model_project_tpu_torch.ops.cuda import attention as k2
    from diffusion_model_project_tpu_torch.ops.cuda import groupnorm_act as k1
    from diffusion_model_project_tpu_torch.training.steps import make_diffusion_train_step
    from diffusion_model_project_tpu_torch.training.train_diffusion import make_optimizer
    from diffusion_model_project_tpu_torch.utils.config import (PUBLISHED_LATENT_CHANNELS,
                                                                PUBLISHED_UNET_KWARGS)

    if not torch.cuda.is_available():
        raise SystemExit("train_step_time: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    pred = LatentDiffusionPredictor.create(dict(PUBLISHED_UNET_KWARGS), seed=0,
                                           latent_channels=PUBLISHED_LATENT_CHANNELS)
    pred.model.requires_grad_(True)
    opt = make_optimizer(pred.model, 1e-4)
    g = torch.Generator().manual_seed(1)
    batch = {"img": (torch.rand((B, S, 1, HW, HW), generator=g) > 0.3).float().cuda(),
             "U_2d": (torch.randn((B, S, 3, HW, HW), generator=g) * 1e-2).cuda(),
             "U": (torch.randn((B, S, 3, HW, HW), generator=g) * 1e-2).cuda()}
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {"root": str(root), "card": smi, "steps": args.steps, "variants": {}}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, r

    with torch.no_grad():
        out["encode_s"] = [timed(lambda: pred.encode_target(batch["U"]))[0] for _ in range(2)]
    print("E3D encode, no grad, s: " + ", ".join(f"{x:.4f}" for x in out["encode_s"]), flush=True)

    variants = (("plain float32", torch.float32, {}),
                ("heavy float32", torch.float32,
                 dict(physics=PhysicsLoss(**PHYSICS), lambda_velocity=0.1)),
                ("plain bfloat16", torch.bfloat16, {}))
    for name, dtype, kw in variants:
        pred.compute_dtype = dtype
        step = make_diffusion_train_step(opt, **kw)
        warm = [timed(lambda: step(pred, batch, gen))[0] for _ in range(2)]
        torch.cuda.reset_peak_memory_stats()
        secs, launches = [], None
        for _ in range(args.steps):
            before = (k1.LAUNCHES, k2.LAUNCHES)
            sec, aux = timed(lambda: step(pred, batch, gen))
            secs.append(sec)
            launches = (k1.LAUNCHES - before[0], k2.LAUNCHES - before[1])
        if not all(torch.isfinite(v) for v in aux.values()):
            raise RuntimeError(f"{name}: a loss is not finite: {aux}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out["variants"][name] = {"warmup_s": warm, "seconds": secs,
                                 "mean_s": sum(secs) / len(secs),
                                 "peak_gib": peak, "k1_launches": launches[0],
                                 "k2_launches": launches[1]}
        print(f"{name}: warm-up s {warm[0]:.4f}, {warm[1]:.4f}; s a step "
              + ", ".join(f"{x:.4f}" for x in secs)
              + f" (mean {sum(secs) / len(secs):.4f}); peak {peak:.2f} GiB; launches a step "
              f"K1 {launches[0]}, K2 {launches[1]} | {smi}", flush=True)

    pred.compute_dtype = torch.float32
    step = make_diffusion_train_step(opt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(SENTINELS):
            torch.cuda._sleep(1000)
        t0 = time.perf_counter()
        step(pred, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        # "Optimizer.step#Adam.step" is an annotation that spans kernels, not one
        if (e.device_type == DeviceType.CUDA and "sleep" not in e.name
                and not e.name.startswith("Optimizer.")):
            k = by_kind[kind(e.name)]
            k[0] += (e.time_range.end - e.time_range.start) / 1e3
            k[1] += 1
    device_ms = sum(v[0] for v in by_kind.values())
    out["profile"] = {"wall_ms": wall_ms, "device_ms": device_ms,
                      "by_kind": {k: {"ms": ms, "launches": n} for k, (ms, n) in by_kind.items()}}
    print(f"one plain float32 step under torch.profiler: {wall_ms:.1f} ms wall, "
          f"{device_ms:.1f} ms on the device | {smi}")
    for k, (ms, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"  {k:12s} {ms:9.3f} ms {n:6d} launches")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
