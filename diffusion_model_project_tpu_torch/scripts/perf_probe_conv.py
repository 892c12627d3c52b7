"""Microbenchmark: candidate implementations of the VAE's hot 3x3 Conv2D
stages (the depth-decomposed Conv3D inner op) on one NVIDIA GPU.

Stages (per depth decomposition, 4 volumes x 11 slices => N = 44 images),
NHWC x HWIO -> NHWC, bf16:
  A: 256x256 x 128->128   (decoder res3 / encoder res1)
  B: 128x128 x 256->256   (decoder res2 / encoder res2)
  C:  64x64  x 512->512   (decoder res1 / encoder res3)

Candidates:
  cudnn_bf16 : F.conv2d on the NHWC tensor viewed as channels-last (the
               library yardstick; ``conv2d_bf16`` on the CPU)
  k3[THxTW]  : the hand-written K3 kernel (csrc/conv3x3.cu) at each compiled
               tile of TH x TW output pixels a block; on the CPU the
               wrapper's plain version, once
  k4_int8    : the JAX probe's int8 row (``xla_int8``) on the hand-written
               K4 kernel (csrc/int8_conv.cu): int8 x int8 -> int32 on random
               codes, rescaled to bf16; its max abs error is against K4's
               plain version (0 when they agree bit for bit), its share of
               the bound at the int8 rates

Each prints ms and TFLOP/s (TOPS for int8) and its max abs error against K3's
plain version (float32 from the same bf16 inputs); K3 and K4 also print their
share of their bound on an H100, and each stage the tile K3's planner takes.
On the card, times come from CUDA events around back-to-back calls; on the
CPU (``--device cpu``) from the host clock.

Usage:
  python -m diffusion_model_project_tpu_torch.scripts.perf_probe_conv [stage ...]
      [--device cpu] [--iters N] [--shape N H W CIN COUT]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda import conv3x3 as k3
from ..ops.cuda import int8_conv as k4
from ..utils.device import resolve_device

STAGES = {
    "A": (44, 256, 256, 128, 128),
    "B": (44, 128, 128, 256, 256),
    "C": (44, 64, 64, 512, 512),
}
# H100 SXM published peaks (NVIDIA data sheet, dense)
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12
INT8_SCALE = 1e-4  # the int8 row's rescale, as the JAX probe's
WARMUP = 3


def flops(n, h, w, cin, cout):
    return 2 * 9 * n * h * w * cin * cout


def bound(n, h, w, cin, cout) -> dict:
    """Least H100 time of one bf16 stage: operations at the bf16 tensor-core
    peak against x, y and W each moved once at the HBM rate."""
    nbytes = 2 * (n * h * w * (cin + cout) + 9 * cin * cout)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops(n, h, w, cin, cout) / BF16_FLOPS * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms}


def int8_bound(n, h, w, cin, cout) -> dict:
    """Least H100 time of one int8 stage: operations at the int8 tensor-core
    peak against the codes of x and W, the scales and the bf16 y each moved
    once at the HBM rate."""
    nbytes = n * h * w * (k4.padded_channels(cin) + 2 * cout) + 9 * cout * k4.padded_channels(
        cin) + 4 * cout
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops(n, h, w, cin, cout) / INT8_OPS * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms}


def time_ms(fn, device: torch.device, iters: int) -> float:
    """Mean time of one call over ``iters`` back-to-back calls, after warm-up."""
    for _ in range(WARMUP):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def probe_stage(name, shape, device, iters, rng) -> list:
    n, h, w, cin, cout = shape
    fl = flops(*shape)
    b = bound(*shape)
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin), dtype=np.float32)).to(
        device, torch.bfloat16)
    wgt = torch.from_numpy(rng.standard_normal((3, 3, cin, cout), dtype=np.float32) * 0.05).to(
        device, torch.bfloat16)
    ref = k3.conv3x3_plain(x.float(), wgt.float())
    try:
        planned = "x".join(map(str, k3.plan(*shape).tile))
    except ValueError as e:  # outside the bf16 kernel's range: on the card K3 raises too
        planned = f"none ({e})"
    print(f"\n=== stage {name}: ({n},{h},{w},{cin})->{cout}  {fl / 1e12:.3f} TFLOP  "
          f"bound {b['bound_ms']:.3f} ms ({b['bound_by']})  planned K3 tile {planned}",
          flush=True)

    # the library's own layout: x as an NCHW view with channels-last strides,
    # W converted once to OIHW channels-last (outside the clock)
    x_cl = x.permute(0, 3, 1, 2)
    w_cl = wgt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    lib_name = "cudnn_bf16" if device.type == "cuda" else "conv2d_bf16"
    candidates = [(lib_name, lambda: F.conv2d(x_cl, w_cl, padding=1).permute(0, 2, 3, 1))]
    # on the CPU every tile is the same plain version: run it once
    for tile in k3.TILES if device.type == "cuda" else k3.TILES[:1]:
        candidates.append((f"k3[{tile[0]}x{tile[1]}]",
                           lambda tile=tile: k3.conv3x3(x, wgt, tile)))

    results = []
    with torch.inference_mode():
        for cand, fn in candidates:
            err = (fn().float() - ref).abs().max().item()
            ms = time_ms(fn, device, iters)
            rec = {"stage": name, "shape": list(shape), "candidate": cand, "ms": ms,
                   "tflops": fl / ms / 1e9, "max_abs_err": err, "calls": 1 + WARMUP + iters,
                   **b}
            results.append(rec)
            line = (f"  {cand:12s}: {ms:9.3f} ms  {rec['tflops']:7.1f} TFLOP/s  "
                    f"max abs err {err:.3e}")
            if cand.startswith("k3") and device.type == "cuda":
                line += (f"  {100 * b['bound_ms'] / ms:.1f}% of the bound {b['bound_ms']:.3f} ms "
                         f"({b['bound_by']})")
            print(line, flush=True)
    results.append(probe_int8(name, shape, device, iters, rng))
    return results


def probe_int8(name, shape, device, iters, rng) -> dict:
    """The int8 row: K4 on random codes (x (N, 1, H, W, Cin), W (Cout, 1, 3, 3,
    Cin)), zero "same" padding, rescaled by ``INT8_SCALE`` to bf16."""
    n, h, w, cin, cout = shape
    cp = k4.padded_channels(cin)
    x_q = torch.from_numpy(rng.integers(-127, 128, (n, 1, h, w, cp), dtype=np.int8)).to(device)
    w_q = torch.from_numpy(rng.integers(-127, 128, (cout, 1, 3, 3, cp), dtype=np.int8)).to(device)
    x_q[..., cin:] = 0
    w_q[..., cin:] = 0
    sw = torch.full((cout,), INT8_SCALE, device=device)
    args = (x_q, w_q, sw, (1, 1, 1), (0, 0, 1, 1, 1, 1), torch.bfloat16)
    b = int8_bound(*shape)
    with torch.inference_mode():
        err = (k4.int8_conv(*args).float() - k4.int8_conv_plain(*args).float()).abs().max().item()
        ms = time_ms(lambda: k4.int8_conv(*args), device, iters)
    fl = flops(*shape)
    rec = {"stage": name, "shape": list(shape), "candidate": "k4_int8", "ms": ms,
           "tflops": fl / ms / 1e9, "max_abs_err": err, "calls": 1 + WARMUP + iters, **b}
    line = (f"  {'k4_int8':12s}: {ms:9.3f} ms  {rec['tflops']:7.1f} TOPS     "
            f"max abs err {err:.3e} (against its plain version)")
    if device.type == "cuda":
        line += (f"  {100 * b['bound_ms'] / ms:.1f}% of the int8 bound {b['bound_ms']:.3f} ms "
                 f"({b['bound_by']})")
    print(line, flush=True)
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stages", nargs="*", choices=sorted(STAGES),
                    help="stages to probe (default: all)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--iters", type=int, default=20, help="timed calls per candidate")
    ap.add_argument("--shape", type=int, nargs=5, metavar=("N", "H", "W", "CIN", "COUT"),
                    help="probe this one shape instead of the stages")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain reference in full float32
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    else:
        print(f"device: {device.type} (K3 runs its plain version; host-clock times)", flush=True)
    if args.shape:
        todo = {"shape": tuple(args.shape)}
    else:
        todo = {s: STAGES[s] for s in (args.stages or sorted(STAGES))}
    rng = np.random.default_rng(0)
    results = []
    for name, shape in todo.items():
        results += probe_stage(name, shape, device, args.iters, rng)
    return results


if __name__ == "__main__":
    main()
