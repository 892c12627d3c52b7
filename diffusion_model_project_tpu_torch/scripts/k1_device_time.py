"""K1's plan and device time at the published DDIM-50 request's 19 GroupNorm pairs.

    python3 diffusion_model_project_tpu_torch/scripts/k1_device_time.py --plan
    python3 diffusion_model_project_tpu_torch/scripts/k1_device_time.py [--root DIR] [--batch B]

``--plan`` needs no card: it prints, for each (shape, act) pair of one
``predict_ddim(50)`` at batch B (default 2: the UNet at N = 11 B, the VAE
at N = B), the calls a request, bytes (x read once, y written once, the
affine in float32), the bound at 3.35 TB/s and the plan of
``ops/cuda/groupnorm_act.py::plan`` (path, cluster size, blocks, bytes a
block holds) at ``max_cluster`` 16 and 8.

Without ``--plan`` it reads on the card, for each pair in bf16: K1's device
time (``chip_smoke.py``'s ``device_ms``: the kernels of 10 calls from a
torch.profiler trace that holds every one of them, summed over the calls),
its back-to-back time (CUDA events around 20 calls) and the device time of
the library call (``chip_smoke.py``'s ``k1_library_call``), and sums each
over a request.
``--root`` takes the port's package from another checkout (an older commit
unpacked with ``git archive``), so two versions of K1 are read by one rule
on the same card. Prints one line a pair and one JSON line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
HBM_BYTES_PER_S = 3.35e12
STEPS = 50

# (shape at batch 1, groups, act, calls a request): the UNet's 38 GroupNorms
# a forward (N = 11 slices a volume) times 50 steps, then the VAE's 26
# (E2D encoder and D3D decoder, N = 1 volume, 256^2 x 11)
_UNET = [((11, 64, 64, 64), 5), ((11, 64, 32, 32), 1), ((11, 128, 32, 32), 5),
         ((11, 128, 16, 16), 1), ((11, 256, 16, 16), 5), ((11, 256, 8, 8), 1),
         ((11, 512, 8, 8), 5), ((11, 512, 4, 4), 1), ((11, 1024, 4, 4), 5),
         ((11, 1024, 2, 2), 1), ((11, 2048, 2, 2), 2)]
_PRE_NORM = [(11, 256, 16, 16), (11, 512, 8, 8), (11, 1024, 4, 4)]  # attention, no act, 2 each
_VAE = [((1, 128, 11, 256, 256), 9), ((1, 128, 11, 128, 128), 1), ((1, 256, 11, 128, 128), 7),
        ((1, 256, 11, 64, 64), 1), ((1, 512, 11, 64, 64), 8)]
PAIRS = ([(s, 1, "silu", c * STEPS) for s, c in _UNET]
         + [(s, 1, "", 2 * STEPS) for s in _PRE_NORM]
         + [(s, 32, "silu", c) for s, c in _VAE])


def pairs(batch: int = 2) -> list:
    """The 19 (shape, groups, act, calls a request) of one request at ``batch``."""
    return [((s[0] * batch, *s[1:]), g, a, c) for s, g, a, c in PAIRS]


def nbytes(shape, elem_bytes: int = 2) -> int:
    """x read once and y written once, the float32 affine read once."""
    return 2 * math.prod(shape) * elem_bytes + 2 * shape[1] * 4


def plan_rows(batch: int = 2, max_cluster: int = 16) -> list:
    from diffusion_model_project_tpu_torch.ops.cuda import groupnorm_act as k1

    rows = []
    for shape, groups, act, calls in pairs(batch):
        p = k1.plan(shape[0], shape[1], math.prod(shape[2:]), groups, 2, True, max_cluster)
        b = nbytes(shape)
        rows.append(dict(shape=shape, groups=groups, act=act, calls=calls, bytes=b,
                         bound_us=b / HBM_BYTES_PER_S * 1e6, path=p.path, k=p.k,
                         blocks=p.grid[0] * p.grid[1], slice_bytes=p.slice * 2,
                         group_bytes=p.group_len * 2, kernels=p.kernels))
    return rows


def print_plan(batch: int) -> None:
    for mc in (16, 8):
        rows = plan_rows(batch, mc)
        print(f"max_cluster {mc}, batch {batch}:")
        for r in rows:
            print(f"  {str(r['shape']):24s} G={r['groups']:<2d} {r['act'] or 'none':4s} "
                  f"x{r['calls']:<4d} group {r['group_bytes'] / 1024:8.1f} KB | "
                  f"{r['bytes'] / 1e6:8.3f} MB, bound {r['bound_us']:7.2f} us | {r['path']:7s} "
                  f"k={r['k']:<2d} blocks {r['blocks']:5d} of {r['slice_bytes'] / 1024:6.1f} KB")
        unet = sum(r["bound_us"] * r["calls"] for r in rows if r["groups"] == 1) / 1e3
        vae = sum(r["bound_us"] * r["calls"] for r in rows if r["groups"] == 32) / 1e3
        print(f"  bound a request: UNet {unet:.3f} ms, VAE {vae:.3f} ms, total {unet + vae:.3f}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plan", action="store_true", help="print the plan table (no card)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--root", default=str(HERE), help="checkout whose K1 is timed")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    if args.plan:
        print_plan(args.batch)
        return {}
    import torch

    from diffusion_model_project_tpu_torch.ops.cuda import _lib
    from diffusion_model_project_tpu_torch.ops.cuda import groupnorm_act as k1

    if not torch.cuda.is_available():
        raise SystemExit("k1_device_time: needs a CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _lib.build()
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {"root": str(root), "card": torch.cuda.get_device_name(0), "pairs": []}
    total = {"device_ms": 0.0, "ms": 0.0, "library_device_ms": 0.0, "bound_ms": 0.0}
    for shape, groups, act, calls in pairs(args.batch):
        c = shape[1]
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        w = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        b = 0.1 * torch.randn(c, generator=gen, device="cuda")
        kernels = k1.launch_plan(x, groups, act).kernels if hasattr(k1, "launch_plan") else 2
        call = lambda: k1.groupnorm_act(x, w, b, groups, act)  # noqa: E731
        res = dict(shape=shape, groups=groups, act=act, calls=calls, kernels=kernels,
                   bound_ms=nbytes(shape) / HBM_BYTES_PER_S * 1e3,
                   device_ms=smoke.device_ms(call, counter=lambda: k1.LAUNCHES,
                                             per_launch=kernels),
                   ms=smoke.sync_ms(call),
                   library_device_ms=smoke.library_device_ms(
                       smoke.k1_library_call(x, w, b, groups, act)))
        out["pairs"].append(res)
        for key in total:
            total[key] = None if total[key] is None or res[key] is None \
                else total[key] + res[key] * calls
        print(f"{str(shape):24s} G={groups:<2d} {act or 'none':4s} x{calls:<4d} kernels "
              f"{kernels} | device {res['device_ms'] * 1e3:8.2f} us, back to back "
              f"{res['ms'] * 1e3:8.2f} us, library device "
              f"{res['library_device_ms'] and res['library_device_ms'] * 1e3} us, bound "
              f"{res['bound_ms'] * 1e3:7.2f} us", flush=True)
    out["request_ms"] = total
    out["profiler"] = dict(smoke.PROFILER)
    out["clocks_after"] = smoke.clocks()
    print(f"a request (ms): {total}", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
