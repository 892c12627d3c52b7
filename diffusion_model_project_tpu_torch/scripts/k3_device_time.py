"""Device time of K3 at each compiled tile, and of cuDNN, at the conv probe's stages.

    python3 diffusion_model_project_tpu_torch/scripts/k3_device_time.py [--root DIR] [A B C]

Each time is ``chip_smoke.py``'s ``device_ms`` from this checkout: the
kernels of K3_ITERS calls in one torch.profiler trace that holds every one
of them, after K3_WARM calls, summed over the calls. ``--root`` takes the
port's package from another checkout (an older commit unpacked with
``git archive``, say), so two versions of K3 are read by one rule on the
same card; by default it is this checkout. The inputs are the probe's
stages, made on the card from a fixed seed; cuDNN (``F.conv2d``,
channels-last) is timed before and after K3's tiles. Needs a CUDA card.
Prints one line a stage and one JSON line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stages", nargs="*", default=["A", "B", "C"])
    ap.add_argument("--root", default=str(HERE), help="checkout whose K3 is timed")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    from diffusion_model_project_tpu_torch.ops.cuda import _lib
    from diffusion_model_project_tpu_torch.ops.cuda import conv3x3 as k3
    from diffusion_model_project_tpu_torch.scripts import perf_probe_conv as probe

    if not torch.cuda.is_available():
        raise SystemExit("k3_device_time: needs a CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _lib.build()
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {"root": str(root), "card": torch.cuda.get_device_name(0), "stages": {}}
    for stage in args.stages:
        shape = probe.STAGES[stage]
        n, h, w, cin, cout = shape
        x = torch.randn((n, h, w, cin), generator=gen, device="cuda").to(torch.bfloat16)
        wgt = (0.05 * torch.randn((3, 3, cin, cout), generator=gen, device="cuda")).to(
            torch.bfloat16)
        x_cl = x.permute(0, 3, 1, 2)
        w_cl = wgt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        cudnn = lambda: F.conv2d(x_cl, w_cl, padding=1)  # noqa: E731
        timed = dict(iters=smoke.K3_ITERS, warmup=smoke.K3_WARM)
        res = {"cudnn_before": smoke.library_device_ms(cudnn, **timed)}
        for th, tw in k3.TILES:
            res[f"{th}x{tw}"] = smoke.device_ms(
                lambda: k3.conv3x3(x, wgt, (th, tw)), keep=lambda name: "conv3x3" in name,
                counter=lambda: k3.LAUNCHES, **timed)
        res["cudnn_after"] = smoke.library_device_ms(cudnn, **timed)
        res["clocks_after"] = smoke.clocks()
        out["stages"][stage] = res
        print(f"stage {stage} {shape}: device ms " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in res.items()),
            flush=True)
    out["profiler"] = dict(smoke.PROFILER)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
