"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing a result line:
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile the hand-written kernels (csrc/*.cu, one nvcc per source)
     into libkernels.so;
  3. slice: the published predictor (UNet PUBLISHED_UNET_KWARGS, VAE latent
     8 at 128/256/512, 256^2 x 11 volumes, T=1000, bf16, seeded random
     weights with nonzero final_conv / proj_out) runs predict_ddim(50) on 2
     volumes: once to warm up (recording every GroupNorm and attention shape
     it meets), once with the kernels' launch counters set to 0 (each must
     equal the main path's GroupNorm / attention call count), then timed;
  4. kernels: each kernel against its plain PyTorch version on the card at
     every shape phase 3 met, bf16 inputs, the plain version in float32 from
     the same bf16 tensors; kernel, plain, library (one PyTorch call, used
     nowhere in the port) and bound times;
  5. card against CPU: the same port at published widths, 128^2 x 3, B=1,
     DDIM-5, float32 (TF32 off), from the same weights and noise;
  6. the kernel table as one JSON line, then the result line.
Details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): K2's products run on
# the bf16 tensor cores, K1's per-element work in float32 outside them
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
# tolerances, relative to the largest magnitude of the plain version's output:
# K1 rounds its float32 result to bf16 once (half an ulp is 2^-9); K2 rounds
# qkv, P, the attention output and the projection to bf16 along the way.
# Each limit is about twice the largest reading this script and
# tests/test_torch_cuda.py give on an H100
K1_TOL = 2.0 ** -7
K2_TOL = 1.3e-2
CARD_VS_CPU_TOL = 1e-3  # float32, sums in another order on each side

B, S, HW, STEPS = 2, 11, 256, 50
NORM_OUTPUT = [2.1e-2, 1.6e-2, 7.9e-3]


def log(msg: str) -> None:
    print(msg, flush=True)


def sync_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name} | count {torch.cuda.device_count()} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi)  # name and power limit, as nvidia-smi gives them
    return {"kind": name, "count": torch.cuda.device_count(), "nvidia_smi": smi}


def phase_build() -> dict:
    from diffusion_model_project_tpu_torch.ops.cuda import _lib

    t0 = time.perf_counter()
    so = _lib.build()
    _lib.lib()
    secs = time.perf_counter() - t0
    log(f"[build] {os.path.relpath(so, REPO)} in {secs:.1f} s "
        f"({'built' if _lib.build_seconds is not None else 'cached'})")
    usage = [ln.strip() for ln in _lib.build_log().splitlines()
             if "registers" in ln or "spill" in ln and " 0 bytes spill" not in ln]
    for ln in usage:
        log(f"[build] {ln}")
    return {"seconds": secs, "ptxas": usage}


def published_predictor(device, dtype, seed=0):
    from diffusion_model_project_tpu_torch.diffusion.predictor import LatentDiffusionPredictor
    from diffusion_model_project_tpu_torch.models.layers import uniform_
    from diffusion_model_project_tpu_torch.models.unet import SelfAttention2D
    from diffusion_model_project_tpu_torch.utils.config import (
        PUBLISHED_LATENT_CHANNELS, PUBLISHED_UNET_KWARGS)

    pred = LatentDiffusionPredictor.create(
        dict(PUBLISHED_UNET_KWARGS), seed=seed, device="cpu", compute_dtype=dtype,
        num_timesteps=1000, latent_channels=PUBLISHED_LATENT_CHANNELS)
    # the JAX init zeroes final_conv and proj_out (output identically 0,
    # attention path dead); give them random weights so both are exercised
    gen = torch.Generator().manual_seed(seed + 1)
    unet = pred.model
    uniform_(unet.final_conv.weight, 1.0 / math.sqrt(unet.final_conv.weight[0].numel()), gen)
    uniform_(unet.final_conv.bias, 0.05, gen)
    for m in unet.modules():
        if isinstance(m, SelfAttention2D):
            uniform_(m.proj_out.weight, 1.0 / math.sqrt(m.proj_out.weight.shape[1]), gen)
            uniform_(m.proj_out.bias, 0.05, gen)
    pred.set_normalizer({"input": [1.0], "output": NORM_OUTPUT})
    return pred.to(device)


def make_inputs(b, s, hw, seed):
    gen = torch.Generator().manual_seed(seed)
    img = (torch.rand((b, s, 1, hw, hw), generator=gen) > 0.3).float()
    vel = torch.randn((b, s, 3, hw, hw), generator=gen) * 1e-2
    vel[:, :, 2] = 0.0
    noise = torch.randn((b * s, 8, hw // 4, hw // 4), generator=gen)
    return img, vel, noise


def record_shapes(pred):
    """Forward pre-hooks that count each (GroupNorm | attention) input shape."""
    from diffusion_model_project_tpu_torch.models.layers import GroupNorm, MultiheadSelfAttention

    seen, handles = {}, []

    def hook(mod, args):
        x = args[0]
        if isinstance(mod, GroupNorm):
            key = ("groupnorm_act", tuple(x.shape), mod.num_groups, mod.act)
        else:
            key = ("fused_attention", tuple(x.shape), mod.num_heads)
        seen[key] = seen.get(key, 0) + 1

    for m in pred.modules():
        if isinstance(m, (GroupNorm, MultiheadSelfAttention)):
            handles.append(m.register_forward_pre_hook(hook))
    return seen, handles


def expected_calls(pred, steps):
    from diffusion_model_project_tpu_torch.models.layers import GroupNorm, MultiheadSelfAttention

    def count(module, cls):
        return sum(isinstance(m, cls) for m in module.modules())

    gn = (count(pred.model, GroupNorm) * steps + count(pred.vae.encoder_2d, GroupNorm)
          + count(pred.vae.decoder_3d, GroupNorm))
    return gn, count(pred.model, MultiheadSelfAttention) * steps


def phase_slice() -> dict:
    from diffusion_model_project_tpu_torch.ops.cuda import attention as k2
    from diffusion_model_project_tpu_torch.ops.cuda import groupnorm_act as k1

    dev = torch.device("cuda")
    pred = published_predictor(dev, torch.bfloat16)
    img, vel, noise = make_inputs(B, S, HW, seed=1)
    img, vel, noise = img.to(dev), vel.to(dev), noise.to(dev)

    seen, handles = record_shapes(pred)
    t0 = time.perf_counter()
    pred.predict_ddim(img, vel, num_steps=STEPS, noise=noise)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    for h in handles:
        h.remove()

    exp_gn, exp_attn = expected_calls(pred, STEPS)
    k1.LAUNCHES = k2.LAUNCHES = 0
    out = pred.predict_ddim(img, vel, num_steps=STEPS, noise=noise)
    torch.cuda.synchronize()
    launches = {"groupnorm_act": k1.LAUNCHES, "fused_attention": k2.LAUNCHES}
    log(f"[slice] launches in one predict_ddim({STEPS}) at B={B}: {launches} "
        f"(expected groupnorm_act {exp_gn}, fused_attention {exp_attn})")
    if launches != {"groupnorm_act": exp_gn, "fused_attention": exp_attn}:
        raise RuntimeError(f"main path did not go through the kernels as expected: {launches}")
    if tuple(out.shape) != (B, S, 3, HW, HW) or not torch.isfinite(out).all():
        raise RuntimeError(f"bad output: shape {tuple(out.shape)}, "
                           f"finite {bool(torch.isfinite(out).all())}")
    log(f"[slice] output {tuple(out.shape)} finite, max |v| {out.abs().max().item():.4e}")

    torch.cuda.reset_peak_memory_stats()
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        pred.predict_ddim(img, vel, num_steps=STEPS, noise=noise)
    torch.cuda.synchronize()
    per_req = (time.perf_counter() - t0) / reps
    peak = torch.cuda.max_memory_allocated()

    stages = {"conditioning": 0.0, "ddim_loop": 0.0, "decode_finish": 0.0}
    with torch.inference_mode():
        for _ in range(reps):
            t0 = time.perf_counter()
            img_d, x, z_cond, m_cond = pred._setup_sampling(img, vel, noise, None)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            x = pred._ddim_loop(x, z_cond, m_cond, STEPS)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            pred._decode_and_finish(x, img_d)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            stages["conditioning"] += (t1 - t0) * 1e3 / reps
            stages["ddim_loop"] += (t2 - t1) * 1e3 / reps
            stages["decode_finish"] += (t3 - t2) * 1e3 / reps

    with torch.inference_mode():
        _, x, z_cond, m_cond = pred._setup_sampling(img, vel, noise, None)
        t_batch = torch.full((x.shape[0],), 999, dtype=torch.int64, device=dev)
        from torch.profiler import ProfilerActivity, profile

        pred._unet_eps(x, z_cond, m_cond, t_batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pred._unet_eps(x, z_cond, m_cond, t_batch)
            torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=15)
    for ln in table.splitlines():
        log(f"[profile] {ln}")

    res = {"batch": B, "slices": S, "hw": HW, "steps": STEPS, "warmup_s": warm_s,
           "request_s": per_req, "volumes_per_s": B / per_req, "stage_ms": stages,
           "peak_bytes": peak, "launches": launches, "shapes": seen,
           "profile_unet_forward": table}
    log(f"[slice] warm-up {warm_s:.2f} s; request {per_req * 1e3:.1f} ms; "
        f"{B / per_req:.3f} volumes/s; stages (ms) "
        + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
        + f"; peak memory {peak / 2**30:.2f} GiB")
    return res


def _k1_case(shape, groups, act, gen):
    import torch.nn.functional as F

    from diffusion_model_project_tpu_torch.ops.cuda import groupnorm_act as k1

    c = shape[1]
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    w = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    b = 0.1 * torch.randn(c, generator=gen, device="cuda")
    got = k1.groupnorm_act(x, w, b, groups, act).float()
    ref = k1.groupnorm_act_plain(x.float(), w, b, groups, act)
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    post = {"silu": F.silu, "relu": F.relu, "": lambda v: v}[act]
    times = {
        "ms": sync_ms(lambda: k1.groupnorm_act(x, w, b, groups, act)),
        "plain_ms": sync_ms(lambda: k1.groupnorm_act_plain(x, w, b, groups, act)),
        "library_ms": sync_ms(lambda: post(F.group_norm(x, groups, w.to(x.dtype), b.to(x.dtype)))),
    }
    n = x.numel()
    nbytes = 2 * n * 2 + 2 * c * 4          # bf16 x read + y written, f32 affine
    flops = 8 * n                            # stats + normalize + affine + act, a few per element
    return err, err / scale, nbytes, flops, times


def _k2_case(shape, heads, gen):
    import torch.nn.functional as F

    from diffusion_model_project_tpu_torch.ops.attention import multihead_attention
    from diffusion_model_project_tpu_torch.ops.cuda import attention as k2

    n, t, e = shape
    hd = e // heads
    bf = torch.bfloat16
    x = torch.randn(shape, generator=gen, device="cuda").to(bf)
    w_qkv = (torch.randn((3 * e, e), generator=gen, device="cuda") / math.sqrt(e)).to(bf)
    b_qkv = (0.02 * torch.randn(3 * e, generator=gen, device="cuda")).to(bf)
    w_out = (torch.randn((e, e), generator=gen, device="cuda") / math.sqrt(e)).to(bf)
    b_out = (0.02 * torch.randn(e, generator=gen, device="cuda")).to(bf)
    args = (x, w_qkv.t(), b_qkv, w_out.t(), b_out)  # JAX layouts as views, as the module passes
    got = k2.fused_attention(*args, heads).float()
    ref = multihead_attention(*[a.float() for a in args], heads)
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()

    def library():
        qkv = F.linear(x, w_qkv, b_qkv).view(n, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
        return F.linear(o.transpose(1, 2).reshape(n, t, e), w_out, b_out)

    times = {
        "ms": sync_ms(lambda: k2.fused_attention(*args, heads)),
        "plain_ms": sync_ms(lambda: multihead_attention(*args, heads)),
        "library_ms": sync_ms(library),
    }
    nbytes = 2 * (2 * n * t * e + 4 * e * e + 4 * e)
    flops = 2 * n * t * e * 3 * e + 2 * 2 * n * t * t * e + 2 * n * t * e * e
    return err, err / scale, nbytes, flops, times


def phase_kernels(shapes: dict, launches: dict) -> list:
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for key, calls in sorted(shapes.items(), key=lambda kv: str(kv[0])):
        if key[0] == "groupnorm_act":
            _, shape, groups, act = key
            err, rel, nbytes, flops, times = _k1_case(shape, groups, act, gen)
            tol, label, peak = K1_TOL, f"G={groups} act={act or 'none'}", F32_FLOPS
        else:
            _, shape, heads = key
            err, rel, nbytes, flops, times = _k2_case(shape, heads, gen)
            tol, label, peak = K2_TOL, f"heads={heads} hd={shape[2] // heads}", BF16_FLOPS
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        row = dict(kernel=key[0], shape=list(shape), detail=label, calls_per_request=calls,
                   max_abs_err=err, rel_err=rel, tol=tol, bound_ms=bound_ms,
                   bound_by=bound_by, bytes=nbytes, flops=flops, bytes_ms=bytes_ms,
                   ops_ms=ops_ms, **times)
        rows.append(row)
        log(f"[kernels] {key[0]:15s} {str(tuple(shape)):26s} {label:20s} x{calls:<5d} "
            f"err {err:.3e} (rel {rel:.2e}, tol {tol:.2e}) | ms {times['ms']:.4f} "
            f"plain {times['plain_ms']:.4f} library {times['library_ms']:.4f} "
            f"bound {bound_ms:.4f} ({bound_by})")
        if not rel <= tol:
            raise RuntimeError(f"{key[0]} {shape}: error {rel:.3e} above tolerance {tol:.3e}")
    for name, n in launches.items():
        if not any(r["kernel"] == name for r in rows):
            raise RuntimeError(f"no shape of {name} was checked")
    return rows


def phase_card_vs_cpu() -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hw, s = 128, 3
    cpu = published_predictor(torch.device("cpu"), torch.float32, seed=3)
    gpu = copy.deepcopy(cpu).to("cuda")
    img, vel, noise = make_inputs(1, s, hw, seed=4)
    t0 = time.perf_counter()
    ref = cpu.predict_ddim(img, vel, num_steps=5, noise=noise)
    cpu_s = time.perf_counter() - t0
    got = gpu.predict_ddim(img.cuda(), vel.cuda(), num_steps=5, noise=noise.cuda()).cpu()
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    log(f"[card-vs-cpu] published widths, {s}x{hw}^2, B=1, DDIM-5, float32: "
        f"max|card-cpu|/max|cpu| = {rel:.3e} (tol {CARD_VS_CPU_TOL:.0e}); cpu {cpu_s:.1f} s")
    if not (torch.isfinite(got).all() and rel <= CARD_VS_CPU_TOL):
        raise RuntimeError(f"card and CPU disagree: {rel:.3e}")
    return {"rel_err": rel, "tol": CARD_VS_CPU_TOL, "cpu_s": cpu_s}


def summarize(rows: list, launches: dict) -> list:
    """One entry per kernel; times are per predict_ddim request (each shape's
    time times its calls per request, summed), errors the largest seen."""
    meta = {
        "groupnorm_act": ("diffusion_model_project_tpu_torch/csrc/groupnorm_act.cu",
                          "diffusion_model_project_tpu/ops/pallas/groupnorm_silu.py:47"),
        "fused_attention": ("diffusion_model_project_tpu_torch/csrc/attention.cu",
                            "diffusion_model_project_tpu/ops/pallas/attention.py:56"),
    }
    out = []
    for name, (source, replaces) in meta.items():
        rs = [r for r in rows if r["kernel"] == name]
        tot = lambda k: sum(r[k] * r["calls_per_request"] for r in rs)
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": launches[name], "max_abs_err": max(r["max_abs_err"] for r in rs),
                    "ms": tot("ms"), "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
                    "bound_by": "bytes" if tot("bytes_ms") >= tot("ops_ms") else "operations",
                    "library_ms": tot("library_ms")})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()
    device = phase_device()
    build = phase_build()
    sl = phase_slice()
    rows = phase_kernels(sl["shapes"], sl["launches"])
    cvc = phase_card_vs_cpu()
    kernels = summarize(rows, sl["launches"])
    total = time.perf_counter() - t_start

    detail = {"device": device, "build": build, "slice": {**sl, "shapes": [
        {"key": list(map(str, k)), "calls": v} for k, v in sl["shapes"].items()]},
        "kernel_rows": rows, "card_vs_cpu": cvc, "kernels": kernels, "seconds": total}
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1)
    log(f"[done] {total:.1f} s; card {device['nvidia_smi']}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                           "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
