"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, in the order 1, 2, 5, 3, 4, 18, 8, 9, 10, 12, 14, 16, 19, 20, 11, 13, 15, 17,
6, 7 (the conv probe's device times are read before phase 3 profiles a UNet
forward; see device_kernels); any failure raises and the script exits
non-zero without printing a result line:
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile the hand-written kernels (csrc/*.cu, one nvcc per source)
     into libkernels.so;
  3. slice: the published predictor (UNet PUBLISHED_UNET_KWARGS, VAE latent
     8 at 128/256/512, 256^2 x 11 volumes, T=1000, bf16, seeded random
     weights with nonzero final_conv / proj_out) runs predict_ddim(50) on 2
     volumes: once to warm up (recording every GroupNorm and attention shape
     it meets), once with the kernels' launch counters set to 0 (each must
     equal the main path's GroupNorm / attention call count, and every K1
     launch be on channels-last x, LAUNCHES_CHANNELS_LAST), then timed;
     then one UNet forward under torch.profiler: K1's and K2's device time
     in it (K1 against the kernels its planner gives each call);
  4. kernels: each kernel against its plain PyTorch version on the card at
     every shape phase 3 met, bf16 inputs, the plain version in float32 from
     the same bf16 tensors; kernel (CUDA events around 20 back-to-back
     calls), device (torch.profiler: the kernels a call launches, from a
     trace that holds every one of them, K1's count from its plan; K2 split
     into QKV GEMM, core and output GEMM), plain, library (one PyTorch call,
     used nowhere in the port; back to back and device) and bound times;
     K1's path and cluster size at each shape, and its device time a
     request split into the UNet's and the VAE's calls; K1 once more on
     channels-last x at each shape (the samplers' layout on the card), rows
     of their own: the table's K1 entry totals those, its "channels_first"
     the others;
  5. conv probe: the port's conv probe (scripts/perf_probe_conv.py) over
     stages A, B and C with the launch counters set to 0 (K3 and K4, its
     int8 row, must have launched as often as the probe called them, K1 and
     K2 never; K4 equal to its plain version); then K3 at
     each stage and tile against its plain version in float32 from the same
     bf16 tensors, the device time (torch.profiler) of K3 at each tile and
     of cuDNN, and at the planner's tile (the one conv3x3() launches by
     default, K3's row) K3's TFLOP/s and share of the bound; the plain
     version's time (back-to-back kernel and library times are the probe's);
  6. card against CPU: the same port at published widths, 128^2 x 3, B=1,
     float32 (TF32 off), from the same weights and noise: DDIM-5, DDPM on a
     T=20 predictor from one shared step-noise table, DPM-Solver++ with 5
     steps; forward's eps_pred and the eval step's loss from the same noise
     and t; the sanity (E3D, D3D) and cross (E2D, D3D) reconstructions;
  7. the kernel table as one JSON line (K4's from phase 20; phase 9's
     numbers under each
     kernel's "cli", phase 11's under its "evaluation", phase 13's and the
     training paths' launches under its "training", phase 15's and the VAE
     training paths' launches under its "vae_training", phase 17's and the
     serving paths' launches under its "serving", phase 18's rows and phase
     19's launches under K2's "wide"), then the result line;
  8. entry point: a run dir in the reference layout (log.json naming a VAE
     dir, the dataset, evaluate's batch 2 and cost; best_model.pt of a
     seeded published-width predictor, float32; vae.pt with dual_full keys
     and vae_log.json with norm_factors) and a 256^2 x 11 dataset of 12
     samples whose test split holds 3, written under _build/ (phases
     8-10); the port's CLI (inference.run) on it through its argv with
     --sampler ddpm (T=1000), dpm --steps 10 and ddim --steps 50, each with
     the launch counters set to 0: the loaded state dict's checksum equals
     the written one, the output is finite, (1, 11, 3, 256, 256) and 0
     where the mask is, K1 launched 38 x evaluations + 26 times, K2 6 x
     evaluations, K3 never; the request time and volumes/s; then one more
     DDIM-50 request of the CLI with a global forward hook recording the
     shape and dtype of every GroupNorm and attention input (float32, B=1);
     and the host share of a DDPM request of the CLI (1 - device time /
     wall time) on a copy of the run dir with T=10: the CLI's own request
     time, the device time from torch.profiler around its predictor's
     predict() on the same inputs and generator;
  9. cli kernels: phase 4 at the shapes and dtype phase 8 recorded, with the
     float32 tolerances, calls counted a DDIM-50 request of the CLI (K1's
     "cli" totals its channels-last rows);
 10. evaluation: on phase 8's dirs, float32, each with the launch counters
     set to 0 and held to the counts derived from the modules (K3 never):
     evaluate at B=2 (finite loss, test_result.txt, seconds a batch);
     eval_testset_end2end over the test split with DDIM-50 at batch 1 and
     2 (per-sample nMAE equal within 1e-3), DPM-10, --sanity-mode and
     --cross-mode (the report, seconds a sample, steady state);
     inference_vae.run in modes 2d, 3d and cross (finite masked MAE);
     then each path once more under a global forward hook recording the
     GroupNorm and attention inputs;
 11. eval kernels: phase 4 at the (shape, dtype) pairs of phase 10 that no
     earlier phase held, float32 tolerances, calls counted over phase 10's
     hooked runs;
 12. training: the port's train CLI at the published UNet on phase 8's
     dataset (8 train, 1 validation, 3 test samples) and VAE dir, B=2,
     every step timed (host clock, synchronized) with its launches held to
     the module-derived counts (in a train step K1 for the frozen E3D + E2D
     encodes and no K2; in a validation or test step every call): (a) 2 epochs, float32 (step, validation-batch and epoch
     seconds, peak memory, finite losses, the run dir's files); (b) the
     physics and velocity losses, 1 epoch (heavy and plain steps, finite
     components); (c) 1 epoch, then --resume to 2: epoch 1's losses within
     1e-3 of (a)'s; (d) the inference CLI, DDIM-50, on (a)'s run dir; (e)
     30 steps on one fixed batch (the loss must fall), then one train step
     under torch.profiler, its device time by kernel; (f) one train step's
     UNet gradients on the card and on the CPU, 128^2 x 3, B=1, float32,
     TF32 off, plain and with physics, within 1e-3; (g) 1 epoch in
     bfloat16; then the kernel inputs of the validation and test passes
     and of a train step, recorded by a global hook;
 13. train kernels: phase 4 at the pairs of phase 12 that no earlier phase
     held;
 14. VAE training: the port's VAE trainers at the reference widths (latent
     8, 128/256/512) on phase 8's dataset (8 train, 1 validation, 3 test
     microstructures), B=2, float32 (TF32 convs), every microbatch and
     validation / test batch timed with its launches held to the
     module-derived counts (K1: 0 a stage-1 train microbatch, E3D + D3D a
     stage-1 eval batch, the frozen E3D a stage-2 microbatch, all four
     networks a stage-2 eval batch; K2 and K3 never): (a) the data-prep CLI
     (generate_statistics --generate-split --force) into a copy of the
     dataset; (b) stage 1, 2 epochs, accum 2, resident data; (c) stage 1
     streamed, epoch 0 within 1e-4 of (b)'s, then --resume to 2, epoch 1
     within 1e-3 of (b)'s; (d) stage 2 on (b) (lambda-align 5, lambda-cross
     50), no frozen-weight warning; (e) the diffusion train CLI on (d) and
     (b) for 1 epoch, then the inference CLI, DDIM-50, on its run dir; (f)
     one stage-1 and one stage-2 microbatch's gradients on the card and on
     the CPU, 128^2 x 3, B=1, TF32 off, within 1e-3; (g) 30 stage-1 steps
     on one sample (the loss must fall), then one microbatch of each stage
     under torch.profiler, its device time by kind of kernel; then the
     kernels' inputs of each path, recorded by a global hook;
 15. VAE kernels: phase 4 at the pairs of phase 14 that no earlier phase
     held, and K1's device time a batch of each VAE path;
 16. serving: on phase 8's run dir, 256^2 x 11: (a) InferenceServer with the
     ladder (1, 8), DDIM-50, bf16 (the serve CLI's default), warmed up under
     a global hook recording the kernels' inputs at B=1 and B=8, then with
     the launch counters set to 0 one lone request and 16 concurrent ones
     from 8 client threads through build_http_server (npz float32 and MFR1
     raw in turn, a seed each): each result finite, (11, 3, 256, 256) and 0
     where the mask is; K1 = 1,926 and K2 = 300 a dispatch, K3 0;
     volumes/s, p50 / p99 latency, batches, padded slots, peak memory in
     the burst; (b) the same at DPM-10 (406 / 60 a dispatch); (c) float32,
     TF32 off, DDIM-10: a request alone, inside a batch of 8 and padded to
     8, each within 1e-4 of the direct predict_ddim on its latents; (d) the
     serve CLI as a process: one request, SIGTERM, exit 0 with its final
     stats; (e) export_sampler DDIM-5 at B=1, float32, then load_sampler:
     within 1e-5 of the eager predictor, 216 K1 and 30 K2 launches, export
     seconds, archive bytes, both timed; (g) a DDIM-50 request at B=1, bf16,
     through the wrappers and through the registered ops; (h) one B=8
     DDIM-50 dispatch under torch.profiler, its device time by kind of
     kernel against its wall time; (i) the server's pipeline at B=8: one
     batch's host work (inputs staged, the sampler's kernels and the
     result's copy queued) under torch.cuda.set_sync_debug_mode("error"), so
     any call on it that waits for the device raises; then two bursts of 16
     requests with a device sleep ahead of each batch's sampler: a batch
     must be queued while the one before it is still on the device (the
     server's queued_while_busy); (f) one train CLI
     epoch with --profile-dir writes a trace with CUDA kernels, and
     --debug-nans on data carrying a NaN raises naming a module;
 17. serve kernels: phase 4 at the pairs of phase 16 that no earlier phase
     held (UNet N=88 and VAE B=8, bf16), K1 on channels-last x, the served
     samplers' layout.
 18. wide attention: K2 against its plain version at attention shapes beyond
     the published UNet's (WIDE_K2_SHAPES: head dims 32 to 2,048, 48 through
     zero-padded weights, up to 11,264 tokens), bf16 and float32, with
     phase 4's times, bound and library call;
 19. search and cached latents, on phase 8's dirs (phase_search): (b) one
     epoch of the train CLI at --features 32 64 128 256 --attention 3..2
     (K2 at head dim 64 in its validation and test passes) and one DDIM-50
     request of the inference CLI at --attention 1..2 (K2 over 4,096
     tokens) on a run dir written here; (c) --mode optimize, 2 trials of 1
     epoch (study.json, a run dir a trial); (d) the port's grid search,
     --grid-index 0, 1 epoch (results.csv, the reports; the dry-run forward
     at 128^2 on the card); (e) the first train batch's loss through the
     latent cache against the uncached one under the same noise and t, then
     --cache-latents with and without --augment, 1 epoch each; every run's
     launches held to the module-derived counts.
 20. int8 (K4 never launched on phases 3-19's float paths): (a) the published
     B=2 bf16 DDIM-50 request as float, with_vae_int8() and with both int8
     flags, each warmed up under a hook recording K4's inputs, then with the
     counters set to 0 (K4 30 a VAE-int8 request, 30 + 22 x 50 with both
     flags, from the modules; K1 / K2 as the float path, K3 0), timed, peak
     memory, relative MSE against float; the both-flags request once under
     torch.profiler (K4's device time, the quantize pass's apart); (b) K4
     against its plain version with torch.equal at every input (a) recorded,
     device ms, bound (int8 1,979 TOPS or bytes), the bf16 cuDNN conv at the
     same shape and at 1x1x1 torch._int_mm (yardsticks only); (c) the probe's
     int8 row from phase 5; (d) the serve CLI's server with --int8 on phase
     8's run dir: one HTTP request padded to a batch of 2, equal to the direct
     call on that padded batch; (e) eval_testset_end2end --int8 DDIM-50 on
     phase 8's dirs (launches held, nMAE beside phase 10's float run); (f)
     both flags at published widths, 128^2 x 3, B=1, float32, TF32 off,
     DDIM-5 on the card and the CPU: each side's int8-against-float spread
     within 2x of the other's, card against CPU within 2.5x the CPU's spread
     (two int8 runs whose float paths differ by ulps carry independent
     rounding noise a few int8 layers on).
Details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import collections
import copy
import csv
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
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
# tests/test_torch_cuda.py give on an H100. K3 rounds its float32 sum to bf16
# once: half an ulp is 2^-9 to 2^-8 of a value, so at most 2^-8 of the
# largest magnitude; the order of the float32 sums adds far less
K1_TOL = 2.0 ** -7
K2_TOL = 1.3e-2
K3_TOL = 2.0 ** -8
# float32 inputs (the CLI's path): the kernels' sums run in another order
# than the plain version's, nothing is rounded to bf16; the limits of
# tests/test_torch_cuda.py's float32 cases
K1_TOL_F32 = 1e-5
K2_TOL_F32 = 1e-4
CARD_VS_CPU_TOL = 1e-3  # float32, sums in another order on each side
K3_WARM, K3_ITERS = 30, 10  # K3 / cuDNN device time: calls before the trace, calls traced

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


SENTINEL = "spin_kernel"  # torch.cuda._sleep's kernel, launched first in every trace
# sentinels a trace: torch.profiler has left out as many as the first six
# kernels of a trace (4 sentinels and the first gemm_bias_f32 and
# attention_core_f32 of K2, late in a run with hundreds of traces)
SENTINELS = 16
PROFILER = {"traces": 0, "first_left_out": 0}  # over the run, by device_kernels


def _trace(fn, iters: int, counter) -> tuple:
    """One torch.profiler trace: the sentinel kernels, then ``iters`` calls of
    ``fn``. Returns the CUDA kernels as (name, ms) in launch order and the
    change of ``counter()`` (a wrapper's launch count; None without one)
    over the calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(SENTINELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        before = counter() if counter else None
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        launched = counter() - before if counter else None
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    return [(e.name, (e.time_range.end - e.time_range.start) / 1e3) for e in evs], launched


def complete(kernels: list, iters: int, keep=None, launched=None, per_launch: int = 1) -> bool:
    """Whether a trace of ``iters`` calls holds every kernel they launched:
    each name a whole number of times a call and, where the wrapper counted
    ``launched`` launches, ``per_launch`` kernels that ``keep`` accepts for
    each of them."""
    counts = {}
    for name, _ in kernels:
        counts[name] = counts.get(name, 0) + 1
    if not counts or any(c % iters for c in counts.values()):
        return False
    kept = sum(c for name, c in counts.items() if keep is None or keep(name))
    return launched is None or kept == per_launch * launched


def device_kernels(fn, iters: int = 10, keep=None, counter=None, per_launch: int = 1,
                   warmup: int = 1, tries: int = 5) -> list:
    """The CUDA kernels that ``iters`` calls of ``fn`` launch, in launch order,
    as (name, ms) from torch.profiler, after ``warmup`` calls. On an H100
    torch.profiler may leave the first kernels of a trace out of it (most
    traces once a process has profiled a UNet forward, phase 3); each trace
    therefore starts with ``SENTINELS`` sentinel kernels of its own, which
    are not returned. A trace that is not :func:`complete` is taken again,
    up to ``tries`` traces, then raises."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        kernels, launched = _trace(fn, iters, counter)
        PROFILER["traces"] += 1
        PROFILER["first_left_out"] += sum(SENTINEL in k[0] for k in kernels) < SENTINELS
        own = [k for k in kernels if SENTINEL not in k[0]]
        if complete(own, iters, keep, launched, per_launch):
            return own
        counts = {}
        for name, _ in own:
            counts[name[:48]] = counts.get(name[:48], 0) + 1
        kept = len(kernels) - len(own)
        log(f"[profile] a trace of {iters} calls ({launched} launches counted) held {counts} "
            f"after {kept} of its {SENTINELS} sentinels; again")
    raise RuntimeError(f"torch.profiler recorded {len(own)} CUDA kernels in {iters} calls")


def device_ms(fn, iters: int = 10, warmup: int = 1, **kw) -> float:
    """Device time of one call of ``fn``: the CUDA kernels ``iters`` calls
    launch, from a complete trace (:func:`device_kernels`), summed over
    ``iters``."""
    return sum(ms for _, ms in device_kernels(fn, iters, warmup=warmup, **kw)) / iters


def library_device_ms(fn, **kw):
    """:func:`device_ms` of a library call, which has no launch counter and
    is read beside a kernel, never checked: None where no trace was complete."""
    try:
        return device_ms(fn, **kw)
    except RuntimeError as e:
        log(f"[profile] library device time not measured: {e}")
        return None


def tally(label: str, since: dict) -> dict:
    """The traces taken since ``since`` (a copy of PROFILER), and of how many
    torch.profiler left the first kernel (a sentinel) out."""
    d = {"label": label, **{k: PROFILER[k] - since[k] for k in PROFILER}}
    log(f"[profile] {label}: torch.profiler left the first kernel (a sentinel) out of "
        f"{d['first_left_out']} of {d['traces']} traces")
    return d


def profiler_check(label: str) -> dict:
    """:func:`tally` of three traces of 10 small elementwise calls."""
    z = torch.zeros(256, device="cuda")
    before = dict(PROFILER)
    for _ in range(3):
        device_kernels(lambda: z.add_(1.0), 10)
    return tally(label, before)


def clocks() -> str:
    """The SM clock and power draw of the card in use, as nvidia-smi reads
    them now, or why they could not be read."""
    uuid = torch.cuda.get_device_properties(torch.cuda.current_device()).uuid
    r = subprocess.run(["nvidia-smi", "-i", f"GPU-{uuid}", "--query-gpu=clocks.sm,power.draw",
                        "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return r.stdout.strip() if r.returncode == 0 else f"not read (nvidia-smi exit {r.returncode})"


K2_PARTS = ("qkv_gemm", "core", "out_gemm")  # K2's three launches, in launch order


def k2_split(kernels: list) -> dict:
    """Device time (ms, summed) of K2's parts among ``kernels``, the kernels of
    whole K2 calls in launch order; "other" sums kernels not K2's own."""
    split = dict.fromkeys(K2_PARTS + ("other",), 0.0)
    own = 0
    for name, ms in kernels:
        if is_k2_kernel(name):
            split[K2_PARTS[own % 3]] += ms
            own += 1
        else:
            split["other"] += ms
    return split


def is_k1_kernel(name: str) -> bool:
    # K1's kernels live in groupnorm_act.cu's anonymous namespace
    return "::gn_cluster" in name or "::gn_partial" in name or "::gn_apply" in name


def is_k2_kernel(name: str) -> bool:
    # K2's kernels live in attention.cu's anonymous namespace; cuBLAS's and
    # cuDNN's names carry no "::gemm_bias" or "::attention_core"
    return "::gemm_bias" in name or "::attention_core" in name


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


def published_predictor(device, dtype, seed=0, num_timesteps=1000):
    from diffusion_model_project_tpu_torch.diffusion.predictor import LatentDiffusionPredictor
    from diffusion_model_project_tpu_torch.utils.config import (
        PUBLISHED_LATENT_CHANNELS, PUBLISHED_UNET_KWARGS)

    pred = LatentDiffusionPredictor.create(
        dict(PUBLISHED_UNET_KWARGS), seed=seed, device="cpu", compute_dtype=dtype,
        num_timesteps=num_timesteps, latent_channels=PUBLISHED_LATENT_CHANNELS)
    enliven(pred.model, seed + 1)
    pred.set_normalizer({"input": [1.0], "output": NORM_OUTPUT})
    return pred.to(device)


def enliven(unet, seed: int) -> None:
    """The JAX init zeroes final_conv and proj_out (output identically 0,
    attention path dead); give them random weights so both are exercised."""
    from diffusion_model_project_tpu_torch.models.layers import uniform_
    from diffusion_model_project_tpu_torch.models.unet import SelfAttention2D

    gen = torch.Generator().manual_seed(seed)
    uniform_(unet.final_conv.weight, 1.0 / math.sqrt(unet.final_conv.weight[0].numel()), gen)
    uniform_(unet.final_conv.bias, 0.05, gen)
    for m in unet.modules():
        if isinstance(m, SelfAttention2D):
            uniform_(m.proj_out.weight, 1.0 / math.sqrt(m.proj_out.weight.shape[1]), gen)
            uniform_(m.proj_out.bias, 0.05, gen)


def make_inputs(b, s, hw, seed):
    gen = torch.Generator().manual_seed(seed)
    img = (torch.rand((b, s, 1, hw, hw), generator=gen) > 0.3).float()
    vel = torch.randn((b, s, 3, hw, hw), generator=gen) * 1e-2
    vel[:, :, 2] = 0.0
    noise = torch.randn((b * s, 8, hw // 4, hw // 4), generator=gen)
    return img, vel, noise


def record_shapes(pred=None):
    """Forward pre-hooks that count each (GroupNorm | attention) input shape
    and dtype where the call goes to the kernel's wrapper (not the calls that
    train_trace() routes to the plain version under autograd): on ``pred``'s
    modules, or on every module (one global hook) without ``pred``."""
    from diffusion_model_project_tpu_torch.models.layers import (GroupNorm, MultiheadSelfAttention,
                                                                 routes_plain)

    seen = {}

    def hook(mod, args):
        x = args[0]
        if isinstance(mod, (GroupNorm, MultiheadSelfAttention)) and routes_plain(mod, x):
            return
        if isinstance(mod, GroupNorm):
            key = ("groupnorm_act", tuple(x.shape), mod.num_groups, mod.act, str(x.dtype))
        elif isinstance(mod, MultiheadSelfAttention):
            key = ("fused_attention", tuple(x.shape), mod.num_heads, str(x.dtype))
        else:
            return
        seen[key] = seen.get(key, 0) + 1

    if pred is None:
        return seen, [torch.nn.modules.module.register_module_forward_pre_hook(hook)]
    return seen, [m.register_forward_pre_hook(hook) for m in pred.modules()
                  if isinstance(m, (GroupNorm, MultiheadSelfAttention))]


def expected_calls(pred, steps):
    from diffusion_model_project_tpu_torch.models.layers import GroupNorm, MultiheadSelfAttention

    def count(module, cls):
        return sum(isinstance(m, cls) for m in module.modules())

    gn = (count(pred.model, GroupNorm) * steps + count(pred.vae.encoder_2d, GroupNorm)
          + count(pred.vae.decoder_3d, GroupNorm))
    return gn, count(pred.model, MultiheadSelfAttention) * steps


def phase_slice() -> dict:
    from diffusion_model_project_tpu_torch.ops.cuda import attention as k2
    from diffusion_model_project_tpu_torch.ops.cuda import conv3x3 as k3
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
    k1.LAUNCHES = k1.LAUNCHES_CHANNELS_LAST = k2.LAUNCHES = k3.LAUNCHES = 0
    out = pred.predict_ddim(img, vel, num_steps=STEPS, noise=noise)
    torch.cuda.synchronize()
    launches = {"groupnorm_act": k1.LAUNCHES, "fused_attention": k2.LAUNCHES}
    log(f"[slice] launches in one predict_ddim({STEPS}) at B={B}: {launches}, K1 on "
        f"channels-last x {k1.LAUNCHES_CHANNELS_LAST}, conv3x3 {k3.LAUNCHES} (expected "
        f"groupnorm_act {exp_gn}, all channels-last, fused_attention {exp_attn}, conv3x3 0)")
    if launches != {"groupnorm_act": exp_gn, "fused_attention": exp_attn} or k3.LAUNCHES \
            or k1.LAUNCHES_CHANNELS_LAST != exp_gn:
        raise RuntimeError(f"main path did not go through the kernels as expected: {launches}, "
                           f"K1 channels-last {k1.LAUNCHES_CHANNELS_LAST}, conv3x3 {k3.LAUNCHES}")
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
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from diffusion_model_project_tpu_torch.models.layers import (
            GroupNorm, MultiheadSelfAttention)

        # K1's kernels in one forward: each GroupNorm call's planned kernel count
        k1_plans, hooks = [], []
        for m in pred.model.modules():
            if isinstance(m, GroupNorm):
                hooks.append(m.register_forward_pre_hook(lambda mod, args: k1_plans.append(
                    k1.launch_plan(args[0], mod.num_groups, mod.act))))
        pred._unet_eps(x, z_cond, m_cond, t_batch)
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        k1_kernels = sum(p.kernels for p in k1_plans)
        k2_kernels = 3 * sum(isinstance(m, MultiheadSelfAttention) for m in pred.model.modules())
        for _ in range(3):  # a trace that misses K1's or K2's kernels is taken again
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                pred._unet_eps(x, z_cond, m_cond, t_batch)
                torch.cuda.synchronize()
            evs = [(e.name, (e.time_range.end - e.time_range.start) / 1e3) for e in sorted(
                (e for e in prof.events() if e.device_type == DeviceType.CUDA),
                key=lambda e: e.time_range.start)]
            k1_evs = [e for e in evs if is_k1_kernel(e[0])]
            k2_evs = [e for e in evs if is_k2_kernel(e[0])]
            if (len(k1_evs), len(k2_evs)) == (k1_kernels, k2_kernels):
                break
            log(f"[profile] the forward's trace held {len(k1_evs)} of K1's {k1_kernels} and "
                f"{len(k2_evs)} of K2's {k2_kernels} kernels; again")
        else:
            raise RuntimeError(f"the profiled forward shows {len(k1_evs)} of K1's {k1_kernels} "
                               f"and {len(k2_evs)} of K2's {k2_kernels} kernels")
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=15)
    for ln in table.splitlines():
        log(f"[profile] {ln}")
    k1_forward = sum(ms for _, ms in k1_evs)
    log(f"[profile] K1 device time in this UNet forward: {k1_forward:.4f} ms over "
        f"{len(k1_evs)} kernels ({len(k1_plans)} calls; "
        + ", ".join(f"{v} {p}" for p, v in sorted(collections.Counter(
            f"{p.path} k={p.k}" for p in k1_plans).items())) + ")")
    k2_forward = k2_split(k2_evs)
    log(f"[profile] K2 device time in this UNet forward (ms): "
        + ", ".join(f"{k} {v:.4f}" for k, v in k2_forward.items())
        + f", total {sum(k2_forward.values()):.4f}")

    res = {"batch": B, "slices": S, "hw": HW, "steps": STEPS, "warmup_s": warm_s,
           "request_s": per_req, "volumes_per_s": B / per_req, "stage_ms": stages,
           "peak_bytes": peak, "launches": launches, "shapes": seen,
           "profile_unet_forward": table, "profile_k1_ms": k1_forward,
           "profile_k2_ms": k2_forward}
    log(f"[slice] warm-up {warm_s:.2f} s; request {per_req * 1e3:.1f} ms; "
        f"{B / per_req:.3f} volumes/s; stages (ms) "
        + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
        + f"; peak memory {peak / 2**30:.2f} GiB")
    return res


def k1_library_call(x, w, b, groups: int, act: str):
    """K1's yardstick, used nowhere in the port: ``F.group_norm`` + act in x's dtype."""
    import torch.nn.functional as F

    post = {"silu": F.silu, "relu": F.relu, "": lambda v: v}[act]
    wb, bb = w.to(x.dtype), b.to(x.dtype)
    return lambda: post(F.group_norm(x, groups, wb, bb))


def _k1_case(shape, groups, act, gen, dtype=torch.bfloat16, channels_last=False):
    from diffusion_model_project_tpu_torch.ops.basic import to_channels_last
    from diffusion_model_project_tpu_torch.ops.cuda import groupnorm_act as k1

    c = shape[1]
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    if channels_last:
        x = to_channels_last(x)
    w = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    b = 0.1 * torch.randn(c, generator=gen, device="cuda")
    got = k1.groupnorm_act(x, w, b, groups, act).float()
    ref = k1.groupnorm_act_plain(x.float(), w, b, groups, act)
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    library = k1_library_call(x, w, b, groups, act)
    p = k1.launch_plan(x, groups, act)
    times = {
        "ms": sync_ms(lambda: k1.groupnorm_act(x, w, b, groups, act)),
        "plain_ms": sync_ms(lambda: k1.groupnorm_act_plain(x, w, b, groups, act)),
        "library_ms": sync_ms(library),
        "device_ms": device_ms(lambda: k1.groupnorm_act(x, w, b, groups, act),
                               counter=lambda: k1.LAUNCHES, per_launch=p.kernels),
        "library_device_ms": library_device_ms(library),
        "plan": {"path": p.path, "k": p.k, "kernels": p.kernels, "blocks": p.grid[0] * p.grid[1],
                 "slice_bytes": p.slice * x.element_size(), "aligned": p.aligned},
    }
    n = x.numel()
    nbytes = 2 * n * x.element_size() + 2 * c * 4   # x read + y written, f32 affine
    flops = 8 * n                            # stats + normalize + affine + act, a few per element
    return err, err / scale, nbytes, flops, times


def _k2_case(shape, heads, gen, dtype=torch.bfloat16):
    import torch.nn.functional as F

    from diffusion_model_project_tpu_torch.ops.attention import multihead_attention
    from diffusion_model_project_tpu_torch.ops.cuda import attention as k2

    n, t, e = shape
    hd = e // heads
    dt = dtype
    x = torch.randn(shape, generator=gen, device="cuda").to(dt)
    w_qkv = (torch.randn((3 * e, e), generator=gen, device="cuda") / math.sqrt(e)).to(dt)
    b_qkv = (0.02 * torch.randn(3 * e, generator=gen, device="cuda")).to(dt)
    w_out = (torch.randn((e, e), generator=gen, device="cuda") / math.sqrt(e)).to(dt)
    b_out = (0.02 * torch.randn(e, generator=gen, device="cuda")).to(dt)
    args = (x, w_qkv.t(), b_qkv, w_out.t(), b_out)  # JAX layouts as views, as the module passes
    got = k2.fused_attention(*args, heads).float()
    ref = multihead_attention(*[a.float() for a in args], heads)
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    # both against the plain version in float64: tells a kernel that sums as
    # the plain version does from one that returns the plain version's output
    ref64 = multihead_attention(*[a.double() for a in args], heads)
    vs_f64 = {"kernel": (got.double() - ref64).abs().max().item(),
              "plain": (ref.double() - ref64).abs().max().item()}
    del ref64

    def library():
        qkv = F.linear(x, w_qkv, b_qkv).view(n, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
        return F.linear(o.transpose(1, 2).reshape(n, t, e), w_out, b_out)

    times = {
        "ms": sync_ms(lambda: k2.fused_attention(*args, heads)),
        "plain_ms": sync_ms(lambda: multihead_attention(*args, heads)),
        "library_ms": sync_ms(library),
        "library_device_ms": library_device_ms(library),
    }
    iters = 10
    kernels = device_kernels(lambda: k2.fused_attention(*args, heads), iters, keep=is_k2_kernel,
                             counter=lambda: k2.LAUNCHES, per_launch=3)
    times["device_split_ms"] = {k: v / iters for k, v in k2_split(kernels).items()}
    times["device_ms"] = sum(times["device_split_ms"].values())
    times["max_abs_err_vs_f64"] = vs_f64
    nbytes = x.element_size() * (2 * n * t * e + 4 * e * e + 4 * e)
    flops = 2 * n * t * e * 3 * e + 2 * 2 * n * t * t * e + 2 * n * t * e * e
    return err, err / scale, nbytes, flops, times


DTYPES = {str(d): d for d in (torch.bfloat16, torch.float32)}


def phase_kernels(shapes: dict, launches: dict, tag: str = "kernels",
                  k1_layouts: tuple = (False,)) -> list:
    """Each kernel against its plain version at every (shape, dtype) of
    ``shapes`` (from :func:`record_shapes`), calls counted a request; K1
    once on each layout of ``k1_layouts`` (channels-last or not), a row
    each."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    cases = [(key, calls, cl)
             for key, calls in sorted(shapes.items(), key=lambda kv: str(kv[0]))
             for cl in (k1_layouts if key[0] == "groupnorm_act" else (False,))]
    for key, calls, channels_last in cases:
        dtype = DTYPES[key[-1]]
        f32 = dtype == torch.float32
        if key[0] == "groupnorm_act":
            _, shape, groups, act, _ = key
            err, rel, nbytes, flops, times = _k1_case(shape, groups, act, gen, dtype,
                                                      channels_last)
            tol, label, peak = (K1_TOL_F32 if f32 else K1_TOL,
                                f"G={groups} act={act or 'none'}", F32_FLOPS)
            if channels_last:
                label += " channels-last"
        else:
            _, shape, heads, _ = key
            err, rel, nbytes, flops, times = _k2_case(shape, heads, gen, dtype)
            # float32 K2 runs SIMT products, bf16 K2 the tensor cores
            tol, label, peak = (K2_TOL_F32 if f32 else K2_TOL,
                                f"heads={heads} hd={shape[2] // heads}",
                                F32_FLOPS if f32 else BF16_FLOPS)
        label += f" {key[-1].replace('torch.', '')}"
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        row = dict(kernel=key[0], shape=list(shape), dtype=key[-1], detail=label,
                   channels_last=channels_last, calls_per_request=calls,
                   max_abs_err=err, rel_err=rel, tol=tol, bound_ms=bound_ms,
                   bound_by=bound_by, bytes=nbytes, flops=flops, bytes_ms=bytes_ms,
                   ops_ms=ops_ms, **times)
        rows.append(row)
        lib_dev = times["library_device_ms"]
        log(f"[{tag}] {key[0]:15s} {str(tuple(shape)):26s} {label:29s} x{calls:<5d} "
            f"err {err:.3e} (rel {rel:.2e}, tol {tol:.2e}) | ms {times['ms']:.4f} "
            f"device {times['device_ms']:.4f} plain {times['plain_ms']:.4f} "
            f"library {times['library_ms']:.4f} library device "
            f"{'not measured' if lib_dev is None else f'{lib_dev:.4f}'} bound {bound_ms:.4f} "
            f"({bound_by})"
            + ("".join(f" | {k} {v:.4f}" for k, v in times["device_split_ms"].items())
               if "device_split_ms" in times else "")
            + ("".join(f" | {k} vs float64 {v:.3e}" for k, v in times["max_abs_err_vs_f64"].items())
               if "max_abs_err_vs_f64" in times else "")
            + (f" | {times['plan']['path']} k={times['plan']['k']}, {times['plan']['kernels']} "
               f"kernel(s), {times['plan']['blocks']} blocks of {times['plan']['slice_bytes']} "
               "bytes" if "plan" in times else ""))
        if not rel <= tol:
            raise RuntimeError(f"{key[0]} {shape}: error {rel:.3e} above tolerance {tol:.3e}")
    for name, n in launches.items():
        if not any(r["kernel"] == name for r in rows):
            raise RuntimeError(f"no shape of {name} was checked")
    k1_parts = {}
    for part, ndim, cl in (("unet", 4, False), ("vae", 5, False),
                           ("unet channels-last", 4, True), ("vae channels-last", 5, True)):
        rs = [r for r in rows if r["kernel"] == "groupnorm_act" and len(r["shape"]) == ndim
              and r["channels_last"] == cl]
        if not rs:
            continue
        k1_parts[part] = {k: sum(r[k] * r["calls_per_request"] for r in rs)
                          for k in ("device_ms", "bound_ms", "ms")}
        k1_parts[part]["calls"] = sum(r["calls_per_request"] for r in rs)
    log(f"[{tag}] K1 a request (ms): " + "; ".join(
        f"{part} ({v['calls']} calls) device {v['device_ms']:.3f}, bound {v['bound_ms']:.3f}, "
        f"back to back {v['ms']:.3f}" for part, v in k1_parts.items())
        + "; total device " + ", ".join(
            ("channels-last " if cl else "")
            + f"{sum(v['device_ms'] for p, v in k1_parts.items() if ('last' in p) == cl):.3f}"
            for cl in k1_layouts))
    return rows, k1_parts


def phase_conv_probe() -> tuple:
    """The conv probe's path, counted; then K3 against its plain version."""
    import torch.nn.functional as F

    from diffusion_model_project_tpu_torch.ops.cuda import attention as k2
    from diffusion_model_project_tpu_torch.ops.cuda import conv3x3 as k3
    from diffusion_model_project_tpu_torch.ops.cuda import groupnorm_act as k1
    from diffusion_model_project_tpu_torch.ops.cuda import int8_conv as k4
    from diffusion_model_project_tpu_torch.scripts import perf_probe_conv as probe

    k1.LAUNCHES = k2.LAUNCHES = k3.LAUNCHES = k4.LAUNCHES = 0
    probed = probe.main(list(probe.STAGES))
    launches = {"groupnorm_act": k1.LAUNCHES, "fused_attention": k2.LAUNCHES,
                "conv3x3": k3.LAUNCHES, "int8_conv": k4.LAUNCHES}
    expected = sum(r["calls"] for r in probed if r["candidate"].startswith("k3["))
    int8_rows = [r for r in probed if r["candidate"] == "k4_int8"]
    expected_k4 = sum(r["calls"] for r in int8_rows)
    log(f"[conv probe] launches in one probe over stages {', '.join(probe.STAGES)}: "
        f"{launches} (expected conv3x3 {expected}, int8_conv {expected_k4}, the others 0)")
    if not expected or launches != {"groupnorm_act": 0, "fused_attention": 0,
                                    "conv3x3": expected, "int8_conv": expected_k4}:
        raise RuntimeError(f"the conv probe did not go through K3 and K4 as expected: "
                           f"{launches}")
    if any(r["max_abs_err"] for r in int8_rows):
        raise RuntimeError(f"the probe's int8 row differs from K4's plain version: {int8_rows}")

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full float32
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for stage, shape in probe.STAGES.items():
        n, h, w, cin, cout = shape
        x = torch.randn((n, h, w, cin), generator=gen, device="cuda").to(torch.bfloat16)
        wgt = (0.05 * torch.randn((3, 3, cin, cout), generator=gen, device="cuda")).to(
            torch.bfloat16)
        ref = k3.conv3x3_plain(x.float(), wgt.float())
        scale = ref.abs().max().item()
        by_tile = {r["candidate"]: r for r in probed if r["stage"] == stage}
        tiles = {}
        for th, tw in k3.TILES:
            err = (k3.conv3x3(x, wgt, (th, tw)).float() - ref).abs().max().item()
            tiles[f"{th}x{tw}"] = {"ms": by_tile[f"k3[{th}x{tw}]"]["ms"], "max_abs_err": err}
        del ref
        plain_ms = sync_ms(lambda: k3.conv3x3_plain(x, wgt), iters=5, warmup=1)
        # device times at the card's steady clock under load (it drops from its
        # 1,980 MHz maximum within a few calls at the 700 W limit): each
        # measurement follows K3_WARM calls of the same function, and cuDNN
        # is taken before and after K3's tiles
        x_cl = x.permute(0, 3, 1, 2)  # the library's own layout, as the probe times it
        w_cl = wgt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        cudnn = lambda: F.conv2d(x_cl, w_cl, padding=1)  # noqa: E731
        cudnn_device = [library_device_ms(cudnn, iters=K3_ITERS, warmup=K3_WARM)]
        for th, tw in k3.TILES:
            tiles[f"{th}x{tw}"]["device_ms"] = device_ms(
                lambda: k3.conv3x3(x, wgt, (th, tw)), iters=K3_ITERS, warmup=K3_WARM,
                keep=lambda name: "conv3x3" in name, counter=lambda: k3.LAUNCHES)
        cudnn_device.append(library_device_ms(cudnn, iters=K3_ITERS, warmup=K3_WARM))
        clock = clocks()
        read = [t for t in cudnn_device if t is not None]
        cudnn_device_ms = sum(read) / len(read) if read else None
        # the row is the tile conv3x3() launches by default; the others are detail
        planned = "x".join(map(str, k3.plan(*shape).tile))
        fastest = min(tiles, key=lambda t: tiles[t]["device_ms"])
        err = max(t["max_abs_err"] for t in tiles.values())
        b = probe.bound(*shape)
        fl = probe.flops(*shape)
        k3_device_ms = tiles[planned]["device_ms"]
        row = dict(kernel="conv3x3", shape=list(shape), detail=f"stage {stage}, tile {planned}",
                   calls_per_request=1, max_abs_err=err, rel_err=err / scale, tol=K3_TOL,
                   bound_ms=b["bound_ms"], bound_by=b["bound_by"], bytes=b["bytes"],
                   flops=fl, bytes_ms=b["bytes_ms"], ops_ms=b["ops_ms"],
                   ms=tiles[planned]["ms"], device_ms=k3_device_ms, plain_ms=plain_ms,
                   library_ms=by_tile["cudnn_bf16"]["ms"], library_device_ms=cudnn_device_ms,
                   library_device_ms_before_after=cudnn_device,
                   device_tflops=fl / k3_device_ms / 1e9, bound_share=b["bound_ms"] / k3_device_ms,
                   planned_tile=planned, fastest_tile=fastest, clocks_after=clock, tiles=tiles)
        rows.append(row)
        log(f"[conv probe] K3 stage {stage} {tuple(shape)}: err {err:.3e} (rel "
            f"{row['rel_err']:.2e}, tol {K3_TOL:.2e}) | ms " + ", ".join(
                f"{t} {v['ms']:.3f}" for t, v in tiles.items())
            + " | device " + ", ".join(f"{t} {v['device_ms']:.3f}" for t, v in tiles.items())
            + f" | planned {planned}: ms {row['ms']:.3f}, device {k3_device_ms:.3f} ms, "
            f"{row['device_tflops']:.1f} TFLOP/s, {100 * row['bound_share']:.1f}% of the bound "
            f"{b['bound_ms']:.3f} ({b['bound_by']}); fastest {fastest} | cudnn ms "
            f"{row['library_ms']:.3f} device {cudnn_device[0]} before, {cudnn_device[1]} after "
            f"| plain {plain_ms:.3f} | clock, power {clock}")
        if not row["rel_err"] <= K3_TOL:
            raise RuntimeError(f"conv3x3 stage {stage}: error {row['rel_err']:.3e} "
                               f"above tolerance {K3_TOL:.3e}")
    return rows, launches, probed


def phase_card_vs_cpu() -> dict:
    from diffusion_model_project_tpu_torch.scripts.eval_testset_end2end import vae_reconstruct
    from diffusion_model_project_tpu_torch.training.steps import make_diffusion_eval_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hw, s, t_ddpm = 128, 3, 20
    cpu = published_predictor(torch.device("cpu"), torch.float32, seed=3)
    gpu = copy.deepcopy(cpu).to("cuda")
    img, vel, noise = make_inputs(1, s, hw, seed=4)
    gen = torch.Generator().manual_seed(5)
    table = torch.randn((t_ddpm,) + tuple(noise.shape), generator=gen)
    cpu20 = published_predictor(torch.device("cpu"), torch.float32, seed=3,
                                num_timesteps=t_ddpm)
    gpu20 = copy.deepcopy(cpu20).to("cuda")
    # the noise-prediction step from one target, noise and t (t drawn in [0, T))
    v3d = torch.randn((1, s, 3, hw, hw), generator=gen) * 1e-2
    t = torch.randint(0, 1000, (s,), generator=gen)
    eval_step = make_diffusion_eval_step(cost_name=EVAL_COST)

    @torch.no_grad()
    def forward(p, d):
        return p.forward(img.to(d), vel.to(d), p.encode_target(v3d.to(d)), noise=noise.to(d),
                         t=t.to(d))[0]

    cases = {
        "DDIM-5": lambda p, d: p.predict_ddim(img.to(d), vel.to(d), num_steps=5,
                                              noise=noise.to(d)),
        f"DDPM T={t_ddpm}, shared step noise": lambda p, d: p.predict(
            img.to(d), vel.to(d), noise=noise.to(d), step_noise=table.to(d)),
        "DPM-Solver++ 5": lambda p, d: p.predict_dpm(img.to(d), vel.to(d), num_steps=5,
                                                     noise=noise.to(d)),
        "forward eps_pred (shared noise, t)": forward,
        # the generator on the CPU on both sides: the same noise and t
        f"eval step loss ({EVAL_COST})": lambda p, d: eval_step(
            p, {"img": img, "U_2d": vel, "U": v3d}, torch.Generator().manual_seed(8))["val_loss"],
        "sanity reconstruction (E3D, D3D)": lambda p, d: vae_reconstruct(
            p, img.to(d), v3d.to(d), from_2d=False),
        "cross reconstruction (E2D, D3D)": lambda p, d: vae_reconstruct(
            p, img.to(d), vel.to(d), from_2d=True),
    }
    out = {}
    for name, run in cases.items():
        on_cpu, on_gpu = (cpu20, gpu20) if name.startswith("DDPM") else (cpu, gpu)
        t0 = time.perf_counter()
        ref = run(on_cpu, "cpu")
        cpu_s = time.perf_counter() - t0
        got = run(on_gpu, "cuda").cpu()
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        values = f" (card {got.item()!r}, cpu {ref.item()!r})" if ref.ndim == 0 else ""
        log(f"[card-vs-cpu] published widths, {s}x{hw}^2, B=1, {name}, float32: "
            f"max|card-cpu|/max|cpu| = {rel:.3e}{values} (tol {CARD_VS_CPU_TOL:.0e}); "
            f"cpu {cpu_s:.1f} s")
        if not (torch.isfinite(got).all() and rel <= CARD_VS_CPU_TOL):
            raise RuntimeError(f"card and CPU disagree in {name}: {rel:.3e}")
        out[name] = {"rel_err": rel, "tol": CARD_VS_CPU_TOL, "cpu_s": cpu_s}
    return out


EP_SAMPLERS = (("ddpm", 1000), ("dpm", 10), ("ddim", 50))  # DDPM takes T steps
# the evaluation phase: evaluate's batch and cost (the run dir's log.json),
# the dataset's size (its test split holds 3 samples)
EVAL_B, EVAL_COST, EVAL_SAMPLES = 2, "normalized_mse_loss_per_component", 12


def dpm_evaluations(pred, steps: int) -> int:
    """UNet evaluations of ``predict_dpm(steps)``: its coefficient table's nodes."""
    import numpy as np

    from diffusion_model_project_tpu_torch.diffusion.scheduler import (
        ddim_timesteps, dpm_solver_coefficients)

    ts = np.unique(ddim_timesteps(pred.num_timesteps, steps))[::-1]
    return len(dpm_solver_coefficients(pred.scheduler.alphas_cumprod, ts)["t"])


def state_checksum(module) -> str:
    """sha256 over a module's state dict: keys, shapes, dtypes and bytes."""
    import hashlib

    h = hashlib.sha256()
    for k, v in sorted(module.state_dict().items()):
        v = v.detach().cpu().contiguous()
        h.update(f"{k}:{tuple(v.shape)}:{v.dtype}".encode())
        h.update(v.view(torch.uint8).numpy().tobytes() if v.numel() else b"")
    return h.hexdigest()


def write_entry_point_dirs(root: str) -> tuple:
    """A run dir in the reference layout, its VAE dir and a dataset; returns
    (run dir, VAE dir, dataset dir, checksum of the predictor written, the
    predictor)."""
    import numpy as np

    from diffusion_model_project_tpu_torch.utils.config import PUBLISHED_UNET_KWARGS

    pred = published_predictor(torch.device("cpu"), torch.float32, seed=6)
    run, vae, data = (os.path.join(root, d) for d in ("run", "vae", "data"))
    for d in (run, vae, os.path.join(data, "x")):
        os.makedirs(d)
    sd = pred.state_dict()
    torch.save({k: v for k, v in sd.items() if k.startswith(("model.", "normalizer."))},
               os.path.join(run, "best_model.pt"))
    torch.save(pred.vae.state_dict(), os.path.join(vae, "vae.pt"))
    with open(os.path.join(vae, "vae_log.json"), "w") as f:
        json.dump({"norm_factors": NORM_OUTPUT}, f)
    predictor_kwargs = {"model_name": "UNet", "model_kwargs": dict(PUBLISHED_UNET_KWARGS),
                        "distance_transform": True, "num_slices": S, "num_timesteps": 1000,
                        "vae_path": vae}
    with open(os.path.join(run, "log.json"), "w") as f:
        json.dump({"params": {
            "dataset": {"root_dir": data, "batch_size": EVAL_B, "use_3d": True},
            "training": {"predictor_type": "latent-diffusion", "predictor": predictor_kwargs,
                         "cost_function": EVAL_COST}}}, f)
    # 12 samples: the 70/15/15 split (get_loader's random.Random(2024)) keeps
    # int(0.7 * 12) = 8 for training, int(0.15 * 12) = 1 for validation and
    # 3 for the test split the CLIs read (the evaluation's second chunk at
    # batch 2 is a padded one)
    rng = np.random.default_rng(7)
    n = EVAL_SAMPLES
    u2d = (rng.standard_normal((n, S, 3, HW, HW)) * 1e-2).astype(np.float32)
    u2d[:, :, 2] = 0.0
    fields = {"domain.pt": (rng.random((n, S, 1, HW, HW)) > 0.3).astype(np.float32),
              "U_2d.pt": u2d,
              "U.pt": (rng.standard_normal((n, S, 3, HW, HW)) * 1e-2).astype(np.float32),
              "p.pt": rng.standard_normal((n, S, 1, HW, HW)).astype(np.float32),
              "dxyz.pt": np.ones((n, 3), np.float32)}
    for name, arr in fields.items():
        torch.save(torch.from_numpy(arr), os.path.join(data, "x", name))
    return run, vae, data, state_checksum(pred), pred


def ddpm_host_share(run_dir: str, t_short: int = 10) -> dict:
    """The host's share of one DDPM request of the CLI: a copy of the run
    dir whose log.json sets T = ``t_short`` (the same weights file, loaded
    by the same loader), driven through the CLI once (its own request wall
    time), then its predictor's predict() once more on the CLI's own inputs
    and generator under torch.profiler (the device time: every CUDA kernel
    and copy of the request)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diffusion_model_project_tpu_torch import inference

    short = run_dir + f"_t{t_short}"
    os.makedirs(short)
    os.link(os.path.join(run_dir, "best_model.pt"), os.path.join(short, "best_model.pt"))
    with open(os.path.join(run_dir, "log.json")) as f:
        log_json = json.load(f)
    log_json["params"]["training"]["predictor"]["num_timesteps"] = t_short
    with open(os.path.join(short, "log.json"), "w") as f:
        json.dump(log_json, f)

    res = inference.run(["--model-dir", short, "--sampler", "ddpm"])
    img, v2d, _ = inference.load_sample(res.args, log_json["params"])
    pred = res.predictor
    gen = torch.Generator(device="cuda").manual_seed(res.args.seed + res.args.index)
    img_t, v2d_t = torch.from_numpy(img).cuda(), torch.from_numpy(v2d).cuda()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = pred.predict(img_t, v2d_t, generator=gen)
        torch.cuda.synchronize()
    # the same request: the same inputs and step noise (the sums' order may
    # differ from run to run)
    ref = torch.from_numpy(res.prediction)
    if not (out.cpu() - ref).abs().max() <= CARD_VS_CPU_TOL * ref.abs().max():
        raise RuntimeError("the profiled DDPM request differs from the CLI's")
    device_ms = sum(e.time_range.end - e.time_range.start for e in prof.events()
                    if e.device_type == DeviceType.CUDA) / 1e3
    wall_ms = res.seconds * 1e3
    return {"num_timesteps": t_short, "request_ms": wall_ms, "device_ms": device_ms,
            "host_share": max(0.0, 1.0 - device_ms / wall_ms)}


def phase_entry_point(smi: str, run_dir: str, written: str, written_pred) -> dict:
    """The port's CLI on the run dir ``write_entry_point_dirs`` wrote, once
    for each sampler."""
    import numpy as np

    from diffusion_model_project_tpu_torch import inference
    from diffusion_model_project_tpu_torch.ops.cuda import attention as k2
    from diffusion_model_project_tpu_torch.ops.cuda import conv3x3 as k3
    from diffusion_model_project_tpu_torch.ops.cuda import groupnorm_act as k1

    runs = {}
    for sampler, steps in EP_SAMPLERS:
        extra = [] if sampler == "ddpm" else ["--steps", str(steps)]
        evals = dpm_evaluations(written_pred, steps) if sampler == "dpm" else steps
        k1.LAUNCHES = k2.LAUNCHES = k3.LAUNCHES = 0
        t0 = time.perf_counter()
        res = inference.run(["--model-dir", run_dir, "--sampler", sampler, *extra])
        cli_s = time.perf_counter() - t0
        launches = {"groupnorm_act": k1.LAUNCHES, "fused_attention": k2.LAUNCHES,
                    "conv3x3": k3.LAUNCHES}
        expected = {"groupnorm_act": 38 * evals + 26, "fused_attention": 6 * evals,
                    "conv3x3": 0}
        # the same counts from the modules the path runs
        if expected_calls(written_pred, evals) != (38 * evals + 26, 6 * evals):
            raise RuntimeError(f"the published predictor's GroupNorm / attention counts "
                               f"are {expected_calls(written_pred, evals)}")
        loaded = state_checksum(res.predictor)
        pred_out = res.prediction
        mask = np.broadcast_to(res.img == 0, pred_out.shape)
        ok_out = (pred_out.shape == (1, S, 3, HW, HW) and bool(np.isfinite(pred_out).all())
                  and not pred_out[mask].any())
        r = {"evaluations": evals, "launches": launches, "expected": expected,
             "checksum_equal": loaded == written, "request_ms": res.seconds * 1e3,
             "volumes_per_s": 1.0 / res.seconds, "cli_s": cli_s,
             "max_abs_v": float(np.abs(pred_out).max()), "output_ok": ok_out}
        runs[sampler] = r
        log(f"[entry point] --sampler {' '.join([sampler] + extra)}: {evals} UNet "
            f"evaluations; launches {launches} (expected {expected}); checksum "
            f"{'equal' if r['checksum_equal'] else 'DIFFERENT'}; output "
            f"{pred_out.shape} finite and masked: {ok_out}, max |v| {r['max_abs_v']:.4e}")
        log(f"[entry point] --sampler {sampler}: request {r['request_ms']:.1f} ms, "
            f"{r['volumes_per_s']:.4f} volumes/s (B=1, float32; the CLI call "
            f"{cli_s:.1f} s with loading) | {smi}")
        if launches != expected:
            raise RuntimeError(f"--sampler {sampler} did not go through the kernels as "
                               f"expected: {launches} against {expected}")
        if not r["checksum_equal"]:
            raise RuntimeError(f"--sampler {sampler}: the loaded weights differ from the "
                               f"written ones")
        if not ok_out:
            raise RuntimeError(f"--sampler {sampler}: bad output")
        del res
    # the kernels at the shapes and dtype the CLI gives them: every
    # GroupNorm and attention input of one DDIM-50 request, recorded by
    # a global forward hook in a run of its own (a hook costs host time)
    seen, handles = record_shapes()
    try:
        inference.run(["--model-dir", run_dir, "--sampler", "ddim", "--steps", "50"])
    finally:
        for h in handles:
            h.remove()
    recorded = {name: sum(v for k, v in seen.items() if k[0] == name)
                for name in ("groupnorm_act", "fused_attention")}
    log(f"[entry point] the DDIM-50 request's kernel inputs: {len(seen)} (shape, dtype) "
        f"pairs, dtypes {sorted({k[-1] for k in seen})}, calls {recorded}")
    if recorded != {k: runs["ddim"]["expected"][k] for k in recorded}:
        raise RuntimeError(f"the DDIM-50 request's hooks saw {recorded} calls")
    share = ddpm_host_share(run_dir)
    log(f"[entry point] DDPM request of the CLI at T={share['num_timesteps']} (the run dir's "
        f"weights, log.json's T set to {share['num_timesteps']}): {share['request_ms']:.1f} "
        f"ms wall, {share['device_ms']:.1f} ms on the device: host share "
        f"{share['host_share']:.3f} | {smi}")
    return {"runs": runs, "shapes": seen, "ddpm_request_host_share": share}


def module_calls(pred) -> dict:
    """GroupNorm calls of each VAE branch and of the UNet, and the UNet's
    attention calls, counted from the modules."""
    from diffusion_model_project_tpu_torch.models.layers import GroupNorm, MultiheadSelfAttention

    def count(module, cls):
        return sum(isinstance(m, cls) for m in module.modules())

    out = {name: count(getattr(pred.vae, name), GroupNorm)
           for name in ("encoder_2d", "encoder_3d", "decoder_2d", "decoder_3d")}
    return {**out, "unet": count(pred.model, GroupNorm),
            "attention": count(pred.model, MultiheadSelfAttention)}


def _launches() -> dict:
    from diffusion_model_project_tpu_torch.ops.cuda import attention as k2
    from diffusion_model_project_tpu_torch.ops.cuda import conv3x3 as k3
    from diffusion_model_project_tpu_torch.ops.cuda import groupnorm_act as k1

    return {"groupnorm_act": k1.LAUNCHES, "fused_attention": k2.LAUNCHES, "conv3x3": k3.LAUNCHES}


def _zero_launches() -> None:
    from diffusion_model_project_tpu_torch.ops.cuda import attention as k2
    from diffusion_model_project_tpu_torch.ops.cuda import conv3x3 as k3
    from diffusion_model_project_tpu_torch.ops.cuda import groupnorm_act as k1

    k1.LAUNCHES = k2.LAUNCHES = k3.LAUNCHES = 0


def _check_launches(path: str, launches: dict, gn: int, attn: int) -> dict:
    expected = {"groupnorm_act": gn, "fused_attention": attn, "conv3x3": 0}
    if launches != expected:
        raise RuntimeError(f"{path} did not go through the kernels as expected: {launches} "
                           f"against {expected}")
    return expected


def phase_evaluation(smi: str, run_dir: str, vae_dir: str, data_dir: str, written_pred,
                     held: set) -> dict:
    """The port's evaluation entry points on the entry point's run dir,
    float32: (a) ``evaluate`` at B=2; (b) ``eval_testset_end2end`` over the
    test split: DDIM-50 at batch 1 and 2, DPM-10, --sanity-mode and
    --cross-mode; (c) ``inference_vae.run`` in modes 2d, 3d and cross. Each
    run's launches must equal the counts derived from the modules (K3 never).
    Then one more run of each path under a global forward hook records the
    GroupNorm and attention inputs; the (shape, dtype) pairs outside ``held``
    (those of the earlier phases) are returned for phase "eval kernels"."""
    import numpy as np

    from diffusion_model_project_tpu_torch import evaluate, inference_vae
    from diffusion_model_project_tpu_torch.scripts import eval_testset_end2end as e2e

    calls = module_calls(written_pred)
    unet_gn, unet_attn = calls["unet"], calls["attention"]
    out_root = os.path.join(os.path.dirname(run_dir), "eval_out")
    res = {"evaluate": None, "end2end": {}, "inference_vae": {}}

    # (a) evaluate: per batch E3D encode_target, E2D conditioning, one UNet evaluation
    _zero_launches()
    t0 = time.perf_counter()
    ev = evaluate.run(["--model-dir", run_dir])
    cli_s = time.perf_counter() - t0
    nb = len(ev.losses)
    expected = _check_launches(
        "evaluate", _launches(), nb * (calls["encoder_3d"] + calls["encoder_2d"] + unet_gn),
        nb * unet_attn)
    with open(ev.result_path) as f:
        written = f.read().splitlines()
    if not (nb >= 2 and np.isfinite(ev.test_loss) and written[1] == f"test_loss: {ev.test_loss}"):
        raise RuntimeError(f"evaluate: {nb} batches, loss {ev.test_loss}, wrote {written}")
    res["evaluate"] = {"batches": nb, "batch_size": EVAL_B, "losses": ev.losses,
                       "test_loss": ev.test_loss, "batch_seconds": ev.batch_seconds,
                       "cli_s": cli_s, "launches": expected}
    log(f"[evaluation] evaluate: {nb} test batches (B={EVAL_B}, the last short), loss "
        f"{ev.test_loss:.6f} ({EVAL_COST}); launches {expected}; seconds a batch "
        + ", ".join(f"{x:.3f}" for x in ev.batch_seconds) + f"; the CLI call {cli_s:.1f} s | {smi}")

    # (b) the end-to-end script; per chunk: E2D + sampler's UNet evaluations + D3D,
    # or the VAE-only path's two halves
    ddim_gn, ddim_attn = expected_calls(written_pred, STEPS)
    dpm_evals = dpm_evaluations(written_pred, 10)
    modes = {
        "ddim_b1": (["--sampler", "ddim", "--steps", str(STEPS)], ddim_gn, ddim_attn),
        "ddim_b2": (["--sampler", "ddim", "--steps", str(STEPS), "--batch-size", "2"],
                    ddim_gn, ddim_attn),
        "dpm10": (["--sampler", "dpm", "--steps", "10"],
                  *expected_calls(written_pred, dpm_evals)),
        "sanity": (["--sanity-mode"], calls["encoder_3d"] + calls["decoder_3d"], 0),
        "cross": (["--cross-mode"], calls["encoder_2d"] + calls["decoder_3d"], 0),
    }
    base = ["--diffusion-model-path", run_dir, "--dataset-dir", data_dir]
    for name, (flags, gn, attn) in modes.items():
        _zero_launches()
        r = e2e.run(base + flags + ["--output-dir", os.path.join(out_root, name)])
        rows = r.per_sample
        chunks = -(-len(rows) // r.args.batch_size)
        expected = _check_launches(f"eval_testset_end2end {name}", _launches(),
                                   chunks * gn, chunks * attn)
        with open(r.json_path) as f:
            report = json.load(f)
        ok = (len(rows) == 3 and [x["sample_id"] for x in report["per_sample_results"]]
              == [0, 1, 2] and all(np.isfinite(x["nmae_total"]) for x in rows))
        if not ok:
            raise RuntimeError(f"eval_testset_end2end {name}: bad report {r.json_path}")
        res["end2end"][name] = {
            "chunks": chunks, "launches": expected, "evaluation_mode": report["evaluation_mode"],
            "nmae_total": [x["nmae_total"] for x in rows],
            "time_sec": [x["time_sec"] for x in rows], "steady_s_per_sample": r.steady_seconds,
            "mean_s_per_sample": float(np.mean([x["time_sec"] for x in rows]))}
        log(f"[evaluation] eval_testset_end2end {' '.join(flags)}: {len(rows)} samples in "
            f"{chunks} chunks; launches {expected}; nMAE "
            + ", ".join(f"{x['nmae_total']:.4f}" for x in rows)
            + "; s a sample " + ", ".join(f"{x['time_sec']:.3f}" for x in rows)
            + f"; steady {r.steady_seconds:.3f}, mean "
            f"{res['end2end'][name]['mean_s_per_sample']:.3f} s a sample | {smi}")
    # the host's share of a sample: the metric suite on one 256^2 x 11 sample
    from diffusion_model_project_tpu_torch.losses.eval_metrics import compute_all_metrics

    rng = np.random.default_rng(9)
    pred_np, target_np = rng.standard_normal((2, 1, S, 3, HW, HW)).astype(np.float32)
    mask_np = (rng.random((1, S, 1, HW, HW)) > 0.3).astype(np.float32)
    t0 = time.perf_counter()
    for _ in range(3):
        compute_all_metrics(pred_np, target_np, NORM_OUTPUT, mask=mask_np)
    res["metrics_s_per_sample"] = (time.perf_counter() - t0) / 3
    log(f"[evaluation] the metric suite (compute_all_metrics, host): "
        f"{res['metrics_s_per_sample'] * 1e3:.1f} ms a sample | {smi}")
    b1, b2 = (np.asarray(res["end2end"][k]["nmae_total"]) for k in ("ddim_b1", "ddim_b2"))
    rel = float(np.abs(b2 - b1).max() / np.abs(b1).max())
    res["ddim_batch_rel_diff"] = rel
    log(f"[evaluation] DDIM-50 per-sample nMAE, batch 2 against batch 1: max rel diff "
        f"{rel:.3e} (tol 1e-3)")
    if not rel <= 1e-3:
        raise RuntimeError(f"DDIM-50 at batch 2 differs from batch 1: {rel:.3e}")

    # (c) inference_vae: one encode and one decode a mode
    vae_modes = {"2d": ("encoder_2d", "decoder_2d"), "3d": ("encoder_3d", "decoder_3d"),
                 "cross": ("encoder_2d", "decoder_3d")}
    for mode, (enc, dec) in vae_modes.items():
        _zero_launches()
        r = inference_vae.run(["--vae-path", vae_dir, "--dataset-dir", data_dir, "--mode", mode])
        expected = _check_launches(f"inference_vae --mode {mode}", _launches(),
                                   calls[enc] + calls[dec], 0)
        if not (r.model_type == "dual_full" and np.isfinite(r.metrics["mae_total"])
                and r.metrics["mae_total"] > 0):
            raise RuntimeError(f"inference_vae --mode {mode}: {r.model_type}, {r.metrics}")
        res["inference_vae"][mode] = {"metrics": r.metrics, "seconds": r.seconds,
                                      "launches": expected}
        log(f"[evaluation] inference_vae --mode {mode}: masked MAE {r.metrics['mae_total']:.6f}; "
            f"launches {expected}; encode + decode {r.seconds * 1e3:.1f} ms | {smi}")

    # the kernels' inputs on these paths, in runs of their own (a hook costs host time)
    seen, handles = record_shapes()
    try:
        evaluate.run(["--model-dir", run_dir])
        for name in ("ddim_b2", "sanity", "cross"):
            e2e.run(base + modes[name][0] + ["--num-samples", "2" if name == "ddim_b2" else "1",
                                             "--output-dir", os.path.join(out_root, "hooked")])
        for mode in vae_modes:
            inference_vae.run(["--vae-path", vae_dir, "--dataset-dir", data_dir, "--mode", mode])
    finally:
        for h in handles:
            h.remove()
    new = {k: v for k, v in seen.items() if k not in held}
    log(f"[evaluation] the kernels' inputs on these paths: {len(seen)} (shape, dtype) pairs, "
        f"{len(new)} not held by an earlier phase: "
        + ", ".join(f"{k[0]} {k[1]}" for k in sorted(new, key=str)))
    res["shapes"] = seen
    res["new_shapes"] = new
    return res


# the training phase: the published UNet on phase 8's dataset and VAE dir
TRAIN_B, TRAIN_EPOCHS, OVERFIT_STEPS = 2, 2, 30
TRAIN_PHYSICS = ["--lambda-div", "0.1", "--lambda-flow", "0.1", "--lambda-smooth", "0.01",
                 "--lambda-laplacian", "0.01", "--lambda-velocity", "0.1",
                 "--physics-loss-freq", "2"]
TRAIN_TOL = 1e-3  # resume: epoch 1's losses, relative; card vs CPU: UNet gradients
_ZERO = {"groupnorm_act": 0, "fused_attention": 0, "conv3x3": 0}
TRAIN_DEVICE = "cuda"  # the training phase's device (a CPU rehearsal sets "cpu")


def _sync() -> None:
    if TRAIN_DEVICE == "cuda":
        torch.cuda.synchronize()


def train_argv(data_dir: str, vae_dir: str, save_dir: str, *extra) -> list:
    """The port's train CLI at the published UNet (PUBLISHED_UNET_KWARGS), B=2."""
    from diffusion_model_project_tpu_torch.utils.config import PUBLISHED_UNET_KWARGS as kw

    return ["--root-dir", data_dir, "--save-dir", save_dir, "--vae-path", vae_dir,
            "--in-channels", str(kw["in_channels"]), "--out-channels", str(kw["out_channels"]),
            "--features", *map(str, kw["features"]), "--attention", kw["attention"],
            "--kernel-size", str(kw["kernel_size"]), "--padding-mode", kw["padding_mode"],
            "--num-slices", str(S), "--num-timesteps", "1000", "--batch-size", str(TRAIN_B),
            "--shuffle", "true", "--cost-function", EVAL_COST, "--device", TRAIN_DEVICE,
            *extra]


class TrainRecorder:
    """Wraps every step the trainer builds (``training/helper.py``'s train and
    validation steps, ``train_diffusion.py``'s test step): each call's host
    time (synchronized before and after), its launches and its values."""

    def __init__(self):
        self.steps = []

    def __enter__(self):
        from diffusion_model_project_tpu_torch.training import helper, train_diffusion

        self._saved = [(helper, "make_diffusion_train_step"),
                       (helper, "make_diffusion_eval_step"),
                       (train_diffusion, "make_diffusion_eval_step")]
        self._orig = [getattr(m, n) for m, n in self._saved]
        for (mod, name), orig, kind in zip(self._saved, self._orig, ("train", "val", "test")):
            setattr(mod, name, self._wrap(orig, kind))
        return self

    def __exit__(self, *exc):
        for (mod, name), orig in zip(self._saved, self._orig):
            setattr(mod, name, orig)

    def _wrap(self, factory, kind):
        def make(*args, **kwargs):
            if kind == "train":
                physics = kwargs.get("physics")
                heavy = ((physics is not None and physics.is_active())
                         or kwargs.get("lambda_velocity", 0) > 0
                         or kwargs.get("velocity_loss_primary", False))
                label = "train_heavy" if heavy else "train_plain"
            else:
                label = kind
            step = factory(*args, **kwargs)

            def run(*a, **kw):
                _sync()
                before = _launches()
                t0 = time.perf_counter()
                out = step(*a, **kw)
                _sync()
                secs = time.perf_counter() - t0
                after = _launches()
                self.steps.append({"kind": label, "seconds": secs,
                                   "launches": {k: after[k] - before[k] for k in after},
                                   "values": {k: float(v) for k, v in out.items()}})
                return out
            return run
        return make

    def of(self, *kinds) -> list:
        return [s for s in self.steps if s["kind"] in kinds]


def _newest_run(save_dir: str) -> str:
    runs = sorted(os.listdir(save_dir))
    if len(runs) != 1:
        raise RuntimeError(f"{save_dir} holds {runs}, one run dir expected")
    return os.path.join(save_dir, runs[0])


def _read_log(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "log.json")) as f:
        return json.load(f)


def check_step_launches(label: str, rec, calls: dict) -> tuple:
    """Each recorded step's launches against the module-derived counts: in a
    train step the frozen encodes' (E3D + E2D GroupNorms; the UNet and D3D
    run plain under autograd), in a validation or test step E3D + E2D + UNet
    GroupNorms, with D3D's where the step reconstructs the velocity, and the
    UNet's attentions. Returns the launches summed over the train steps and
    over the others."""
    for st in rec.steps:
        if st["kind"].startswith("train"):
            want = {**_ZERO, "groupnorm_act": calls["encoder_3d"] + calls["encoder_2d"]}
        else:
            physics = "div_mean" in st["values"]
            want = {"groupnorm_act": calls["encoder_3d"] + calls["encoder_2d"] + calls["unet"]
                    + (calls["decoder_3d"] if physics else 0),
                    "fused_attention": calls["attention"], "conv3x3": 0}
        if st["launches"] != want:
            raise RuntimeError(f"[training] {label}: a {st['kind']} step launched "
                               f"{st['launches']}, expected {want}")

    def launched(train):
        return {k: sum(st["launches"][k] for st in rec.steps
                       if st["kind"].startswith("train") == train) for k in _ZERO}

    return launched(True), launched(False)


def train_run(label: str, argv: list, calls: dict, smi: str, run_dir=None) -> dict:
    """One call of the port's train CLI with the launch counters set to 0
    before it and read after it, every step timed and its launches checked
    against the module-derived counts: in each train step the frozen encodes'
    (E3D + E2D GroupNorms; the UNet and D3D run plain under autograd); in
    each validation and test step E3D + E2D + UNet GroupNorms, with D3D's
    where the step reconstructs the velocity, and the UNet's attentions."""
    from diffusion_model_project_tpu_torch import train as train_cli

    cuda = TRAIN_DEVICE == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    with TrainRecorder() as rec:
        train_cli.main(argv)
    wall = time.perf_counter() - t0
    total = _launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else float("nan")
    run_dir = run_dir or _newest_run(argv[argv.index("--save-dir") + 1])
    log_json = _read_log(run_dir)
    train_launches, eval_launches = check_step_launches(label, rec, calls)
    if total != {k: train_launches[k] + eval_launches[k] for k in _ZERO}:
        raise RuntimeError(f"[training] {label}: the run launched {total}, its train steps "
                           f"{train_launches} and its eval steps {eval_launches}")
    losses = log_json["train_loss"] + log_json["val_loss"] + [log_json.get("test_loss", 0.0)]
    values = [v for st in rec.steps for v in st["values"].values()]
    if not all(math.isfinite(x) for x in losses + values):
        raise RuntimeError(f"[training] {label}: a loss or component is not finite: {log_json}")
    files = sorted(os.listdir(run_dir))

    def secs(*kinds):
        return [round(st["seconds"], 4) for st in rec.of(*kinds)]

    train_s = secs("train_plain", "train_heavy")
    out = {"run_dir": os.path.basename(run_dir), "wall_s": wall, "peak_gib": peak,
           "launches": total, "train_step_launches": train_launches,
           "eval_launches": eval_launches, "epoch_s": log_json["time"],
           "train_loss": log_json["train_loss"], "val_loss": log_json["val_loss"],
           "test_loss": log_json.get("test_loss"), "files": files,
           "train_plain_s": secs("train_plain"), "train_heavy_s": secs("train_heavy"),
           "val_s": secs("val"), "test_s": secs("test"),
           "steady_train_s": (sum(train_s[1:]) / len(train_s[1:])) if len(train_s) > 1
           else None,
           "heavy_values": [st["values"] for st in rec.of("train_heavy")]}
    log(f"[training] {label}: {len(train_s)} train steps, s a step "
        + ", ".join(f"{x:.3f}" for x in train_s)
        + (f" (plain {', '.join(f'{x:.3f}' for x in out['train_plain_s'])}; heavy "
           f"{', '.join(f'{x:.3f}' for x in out['train_heavy_s'])})" if out["train_heavy_s"]
           else "")
        + f"; validation batch s {', '.join(f'{x:.3f}' for x in out['val_s'])}; test batch s "
        f"{', '.join(f'{x:.3f}' for x in out['test_s'])}; epoch s "
        + ", ".join(f"{x:.2f}" for x in log_json["time"])
        + f"; the CLI call {wall:.1f} s; peak memory {peak:.2f} GiB | {smi}")
    log(f"[training] {label}: launches over the train steps {train_launches} (the frozen "
        f"E3D + E2D encodes; module-derived), over the validation and test passes "
        f"{eval_launches} (module-derived); "
        f"train loss {log_json['train_loss']}, val loss {log_json['val_loss']}, test loss "
        f"{log_json.get('test_loss')}; run dir files {files}")
    return out


class _GradCapture:
    """An optimizer that leaves the parameters alone: a step's gradients stay in ``.grad``."""

    def __init__(self, module):
        self.params = list(module.parameters())

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            p.grad = None

    def step(self):
        pass


def train_card_vs_cpu() -> dict:
    """One train step's UNet gradients on the card and on the CPU, published
    widths at 128^2 x 3, B=1, float32 with TF32 off, from the same weights,
    batch, noise and t: plain, and with the physics and velocity losses."""
    from diffusion_model_project_tpu_torch.losses.physics import PhysicsLoss
    from diffusion_model_project_tpu_torch.training.steps import make_diffusion_train_step

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        hw, s = 128, 3
        cpu = published_predictor(torch.device("cpu"), torch.float32, seed=13)
        gpu = copy.deepcopy(cpu).to(TRAIN_DEVICE)
        img, vel, noise = make_inputs(1, s, hw, seed=14)
        gen = torch.Generator().manual_seed(15)
        batch = {"img": img, "U_2d": vel, "U": torch.randn((1, s, 3, hw, hw), generator=gen) * 1e-2}
        t = torch.randint(0, 1000, (s,), generator=gen)
        out = {}
        for name, kw in (("plain", {}),
                         ("physics", dict(physics=PhysicsLoss(0.1, 0.1, 0.01, 0.01),
                                          lambda_velocity=0.1))):
            grads, cpu_s = {}, None
            for pred, d in ((cpu, "cpu"), (gpu, TRAIN_DEVICE)):
                pred.model.requires_grad_(True)
                step = make_diffusion_train_step(_GradCapture(pred.model), cost_name=EVAL_COST,
                                                 **kw)
                t0 = time.perf_counter()
                step(pred, {k: v.to(d) for k, v in batch.items()}, noise=noise.to(d), t=t.to(d))
                if d == "cpu":
                    cpu_s = time.perf_counter() - t0
                grads["cpu" if pred is cpu else "card"] = torch.cat(
                    [p.grad.reshape(-1).cpu() for p in pred.model.parameters()])
                pred.model.requires_grad_(False)
                pred.model.zero_grad(set_to_none=True)
            rel = ((grads["card"] - grads["cpu"]).abs().max() / grads["cpu"].abs().max()).item()
            log(f"[training] card vs CPU, one train step's UNet gradients ({name}), published "
                f"widths, {s}x{hw}^2, B=1, float32, TF32 off: max|g_card - g_cpu| / max|g_cpu| "
                f"= {rel:.3e} (tol {TRAIN_TOL:.0e}); cpu {cpu_s:.1f} s")
            if not (torch.isfinite(grads["card"]).all() and rel <= TRAIN_TOL):
                raise RuntimeError(f"train step gradients ({name}): card and CPU disagree, {rel:.3e}")
            out[name] = {"rel_err": rel, "tol": TRAIN_TOL, "cpu_s": cpu_s}
        return out
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def train_overfit_and_profile(log_a: dict, data_dir: str, smi: str) -> dict:
    """(e) 30 steps (lr 1e-4) on one fixed batch with fixed noise and t: the
    loss must end below where it started; then one more plain step under
    torch.profiler, its device time by kernel (where a train step's time goes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diffusion_model_project_tpu_torch.data import get_loader
    from diffusion_model_project_tpu_torch.training.helper import _batch_dict, set_model
    from diffusion_model_project_tpu_torch.training.steps import make_diffusion_train_step
    from diffusion_model_project_tpu_torch.training.train_diffusion import make_optimizer

    td = log_a["params"]["training"]
    pred = set_model(td["predictor_type"], td["predictor"],
                     os.path.join(data_dir, "statistics.json"), seed=0, device=TRAIN_DEVICE)
    pred.model.requires_grad_(True)
    opt = make_optimizer(pred.model, 1e-4)
    step = make_diffusion_train_step(opt, cost_name=EVAL_COST)
    train_loader = get_loader(data_dir, batch_size=TRAIN_B, use_3d=True)[0][0]
    batch = _batch_dict(next(iter(train_loader)), TRAIN_DEVICE)
    gen = torch.Generator().manual_seed(16)
    noise = torch.randn((TRAIN_B * S, 8, HW // 4, HW // 4), generator=gen).to(TRAIN_DEVICE)
    t = torch.randint(0, 1000, (TRAIN_B * S,), generator=gen).to(TRAIN_DEVICE)
    _sync()
    t0 = time.perf_counter()
    losses = torch.stack([step(pred, batch, noise=noise, t=t)["loss"]
                          for _ in range(OVERFIT_STEPS)]).tolist()
    overfit_s = (time.perf_counter() - t0) / OVERFIT_STEPS
    log(f"[training] overfit: {OVERFIT_STEPS} steps on one batch (fixed noise and t, lr 1e-4): "
        f"loss {losses[0]:.6f} -> {losses[-1]:.6f} (min {min(losses):.6f}); "
        f"{overfit_s:.4f} s a step back to back | {smi}")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise RuntimeError(f"overfit: the loss did not fall: {losses}")

    _sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(pred, batch, noise=noise, t=t)
        _sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            k = kernels[e.name]
            k[0] += (e.time_range.end - e.time_range.start) / 1e3
            k[1] += 1
    device_ms = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:20]
    log(f"[training] one plain train step under torch.profiler: {wall_ms:.1f} ms wall, "
        f"{device_ms:.1f} ms on the device ({len(kernels)} kernel names, "
        f"{sum(v[1] for v in kernels.values())} launches) | {smi}")
    for name, (ms, n) in top:
        log(f"[training]   {ms:9.3f} ms {n:5d}x  {name[:110]}")
    del pred, opt
    return {"losses": losses, "overfit_s_per_step": overfit_s,
            "profile": {"wall_ms": wall_ms, "device_ms": device_ms,
                        "kernels": [{"name": n, "ms": ms, "count": c} for n, (ms, c) in
                                    sorted(kernels.items(), key=lambda kv: -kv[1][0])]}}


def phase_training(smi: str, data_dir: str, vae_dir: str, written_pred, root: str) -> dict:
    """The port's diffusion training (``python -m diffusion_model_project_tpu_torch.train``)
    at the published UNet on phase 8's dataset (12 samples of 256^2 x 11:
    8 train, 1 validation, 3 test) and VAE dir: (a) 2 epochs, B=2, float32;
    (b) the physics and velocity losses, 1 epoch; (c) 1 epoch, then --resume
    to 2, epoch 1's losses against (a)'s; (d) the inference CLI, DDIM-50, on
    (a)'s run dir; (e) overfitting one batch, and one train step profiled;
    (f) one train step's UNet gradients on the card against the CPU; (g) 1
    epoch in bfloat16. Then the kernels' inputs in the validation and test
    passes, recorded by a hook in runs of their own."""
    from diffusion_model_project_tpu_torch import inference
    from diffusion_model_project_tpu_torch.data import get_loader
    from diffusion_model_project_tpu_torch.training.helper import _batch_dict
    from diffusion_model_project_tpu_torch.training.steps import (make_diffusion_eval_step,
                                                                  make_diffusion_train_step)

    calls = module_calls(written_pred)
    base = os.path.join(root, "train")
    res = {}
    t_phase = time.perf_counter()

    # (a) train mode, 2 epochs
    run_a = train_run("(a) train, 2 epochs, B=2, float32",
                      train_argv(data_dir, vae_dir, os.path.join(base, "a"),
                                 "--num-epochs", str(TRAIN_EPOCHS)), calls, smi)
    want = ["best_model.msgpack", "log.json", "model.msgpack", "train_state.msgpack"]
    if run_a["files"] != want:
        raise RuntimeError(f"(a): the run dir holds {run_a['files']}, expected {want}")
    res["a"] = run_a
    dir_a = os.path.join(base, "a", run_a["run_dir"])
    log_a = _read_log(dir_a)

    # (b) physics
    run_b = train_run("(b) physics and velocity losses, 1 epoch",
                      train_argv(data_dir, vae_dir, os.path.join(base, "b"),
                                 "--num-epochs", "1", *TRAIN_PHYSICS), calls, smi)
    comps = {"divergence", "flow_rate", "smoothness", "laplacian", "velocity_loss",
             "loss_u", "loss_v", "loss_w"}
    if not (run_b["train_heavy_s"] and run_b["train_plain_s"]
            and all(comps <= set(v) for v in run_b["heavy_values"])):
        raise RuntimeError(f"(b): heavy {run_b['train_heavy_s']}, plain "
                           f"{run_b['train_plain_s']}, components {run_b['heavy_values']}")
    log(f"[training] (b) heavy step components: " + "; ".join(
        ", ".join(f"{k} {v[k]:.4e}" for k in sorted(comps)) for v in run_b["heavy_values"]))
    res["b"] = run_b
    shutil.rmtree(os.path.join(base, "b"))

    # (c) resume
    save_c = os.path.join(base, "c")
    argv_c = train_argv(data_dir, vae_dir, save_c, "--num-epochs", "1")
    first = train_run("(c) 1 epoch", argv_c, calls, smi)
    dir_c = os.path.join(save_c, first["run_dir"])
    resumed = train_run("(c) --resume to 2 epochs",
                        train_argv(data_dir, vae_dir, save_c, "--num-epochs",
                                   str(TRAIN_EPOCHS), "--resume", dir_c), calls, smi,
                        run_dir=dir_c)
    log_c = _read_log(dir_c)
    diffs = {k: abs(log_c[k][1] - log_a[k][1]) / abs(log_a[k][1])
             for k in ("train_loss", "val_loss")}
    log(f"[training] (c) resume: epoch 1 train loss {log_c['train_loss'][1]!r} against (a)'s "
        f"{log_a['train_loss'][1]!r}, val loss {log_c['val_loss'][1]!r} against "
        f"{log_a['val_loss'][1]!r}: relative differences {diffs['train_loss']:.3e} / "
        f"{diffs['val_loss']:.3e} (tol {TRAIN_TOL:.0e}); epoch 0 {log_c['train_loss'][0]!r} / "
        f"{log_a['train_loss'][0]!r}")
    if not (log_c["epoch"] == [0, 1] and max(diffs.values()) <= TRAIN_TOL):
        raise RuntimeError(f"(c): the resumed run differs from (a): {diffs}, {log_c['epoch']}")
    res["c"] = {"first": first, "resumed": resumed, "rel_diff_epoch1": diffs}
    shutil.rmtree(save_c)

    # (d) the inference CLI on (a)'s run dir
    _zero_launches()
    cli = inference.run(["--model-dir", dir_a, "--sampler", "ddim", "--steps", str(STEPS),
                         "--device", TRAIN_DEVICE])
    launched = _launches()
    gn, attn = expected_calls(cli.predictor, STEPS)
    ok = (cli.prediction.shape == (1, S, 3, HW, HW)
          and bool(torch.isfinite(torch.from_numpy(cli.prediction)).all()))
    log(f"[training] (d) inference CLI, DDIM-{STEPS}, on (a)'s run dir: output "
        f"{cli.prediction.shape} finite: {ok}; request {cli.seconds * 1e3:.1f} ms; launches "
        f"{launched} (expected {gn} / {attn} / 0)")
    if not ok or launched != {"groupnorm_act": gn, "fused_attention": attn, "conv3x3": 0}:
        raise RuntimeError(f"(d): output ok {ok}, launches {launched}")
    res["d"] = {"request_ms": cli.seconds * 1e3, "launches": launched}
    del cli

    # (e) overfit one batch; one train step profiled
    res["e"] = train_overfit_and_profile(log_a, data_dir, smi)

    # (f) card vs CPU
    res["f"] = train_card_vs_cpu()

    # (g) bf16
    run_g = train_run("(g) bfloat16, 1 epoch",
                      train_argv(data_dir, vae_dir, os.path.join(base, "g"), "--num-epochs",
                                 "1", "--compute-dtype", "bfloat16"), calls, smi)
    res["g"] = run_g
    shutil.rmtree(os.path.join(base, "g"))

    # the kernels' inputs in the validation and test passes (batches of 2 and
    # of 1, float32 and bfloat16, with and without physics metrics) and in a
    # train step's frozen encodes (a batch of 2, each dtype)
    from diffusion_model_project_tpu_torch.utils.checkpoint import predictor_from_directory

    pred, _ = predictor_from_directory(dir_a, device=TRAIN_DEVICE)
    loaders = get_loader(data_dir, batch_size=TRAIN_B, use_3d=True)[0]
    batches = [_batch_dict(d, TRAIN_DEVICE) for d in loaders[2]]
    train_step = make_diffusion_train_step(_GradCapture(pred.model), cost_name=EVAL_COST)
    seen, handles = record_shapes()
    try:
        for dtype in (torch.float32, torch.bfloat16):
            pred.compute_dtype = dtype
            for physics in (False, True):
                step = make_diffusion_eval_step(cost_name=EVAL_COST, with_physics_metrics=physics)
                for b in batches:
                    step(pred, b, torch.Generator(device=TRAIN_DEVICE).manual_seed(0))
            pred.model.requires_grad_(True)
            train_step(pred, batches[0], torch.Generator(device=TRAIN_DEVICE).manual_seed(0))
            pred.model.requires_grad_(False)
            pred.model.zero_grad(set_to_none=True)
    finally:
        for h in handles:
            h.remove()
    del pred
    shutil.rmtree(base)
    res["shapes"] = seen
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[training] the phase took {res['seconds']:.1f} s | {smi}")
    return res


# the VAE training phase: the port's stage-1 / stage-2 trainers on phase 8's dataset
VAE_EPOCHS, VAE_OVERFIT_STEPS = 2, 30
VAE_STREAM_TOL, VAE_RESUME_TOL = 1e-4, 1e-3  # epoch 0 streamed / epoch 1 resumed, relative
VAE_LATENT, VAE_FEATURES = 8, None  # the reference's (None: 128/256/512; a rehearsal narrows)
VAE_CVC_HW = 128  # card vs CPU: 128^2 x 3, B=1


class VAERecorder:
    """Wraps the steps the VAE trainers build (``make_steps`` of
    ``training/train_vae_stage{1,2}.py``): each call's host time
    (synchronized before and after), its launches and its batch size."""

    def __init__(self):
        self.steps = []

    def __enter__(self):
        from diffusion_model_project_tpu_torch.training import train_vae_stage1, train_vae_stage2

        self._saved = [(m, m.make_steps) for m in (train_vae_stage1, train_vae_stage2)]
        for mod, orig in self._saved:
            mod.make_steps = self._wrap(orig, "s1" if mod is train_vae_stage1 else "s2")
        return self

    def __exit__(self, *exc):
        for mod, orig in self._saved:
            mod.make_steps = orig

    def _wrap(self, factory, stage):
        def make(*args, **kwargs):
            train_step, apply_step, eval_step = factory(*args, **kwargs)

            def timed(step, kind):
                def run(batch, *a, **kw):
                    _sync()
                    before = _launches()
                    t0 = time.perf_counter()
                    out = step(batch, *a, **kw)
                    _sync()
                    secs = time.perf_counter() - t0
                    after = _launches()
                    self.steps.append({
                        "kind": f"{stage}_{kind}", "seconds": secs,
                        "batch": next(iter(batch.values())).shape[0],
                        "launches": {k: after[k] - before[k] for k in after},
                        "values": {k: float(v) for k, v in out.items()}})
                    return out
                return run
            return timed(train_step, "train"), apply_step, timed(eval_step, "eval")
        return make

    def of(self, kind) -> list:
        return [s for s in self.steps if s["kind"] == kind]


class _Tee:
    """Standard output copied into a buffer as it is written."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def vae_gn_calls(vae) -> dict:
    from diffusion_model_project_tpu_torch.models.layers import GroupNorm

    return {name: sum(isinstance(m, GroupNorm) for m in getattr(vae, name).modules())
            for name in ("encoder_2d", "encoder_3d", "decoder_2d", "decoder_3d")
            if hasattr(vae, name)}


def vae_run(label: str, main, argv: list, smi: str) -> dict:
    """One VAE trainer call with the launch counters set to 0 before it and
    read after it; every step timed and its launches held to the counts
    derived from the trained modules: a stage-1 train microbatch none (all of
    E3D / D3D needs a gradient), a stage-1 validation or test batch E3D + D3D;
    a stage-2 microbatch the frozen E3D encode, a stage-2 validation batch
    all four networks. K2 and K3 never."""
    cuda = TRAIN_DEVICE == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    out_buf = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with VAERecorder() as rec:
        old, sys.stdout = sys.stdout, out_buf
        try:
            vae, log_dict = main(argv)
        finally:
            sys.stdout = old
    wall = time.perf_counter() - t0
    total = _launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else float("nan")
    calls = vae_gn_calls(vae)
    stage = "s2" if "encoder_2d" in calls else "s1"
    want = ({"s1_train": 0, "s1_eval": calls.get("encoder_3d", 0) + calls.get("decoder_3d", 0)}
            if stage == "s1" else
            {"s2_train": calls["encoder_3d"], "s2_eval": sum(calls.values())})
    for st in rec.steps:
        expected = {**_ZERO, "groupnorm_act": want[st["kind"]]}
        if st["launches"] != expected:
            raise RuntimeError(f"[vae training] {label}: a {st['kind']} step launched "
                               f"{st['launches']}, expected {expected}")
    launched = {kind: {k: sum(s["launches"][k] for s in rec.of(kind)) for k in _ZERO}
                for kind in want}
    if total != {k: sum(v[k] for v in launched.values()) for k in _ZERO}:
        raise RuntimeError(f"[vae training] {label}: the run launched {total}, its steps "
                           f"{launched}")
    losses = [x for v in log_dict["loss"].values() for x in v]
    values = [x for st in rec.steps for k, x in st["values"].items() if k != "bad"]
    if not all(math.isfinite(x) for x in losses + values) or any(
            st["values"]["bad"] for st in rec.steps):
        raise RuntimeError(f"[vae training] {label}: a loss is not finite: {log_dict['loss']}")
    save_dir = argv[argv.index("--save-dir") + 1]

    def secs(kind, batch=None):
        return [round(s["seconds"], 4) for s in rec.of(kind) if batch in (None, s["batch"])]

    train_s, eval_s = secs(f"{stage}_train"), secs(f"{stage}_eval")
    out = {"wall_s": wall, "peak_gib": peak, "launches": total, "launches_by_step": launched,
           "per_step_launches": want, "train_s": train_s, "eval_s": eval_s,
           "eval_batches": [s["batch"] for s in rec.of(f"{stage}_eval")],
           "steady_train_s": sum(train_s[1:]) / len(train_s[1:]) if len(train_s) > 1 else None,
           "epoch_s": log_dict["epoch_time"], "loss": log_dict["loss"],
           "files": sorted(os.listdir(save_dir)), "stdout": "".join(out_buf.text)}
    log(f"[vae training] {label}: {len(train_s)} train microbatches, s each "
        + ", ".join(f"{x:.3f}" for x in train_s) + "; validation / test batches s "
        + ", ".join(f"{x:.3f} (B={b})" for x, b in zip(eval_s, out["eval_batches"]))
        + "; epoch s (vae_log.json) " + ", ".join(f"{x:.2f}" for x in log_dict["epoch_time"])
        + f"; the call {wall:.1f} s; peak memory {peak:.2f} GiB | {smi}")
    log(f"[vae training] {label}: launches a train microbatch / an eval batch "
        f"{want} (K1, module-derived; K2 0, K3 0), over the run {launched}; losses "
        + json.dumps(log_dict["loss"]) + f"; files {out['files']}")
    return out


def vae_card_vs_cpu() -> dict:
    """One stage-1 microbatch (fixed noise) and one stage-2 microbatch, the
    reference widths at 128^2 x 3, B=1, float32 with TF32 off, from the same
    weights on the card and on the CPU: each trainable parameter's gradient,
    max|g_card - g_cpu| / max|g_cpu|."""
    from diffusion_model_project_tpu_torch.models.layers import train_trace
    from diffusion_model_project_tpu_torch.models.vae import DualBranchVAE
    from diffusion_model_project_tpu_torch.training import train_vae_stage1 as s1
    from diffusion_model_project_tpu_torch.training import train_vae_stage2 as s2

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        hw, s = VAE_CVC_HW, 3
        gen = torch.Generator().manual_seed(21)
        mask = (torch.rand((1, 1, s, hw, hw), generator=gen) > 0.3).float()
        batch = {"velocity_2d": torch.randn((1, 3, s, hw, hw), generator=gen), "mask_2d": mask,
                 "velocity_3d": torch.randn((1, 3, s, hw, hw), generator=gen), "mask_3d": mask}
        batch["velocity_2d"][:, 2] = 0.0
        noise = torch.randn((1, VAE_LATENT, s, hw // 4, hw // 4), generator=gen)
        s1_vae = s1.Stage1VAE(3, VAE_LATENT, features=VAE_FEATURES)
        s1_vae.init_parameters_(torch.Generator().manual_seed(22))
        s2_vae = DualBranchVAE(3, VAE_LATENT, features=VAE_FEATURES or (128, 256, 512))
        s2_vae.init_parameters_(torch.Generator().manual_seed(23))
        for name in s2.FROZEN:
            getattr(s2_vae, name).requires_grad_(False)
        s2_vae.encoder_2d.remat = s2_vae.decoder_2d.remat = True
        out = {}
        for name, vae in (("stage 1", s1_vae), ("stage 2", s2_vae)):
            grads, cpu_s = {}, None
            card = copy.deepcopy(vae).to(TRAIN_DEVICE)
            for side, d in (("cpu", "cpu"), ("card", TRAIN_DEVICE), ("card again", TRAIN_DEVICE)):
                model = vae if side == "cpu" else card
                params = [p for p in model.parameters() if p.requires_grad]
                b = {k: v.to(d) for k, v in batch.items()}
                t0 = time.perf_counter()
                with train_trace():
                    if name == "stage 1":
                        loss, _ = s1.make_loss_fn(model, "normalized_mae_per_channel")(
                            {"velocity": b["velocity_3d"], "microstructure": b["mask_3d"]},
                            1e-3, noise=noise.to(d))
                    else:
                        loss, _ = s2.make_loss_fn(model, "normalized_mae_per_channel", 5.0,
                                                  50.0)(b)
                    g = torch.autograd.grad(loss, params)
                if side == "cpu":
                    cpu_s = time.perf_counter() - t0
                grads[side] = torch.cat([x.reshape(-1).cpu() for x in g])
                del model, g
            del card
            scale = grads["cpu"].abs().max()
            rel = ((grads["card"] - grads["cpu"]).abs().max() / scale).item()
            # the same microbatch twice on the card: nonzero where its kernels
            # (cuDNN's 3D conv backward) sum in a run-dependent order
            repeat = ((grads["card again"] - grads["card"]).abs().max() / scale).item()
            log(f"[vae training] (f) card vs CPU, one {name} microbatch's gradients, reference "
                f"widths, {s}x{hw}^2, B=1, float32, TF32 off: max|g_card - g_cpu| / max|g_cpu| "
                f"= {rel:.3e} (tol {CARD_VS_CPU_TOL:.0e}); the card against itself {repeat:.3e}; "
                f"cpu {cpu_s:.1f} s")
            if not (torch.isfinite(grads["card"]).all() and rel <= CARD_VS_CPU_TOL):
                raise RuntimeError(f"{name} gradients: card and CPU disagree, {rel:.3e}")
            out[name] = {"rel_err": rel, "tol": CARD_VS_CPU_TOL, "cpu_s": cpu_s,
                         "card_repeat_rel": repeat}
        return out
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def vae_overfit_and_profile(data_dir: str, s1_dir: str, smi: str) -> dict:
    """(g) 30 stage-1 steps (lr 1e-4, accum 1) on one fixed sample of the
    dataset with fixed noise: the loss must end below where it started.
    Then one stage-1 and one stage-2 microbatch (B=2) under torch.profiler,
    their device time by kind of kernel."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diffusion_model_project_tpu_torch.data.dataset import MicroFlowDatasetVAE
    from diffusion_model_project_tpu_torch.models.vae import DualBranchVAE
    from diffusion_model_project_tpu_torch.scripts.train_step_time import kind
    from diffusion_model_project_tpu_torch.training import train_vae_stage1 as s1
    from diffusion_model_project_tpu_torch.training import train_vae_stage2 as s2
    from diffusion_model_project_tpu_torch.utils.checkpoint import load_strict

    with open(os.path.join(s1_dir, "vae_log.json")) as f:
        s1_log = json.load(f)
    nf = np.asarray(s1_log["norm_factors"], np.float32).reshape(3, 1, 1, 1)
    ds = MicroFlowDatasetVAE(data_dir)
    n = ds.num_microstructures
    items = [ds[n + i] for i in range(TRAIN_B)] + [ds[i] for i in range(TRAIN_B)]
    v3d = torch.from_numpy(np.stack([it["velocity"] / nf for it in items[:TRAIN_B]]))
    m = torch.from_numpy(np.stack([it["microstructure"] for it in items[:TRAIN_B]]))
    v2d = torch.from_numpy(np.stack([it["velocity"] / nf for it in items[TRAIN_B:]]))
    dev = TRAIN_DEVICE
    batch1 = {"velocity": v3d.to(dev), "microstructure": m.to(dev)}
    batch2 = {"velocity_2d": v2d.to(dev), "mask_2d": m.to(dev), "velocity_3d": v3d.to(dev),
              "mask_3d": m.to(dev)}

    vae = s1.Stage1VAE(3, s1_log["latent_channels"], features=s1_log["features"])
    vae.init_parameters_(torch.Generator().manual_seed(31))
    vae.to(dev)
    opt = s1.AccumAdam(vae, 1e-4)
    train_step, _, _ = s1.make_steps(vae, s1_log["loss_function"], opt, accum_steps=1)
    c, d, h, w = v3d.shape[1:]
    noise = torch.randn((TRAIN_B, s1_log["latent_channels"], d, h // 4, w // 4),
                        generator=torch.Generator().manual_seed(32)).to(dev)
    one = {k: v[:1] for k, v in batch1.items()}
    _sync()
    t0 = time.perf_counter()
    losses = [float(train_step(one, 1e-5, True, noise=noise[:1])["recons"])
              for _ in range(VAE_OVERFIT_STEPS)]
    overfit_s = (time.perf_counter() - t0) / VAE_OVERFIT_STEPS
    log(f"[vae training] (g) overfit: {VAE_OVERFIT_STEPS} stage-1 steps on one sample (fixed "
        f"noise, lr 1e-4, accum 1): reconstruction loss {losses[0]:.6f} -> {losses[-1]:.6f} "
        f"(min {min(losses):.6f}); {overfit_s:.4f} s a step | {smi}")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise RuntimeError(f"overfit: the loss did not fall: {losses}")

    vae2 = DualBranchVAE(3, s1_log["latent_channels"], features=s1_log["features"])
    vae2.init_parameters_(torch.Generator().manual_seed(33))
    for name in s2.FROZEN:
        load_strict(getattr(vae2, name), getattr(vae, name).state_dict(), name)
        getattr(vae2, name).requires_grad_(False)
    vae2.encoder_2d.remat = vae2.decoder_2d.remat = True
    vae2.to(dev)
    opt2 = s1.AccumAdam(vae2, 5e-5)
    train_step2, _, _ = s2.make_steps(vae2, s1_log["loss_function"], opt2, 5.0, 50.0,
                                      accum_steps=2)
    train_step2(batch2, False)  # the stage-2 step's first call, outside the trace
    profiles = {}
    for name, fn in (("stage 1", lambda: train_step(batch1, 1e-5, False, noise=noise)),
                     ("stage 2", lambda: train_step2(batch2, False))):
        _sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if dev == "cuda":
                for _ in range(SENTINELS):
                    torch.cuda._sleep(1000)
            t0 = time.perf_counter()
            fn()
            _sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_kind = collections.defaultdict(lambda: [0.0, 0])
        for e in prof.events():
            if (e.device_type == DeviceType.CUDA and "sleep" not in e.name
                    and not e.name.startswith("Optimizer.")):
                k = by_kind[kind(e.name)]
                k[0] += (e.time_range.end - e.time_range.start) / 1e3
                k[1] += 1
        device_ms = sum(v[0] for v in by_kind.values())
        profiles[name] = {"wall_ms": wall_ms, "device_ms": device_ms,
                          "by_kind": {k: {"ms": ms, "launches": c}
                                      for k, (ms, c) in by_kind.items()}}
        log(f"[vae training] one {name} microbatch under torch.profiler: {wall_ms:.1f} ms wall, "
            f"{device_ms:.1f} ms on the device | {smi}")
        for k, (ms, c) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
            log(f"[vae training]   {k:12s} {ms:9.3f} ms {c:6d} launches")
    del vae, vae2, opt, opt2
    return {"losses": losses, "overfit_s_per_step": overfit_s, "profile": profiles}


def phase_vae_training(smi: str, data_dir: str, root: str, written_pred) -> dict:
    """The port's VAE training (``train_3d_vae_only`` / ``train_2d_with_cross``)
    at the reference widths (latent 8, 128/256/512) on phase 8's dataset (12
    microstructures of 256^2 x 11: 8 train, 1 validation, 3 test), B=2,
    float32 with cuDNN's default TF32 convolutions: (a) the data-prep CLI
    into a copy of the dataset; (b) stage 1, 2 epochs, accum 2, resident
    data; (c) stage 1 streamed: epoch 0 against (b)'s, then --resume to 2,
    epoch 1 against (b)'s; (d) stage 2 on (b), the README's recipe; (e) the
    diffusion train CLI on (d) + (b) for 1 epoch, then the inference CLI,
    DDIM-50, on its run dir; (f) card vs CPU gradients; (g) overfitting one
    batch, and one microbatch of each stage profiled. Then the kernels'
    inputs of each path, recorded by a hook in runs of their own."""
    from diffusion_model_project_tpu_torch import inference
    from diffusion_model_project_tpu_torch.scripts import generate_statistics
    from diffusion_model_project_tpu_torch.training import train_vae_stage1 as s1
    from diffusion_model_project_tpu_torch.training import train_vae_stage2 as s2

    # its own scratch dir: phase 8's VAE dir (root/vae) serves phase 16 after it
    base = os.path.join(root, "vae_training")
    res = {}
    t_phase = time.perf_counter()

    # (a) data prep into a copy of the dataset (the trainers read phase 8's)
    prep = os.path.join(base, "prep")
    os.makedirs(os.path.join(prep, "x"))
    for name in os.listdir(os.path.join(data_dir, "x")):
        if name.endswith(".pt"):
            os.symlink(os.path.join(data_dir, "x", name), os.path.join(prep, "x", name))
    t0 = time.perf_counter()
    stats = generate_statistics.main(["--dataset-dir", prep, "--generate-split", "--force"])
    prep_s = time.perf_counter() - t0
    with open(os.path.join(data_dir, "statistics.json")) as f:
        used = json.load(f)
    with open(os.path.join(prep, "splits.json")) as f:
        splits = json.load(f)
    log(f"[vae training] (a) generate_statistics --generate-split --force in {prep_s:.1f} s: "
        f"keys {sorted(stats)}, split {[len(splits[k]) for k in ('train', 'val', 'test')]}; "
        f"U_per_component max {[stats['U_per_component'][f'max_{c}'] for c in 'uvw']} | the "
        f"statistics.json the trainers read: keys {sorted(used)}, U_per_component max "
        f"{[used['U_per_component'][f'max_{c}'] for c in 'uvw']}")
    if not all(k in stats for k in ("U", "U_per_component", "U_2d", "U_2d_per_component",
                                     "metadata")):
        raise RuntimeError(f"(a): statistics.json lacks keys: {sorted(stats)}")
    res["a"] = {"seconds": prep_s, "keys": sorted(stats), "used_keys": sorted(used),
                "U_per_component": stats["U_per_component"],
                "used_U_per_component": used["U_per_component"]}

    def s1_argv(save, *extra):
        return ["--dataset-dir", data_dir, "--save-dir", save, "--grad-accum", "2",
                "--device", TRAIN_DEVICE, "--latent-channels", str(VAE_LATENT),
                *(["--features", *map(str, VAE_FEATURES)] if VAE_FEATURES else []), *extra]

    # (b) stage 1, resident data
    dir_b = os.path.join(base, "s1")
    run_b = vae_run("(b) stage 1, 2 epochs, accum 2, --cache-data auto", s1.main,
                    s1_argv(dir_b, "--num-epochs", str(VAE_EPOCHS), "--cache-data", "auto"), smi)
    want = ["best_model.msgpack", "train_state.msgpack", "vae.msgpack", "vae_log.json"]
    if run_b["files"] != want or "Device data store" not in run_b["stdout"]:
        raise RuntimeError(f"(b): the run dir holds {run_b['files']}, expected {want}; "
                           f"resident: {'Device data store' in run_b['stdout']}")
    res["b"] = run_b

    # (c) stage 1 streamed, then resumed
    dir_c = os.path.join(base, "s1_streamed")
    argv_c = s1_argv(dir_c, "--cache-data", "false")
    first = vae_run("(c) stage 1 streamed, 1 epoch", s1.main, [*argv_c, "--num-epochs", "1"], smi)
    resumed = vae_run("(c) stage 1 streamed, --resume to 2 epochs", s1.main,
                      [*argv_c, "--num-epochs", str(VAE_EPOCHS), "--resume"], smi)
    lb, lc = run_b["loss"], resumed["loss"]

    def rel(a, b):
        return abs(a - b) / abs(b)

    diffs = {"epoch0": {k: rel(first["loss"][k][0], lb[k][0])
                        for k in ("recons_train", "recons_val")},
             "epoch1": {k: rel(lc[k][1], lb[k][1]) for k in ("recons_train", "recons_val")}}
    log(f"[vae training] (c) streamed epoch 0 against (b)'s resident one: recons train / val "
        f"{first['loss']['recons_train'][0]!r} / {first['loss']['recons_val'][0]!r} against "
        f"{lb['recons_train'][0]!r} / {lb['recons_val'][0]!r}, relative differences "
        f"{diffs['epoch0']} (tol {VAE_STREAM_TOL:.0e}); resumed epoch 1 "
        f"{lc['recons_train'][1]!r} / {lc['recons_val'][1]!r} against {lb['recons_train'][1]!r} / "
        f"{lb['recons_val'][1]!r}, relative differences {diffs['epoch1']} "
        f"(tol {VAE_RESUME_TOL:.0e})")
    if not (max(diffs["epoch0"].values()) <= VAE_STREAM_TOL
            and max(diffs["epoch1"].values()) <= VAE_RESUME_TOL
            and "Device data store" not in first["stdout"]):
        raise RuntimeError(f"(c): the streamed or resumed run differs from (b): {diffs}")
    res["c"] = {"first": first, "resumed": resumed, "rel_diff": diffs}
    shutil.rmtree(dir_c)

    # (d) stage 2 on (b)'s dir, the README's recipe
    dir_d = os.path.join(base, "s2")
    run_d = vae_run("(d) stage 2 on (b), --lambda-align 5 --lambda-cross 50, 2 epochs, accum 2",
                    s2.main, ["--dataset-dir", data_dir, "--save-dir", dir_d,
                              "--stage1-checkpoint", dir_b, "--lambda-align", "5",
                              "--lambda-cross", "50", "--grad-accum", "2", "--num-epochs",
                              str(VAE_EPOCHS), "--device", TRAIN_DEVICE, "--latent-channels",
                              str(VAE_LATENT)], smi)
    want = ["best_model.msgpack", "model.msgpack", "train_state.msgpack", "vae_log.json"]
    if run_d["files"] != want or "weights changed" in run_d["stdout"]:
        raise RuntimeError(f"(d): files {run_d['files']}; a frozen-weight warning: "
                           f"{'weights changed' in run_d['stdout']}")
    res["d"] = run_d

    # (e) the README pipeline on the port's own VAE dirs: diffusion training,
    # then inference (the predictor's VAE and UNet have phase 8's modules)
    save_e = os.path.join(base, "diffusion")
    argv_e = train_argv(data_dir, dir_d, save_e, "--num-epochs", "1")
    argv_e[argv_e.index("--vae-path")] = "--vae-encoder-path"
    argv_e += ["--vae-decoder-path", dir_b]
    calls = module_calls(written_pred)
    run_e = train_run("(e) diffusion train CLI on the port's stage-2 (encoder) and stage-1 "
                      "(decoder) dirs, 1 epoch", argv_e, calls, smi)
    dir_e = os.path.join(save_e, run_e["run_dir"])
    _zero_launches()
    cli = inference.run(["--model-dir", dir_e, "--sampler", "ddim", "--steps", str(STEPS),
                         "--device", TRAIN_DEVICE])
    launched = _launches()
    gn, attn = expected_calls(cli.predictor, STEPS)
    ok = (cli.prediction.shape[:3] == (1, S, 3)
          and bool(torch.isfinite(torch.from_numpy(cli.prediction)).all()))
    log(f"[vae training] (e) inference CLI, DDIM-{STEPS}, on (e)'s run dir: output "
        f"{cli.prediction.shape} finite: {ok}; request {cli.seconds * 1e3:.1f} ms; launches "
        f"{launched} (expected {gn} / {attn} / 0)")
    if not ok or launched != {"groupnorm_act": gn, "fused_attention": attn, "conv3x3": 0}:
        raise RuntimeError(f"(e): output ok {ok}, launches {launched}")
    res["e"] = {"train": run_e, "request_ms": cli.seconds * 1e3, "launches": launched}
    del cli
    shutil.rmtree(save_e)

    # (f) card vs CPU
    res["f"] = vae_card_vs_cpu()

    # (g) overfit one batch; one microbatch of each stage profiled
    res["g"] = vae_overfit_and_profile(data_dir, dir_b, smi)

    # the kernels' inputs on these paths: a stage-1 validation / test batch
    # (B=2 and the ragged B=1), a stage-2 microbatch (the frozen E3D encode)
    # and a stage-2 validation batch, float32, each counted a batch
    seen_by_path = {}
    for path, fn in vae_hooked_paths(data_dir, dir_b, dir_d).items():
        seen, handles = record_shapes()
        try:
            fn()
        finally:
            for h in handles:
                h.remove()
        seen_by_path[path] = seen
    shutil.rmtree(base)
    res["shapes_by_path"] = seen_by_path
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[vae training] the phase took {res['seconds']:.1f} s | {smi}")
    return res


def vae_hooked_paths(data_dir: str, dir_b: str, dir_d: str) -> dict:
    """One batch of each VAE training path on the written dirs' weights, for
    the shape hook: {path: callable}."""
    import numpy as np

    from diffusion_model_project_tpu_torch.data.dataset import MicroFlowDatasetVAE
    from diffusion_model_project_tpu_torch.models.vae import DualBranchVAE
    from diffusion_model_project_tpu_torch.training import train_vae_stage1 as s1
    from diffusion_model_project_tpu_torch.training import train_vae_stage2 as s2
    from diffusion_model_project_tpu_torch.utils import flax_msgpack
    from diffusion_model_project_tpu_torch.utils.checkpoint import load_vae_params

    with open(os.path.join(dir_b, "vae_log.json")) as f:
        log_b = json.load(f)
    nf = np.asarray(log_b["norm_factors"], np.float32).reshape(3, 1, 1, 1)
    ds = MicroFlowDatasetVAE(data_dir)
    n = ds.num_microstructures
    dev = TRAIN_DEVICE

    def batch(idx):
        items = [ds[i] for i in idx]
        return (torch.from_numpy(np.stack([it["velocity"] / nf for it in items])).to(dev),
                torch.from_numpy(np.stack([it["microstructure"] for it in items])).to(dev))

    vae1 = s1.Stage1VAE(3, log_b["latent_channels"], features=log_b["features"])
    load_vae_params(vae1, flax_msgpack.load(os.path.join(dir_b, "vae.msgpack")), dir_b)
    vae1.to(dev)
    _, _, eval1 = s1.make_steps(vae1, log_b["loss_function"], s1.AccumAdam(vae1, 1e-4))
    vae2 = DualBranchVAE(3, log_b["latent_channels"], features=log_b["features"])
    load_vae_params(vae2, flax_msgpack.load(os.path.join(dir_d, "model.msgpack")), dir_d)
    for name in s2.FROZEN:
        getattr(vae2, name).requires_grad_(False)
    vae2.encoder_2d.remat = vae2.decoder_2d.remat = True
    vae2.to(dev)
    train2, _, eval2 = s2.make_steps(vae2, log_b["loss_function"], s1.AccumAdam(vae2, 5e-5),
                                     5.0, 50.0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def s1_eval(b):
        v, m = batch([n + i for i in range(b)])
        eval1({"velocity": v, "microstructure": m}, 1e-3, generator=gen)

    def s2_batch(b):
        v3, m = batch([n + i for i in range(b)])
        v2, _ = batch(list(range(b)))
        return {"velocity_2d": v2, "mask_2d": m, "velocity_3d": v3, "mask_3d": m}

    return {"s1_eval_b2": lambda: s1_eval(2), "s1_eval_b1": lambda: s1_eval(1),
            "s2_train_b2": lambda: train2(s2_batch(2), False),
            "s2_eval_b2": lambda: eval2(s2_batch(2)), "s2_eval_b1": lambda: eval2(s2_batch(1))}


def vae_k1_device_ms(shapes_by_path: dict, rows: list) -> dict:
    """K1's device time a batch of each VAE training path: each (shape,
    dtype)'s device time a call, from the kernel rows of whichever phase held
    it, times its calls in that path's batch, summed."""
    by_key = {(r["kernel"], tuple(r["shape"]), r["detail"]): r for r in rows}
    out = {}
    for path, seen in shapes_by_path.items():
        total = bound = 0.0
        for key, calls in seen.items():
            _, shape, groups, act, dtype = key
            row = by_key[("groupnorm_act", tuple(shape),
                          f"G={groups} act={act or 'none'} {dtype.replace('torch.', '')}")]
            total += row["device_ms"] * calls
            bound += row["bound_ms"] * calls
        out[path] = {"calls": sum(seen.values()), "device_ms": total, "bound_ms": bound}
    log("[vae kernels] K1 a batch of each VAE training path (device ms from the rows that hold "
        "each shape): " + "; ".join(f"{p} {v['calls']} calls, device {v['device_ms']:.3f}, bound "
                                    f"{v['bound_ms']:.3f}" for p, v in out.items()))
    return out


# phase 16: the serving daemon, its CLI, the exported sampler and the train
# CLI's observability flags, on phase 8's dirs
SERVE_LADDER = (1, 8)
SERVE_CLIENTS, SERVE_BURST = 8, 16      # client threads, concurrent requests
SERVE_SAMPLERS = (("ddim", 50), ("dpm", 10))
SERVE_F32_STEPS = 10                    # (c): batch-invariance check, float32
SERVE_F32_TOL = 1e-4                    # (c): relative to max|direct|
EXPORT_STEPS, EXPORT_TOL = 5, 1e-5      # (e): DDIM-5, B=1, float32, relative
OP_ROUNDS = 6                           # (g): requests a route, interleaved
PIPE_STEPS, PIPE_SLEEP_MS = 5, 500.0    # (i): DDIM-5 at B=8, a device sleep ahead of each batch


def _nearest_rank(ms: list, q: float) -> float:
    ms = sorted(ms)
    return ms[max(0, math.ceil(q * len(ms)) - 1)]


def _check_served(out, img, label: str) -> None:
    import numpy as np

    if out.shape != (S, 3, HW, HW) or not np.isfinite(out).all():
        raise RuntimeError(f"[serving] {label}: bad output {out.shape}")
    if np.abs(out[np.broadcast_to(img == 0, out.shape)]).max(initial=0.0) != 0.0:
        raise RuntimeError(f"[serving] {label}: nonzero velocity where the mask is 0")


def serve_http(server, payloads: list, smi: str, label: str, per_dispatch: dict) -> dict:
    """1 lone request, then SERVE_BURST concurrent ones from SERVE_CLIENTS
    client threads, through ``build_http_server``: npz float32 for even
    indices, MFR1 raw for odd ones, each with its own seed. Every result is
    checked; the launch counters, set to 0 before, must equal
    ``per_dispatch`` times the batches."""
    import io
    import threading
    import urllib.request

    import numpy as np

    from diffusion_model_project_tpu_torch.utils.serving import (
        build_http_server, decode_raw_response, encode_raw_request)

    httpd = build_http_server(server, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    bodies = []
    for i, (img, v2d) in enumerate(payloads):
        if i % 2:
            bodies.append(encode_raw_request(img, v2d, seed=i))
        else:
            buf = io.BytesIO()
            np.savez(buf, img=img, v2d=v2d, seed=i)
            bodies.append(buf.getvalue())

    def post(i):
        t0 = time.perf_counter()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/predict", data=bodies[i])
        with urllib.request.urlopen(req, timeout=600) as resp:
            body = resp.read()
        out = decode_raw_response(body) if i % 2 else np.load(io.BytesIO(body))["velocity"]
        _check_served(out, payloads[i][0], f"{label} request {i}")
        return time.perf_counter() - t0

    try:
        _zero_launches()
        before = server.stats()
        lone_ms = post(0) * 1e3
        mid = server.stats()
        torch.cuda.reset_peak_memory_stats()
        lat, errors, lock = {}, [], threading.Lock()
        todo = iter(range(1, 1 + SERVE_BURST))

        def client():
            while True:
                with lock:
                    i = next(todo, None)
                if i is None:
                    return
                try:
                    ms = post(i) * 1e3
                except Exception as e:  # noqa: BLE001 (re-raised below)
                    errors.append(e)
                    return
                with lock:
                    lat[i] = ms

        threads = [threading.Thread(target=client) for _ in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        peak = torch.cuda.max_memory_allocated()
        after = server.stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
    launches = _launches()
    batches = after["batches"] - before["batches"]
    expected = {"groupnorm_act": per_dispatch["groupnorm_act"] * batches,
                "fused_attention": per_dispatch["fused_attention"] * batches, "conv3x3": 0}
    ms = list(lat.values())
    by_payload = {name: {"p50_ms": _nearest_rank(v, 0.5), "p99_ms": _nearest_rank(v, 0.99)}
                  for name, v in (("npz_f32", [lat[i] for i in lat if i % 2 == 0]),
                                  ("mfr1_raw", [lat[i] for i in lat if i % 2]))}
    res = {"lone_ms": lone_ms, "lone_batches": mid["batches"] - before["batches"],
           "burst_requests": SERVE_BURST, "burst_s": wall, "volumes_per_s": SERVE_BURST / wall,
           "p50_ms": _nearest_rank(ms, 0.5), "p99_ms": _nearest_rank(ms, 0.99),
           "by_payload": by_payload, "batches": batches,
           "burst_batches": after["batches"] - mid["batches"],
           "padded_slots": after["padded_slots"] - before["padded_slots"],
           "peak_bytes_burst": peak, "launches": launches, "expected": expected,
           "server_batch_ms": after.get("batch_ms"),
           "queued_while_busy": after["queued_while_busy"] - before["queued_while_busy"]}
    log(f"[serving] {label}: lone request {lone_ms:.1f} ms ({res['lone_batches']} batch at "
        f"B=1); {SERVE_BURST} concurrent requests from {SERVE_CLIENTS} clients in {wall:.3f} s: "
        f"{res['volumes_per_s']:.3f} volumes/s, latency p50 {res['p50_ms']:.1f} ms p99 "
        f"{res['p99_ms']:.1f} ms (" + ", ".join(
            f"{k} p50 {v['p50_ms']:.1f} p99 {v['p99_ms']:.1f}" for k, v in by_payload.items())
        + f"); {batches} batches ({res['burst_batches']} in the burst, "
        f"{res['queued_while_busy']} queued while the one before was on the device), "
        f"{res['padded_slots']} padded slots; peak memory in the burst "
        f"{peak / 2**30:.2f} GiB; batch ms {after.get('batch_ms')} | {smi}")
    log(f"[serving] {label}: launches {launches} (expected {expected})")
    if launches != expected:
        raise RuntimeError(f"[serving] {label} did not go through the kernels as expected: "
                           f"{launches} against {expected}")
    return res


def serve_f32_invariance(pred, smi: str) -> dict:
    """(c) float32, TF32 off: one request served alone (B=1), one inside a
    batch of 8 and one padded to 8, each against the direct predict_ddim on
    the request's own latents."""
    import numpy as np

    from diffusion_model_project_tpu_torch.scripts.perf_serve_daemon import volume
    from diffusion_model_project_tpu_torch.utils.serving import InferenceServer, request_noise

    ld = S // pred.vae_depth_factor
    shape = (ld, pred.latent_channels, HW // 4, HW // 4)

    def direct(img, v2d, seed):
        out = pred.predict_ddim(torch.from_numpy(img[None]).cuda(),
                                torch.from_numpy(v2d[None]).cuda(), num_steps=SERVE_F32_STEPS,
                                noise=request_noise(seed, shape)[None].cuda())
        return out[0].cpu().numpy()

    vols = [volume(i, 7000) for i in range(8)]
    res = {}
    with InferenceServer(pred, num_steps=SERVE_F32_STEPS, batch_sizes=SERVE_LADDER,
                         max_wait_ms=500.0, expected_shape=(S, HW, HW)) as server:
        got = {"alone": (server.predict(*vols[0], seed=0), 0)}
        futs = [server.submit(img, v2d, seed=i) for i, (img, v2d) in enumerate(vols)]
        outs = [f.result() for f in futs]
        st = server.stats()
        if st["batches"] != 2 or st["padded_slots"] != 0:
            raise RuntimeError(f"[serving] (c): 8 requests did not form one batch of 8: {st}")
        got["batch_of_8"] = (outs[5], 5)
    with InferenceServer(pred, num_steps=SERVE_F32_STEPS, max_batch=8,
                         max_wait_ms=1.0, expected_shape=(S, HW, HW)) as server:
        got["padding"] = (server.predict(*vols[3], seed=3), 3)
        if server.stats()["padded_slots"] != 7:
            raise RuntimeError(f"[serving] (c): the lone request was not padded to 8")
    for case, (out, i) in got.items():
        want = direct(*vols[i], i)
        rel = float(np.abs(out - want).max() / np.abs(want).max())
        res[case] = {"seed": i, "rel_err": rel}
        if not rel <= SERVE_F32_TOL:
            raise RuntimeError(f"[serving] (c) {case}: {rel:.3e} from the direct call")
    log(f"[serving] (c) float32 DDIM-{SERVE_F32_STEPS}, TF32 off: against the direct "
        f"predict_ddim on the same latents: " + ", ".join(
            f"{k} {v['rel_err']:.3e}" for k, v in res.items()) + f" (tol {SERVE_F32_TOL}) | {smi}")
    return res


def _read_lines(proc, out: list, ready, marker: str) -> None:
    for line in proc.stdout:
        out.append(line)
        if line.startswith(marker):
            ready.set()
    ready.set()


def serve_cli_sigterm(run_dir: str, smi: str) -> dict:
    """(d) the serve CLI as a process on a free port: one request, SIGTERM,
    exit 0 with its final stats."""
    import io
    import signal
    import threading
    import urllib.request

    import numpy as np

    from diffusion_model_project_tpu_torch.scripts.perf_serve_daemon import volume

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "diffusion_model_project_tpu_torch.scripts.serve",
         "--model-dir", run_dir, "--port", "0", "--batch-sizes", "1", "--steps", "10"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, ready = [], threading.Event()
    reader = threading.Thread(target=_read_lines, args=(proc, lines, ready, "serving "),
                              daemon=True)
    reader.start()
    try:
        if not ready.wait(300) or not lines or not lines[-1].startswith("serving "):
            raise RuntimeError("[serving] (d) the serve CLI did not come up:\n" + "".join(lines))
        start_s = time.perf_counter() - t0
        port = int(lines[-1].split("http://127.0.0.1:")[1].split()[0])
        img, v2d = volume(0, 9000)
        buf = io.BytesIO()
        np.savez(buf, img=img, v2d=v2d, seed=3)
        t1 = time.perf_counter()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/predict", data=buf.getvalue())
        with urllib.request.urlopen(req, timeout=300) as resp:
            out = np.load(io.BytesIO(resp.read()))["velocity"]
        request_ms = (time.perf_counter() - t1) * 1e3
        _check_served(out, img, "(d) the serve CLI")
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(10)
    text = "".join(lines)
    stats = [ln for ln in lines if "final stats" in ln]
    log(f"[serving] (d) serve CLI: up in {start_s:.1f} s (process start, load, warm-up), one "
        f"request {request_ms:.1f} ms, SIGTERM -> exit {code}; {stats[-1].strip() if stats else ''}")
    if code != 0 or not stats or "'requests': 1" not in stats[-1]:
        raise RuntimeError(f"[serving] (d) the serve CLI did not stop cleanly (exit {code}):\n"
                           + text[-4000:])
    return {"start_s": start_s, "request_ms": request_ms, "exit_code": code,
            "final_stats": stats[-1].strip()}


def serve_export(pred, smi: str) -> dict:
    """(e) DDIM-EXPORT_STEPS at B=1, float32, TF32 off: export_sampler, then
    load_sampler; the loaded program against the eager predictor on the same
    inputs and noise, its launches, and both timed."""
    from diffusion_model_project_tpu_torch.utils.export import export_sampler, load_sampler

    img, vel, noise = make_inputs(1, S, HW, seed=11)
    img, vel, noise = img.cuda(), vel.cuda(), noise.cuda()
    t0 = time.perf_counter()
    blob = export_sampler(pred, batch=1, num_steps=EXPORT_STEPS, image_hw=(HW, HW), num_slices=S)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    f = load_sampler(blob)
    load_s = time.perf_counter() - t0
    nbytes = len(blob)
    del blob
    _zero_launches()
    got = f(img, vel, noise)
    torch.cuda.synchronize()
    launches = _launches()
    evals = EXPORT_STEPS
    expected = {"groupnorm_act": 38 * evals + 26, "fused_attention": 6 * evals, "conv3x3": 0}
    want = pred.predict_ddim(img, vel, num_steps=EXPORT_STEPS, noise=noise)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    times = {"exported": [], "eager": []}
    for route in ("exported", "eager", "eager", "exported", "exported", "eager"):
        fn = f if route == "exported" else (
            lambda i, v, n: pred.predict_ddim(i, v, num_steps=EXPORT_STEPS, noise=n))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(img, vel, noise)
        torch.cuda.synchronize()
        times[route].append((time.perf_counter() - t0) * 1e3)
    res = {"steps": EXPORT_STEPS, "export_s": export_s, "load_s": load_s, "archive_bytes": nbytes,
           "launches": launches, "expected": expected, "rel_err": rel, "request_ms": times}
    log(f"[serving] (e) export_sampler DDIM-{EXPORT_STEPS}, B=1, float32: {export_s:.1f} s, "
        f"archive {nbytes} bytes; load_sampler {load_s:.1f} s; launches {launches} (expected "
        f"{expected}); against the eager predictor {rel:.3e} (tol {EXPORT_TOL}); request ms "
        f"exported {', '.join(f'{t:.1f}' for t in times['exported'])}, eager "
        f"{', '.join(f'{t:.1f}' for t in times['eager'])} | {smi}")
    if launches != expected:
        raise RuntimeError(f"[serving] (e) the exported program did not run the kernels: "
                           f"{launches} against {expected}")
    if not rel <= EXPORT_TOL:
        raise RuntimeError(f"[serving] (e) the exported program differs by {rel:.3e}")
    return res


def serve_observability(data_dir: str, vae_dir: str, root: str, smi: str) -> dict:
    """(f) one train CLI epoch with --profile-dir writes a trace; --debug-nans
    on a copy of the dataset whose 3D velocity carries a NaN raises, naming
    a module."""
    from diffusion_model_project_tpu_torch import train as train_cli
    from diffusion_model_project_tpu_torch.utils.profiling import enable_nan_debugging

    trace_dir = os.path.join(root, "trace")
    t0 = time.perf_counter()
    train_cli.main(train_argv(data_dir, vae_dir, os.path.join(root, "runs_profiled"),
                              "--num-epochs", "1", "--profile-dir", trace_dir))
    profiled_s = time.perf_counter() - t0
    traces = [os.path.join(trace_dir, n) for n in os.listdir(trace_dir)
              if n.endswith(".pt.trace.json")]
    if len(traces) != 1:
        raise RuntimeError(f"[serving] (f) --profile-dir wrote {os.listdir(trace_dir)}")
    with open(traces[0], "rb") as fh:
        text = fh.read()
    kernels = text.count(b'"cat": "kernel"') + text.count(b'"cat":"kernel"')
    if not kernels:
        raise RuntimeError("[serving] (f) the trace holds no CUDA kernel")
    nan_data = os.path.join(root, "nan_data")
    shutil.copytree(data_dir, nan_data)
    u = torch.load(os.path.join(nan_data, "x", "U.pt"))
    u[:, 0, 0, 0, 0] = float("nan")
    torch.save(u, os.path.join(nan_data, "x", "U.pt"))
    message = None
    t0 = time.perf_counter()
    try:
        train_cli.main(train_argv(nan_data, vae_dir, os.path.join(root, "runs_nan"),
                                  "--num-epochs", "1", "--debug-nans", "true"))
    except FloatingPointError as e:
        message = str(e)
    finally:
        enable_nan_debugging(False)
    nan_s = time.perf_counter() - t0
    res = {"profiled_epoch_s": profiled_s, "trace_bytes": len(text), "trace_kernels": kernels,
           "debug_nans_error": message, "debug_nans_s": nan_s}
    log(f"[serving] (f) train CLI, 1 epoch with --profile-dir: {profiled_s:.1f} s, trace "
        f"{len(text)} bytes with {kernels} CUDA kernel events; --debug-nans on data with a "
        f"NaN: {message!r} after {nan_s:.1f} s | {smi}")
    if not message or "module" not in message:
        raise RuntimeError("[serving] (f) --debug-nans did not stop at a module")
    return res


def serve_op_overhead(pred, smi: str) -> dict:
    """(g) a DDIM-50 request at B=1, bf16, with the layers calling K1 and K2
    through their wrappers (the eager path) and through the registered ops
    (``torch.ops.dm_port.*``), interleaved, each route's first request
    untimed; both launch the kernels."""
    from diffusion_model_project_tpu_torch.models import layers

    img, vel, noise = make_inputs(1, S, HW, seed=12)
    img, vel, noise = img.cuda(), vel.cuda(), noise.cuda()
    wrappers = (layers.groupnorm_act, layers.fused_attention)
    ops = (lambda x, w, b, g, act="", eps=1e-5: torch.ops.dm_port.groupnorm_act(x, w, b, g, act,
                                                                                 eps),
           torch.ops.dm_port.fused_attention)
    times = {"wrapper": [], "op": []}
    launches = {}
    try:
        for route in ["op", "wrapper"] + ["wrapper", "op", "op", "wrapper"] * (OP_ROUNDS // 2):
            layers.groupnorm_act, layers.fused_attention = \
                wrappers if route == "wrapper" else ops
            _zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred.predict_ddim(img, vel, num_steps=STEPS, noise=noise)
            torch.cuda.synchronize()
            times[route].append((time.perf_counter() - t0) * 1e3)
            launches[route] = _launches()
    finally:
        layers.groupnorm_act, layers.fused_attention = wrappers
    times = {k: v[1:] for k, v in times.items()}  # each route's first request warms it
    # the median: a host-bound request's time has outliers of +50%
    median = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    res = {"request_ms": times, "median_ms": median, "launches": launches,
           "overhead": median["op"] / median["wrapper"] - 1.0}
    log(f"[serving] (g) DDIM-{STEPS} request, B=1, bf16: through the wrappers "
        f"{', '.join(f'{t:.1f}' for t in times['wrapper'])} ms (median "
        f"{median['wrapper']:.1f}), through the registered ops "
        f"{', '.join(f'{t:.1f}' for t in times['op'])} ms (median {median['op']:.1f}): "
        f"{res['overhead'] * 100:+.2f}%; launches {launches} | {smi}")
    expected = {"groupnorm_act": 1926, "fused_attention": 300, "conv3x3": 0}
    if any(v != expected for v in launches.values()):
        raise RuntimeError(f"[serving] (g) launches {launches} against {expected}")
    return res


def serve_batch_profile(pred, smi: str) -> dict:
    """(h) where a B=8 DDIM-50 dispatch's time goes: one predict_ddim at B=8,
    bf16, under torch.profiler (after SENTINELS sentinel kernels), its
    device time by kind of kernel against its wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diffusion_model_project_tpu_torch.scripts.train_step_time import kind

    b = SERVE_LADDER[-1]
    img, vel, noise = make_inputs(b, S, HW, seed=13)
    img, vel, noise = img.cuda(), vel.cuda(), noise.cuda()
    pred.predict_ddim(img, vel, num_steps=STEPS, noise=noise)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred.predict_ddim(img, vel, num_steps=STEPS, noise=noise)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(SENTINELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        pred.predict_ddim(img, vel, num_steps=STEPS, noise=noise)
        torch.cuda.synchronize()
    by_kind = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and SENTINEL not in e.name:
            k = "k1" if is_k1_kernel(e.name) else "k2" if is_k2_kernel(e.name) else kind(e.name)
            by_kind[k] += (e.time_range.end - e.time_range.start) / 1e3
    device = sum(by_kind.values())
    res = {"batch": b, "wall_ms": wall_ms, "device_ms": device,
           "busy_share": device / wall_ms, "device_ms_by_kind": dict(by_kind)}
    log(f"[serving] (h) one DDIM-{STEPS} dispatch at B={b}, bf16: {wall_ms:.1f} ms wall, "
        f"{device:.1f} ms on the device (busy {device / wall_ms:.3f}); by kind (ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in by_kind.most_common()) + f" | {smi}")
    return res


def serve_pipeline(pred, smi: str) -> dict:
    """(i) the server's two-stage pipeline on the card, bf16 DDIM-PIPE_STEPS
    at B=8. One batch's host work (its inputs staged, the sampler's kernels
    and the result's copy queued) runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a call on it that waits for
    the device (a copy from pageable memory, a read of a device value)
    raises. Then two bursts of 16 requests, each batch's sampler call
    preceded on the stream by a PIPE_SLEEP_MS device sleep, so a batch is
    still on the device when the next one is queued unless queuing waits
    for it: the second burst's second batch must count as queued while the
    first was busy (the first burst also warms the pinned host buffers)."""
    from diffusion_model_project_tpu_torch.scripts.perf_serve_daemon import volume
    from diffusion_model_project_tpu_torch.utils.serving import InferenceServer, request_noise

    b = SERVE_LADDER[-1]
    vols = [volume(i, 9000) for i in range(2 * b)]
    shape = (S // pred.vae_depth_factor, pred.latent_channels, HW // 4, HW // 4)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    torch.cuda._sleep(10 ** 8)
    e1.record()
    e1.synchronize()
    cycles = int(10 ** 8 * PIPE_SLEEP_MS / e0.elapsed_time(e1))
    with InferenceServer(pred, num_steps=PIPE_STEPS, max_batch=b, max_wait_ms=200.0,
                         expected_shape=(S, HW, HW)) as server:
        server.warmup()
        with torch.inference_mode():
            torch.cuda.set_sync_debug_mode("error")
            try:
                img = server._stage([v[0] for v in vols[:b]])
                v2d = server._stage([v[1] for v in vols[:b]])
                noise = server._stage([request_noise(i, shape).numpy() for i in range(b)])
                _, done = server._copy_out(server._fn(pred, img, v2d, noise))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        done.synchronize()
        fn = server._fn

        def slowed(*args):
            torch.cuda._sleep(cycles)
            return fn(*args)

        server._fn = slowed
        counts, walls = [], []
        for _ in range(2):
            before = server.stats()
            t0 = time.perf_counter()
            futs = [server.submit(img, v2d, seed=i) for i, (img, v2d) in enumerate(vols)]
            for f, (img, _) in zip(futs, vols):
                _check_served(f.result(), img, "(i)")
            walls.append(time.perf_counter() - t0)
            after = server.stats()
            counts.append(after["queued_while_busy"] - before["queued_while_busy"])
        st = server.stats()
    res = {"steps": PIPE_STEPS, "batch": b, "sleep_ms": PIPE_SLEEP_MS, "sleep_cycles": cycles,
           "queued_while_busy": counts, "burst_s": walls, "batches": st["batches"],
           "padded_slots": st["padded_slots"]}
    log(f"[serving] (i) pipeline, DDIM-{PIPE_STEPS} at B={b}, bf16: one batch's host work "
        f"made no synchronizing call; with {PIPE_SLEEP_MS:.0f} ms of device sleep ahead of "
        f"each batch, bursts of {2 * b} requests took "
        f"{', '.join(f'{w:.3f}' for w in walls)} s, batches queued while the one before "
        f"was on the device {counts}; {st['batches']} batches, {st['padded_slots']} padded "
        f"slots | {smi}")
    if st["batches"] != 4 or st["padded_slots"] != 0:
        raise RuntimeError(f"[serving] (i) the bursts did not form 4 batches of {b}: {st}")
    if counts[1] < 1:
        raise RuntimeError("[serving] (i) the batcher waited for the previous batch before "
                           f"queuing the next: queued_while_busy {counts}")
    return res


def phase_serving(smi: str, run_dir: str, data_dir: str, vae_dir: str, root: str) -> dict:
    """Phase 16 on phase 8's run dir at published width, 256^2 x 11."""
    from diffusion_model_project_tpu_torch.scripts.perf_serve_daemon import volume
    from diffusion_model_project_tpu_torch.utils.checkpoint import predictor_from_directory
    from diffusion_model_project_tpu_torch.utils.serving import InferenceServer

    t_phase = time.perf_counter()
    pred, _ = predictor_from_directory(run_dir, device="cuda")
    pred.compute_dtype = torch.bfloat16  # the serve CLI's default
    payloads = [volume(i, 8000) for i in range(1 + SERVE_BURST)]
    out = {"ladder": list(SERVE_LADDER)}
    shapes = None
    for sampler, steps in SERVE_SAMPLERS:
        evals = dpm_evaluations(pred, steps) if sampler == "dpm" else steps
        per_dispatch = {"groupnorm_act": 38 * evals + 26, "fused_attention": 6 * evals}
        if expected_calls(pred, evals) != tuple(per_dispatch.values()):
            raise RuntimeError(f"the run dir's GroupNorm / attention counts are "
                               f"{expected_calls(pred, evals)}")
        with InferenceServer(pred, sampler=sampler, num_steps=steps, batch_sizes=SERVE_LADDER,
                             max_wait_ms=50.0, expected_shape=(S, HW, HW)) as server:
            t0 = time.perf_counter()
            if shapes is None:  # the kernels' inputs at B=1 and B=8, by a global hook
                shapes, handles = record_shapes()
                try:
                    server.warmup()
                finally:
                    for h in handles:
                        h.remove()
            else:
                server.warmup()
            warm_s = time.perf_counter() - t0
            label = f"(a) {sampler}-{steps}" if sampler == "ddim" else f"(b) {sampler}-{steps}"
            r = serve_http(server, payloads, smi, label, per_dispatch)
        out[f"{sampler}{steps}"] = {"per_dispatch": per_dispatch, "warmup_s": warm_s, **r}
    out["pipeline"] = serve_pipeline(pred, smi)
    pred.compute_dtype = torch.float32
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out["f32_invariance"] = serve_f32_invariance(pred, smi)
        out["export"] = serve_export(pred, smi)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    out["cli"] = serve_cli_sigterm(run_dir, smi)
    pred.compute_dtype = torch.bfloat16
    out["op_overhead"] = serve_op_overhead(pred, smi)
    out["batch_profile"] = serve_batch_profile(pred, smi)
    del pred
    torch.cuda.empty_cache()
    out["observability"] = serve_observability(data_dir, vae_dir, os.path.join(root, "observe"),
                                               smi)
    out["shapes"] = shapes
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[serving] the kernels' inputs at B=1 and B=8: {len(shapes)} (shape, dtype) pairs; "
        f"phase {out['seconds']:.1f} s")
    return out


# phase 18: K2 at attention shapes beyond the published UNet's, each dtype:
# the grid's narrow stacks (hd 64 at T 256 and 1,024), --attention 1..2 (hd
# 32 at 4,096 tokens), --attention 3..4 at N=88 (hd 64), the optimize space's
# 2048-wide bottom at T=1 (hd 1,024 and 2,048), a head dim off the core's
# instances (hd 48), and an AttentionBlock's 11 x 32^2 tokens
WIDE_K2_SHAPES = (((22, 256, 128), 2), ((22, 1024, 128), 2), ((22, 4096, 64), 2),
                  ((88, 256, 256), 4), ((22, 1, 2048), 2), ((22, 1, 2048), 1),
                  ((2, 64, 96), 2), ((2, 11264, 512), 2))


def phase_wide_attention() -> list:
    """Phase 18: K2 against its plain version at WIDE_K2_SHAPES in bf16
    (K2_TOL) and float32 (K2_TOL_F32), with phase 4's times, bound and library
    call, one call each."""
    shapes = {("fused_attention", shape, heads, str(dt)): 1
              for shape, heads in WIDE_K2_SHAPES for dt in (torch.bfloat16, torch.float32)}
    rows, _ = phase_kernels(shapes, {"fused_attention": 1}, tag="wide attention")
    return rows


# phase 19: the search modes and --cache-latents, on phase 8's data
SEARCH_FEATURES = (32, 64, 128, 256)  # the grid's first stack: hd 64 at level 3
CACHE_TOL = 1e-5  # the first step's cached loss against the uncached one, relative


def search_calls(written_pred, unet_kwargs: dict) -> dict:
    """:func:`module_calls` with ``written_pred``'s VAE and a UNet of ``unet_kwargs``."""
    from diffusion_model_project_tpu_torch.models.layers import GroupNorm, MultiheadSelfAttention
    from diffusion_model_project_tpu_torch.models.unet import UNet

    with torch.device("meta"):
        unet = UNet(**unet_kwargs)
    return {**module_calls(written_pred),
            "unet": sum(isinstance(m, GroupNorm) for m in unet.modules()),
            "attention": sum(isinstance(m, MultiheadSelfAttention) for m in unet.modules())}


def write_run_dir(run: str, vae_dir: str, data_dir: str, unet_kwargs: dict, seed: int) -> str:
    """A run dir in the reference layout (best_model.pt, log.json naming the
    VAE dir) of a seeded predictor with a UNet of ``unet_kwargs``."""
    from diffusion_model_project_tpu_torch.diffusion.predictor import LatentDiffusionPredictor
    from diffusion_model_project_tpu_torch.utils.config import PUBLISHED_LATENT_CHANNELS

    pred = LatentDiffusionPredictor.create(dict(unet_kwargs), seed=seed, device="cpu",
                                           num_timesteps=1000,
                                           latent_channels=PUBLISHED_LATENT_CHANNELS)
    enliven(pred.model, seed + 1)
    os.makedirs(run)
    torch.save({k: v for k, v in pred.state_dict().items() if k.startswith("model.")},
               os.path.join(run, "best_model.pt"))
    predictor_kwargs = {"model_name": "UNet", "model_kwargs": dict(unet_kwargs),
                        "distance_transform": True, "num_slices": S, "num_timesteps": 1000,
                        "vae_path": vae_dir}
    with open(os.path.join(run, "log.json"), "w") as f:
        json.dump({"params": {
            "dataset": {"root_dir": data_dir, "batch_size": EVAL_B, "use_3d": True},
            "training": {"predictor_type": "latent-diffusion", "predictor": predictor_kwargs,
                         "cost_function": EVAL_COST}}}, f)
    return run


def _recorded(label: str, main, argv: list, calls: dict) -> tuple:
    """``main(argv)`` with the launch counters set to 0 and every train /
    validation / test step recorded and held to the module-derived counts
    (:func:`check_step_launches`); returns (recorder, launches of the whole
    call, of the steps, seconds)."""
    _zero_launches()
    t0 = time.perf_counter()
    with TrainRecorder() as rec:
        main(argv)
    _sync()
    secs = time.perf_counter() - t0
    total = _launches()
    tr, ev = check_step_launches(label, rec, calls)
    return rec, total, {k: tr[k] + ev[k] for k in _ZERO}, secs


def _finite_log(label: str, run_dir: str, epochs: int) -> dict:
    log_json = _read_log(run_dir)
    losses = log_json["train_loss"] + log_json["val_loss"] + [log_json.get("test_loss", 0.0)]
    if len(log_json["epoch"]) != epochs or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"[search] {label}: {run_dir}'s log holds epochs "
                           f"{log_json['epoch']}, losses {losses}")
    return log_json


def phase_search(smi: str, data_dir: str, vae_dir: str, written_pred, root: str) -> dict:
    """Phase 19 on phase 8's dataset and VAE dir, with K2 at shapes beyond
    the published UNet's: (b) one epoch of the train CLI (its validation and
    test passes launch K2 at hd 64) at --features 32 64 128 256 --attention
    3..2, and one inference CLI DDIM-50 request at --attention 1..2 (K2 at
    4,096 tokens) on a run dir written here; (c) --mode optimize, 2 trials of
    1 epoch; (d) the port's grid search, --grid-index 0, 1 epoch; (e) the
    first step's loss through the latent cache against the uncached one
    under the same noise and t, then --cache-latents with and without
    --augment, 1 epoch each. Every run's launches are held to the counts
    derived from the modules."""
    from diffusion_model_project_tpu_torch import inference
    from diffusion_model_project_tpu_torch import train as train_cli
    from diffusion_model_project_tpu_torch.data import get_loader
    from diffusion_model_project_tpu_torch.scripts import gridsearch_diffusion as gs
    from diffusion_model_project_tpu_torch.training.helper import (_batch_dict,
                                                                   _natural_order_batches,
                                                                   set_model)
    from diffusion_model_project_tpu_torch.training.steps import (cached_latent_loss_fn,
                                                                  diffusion_loss_fn,
                                                                  precompute_latent_cache)
    from diffusion_model_project_tpu_torch.utils.config import (PUBLISHED_UNET_KWARGS, parser,
                                                                process_args)

    t_phase = time.perf_counter()
    base = os.path.join(root, "search")
    feats = [str(f) for f in SEARCH_FEATURES]
    kw = dict(PUBLISHED_UNET_KWARGS, features=SEARCH_FEATURES)
    calls = search_calls(written_pred, kw)
    res = {"features": list(SEARCH_FEATURES), "calls": calls}

    # (b) the train CLI at the grid's first stack; the inference CLI at --attention 1..2
    res["b_train"] = train_run("(b) --features 32 64 128 256 --attention 3..2, 1 epoch",
                               train_argv(data_dir, vae_dir, os.path.join(base, "b"),
                                          "--num-epochs", "1", "--features", *feats),
                               calls, smi)
    run_12 = write_run_dir(os.path.join(base, "run_1_2"), vae_dir, data_dir,
                           dict(PUBLISHED_UNET_KWARGS, attention="1..2"), seed=8)
    _zero_launches()
    cli = inference.run(["--model-dir", run_12, "--sampler", "ddim", "--steps", str(STEPS),
                         "--device", TRAIN_DEVICE])
    launched = _launches()
    gn, attn = expected_calls(cli.predictor, STEPS)
    ok = (cli.prediction.shape == (1, S, 3, HW, HW)
          and bool(torch.isfinite(torch.from_numpy(cli.prediction)).all()))
    log(f"[search] (b) inference CLI, DDIM-{STEPS}, --attention 1..2 (the UNet's first level "
        f"attends over {(HW // 4) ** 2} tokens): output {cli.prediction.shape} finite: {ok}; "
        f"request {cli.seconds * 1e3:.1f} ms; launches {launched} (expected {gn} / {attn} / 0)"
        f" | {smi}")
    if not ok or launched != {"groupnorm_act": gn, "fused_attention": attn, "conv3x3": 0}:
        raise RuntimeError(f"(b): output ok {ok}, launches {launched}")
    res["b_inference"] = {"request_ms": cli.seconds * 1e3, "launches": launched}
    del cli

    # (c) --mode optimize: 2 trials of 1 epoch, each drawing its batch, kernel
    # and lr; 4 levels from 32 channels = the same UNet as (b)
    save_c = os.path.join(base, "c")
    argv_c = train_argv(data_dir, vae_dir, save_c, "--mode", "optimize", "--n-trials", "2",
                        "--num-epochs", "1", "--range-batch-size", str(TRAIN_B), str(TRAIN_B),
                        "--range-kernel-size", "3", "3", "--range-level", "4", "4",
                        "--top-feature-channels", feats[0], "--range-learning-rate",
                        "1e-4", "1e-3")
    rec, total, steps, secs = _recorded("(c) optimize", train_cli.main, argv_c, calls)
    with open(os.path.join(save_c, "study.json")) as f:
        study = json.load(f)
    runs = sorted(d for d in os.listdir(save_c) if os.path.isdir(os.path.join(save_c, d)))
    if (total != steps or [r["state"] for r in study] != ["COMPLETE"] * 2 or len(runs) != 2
            or not all(math.isfinite(r["value"]) for r in study)):
        raise RuntimeError(f"(c): launches {total} against the steps' {steps}; study {study}; "
                           f"run dirs {runs}")
    for d in runs:
        _finite_log("(c)", os.path.join(save_c, d), 1)
    log(f"[search] (c) --mode optimize, 2 trials of 1 epoch: {secs:.1f} s; study "
        + "; ".join(f"trial {r['trial']} {r['state']} value {r['value']!r} params {r['params']}"
                    for r in study)
        + f"; launches {total}, every step's module-derived | {smi}")
    res["c"] = {"seconds": secs, "study": study, "launches": total}

    # (d) the grid search's first entry: the dry-run forward at 128^2 launches
    # E3D + E2D + UNet GroupNorms and the UNet's attentions once
    save_d = os.path.join(base, "d")
    argv_d = ["--root-dir", data_dir, "--save-dir", save_d, "--vae-path", vae_dir,
              "--in-channels", str(kw["in_channels"]), "--out-channels", str(kw["out_channels"]),
              "--batch-size", str(TRAIN_B), "--epochs", "1", "--num-slices", str(S),
              "--num-timesteps", "1000", "--device", TRAIN_DEVICE, "--grid-index", "0"]
    if list(gs.GRID[0]["features"]) != list(SEARCH_FEATURES):
        raise RuntimeError(f"the grid's first entry is {gs.GRID[0]}")
    rec, total, steps, secs = _recorded("(d) grid", gs.main, argv_d, calls)
    dry = {"groupnorm_act": calls["encoder_3d"] + calls["encoder_2d"] + calls["unet"],
           "fused_attention": calls["attention"], "conv3x3": 0}
    with open(os.path.join(save_d, "results.csv")) as f:
        rows = list(csv.DictReader(f))
    if (total != {k: steps[k] + dry[k] for k in _ZERO} or len(rows) != 1
            or rows[0]["run_name"] != gs.run_name(gs.GRID[0])
            or not math.isfinite(float(rows[0]["val_loss"]))
            or not all(os.path.exists(os.path.join(save_d, f))
                       for f in ("top10.csv", "summary.txt"))):
        raise RuntimeError(f"(d): launches {total}, steps {steps} + dry run {dry}; rows {rows}")
    log(f"[search] (d) grid search --grid-index 0 ({rows[0]['run_name']}), 1 epoch: {secs:.1f} s;"
        f" val_loss {rows[0]['val_loss']}; launches {total} = the steps' + the dry run's {dry}"
        f" | {smi}")
    res["d"] = {"seconds": secs, "row": rows[0], "launches": total}

    # (e) the latent cache: the first train batch's loss through the cache
    # against the uncached loss, same noise and t; then the CLI
    argv_e = train_argv(data_dir, vae_dir, os.path.join(base, "e"), "--num-epochs", "1",
                        "--features", *feats, "--cache-latents", "true")
    pdict = process_args(parser.parse_args(argv_e))
    loaders = get_loader(data_dir, batch_size=TRAIN_B, use_3d=True)[0]
    pred = set_model("latent-diffusion", pdict["training"]["predictor"],
                     os.path.join(data_dir, "statistics.json"), device=TRAIN_DEVICE)
    with torch.no_grad():
        enliven(pred.model, 9)  # a UNet output that depends on its inputs
    raw = _batch_dict(next(_natural_order_batches(loaders[0])), TRAIN_DEVICE)
    gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(0)
    noise = torch.randn((TRAIN_B * S, 8, HW // 4, HW // 4), generator=gen, device=TRAIN_DEVICE)
    t = torch.randint(0, 1000, (TRAIN_B * S,), generator=gen, device=TRAIN_DEVICE)
    with torch.no_grad():
        ref = diffusion_loss_fn(pred, raw, noise=noise, t=t)[0].item()
        got = cached_latent_loss_fn(pred, precompute_latent_cache(pred, raw), noise=noise,
                                    t=t)[0].item()
    rel = abs(got - ref) / abs(ref)
    log(f"[search] (e) the first train batch's loss through the latent cache {got!r} against "
        f"the uncached {ref!r}: relative difference {rel:.3e} (tol {CACHE_TOL:.0e})")
    if not rel <= CACHE_TOL:
        raise RuntimeError(f"(e): cached loss {got} against uncached {ref}")
    del pred, raw
    res["e"] = {"first_loss": {"cached": got, "uncached": ref, "rel_diff": rel}}
    n_train, n_val, n_test = (len(ld.dataset) for ld in loaders)
    batches = lambda n: -(-n // TRAIN_B)  # noqa: E731
    encode = calls["encoder_3d"] + calls["encoder_2d"]
    for augment, variants in (("false", 1), ("true", 4)):
        save_e = os.path.join(base, f"e_{augment}")
        argv = train_argv(data_dir, vae_dir, save_e, "--num-epochs", "1", "--features", *feats,
                          "--cache-latents", "true", "--augment", augment)
        _zero_launches()
        t0 = time.perf_counter()
        train_cli.main(argv)
        _sync()
        secs = time.perf_counter() - t0
        total = _launches()
        # the cache build encodes every train batch of each variant and the
        # val batches; the cached train steps launch nothing (the UNet runs
        # plain under autograd), a cached val step the UNet's calls, a test
        # step (raw batches) E3D + E2D + the UNet's
        n_cached_val, n_test_b = batches(n_val), batches(n_test)
        want = {"groupnorm_act": (variants * batches(n_train) + n_cached_val) * encode
                + n_cached_val * calls["unet"] + n_test_b * (encode + calls["unet"]),
                "fused_attention": (n_cached_val + n_test_b) * calls["attention"],
                "conv3x3": 0}
        run = _newest_run(save_e)
        log_json = _finite_log(f"(e) --augment {augment}", run, 1)
        log(f"[search] (e) --cache-latents --augment {augment}, 1 epoch: {secs:.1f} s (epoch "
            f"{log_json['time'][0]:.2f} s); train loss {log_json['train_loss']}, val loss "
            f"{log_json['val_loss']}, test loss {log_json.get('test_loss')}; launches {total} "
            f"(expected {want}) | {smi}")
        if total != want:
            raise RuntimeError(f"(e) --augment {augment}: launches {total}, expected {want}")
        res["e"][f"augment_{augment}"] = {"seconds": secs, "epoch_s": log_json["time"],
                                          "train_loss": log_json["train_loss"],
                                          "val_loss": log_json["val_loss"], "launches": total}
    shutil.rmtree(base)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[search] the phase took {res['seconds']:.1f} s | {smi}")
    return res


# ------------------------------------------------------------------ phase 20: int8

INT8_OPS = 1979e12       # H100 SXM dense int8 tensor-core peak, operations/s
INT8_REPS = 2            # timed requests of each variant in (a)
INT8_CVC_HW, INT8_CVC_STEPS = 128, 5  # (f): card against CPU, 128^2 x 3, B=1, DDIM-5
# (f) and the card tests: two int8 runs whose float paths differ by ulps carry
# independent rounding noise a few int8 layers on, so their distance is held
# to that of two independent int8 errors (2x one) with room, and each one's
# spread from its own float32 result to within 2x of the other's
INT8_CROSS, INT8_SPREAD = 2.5, 2.0


def is_k4_kernel(name: str) -> bool:
    return "int8_conv_mma" in name


def int8_calls(pred) -> dict:
    """K4 launches of a VAE-int8 predict call (E2D + D3D) and of a UNet-int8
    forward, counted from the modules: every Conv2d / Conv3d whose channels
    are not too thin for the int8 path."""
    from diffusion_model_project_tpu_torch.models.layers import Conv2d, Conv3d
    from diffusion_model_project_tpu_torch.ops.quant import use_float_path

    def count(module):
        return sum(not use_float_path(m.in_channels, m.out_channels)
                   for m in module.modules() if isinstance(m, (Conv2d, Conv3d)))

    return {"vae": count(pred.vae.encoder_2d) + count(pred.vae.decoder_3d),
            "unet": count(pred.model)}


class Int8Recorder:
    """While entered, counts K4's inputs a call of the int8 conv meets: the
    codes' shapes (N, D, H, W, Cp) and (Cout, kd, kh, kw, Cp), stride,
    padding, Cin and the output dtype, by wrapping ``models.layers.int8_conv``."""

    def __enter__(self):
        from diffusion_model_project_tpu_torch.models import layers
        from diffusion_model_project_tpu_torch.ops.cuda import int8_conv as k4

        self.seen = collections.Counter()
        self._layers, self._orig = layers, layers.int8_conv

        def record(x, weight, stride, padding, out_dtype):
            two_d = x.ndim == 4
            n, cin = x.shape[:2]
            cp = k4.padded_channels(cin)
            spatial = ((1,) if two_d else ()) + tuple(x.shape[2:])
            kernel = ((1,) if two_d else ()) + tuple(weight.shape[2:])
            stride3 = ((1,) if two_d else ()) + tuple(stride)
            pads = (((0, 0),) if two_d else ()) + tuple(tuple(p) for p in padding)
            self.seen[("int8_conv", (n, *spatial, cp), (weight.shape[0], *kernel, cp), stride3,
                       tuple(v for p in pads for v in p), cin, str(out_dtype))] += 1
            return self._orig(x, weight, stride, padding, out_dtype)

        layers.int8_conv = record
        return self

    def __exit__(self, *exc):
        self._layers.int8_conv = self._orig


def _k4_case(key, calls: int, gen) -> dict:
    """K4 against its plain version (torch.equal) at one recorded input, with
    its times, bound and the library yardsticks: the bf16 cuDNN conv at the
    same shape (what the float path runs) and, at 1x1x1, ``torch._int_mm``."""
    import torch.nn.functional as F

    from diffusion_model_project_tpu_torch.ops.cuda import int8_conv as k4

    _, xs, ws, stride, pads, cin, dt = key
    dtype = DTYPES[dt]
    x_q = torch.randint(-127, 128, xs, generator=gen, device="cuda", dtype=torch.int8)
    w_q = torch.randint(-127, 128, ws, generator=gen, device="cuda", dtype=torch.int8)
    x_q[..., cin:] = 0
    w_q[..., cin:] = 0
    sw = torch.rand(ws[0], generator=gen, device="cuda") * 1e-4 + 1e-6
    args = (x_q, w_q, sw, stride, pads, dtype)
    got = k4.int8_conv(*args)
    want = k4.int8_conv_plain(*args)
    equal = torch.equal(got, want)
    err = (got.float() - want.float()).abs().max().item()
    del want
    times = {"ms": sync_ms(lambda: k4.int8_conv(*args), iters=10, warmup=2),
             "plain_ms": sync_ms(lambda: k4.int8_conv_plain(*args), iters=1, warmup=0),
             "device_ms": device_ms(lambda: k4.int8_conv(*args), keep=is_k4_kernel,
                                    counter=lambda: k4.LAUNCHES)}
    # the library: the float path's bf16 conv on the same values, channels-first
    xb = F.pad(x_q[..., :cin].permute(0, 4, 1, 2, 3).to(torch.bfloat16),
               pads[4:6] + pads[2:4] + pads[0:2])
    wb = w_q[..., :cin].permute(0, 4, 1, 2, 3).to(torch.bfloat16)
    if xs[1] == 1 and ws[1] == 1:
        xb, wb = xb[:, :, 0], wb[:, :, 0]
        library = lambda: F.conv2d(xb, wb, stride=stride[1:])  # noqa: E731
    else:
        library = lambda: F.conv3d(xb, wb, stride=stride)  # noqa: E731
    times["library_ms"] = sync_ms(library, iters=10, warmup=2)
    times["library_device_ms"] = library_device_ms(library)
    if ws[1:4] == (1, 1, 1):
        a, b = x_q.reshape(-1, xs[-1]), w_q.reshape(ws[0], xs[-1]).t()
        try:
            times["int_mm_ms"] = sync_ms(lambda: torch._int_mm(a, b), iters=10, warmup=2)
        except RuntimeError as e:
            log(f"[int8] torch._int_mm not measured at {xs}: {str(e)[:120]}")
            times["int_mm_ms"] = None
    del xb, wb
    m = got[:, 0].numel()
    taps = ws[1] * ws[2] * ws[3]
    flops = 2 * m * ws[0] * taps * cin
    nbytes = x_q.numel() + w_q.numel() + 4 * ws[0] + got.numel() * got.element_size()
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / INT8_OPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    detail = (f"{'x'.join(map(str, ws[1:4]))} stride {'x'.join(map(str, stride))} Cin {cin} "
              f"-> {ws[0]} {dt.replace('torch.', '')}")
    return dict(kernel="int8_conv", shape=list(xs), weight_shape=list(ws), stride=list(stride),
                padding=list(pads), dtype=dt, detail=detail, calls_per_request=calls,
                equal=equal, max_abs_err=err, rel_err=err, tol=0.0, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations", bytes=nbytes,
                flops=flops, bytes_ms=bytes_ms, ops_ms=ops_ms,
                device_tops=flops / times["device_ms"] / 1e9, **times)


def _rel_mse(a, b) -> float:
    return ((a.float() - b.float()).pow(2).mean() / b.float().pow(2).mean()).item()


def int8_request(smi: str) -> tuple:
    """(a) the published B=2 bf16 DDIM-50 request as float, with_vae_int8()
    and both flags: launches held to the module counts, request ms, peak
    memory, int8 against float; the both-flags request once more under
    torch.profiler: device time of K4 and of the quantize pass."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from diffusion_model_project_tpu_torch.ops import quant
    from diffusion_model_project_tpu_torch.ops.cuda import int8_conv as k4

    dev = torch.device("cuda")
    pred = published_predictor(dev, torch.bfloat16)
    img, vel, noise = (t.to(dev) for t in make_inputs(B, S, HW, seed=1))
    calls = int8_calls(pred)
    exp_gn, exp_attn = expected_calls(pred, STEPS)
    variants = {"float": (pred, 0), "vae": (pred.with_vae_int8(), calls["vae"]),
                "vae_unet": (pred.with_vae_int8().with_unet_int8(),
                             calls["vae"] + calls["unet"] * STEPS)}

    def request(p):
        out = p.predict_ddim(img, vel, num_steps=STEPS, noise=noise)
        torch.cuda.synchronize()
        return out

    res, shapes, outs = {}, {}, {}
    for name, (p, k4_calls) in variants.items():
        with Int8Recorder() as rec:  # the warm-up, recording K4's inputs
            request(p)
        shapes[name] = rec.seen
        _zero_launches()
        k4.LAUNCHES = 0
        out = request(p)
        launches = {**_launches(), "int8_conv": k4.LAUNCHES}
        want = {"groupnorm_act": exp_gn, "fused_attention": exp_attn, "conv3x3": 0,
                "int8_conv": k4_calls}
        if launches != want:
            raise RuntimeError(f"[int8] (a) {name}: launches {launches} against {want}")
        if tuple(out.shape) != (B, S, 3, HW, HW) or not torch.isfinite(out).all():
            raise RuntimeError(f"[int8] (a) {name}: bad output {tuple(out.shape)}")
        outs[name] = out
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(INT8_REPS):
            request(p)
        ms = (time.perf_counter() - t0) * 1e3 / INT8_REPS
        res[name] = {"launches": launches, "request_ms": ms, "volumes_per_s": B * 1e3 / ms,
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "k4_inputs": sum(rec.seen.values())}
    for name in ("vae", "vae_unet"):
        res[name]["rel_mse_vs_float"] = _rel_mse(outs[name], outs["float"])
        if not 0 < res[name]["rel_mse_vs_float"] < 1:
            raise RuntimeError(f"[int8] (a) {name}: relative MSE against float "
                               f"{res[name]['rel_mse_vs_float']:.3e}")

    # one both-flags request under the profiler, the quantize pass in ranges
    saved = (quant.quantize_channels_last, quant.quantize_weight)

    def ranged(fn):
        def call(*a, **kw):
            with record_function("int8 quantize"):
                return fn(*a, **kw)
        return call

    quant.quantize_channels_last, quant.quantize_weight = map(ranged, saved)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(SENTINELS):
                torch.cuda._sleep(1000)
            request(variants["vae_unet"][0])
    finally:
        quant.quantize_channels_last, quant.quantize_weight = saved
    # the kernels (not the range's own span on the device timeline, which
    # holds the gaps between its kernels); the quantize pass: the kernels its
    # ranges launched
    evs = [(e.name, (e.time_range.end - e.time_range.start) / 1e3) for e in prof.events()
           if e.device_type == DeviceType.CUDA and SENTINEL not in e.name
           and e.name != "int8 quantize"]
    quant_ms = sum(e.device_time_total for e in prof.events()
                   if e.device_type == DeviceType.CPU and e.name == "int8 quantize") / 1e3
    k4_evs = [ms for name, ms in evs if is_k4_kernel(name)]
    profiled = {"device_ms": sum(ms for _, ms in evs), "k4_ms": sum(k4_evs),
                "k4_kernels": len(k4_evs), "quantize_ms": quant_ms}
    profiled["other_ms"] = profiled["device_ms"] - profiled["k4_ms"] - quant_ms
    res["vae_unet"]["profile"] = profiled
    for name, r in res.items():
        log(f"[int8] (a) {name}: B={B} bf16 DDIM-{STEPS} request {r['request_ms']:.1f} ms, "
            f"{r['volumes_per_s']:.3f} volumes/s, peak {r['peak_bytes'] / 2**30:.2f} GiB; "
            f"launches {r['launches']}"
            + (f"; relative MSE against float {r['rel_mse_vs_float']:.3e}" if name != "float"
               else "") + f" | {smi}")
    log(f"[int8] (a) vae_unet under torch.profiler: device {profiled['device_ms']:.1f} ms, K4 "
        f"{profiled['k4_ms']:.1f} ms over {profiled['k4_kernels']} kernels, the quantize pass "
        f"{quant_ms:.1f} ms, the rest {profiled['other_ms']:.1f} ms | {smi}")
    return res, shapes["vae_unet"], calls


def int8_serve(run_dir: str, calls: dict, smi: str) -> dict:
    """(d) the serve CLI's server with --int8 on phase 8's run dir: one
    request over HTTP, padded to a batch of 2, against the direct call on
    that padded batch (its request twice, its latents twice)."""
    import io
    import threading
    import urllib.request

    import numpy as np

    from diffusion_model_project_tpu_torch.ops.cuda import int8_conv as k4
    from diffusion_model_project_tpu_torch.scripts import serve as serve_cli
    from diffusion_model_project_tpu_torch.scripts.perf_serve_daemon import volume
    from diffusion_model_project_tpu_torch.utils.serving import request_noise

    predictor, server, httpd = serve_cli.build_server(serve_cli.parse_args(
        ["--model-dir", run_dir, "--int8", "--port", "0", "--batch-sizes", "2",
         "--max-wait-ms", "1", "--image-size", str(HW)]))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        if not (predictor.vae_int8 and not predictor.unet_int8):
            raise RuntimeError("[int8] (d): serve --int8 did not build a vae_int8 predictor")
        img, v2d = volume(0, 9000)
        buf = io.BytesIO()
        np.savez(buf, img=img, v2d=v2d, seed=9)
        server.warmup()
        _zero_launches()
        k4.LAUNCHES = 0
        t0 = time.perf_counter()
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/v1/predict",
                                     data=buf.getvalue())
        with urllib.request.urlopen(req, timeout=600) as resp:
            got = np.load(io.BytesIO(resp.read()))["velocity"]
        latency = time.perf_counter() - t0
        launches = {**_launches(), "int8_conv": k4.LAUNCHES}
        stats = server.stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        th.join(timeout=60)
    exp_gn, exp_attn = expected_calls(predictor, STEPS)
    want_l = {"groupnorm_act": exp_gn, "fused_attention": exp_attn, "conv3x3": 0,
              "int8_conv": calls["vae"]}
    if launches != want_l or stats["padded_slots"] != 1:
        raise RuntimeError(f"[int8] (d): launches {launches} against {want_l}, stats {stats}")
    ld = S // predictor.vae_depth_factor
    noise = request_noise(9, (ld, predictor.latent_channels, HW // 4, HW // 4))
    two = lambda a: torch.from_numpy(np.stack([a, a])).cuda()  # noqa: E731
    want = predictor.predict_ddim(two(img), two(v2d), num_steps=STEPS,
                                  noise=torch.stack([noise, noise]).cuda())[0].cpu().numpy()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    if got.shape != (S, 3, HW, HW) or not rel <= 1e-6:
        raise RuntimeError(f"[int8] (d): served {got.shape} at {rel:.3e} from the direct call")
    log(f"[int8] (d) serve.py --int8: one request padded to a batch of 2 in {latency:.3f} s; "
        f"against the direct call on that padded batch {rel:.3e}; launches {launches} | {smi}")
    return {"latency_s": latency, "rel_err_vs_direct": rel, "launches": launches,
            "padded_slots": stats["padded_slots"]}


def int8_eval(run_dir: str, data_dir: str, calls: dict, ev: dict, smi: str) -> dict:
    """(e) eval_testset_end2end --int8, DDIM-50 at batch 1, on phase 8's dirs,
    float32 as the script runs; launches held; nMAE beside phase 10's float run."""
    import contextlib

    import numpy as np

    from diffusion_model_project_tpu_torch.ops.cuda import int8_conv as k4
    from diffusion_model_project_tpu_torch.scripts import eval_testset_end2end as e2e

    out_dir = os.path.join(os.path.dirname(run_dir), "eval_int8")
    _zero_launches()
    k4.LAUNCHES = 0
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        r = e2e.run(["--diffusion-model-path", run_dir, "--dataset-dir", data_dir, "--int8",
                     "--sampler", "ddim", "--steps", str(STEPS), "--output-dir", out_dir])
    n = len(r.per_sample)
    gn, attn = expected_calls(r.predictor, STEPS)
    launches = {**_launches(), "int8_conv": k4.LAUNCHES}
    want = {"groupnorm_act": n * gn, "fused_attention": n * attn, "conv3x3": 0,
            "int8_conv": n * calls["vae"]}
    nmae = [x["nmae_total"] for x in r.per_sample]
    if (launches != want or "int8 frozen-VAE path enabled" not in "".join(tee.text)
            or n != 3 or not np.all(np.isfinite(nmae))):
        raise RuntimeError(f"[int8] (e): launches {launches} against {want}, nMAE {nmae}")
    float_nmae = ev["end2end"]["ddim_b1"]["nmae_total"]
    log(f"[int8] (e) eval_testset_end2end --int8 DDIM-{STEPS}: {n} samples, nMAE "
        + ", ".join(f"{x:.4f}" for x in nmae) + " (float " + ", ".join(
            f"{x:.4f}" for x in float_nmae) + f"); steady {r.steady_seconds:.3f} s a sample; "
        f"launches {launches} | {smi}")
    return {"launches": launches, "nmae_total": nmae, "float_nmae_total": float_nmae,
            "steady_s_per_sample": r.steady_seconds}


def int8_card_vs_cpu(smi: str) -> dict:
    """(f) both int8 flags at published widths, 128^2 x 3, B=1, float32, TF32
    off, DDIM-5, on the card and on the CPU from the same weights and noise."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    s, hw = 3, INT8_CVC_HW
    cpu = published_predictor(torch.device("cpu"), torch.float32, seed=3)
    card = copy.deepcopy(cpu).to("cuda")
    img, vel, noise = make_inputs(1, s, hw, seed=4)

    def run(p, d):
        return p.predict_ddim(img.to(d), vel.to(d), num_steps=INT8_CVC_STEPS,
                              noise=noise.to(d)).cpu()

    t0 = time.perf_counter()
    cpu_f32, cpu8 = run(cpu, "cpu"), run(cpu.with_vae_int8().with_unet_int8(), "cpu")
    cpu_s = time.perf_counter() - t0
    card_f32, card8 = run(card, "cuda"), run(card.with_vae_int8().with_unet_int8(), "cuda")
    r = {"cpu_spread": _rel_mse(cpu8, cpu_f32), "card_spread": _rel_mse(card8, card_f32),
         "card_vs_cpu": _rel_mse(card8, cpu8), "float_card_vs_cpu": _rel_mse(card_f32, cpu_f32),
         "cpu_s": cpu_s}
    log(f"[int8] (f) card against CPU, published widths, {s}x{hw}^2, B=1, float32, DDIM-"
        f"{INT8_CVC_STEPS}, both int8 flags: relative MSE int8 against float32 CPU "
        f"{r['cpu_spread']:.3e}, card {r['card_spread']:.3e}; card int8 against CPU int8 "
        f"{r['card_vs_cpu']:.3e} (limit {INT8_CROSS} x the CPU's spread); float32 card "
        f"against CPU {r['float_card_vs_cpu']:.3e}; cpu {cpu_s:.1f} s | {smi}")
    ok = (torch.isfinite(card8).all() and 0 < r["cpu_spread"]
          and r["cpu_spread"] / INT8_SPREAD <= r["card_spread"] <= INT8_SPREAD * r["cpu_spread"]
          and r["card_vs_cpu"] <= INT8_CROSS * r["cpu_spread"])
    if not ok:
        raise RuntimeError(f"[int8] (f): card and CPU int8 disagree: {r}")
    return r


def phase_int8(smi: str, run_dir: str, data_dir: str, ev: dict, probe_rows: list) -> dict:
    """Phase 20: the int8 variants (with_vae_int8 / with_unet_int8, K4)."""
    from diffusion_model_project_tpu_torch.ops.cuda import int8_conv as k4

    t_start = time.perf_counter()
    float_paths = k4.LAUNCHES - sum(r["calls"] for r in probe_rows)
    if float_paths:
        raise RuntimeError(f"[int8] K4 launched {float_paths} times on the float paths")
    req, shapes, calls = int8_request(smi)
    # (b) K4 at every input (a)'s both-flags request met
    gen = torch.Generator(device="cuda").manual_seed(20)
    rows = []
    for key, n in sorted(shapes.items(), key=lambda kv: str(kv[0])):
        row = _k4_case(key, n, gen)
        rows.append(row)
        lib_dev = row["library_device_ms"]
        log(f"[int8] (b) {str(tuple(key[1])):24s} {row['detail']:38s} x{n:<4d} equal "
            f"{row['equal']} (max abs err {row['max_abs_err']:.1e}) | ms {row['ms']:.4f} device "
            f"{row['device_ms']:.4f} ({row['device_tops']:.1f} TOPS) plain {row['plain_ms']:.2f} "
            f"bf16 cuDNN {row['library_ms']:.4f} device "
            f"{'not measured' if lib_dev is None else f'{lib_dev:.4f}'}"
            + (f" int_mm {row['int_mm_ms']:.4f}" if row.get("int_mm_ms") else "")
            + f" bound {row['bound_ms']:.4f} ({row['bound_by']})")
        if not row["equal"]:
            raise RuntimeError(f"[int8] (b) K4 differs from its plain version at {key}")
    per = {k: sum(r[k] * r["calls_per_request"] for r in rows)
           for k in ("device_ms", "bound_ms", "ms", "library_ms")}
    log(f"[int8] (b) K4 a both-flags request: {sum(r['calls_per_request'] for r in rows)} calls "
        f"at {len(rows)} inputs, device {per['device_ms']:.2f} ms (bound {per['bound_ms']:.2f}), "
        f"back to back {per['ms']:.2f}, the bf16 cuDNN convs {per['library_ms']:.2f} | {smi}")
    # (c) the probe's int8 row (phase 5 ran it)
    for r in probe_rows:
        log(f"[int8] (c) conv probe stage {r['stage']} {tuple(r['shape'])}: K4 {r['ms']:.3f} ms, "
            f"{r['tflops']:.1f} TOPS, {100 * r['bound_ms'] / r['ms']:.1f}% of the int8 bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}), max abs err {r['max_abs_err']:.1e}")
    sv = int8_serve(run_dir, calls, smi)
    e2e = int8_eval(run_dir, data_dir, calls, ev, smi)
    cvc = int8_card_vs_cpu(smi)
    secs = time.perf_counter() - t_start
    log(f"[int8] phase 20 in {secs:.1f} s")
    return {"request": req, "calls": calls, "rows": rows, "per_request": per,
            "probe_rows": probe_rows, "serve": sv, "eval": e2e, "card_vs_cpu": cvc,
            "seconds": secs}


def _totals(rs: list) -> dict:
    """A kernel's numbers a request from its rows: each shape's time times
    its calls a request, summed; the largest error."""
    tot = lambda k: sum(r[k] * r["calls_per_request"] for r in rs)  # noqa: E731
    lib_dev = [r.get("library_device_ms") for r in rs]
    return {"max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": tot("ms"), "device_ms": tot("device_ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"),
            "bound_by": "bytes" if tot("bytes_ms") >= tot("ops_ms") else "operations",
            "library_ms": tot("library_ms"),
            "library_device_ms": None if None in lib_dev else tot("library_device_ms")}


def summarize(rows: list, launches: dict, by_path: dict, cli_rows: list, eval_rows: list,
              eval_paths: list, train_rows: list, train_paths: list, vae_rows: list,
              vae_paths: list, vae_k1: dict, serve_rows: list, serve_paths: list,
              sv: dict, wide_rows: list, search_paths: list) -> list:
    """One entry per kernel; times are per request of its path: one
    predict_ddim for K1 (on channels-last x, the samplers' layout on the
    card, as in ``cli`` and ``serving``; ``channels_first`` the request's
    calls on channels-first x) and K2, one call at each probe stage (the
    planner's tile) for K3. ``launches`` is the DDIM slice's count (the conv probe's
    for K3), ``launches_by_path`` every counted path's; ``cli`` holds K1 and
    K2 at the CLI's own shapes and dtype, a DDIM-50 request of the CLI;
    ``evaluation`` at the evaluation paths' (shape, dtype) pairs that no
    earlier phase held, calls counted over phase "evaluation"'s hooked runs,
    with the launches of each evaluation path; ``training`` at the training
    paths' pairs that no earlier phase held (the validation and test passes,
    and the train steps' frozen encodes), with the training paths' launches;
    ``vae_training`` likewise for the VAE trainers' paths, with K1's device
    time a batch of each; ``serving`` the serving paths' launches and a
    dispatch's, and the kernels at the served pairs no earlier phase held
    (calls a dispatch of the batch size that meets them); ``wide`` (K2)
    each of phase 18's rows, one call at a shape beyond the published UNet's,
    with the launches of phase 19's paths."""
    meta = {
        "groupnorm_act": ("diffusion_model_project_tpu_torch/csrc/groupnorm_act.cu",
                          "diffusion_model_project_tpu/ops/pallas/groupnorm_silu.py:47"),
        "fused_attention": ("diffusion_model_project_tpu_torch/csrc/attention.cu",
                            "diffusion_model_project_tpu/ops/pallas/attention.py:56"),
        "conv3x3": ("diffusion_model_project_tpu_torch/csrc/conv3x3.cu",
                    "scripts/perf_probe_conv.py:77"),
    }
    out = []
    for name, (source, replaces) in meta.items():
        # the samplers' K1 calls (the request, the CLI, serving) run on
        # channels-last x; the channels-first rows of the request apart
        sampled = lambda rs: [r for r in rs if r["kernel"] == name  # noqa: E731
                              and r.get("channels_last", False) == (name == "groupnorm_act")]
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches[name],
                 "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
                 **_totals(sampled(rows))}
        if name == "groupnorm_act":
            entry["channels_first"] = _totals(
                [r for r in rows if r["kernel"] == name and not r["channels_last"]])
        cli = sampled(cli_rows)
        if cli:
            entry["cli"] = {"dtypes": sorted({r["dtype"] for r in cli}),
                            "launches": by_path["cli_ddim"][name],
                            "rel_err": max(r["rel_err"] for r in cli),
                            "tol": max(r["tol"] for r in cli), **_totals(cli)}
        ev = [r for r in eval_rows if r["kernel"] == name]
        if ev:
            entry["evaluation"] = {"dtypes": sorted({r["dtype"] for r in ev}),
                                   "launches": {p: by_path[p][name] for p in eval_paths},
                                   "rel_err": max(r["rel_err"] for r in ev),
                                   "tol": max(r["tol"] for r in ev), **_totals(ev)}
        tr = [r for r in train_rows if r["kernel"] == name]
        entry["training"] = {"launches": {p: by_path[p][name] for p in train_paths}}
        if tr:
            entry["training"].update({"dtypes": sorted({r["dtype"] for r in tr}),
                                      "rel_err": max(r["rel_err"] for r in tr),
                                      "tol": max(r["tol"] for r in tr), **_totals(tr)})
        vr = [r for r in vae_rows if r["kernel"] == name]
        entry["vae_training"] = {"launches": {p: by_path[p][name] for p in vae_paths}}
        if name == "groupnorm_act":
            entry["vae_training"]["device_ms_a_batch"] = vae_k1
        if vr:
            entry["vae_training"].update({"dtypes": sorted({r["dtype"] for r in vr}),
                                          "rel_err": max(r["rel_err"] for r in vr),
                                          "tol": max(r["tol"] for r in vr), **_totals(vr)})
        sr = sampled(serve_rows)
        entry["serving"] = {"launches": {p: by_path[p][name] for p in serve_paths},
                            "per_dispatch": {k: sv[k]["per_dispatch"].get(name, 0)
                                             for k in ("ddim50", "dpm10")}}
        if sr:
            entry["serving"].update({"dtypes": sorted({r["dtype"] for r in sr}),
                                     "rel_err": max(r["rel_err"] for r in sr),
                                     "tol": max(r["tol"] for r in sr), **_totals(sr)})
        if name == "fused_attention":
            entry["wide"] = {
                "launches": {p: by_path[p][name] for p in search_paths},
                "rows": [{k: r[k] for k in ("shape", "dtype", "detail", "max_abs_err", "rel_err",
                                            "tol", "ms", "device_ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms", "library_device_ms")}
                         for r in wide_rows]}
        out.append(entry)
    return out


def summarize_int8(i8: dict, probe_launches: int, by_path: dict) -> dict:
    """K4's entry: times a request of the both-flags B=2 DDIM-50 path (phase
    20 (a)'s inputs, each (b) row's time times its calls), its launches on
    that path, and on every int8 path counted."""
    paths = sorted(p for p in by_path if p.startswith("int8_"))
    return {"name": "int8_conv", "route": "cuda",
            "source": "diffusion_model_project_tpu_torch/csrc/int8_conv.cu",
            "replaces": "diffusion_model_project_tpu/ops/quant.py:67",
            "launches": i8["request"]["vae_unet"]["launches"]["int8_conv"],
            "launches_by_path": {"conv_probe": probe_launches,
                                 **{p: by_path[p]["int8_conv"] for p in paths}},
            **_totals(i8["rows"]),
            "int8": {"rows": len(i8["rows"]), "probe": [
                {k: r[k] for k in ("stage", "ms", "tflops", "bound_ms", "bound_by",
                                   "max_abs_err")} for r in i8["probe_rows"]],
                "request_ms": {k: v["request_ms"] for k, v in i8["request"].items()},
                "profile": i8["request"]["vae_unet"]["profile"]}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()
    device = phase_device()
    build = phase_build()
    # the conv probe first: its device times are read before phase 3's trace
    # of a UNet forward, after which torch.profiler drops kernels
    start = dict(PROFILER)
    conv_rows, probe_launches, probed = phase_conv_probe()
    conv_launches = probe_launches["conv3x3"]
    tallies = [tally("conv probe", start), profiler_check("before the slice")]
    sl = phase_slice()
    tallies.append(profiler_check("after the slice"))
    mark = dict(PROFILER)
    rows, k1_parts = phase_kernels(sl["shapes"], sl["launches"], k1_layouts=(False, True))
    tallies.append(tally("kernels", mark))
    mark = dict(PROFILER)
    wide_rows = phase_wide_attention()
    tallies.append(tally("wide attention", mark))
    from diffusion_model_project_tpu_torch.ops.cuda import _lib

    os.makedirs(_lib.BUILD_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix="entry_point_", dir=_lib.BUILD_DIR)  # inside the checkout
    try:
        t0 = time.perf_counter()
        run_dir, vae_dir, data_dir, written, written_pred = write_entry_point_dirs(root)
        log(f"[entry point] wrote the run dir, VAE dir and dataset ({EVAL_SAMPLES} samples) in "
            f"{time.perf_counter() - t0:.1f} s")
        ep = phase_entry_point(device["nvidia_smi"], run_dir, written, written_pred)
        mark = dict(PROFILER)
        cli_rows, cli_k1_parts = phase_kernels(
            ep["shapes"], {k: v for k, v in ep["runs"]["ddim"]["launches"].items() if v},
            tag="cli kernels", k1_layouts=(False, True))
        tallies.append(tally("cli kernels", mark))
        ev = phase_evaluation(device["nvidia_smi"], run_dir, vae_dir, data_dir, written_pred,
                              set(sl["shapes"]) | set(ep["shapes"]))
        tr = phase_training(device["nvidia_smi"], data_dir, vae_dir, written_pred, root)
        vt = phase_vae_training(device["nvidia_smi"], data_dir, root, written_pred)
        sv = phase_serving(device["nvidia_smi"], run_dir, data_dir, vae_dir, root)
        se = phase_search(device["nvidia_smi"], data_dir, vae_dir, written_pred, root)
        i8 = phase_int8(device["nvidia_smi"], run_dir, data_dir, ev,
                        [r for r in probed if r["candidate"] == "k4_int8"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    mark = dict(PROFILER)
    eval_rows, eval_k1_parts = phase_kernels(
        ev["new_shapes"], {"groupnorm_act": 1, "fused_attention": 1}, tag="eval kernels")
    tallies.append(tally("eval kernels", mark))
    held = set(sl["shapes"]) | set(ep["shapes"]) | set(ev["shapes"])
    tr["new_shapes"] = {k: v for k, v in tr["shapes"].items() if k not in held}
    log(f"[training] the kernels' inputs in the validation and test passes: "
        f"{len(tr['shapes'])} (shape, dtype) pairs, {len(tr['new_shapes'])} not held by an "
        f"earlier phase: " + ", ".join(f"{k[0]} {k[1]} {k[-1]}"
                                       for k in sorted(tr["new_shapes"], key=str)))
    train_rows, train_k1_parts = [], {}
    if tr["new_shapes"]:
        mark = dict(PROFILER)
        train_rows, train_k1_parts = phase_kernels(
            tr["new_shapes"], {k[0]: 1 for k in tr["new_shapes"]}, tag="train kernels")
        tallies.append(tally("train kernels", mark))
    held |= set(tr["shapes"])
    vae_shapes = collections.Counter()
    for seen in vt["shapes_by_path"].values():
        vae_shapes.update(seen)
    vt["new_shapes"] = {k: v for k, v in vae_shapes.items() if k not in held}
    log(f"[vae training] the kernels' inputs on the VAE training paths: {len(vae_shapes)} "
        f"(shape, dtype) pairs, {len(vt['new_shapes'])} not held by an earlier phase: "
        + ", ".join(f"{k[0]} {k[1]} {k[-1]}" for k in sorted(vt["new_shapes"], key=str)))
    vae_rows, vae_k1_parts = [], {}
    if vt["new_shapes"]:
        mark = dict(PROFILER)
        vae_rows, vae_k1_parts = phase_kernels(
            vt["new_shapes"], {k[0]: 1 for k in vt["new_shapes"]}, tag="vae kernels")
        tallies.append(tally("vae kernels", mark))
    vt["k1_device_ms"] = vae_k1_device_ms(vt["shapes_by_path"],
                                          rows + cli_rows + eval_rows + train_rows + vae_rows)
    held |= set(vae_shapes)
    sv["new_shapes"] = {k: v for k, v in sv["shapes"].items() if k not in held}
    log(f"[serving] the kernels' inputs at B=1 and B=8: {len(sv['shapes'])} (shape, dtype) "
        f"pairs, {len(sv['new_shapes'])} not held by an earlier phase: "
        + ", ".join(f"{k[0]} {k[1]} {k[-1]}" for k in sorted(sv["new_shapes"], key=str)))
    serve_rows, serve_k1_parts = [], {}
    if sv["new_shapes"]:
        mark = dict(PROFILER)
        serve_rows, serve_k1_parts = phase_kernels(
            sv["new_shapes"], {k[0]: 1 for k in sv["new_shapes"]}, tag="serve kernels",
            k1_layouts=(True,))
        tallies.append(tally("serve kernels", mark))
    cvc = phase_card_vs_cpu()
    eval_paths = {"evaluate": ev["evaluate"]["launches"],
                  **{f"eval_{k}": v["launches"] for k, v in ev["end2end"].items()},
                  **{f"inference_vae_{k}": v["launches"] for k, v in ev["inference_vae"].items()}}
    train_paths = {"train_steps": tr["a"]["train_step_launches"],
                   "train_eval_passes": tr["a"]["eval_launches"],
                   "train_physics_eval_passes": tr["b"]["eval_launches"]}
    vae_paths = {f"vae_{stage}_{kind}": vt[run]["launches_by_step"][f"{stage}_{kind}"]
                 for stage, run in (("s1", "b"), ("s2", "d")) for kind in ("train", "eval")}
    serve_paths = {"serve_ddim50": sv["ddim50"]["launches"], "serve_dpm10": sv["dpm10"]["launches"],
                   f"serve_export_ddim{EXPORT_STEPS}": sv["export"]["launches"],
                   "serve_ops_ddim50": sv["op_overhead"]["launches"]["op"]}
    search_paths = {"search_train_eval_passes": se["b_train"]["eval_launches"],
                    "search_cli_ddim_attention_1_2": se["b_inference"]["launches"],
                    "search_optimize": se["c"]["launches"], "search_grid": se["d"]["launches"],
                    "search_cache_latents": se["e"]["augment_false"]["launches"],
                    "search_cache_latents_augment": se["e"]["augment_true"]["launches"]}
    by_path = {"ddim_slice": {**sl["launches"], "conv3x3": 0},
               "conv_probe": {"groupnorm_act": 0, "fused_attention": 0,
                              "conv3x3": conv_launches},
               **{f"int8_ddim50_{k}": v["launches"] for k, v in i8["request"].items()},
               "int8_serve": i8["serve"]["launches"], "int8_eval_ddim50": i8["eval"]["launches"],
               **{f"cli_{k}": v["launches"] for k, v in ep["runs"].items()}, **eval_paths,
               **train_paths, **vae_paths, **serve_paths, **search_paths}
    kernels = summarize(rows + conv_rows, {**sl["launches"], "conv3x3": conv_launches}, by_path,
                        cli_rows, eval_rows, sorted(eval_paths), train_rows, sorted(train_paths),
                        vae_rows, sorted(vae_paths), vt["k1_device_ms"], serve_rows,
                        sorted(serve_paths), sv, wide_rows, sorted(search_paths))
    kernels.append(summarize_int8(i8, probe_launches["int8_conv"], by_path))
    total = time.perf_counter() - t_start

    detail = {"device": device, "build": build, "slice": {**sl, "shapes": [
        {"key": list(map(str, k)), "calls": v} for k, v in sl["shapes"].items()]},
        "kernel_rows": rows + conv_rows, "k1_request_ms": k1_parts, "conv_probe": probed,
        "card_vs_cpu": cvc, "cli_kernel_rows": cli_rows, "cli_k1_request_ms": cli_k1_parts,
        "entry_point": {**ep, "shapes": [{"key": list(map(str, k)), "calls": v}
                                         for k, v in ep["shapes"].items()]},
        "evaluation": {**ev, **{key: [{"key": list(map(str, k)), "calls": v}
                                      for k, v in ev[key].items()]
                                for key in ("shapes", "new_shapes")}},
        "eval_kernel_rows": eval_rows, "eval_k1_request_ms": eval_k1_parts,
        "training": {**tr, **{key: [{"key": list(map(str, k)), "calls": v}
                                    for k, v in tr[key].items()]
                              for key in ("shapes", "new_shapes")}},
        "train_kernel_rows": train_rows, "train_k1_request_ms": train_k1_parts,
        "vae_training": {**vt, "shapes_by_path": {
            p: [{"key": list(map(str, k)), "calls": v} for k, v in seen.items()]
            for p, seen in vt["shapes_by_path"].items()},
            "new_shapes": [{"key": list(map(str, k)), "calls": v}
                           for k, v in vt["new_shapes"].items()]},
        "vae_kernel_rows": vae_rows, "vae_k1_request_ms": vae_k1_parts,
        "serving": {**sv, **{key: [{"key": list(map(str, k)), "calls": v}
                                   for k, v in sv[key].items()]
                             for key in ("shapes", "new_shapes")}},
        "serve_kernel_rows": serve_rows, "serve_k1_dispatch_ms": serve_k1_parts,
        "wide_kernel_rows": wide_rows, "search": se,
        "int8": {**i8, "rows": [{k: (list(v) if isinstance(v, tuple) else v)
                                 for k, v in r.items()} for r in i8["rows"]]},
        "kernels": kernels, "profiler": {**PROFILER, "phases": tallies}, "seconds": total}
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
