"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without an NVIDIA GPU (the kernels have no
CPU or interpret mode). This file imports no JAX, so on a machine without it
the tests run with

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest -p no:cacheprovider
"""
import math

import pytest
import torch

from diffusion_model_project_tpu_torch.ops.attention import multihead_attention
from diffusion_model_project_tpu_torch.ops.cuda import attention as k2
from diffusion_model_project_tpu_torch.ops.cuda import conv3x3 as k3
from diffusion_model_project_tpu_torch.ops.cuda import groupnorm_act as k1
from diffusion_model_project_tpu_torch.ops.cuda import int8_conv as k4


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU or interpret mode)")
    return torch.Generator(device="cuda").manual_seed(2024)


def _rel_err(got, ref):
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


# float32 checks the algorithm (sums in another order only); bf16 checks the
# kernel in the working type, where the output alone rounds by 2^-9
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("shape,groups,act", [
    ((22, 64, 64, 64), 1, "silu"),        # UNet level 1, vectorized
    ((22, 2048, 2, 2), 1, "silu"),        # UNet bottleneck: spatial 4 < one vector
    ((22, 256, 16, 16), 1, ""),           # attention pre-norm
    ((2, 128, 3, 40, 40), 32, "silu"),    # VAE GN(32), several chunks per group
    ((3, 96, 5, 7), 32, "relu"),          # odd sizes: the scalar path
])
def test_groupnorm_act_kernel(gen, dtype, tol, shape, groups, act):
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    c = shape[1]
    w = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    b = 0.1 * torch.randn(c, generator=gen, device="cuda")
    before = k1.LAUNCHES
    got = k1.groupnorm_act(x, w, b, groups, act)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel_err(got, k1.groupnorm_act_plain(x.float(), w, b, groups, act)) <= tol


def _k1_inputs(gen, shape, dtype=torch.bfloat16, mean=0.0):
    x = (torch.randn(shape, generator=gen, device="cuda") + mean).to(dtype)
    w = 1 + 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
    b = 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
    return x, w, b


def _k1_check(x, w, b, groups, act="silu", tol=2.0 ** -7):
    before = k1.LAUNCHES
    got = k1.groupnorm_act(x, w, b, groups, act)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    assert _rel_err(got, k1.groupnorm_act_plain(x.float(), w, b, groups, act)) <= tol


# each cluster size the planner takes at the published pairs (bf16; B=2, and
# B=8 for k = 1); a card that schedules no cluster of 16 takes a smaller k
@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups,k", [
    ((88, 2048, 2, 2), 1, 1),
    ((22, 1024, 2, 2), 1, 2),
    ((22, 64, 64, 64), 1, 4),
    ((2, 256, 11, 64, 64), 32, 8),
    ((2, 512, 11, 64, 64), 32, 16),
    ((2, 256, 11, 128, 128), 32, 16),
])
def test_groupnorm_act_cluster_sizes(gen, shape, groups, k):
    x, w, b = _k1_inputs(gen, shape)
    p = k1.launch_plan(x, groups, "silu")
    if k <= k1.max_cluster(x.device.index):
        assert (p.path, p.k, p.kernels) == ("cluster", k, 1)
    else:
        assert p.k <= k1.max_cluster(x.device.index)
    _k1_check(x, w, b, groups)


@pytest.mark.cuda
def test_groupnorm_act_published_split(gen):
    # the VAE's 5.5 MB groups are past any cluster's capacity
    x, w, b = _k1_inputs(gen, (2, 128, 11, 256, 256))
    p = k1.launch_plan(x, 32, "silu")
    assert (p.path, p.kernels) == ("split", 2)
    _k1_check(x, w, b, 32)


@pytest.mark.cuda
def test_groupnorm_act_at_and_past_a_clusters_capacity(gen):
    mc = k1.max_cluster(0)

    def path(spatial):  # x (2, 8, spatial), G=1, bf16
        return k1.plan(2, 8, spatial, 1, 2, True, mc).path

    lo, hi = 1, k1.SMEM_LIMIT * mc  # cluster at lo, split at hi: the last spatial a cluster holds
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if path(mid) == "cluster" else (lo, mid)
    for spatial, want in ((lo, "cluster"), (hi, "split")):
        x, w, b = _k1_inputs(gen, (2, 8, spatial))
        p = k1.launch_plan(x, 1)
        assert p.path == want and (want == "split" or p.k == mc)
        assert p.smem <= k1.SMEM_LIMIT
        _k1_check(x, w, b, 1, "")


@pytest.mark.cuda
def test_groupnorm_act_misaligned_x_takes_the_scalar_variant(gen):
    shape = (4, 64, 16, 16)
    x, w, b = _k1_inputs(gen, shape)
    x = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")[1:].view(shape).copy_(x)
    assert not k1.launch_plan(x, 1).aligned
    _k1_check(x, w, b, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [((2, 128, 3, 40, 40), 32), ((22, 64, 64, 64), 1)])
def test_groupnorm_act_float32_large_mean(gen, shape, groups):
    # x = 50 + noise: the one-pass plain version loses digits in E[x^2] - mean^2,
    # so the reference is float64
    import torch.nn.functional as F

    x, w, b = _k1_inputs(gen, shape, torch.float32, mean=50.0)
    got = k1.groupnorm_act(x, w, b, groups, "silu")
    ref = F.silu(F.group_norm(x.double(), groups, w.double(), b.double(), eps=1e-5))
    assert ((got.double() - ref).abs().max() / ref.abs().max()).item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [((22, 64, 64, 64), 1), ((2, 128, 11, 256, 256), 32)])
def test_groupnorm_act_launches_the_plans_kernels(gen, shape, groups):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, w, b = _k1_inputs(gen, shape)
    p = k1.launch_plan(x, groups, "silu")
    k1.groupnorm_act(x, w, b, groups, "silu")  # built and planned before the trace
    torch.cuda.synchronize()
    before = k1.LAUNCHES
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)  # the first kernel of a trace may be left out of it
        torch.cuda.synchronize()
        k1.groupnorm_act(x, w, b, groups, "silu")
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert k1.LAUNCHES == before + 1
    assert sum("gn_" in n for n in names) == p.kernels


# ------------------------------------------------ K1 on channels-last x

def _k1_cl_check(gen, shape, groups, act, dtype, tol, mean=0.0):
    """K1 on channels-last x against its plain version: y channels-last, one
    launch counted on both counters, the plan's path by G."""
    from diffusion_model_project_tpu_torch.ops.basic import to_channels_last

    x, w, b = _k1_inputs(gen, shape, torch.float32, mean)
    x = to_channels_last((x * 2 + 0.5).to(dtype))
    p = k1.launch_plan(x, groups, act)
    assert p.channels_last and p.kernels == (1 if p.path == "cluster" else 2)
    before = (k1.LAUNCHES, k1.LAUNCHES_CHANNELS_LAST)
    got = k1.groupnorm_act(x, w, b, groups, act)
    torch.cuda.synchronize()
    assert (k1.LAUNCHES, k1.LAUNCHES_CHANNELS_LAST) == (before[0] + 1, before[1] + 1)
    assert got.dtype == dtype and got.shape == x.shape
    assert k1.is_channels_last(got) and got.stride() == x.stride()
    assert _rel_err(got, k1.groupnorm_act_plain(x.float(), w, b, groups, act)) <= tol
    return p


def _published_pairs():
    from diffusion_model_project_tpu_torch.scripts import k1_device_time

    return [(s, g, a) for s, g, a, _ in k1_device_time.pairs(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("shape,groups,act", _published_pairs(),
                         ids=[f"{'x'.join(map(str, s))}-G{g}-{a or 'none'}"
                              for s, g, a in _published_pairs()])
def test_groupnorm_act_channels_last_at_the_published_pairs(gen, dtype, tol, shape, groups, act):
    p = _k1_cl_check(gen, shape, groups, act, dtype, tol)
    assert p.path == ("cluster" if groups == 1 else "rows")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("act", ["", "silu", "relu"])
@pytest.mark.parametrize("shape,groups,path", [
    ((22, 64, 64, 64), 1, "cluster"),     # UNet level 1
    ((2, 128, 3, 40, 40), 32, "rows"),    # VAE GN(32), 4 channels a group
    ((2, 12, 5, 8), 1, "cluster"),        # 16-byte vectors that straddle rows of C (bf16)
    ((2, 20, 3, 5, 7), 4, "rows"),        # rows off 16 bytes (bf16): one element a thread
    ((3, 96, 5, 7), 32, "rows"),          # 96 channels: 24 or 12 vectors a row
    ((2, 64, 256, 256), 1, "rows"),       # a sample past any cluster
])
def test_groupnorm_act_channels_last_each_activation(gen, dtype, tol, act, shape, groups, path):
    assert _k1_cl_check(gen, shape, groups, act, dtype, tol).path == path


@pytest.mark.cuda
def test_groupnorm_act_channels_last_misaligned_x(gen):
    from diffusion_model_project_tpu_torch.ops.basic import to_channels_last

    x, w, b = _k1_inputs(gen, (2, 64, 3, 8, 8))
    x = to_channels_last(x)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")[1:]
    xm = buf.as_strided(x.shape, x.stride()).copy_(x)
    assert k1.is_channels_last(xm) and not k1.launch_plan(xm, 32).aligned
    got = k1.groupnorm_act(xm, w, b, 32, "silu")
    assert _rel_err(got, k1.groupnorm_act_plain(xm.float(), w, b, 32, "silu")) <= 2.0 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [((2, 128, 3, 40, 40), 32), ((22, 64, 64, 64), 1)])
def test_groupnorm_act_channels_last_float32_large_mean(gen, shape, groups):
    import torch.nn.functional as F

    from diffusion_model_project_tpu_torch.ops.basic import to_channels_last

    x, w, b = _k1_inputs(gen, shape, torch.float32, mean=50.0)
    got = k1.groupnorm_act(to_channels_last(x), w, b, groups, "silu")
    ref = F.silu(F.group_norm(x.double(), groups, w.double(), b.double(), eps=1e-5))
    assert ((got.double() - ref).abs().max() / ref.abs().max()).item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [((22, 64, 64, 64), 1), ((2, 128, 11, 256, 256), 32)])
def test_groupnorm_act_channels_last_launches_the_plans_kernels(gen, shape, groups):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diffusion_model_project_tpu_torch.ops.basic import to_channels_last

    x, w, b = _k1_inputs(gen, shape)
    x = to_channels_last(x)
    p = k1.launch_plan(x, groups, "silu")
    k1.groupnorm_act(x, w, b, groups, "silu")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        k1.groupnorm_act(x, w, b, groups, "silu")
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    k1_names = [n for n in names if "::gn_cluster" in n or "::gn_partial" in n
                or "::gn_apply" in n]
    assert len(k1_names) == p.kernels == (1 if groups == 1 else 2)
    assert all("_cl<" in n for n in k1_names)


@pytest.mark.cuda
def test_sampler_launches_k1_on_channels_last_x_and_training_does_not(gen):
    """A float sampler call on the card launches every K1 call on
    channels-last x; a train step (its frozen encodes) none."""
    from diffusion_model_project_tpu_torch.training import steps

    pred = _tiny_predictor().to("cuda")
    img, vel, noise, _ = _tiny_inputs(hw=64)   # latents 16^2: no 1x1 map, which is both layouts
    before = (k1.LAUNCHES, k1.LAUNCHES_CHANNELS_LAST)
    out = pred.predict_ddim(img.cuda(), vel.cuda(), num_steps=2, noise=noise.cuda())
    torch.cuda.synchronize()
    launched = k1.LAUNCHES - before[0]
    assert launched > 0 and k1.LAUNCHES_CHANNELS_LAST - before[1] == launched
    assert out.is_contiguous() and torch.isfinite(out).all()
    batch, noise, t = _tiny_batch(hw=64)
    pred.model.requires_grad_(True)
    step = steps.make_diffusion_train_step(_GradCapture(pred.model))
    before = (k1.LAUNCHES, k1.LAUNCHES_CHANNELS_LAST)
    step(pred, {k: v.cuda() for k, v in batch.items()}, noise=noise.cuda(), t=t.cuda())
    torch.cuda.synchronize()
    assert k1.LAUNCHES > before[0] and k1.LAUNCHES_CHANNELS_LAST == before[1]


@pytest.mark.cuda
@pytest.mark.parametrize("flag", ["vae", "unet"])
def test_int8_sampler_launches_k1_on_channels_first_x(gen, flag):
    """An int8 predictor's sampler call stays channels-first (K4 writes that
    layout): K1 launches, none on channels-last x."""
    pred = _tiny_predictor().to("cuda")
    pred = pred.with_vae_int8() if flag == "vae" else pred.with_unet_int8()
    img, vel, noise, _ = _tiny_inputs(hw=64)
    before = (k1.LAUNCHES, k1.LAUNCHES_CHANNELS_LAST)
    out = pred.predict_ddim(img.cuda(), vel.cuda(), num_steps=2, noise=noise.cuda())
    torch.cuda.synchronize()
    assert k1.LAUNCHES > before[0] and k1.LAUNCHES_CHANNELS_LAST == before[1]
    assert out.shape == (1, 3, 3, 64, 64) and torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_published_sampler_loop_and_decode_transpose_nothing(gen, sampler):
    """At the published config (bf16, B=2, 256^2 x 11) the UNet loop and D3D
    launch no cuDNN layout kernel (nchwToNhwc / nhwcToNchw)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diffusion_model_project_tpu_torch.diffusion.predictor import LatentDiffusionPredictor
    from diffusion_model_project_tpu_torch.utils.config import (PUBLISHED_LATENT_CHANNELS,
                                                                PUBLISHED_UNET_KWARGS)

    pred = LatentDiffusionPredictor.create(dict(PUBLISHED_UNET_KWARGS), seed=0,
                                           latent_channels=PUBLISHED_LATENT_CHANNELS,
                                           compute_dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(9)
    img = (torch.rand((2, 11, 1, 256, 256), generator=g) > 0.3).float().cuda()
    vel = (torch.randn((2, 11, 3, 256, 256), generator=g) * 1e-2).cuda()
    noise = torch.randn((22, PUBLISHED_LATENT_CHANNELS, 64, 64), generator=g).cuda()

    def loop(x, z, m):
        if sampler == "dpm":
            return pred._dpm_loop(x, z, m, 2, 2)
        return pred._ddim_loop(x, z, m, 2)

    with torch.inference_mode():
        pred.predict_ddim(img, vel, num_steps=2, noise=noise)   # warm: cuDNN's choices made
        img_d, x, z, m = pred._setup_sampling(img, vel, noise, None)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = pred._decode_and_finish(loop(x, z, m), img_d)
            torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    layout = sorted({n for n in names if "nchwToNhwc" in n or "nhwcToNchw" in n})
    assert names and not layout, layout
    assert out.shape == (2, 11, 3, 256, 256) and out.is_contiguous()
    assert torch.isfinite(out).all()


def _weight(w, layout):
    """A (K, N) weight from its (N, K) storage: the transposed view the module
    passes, or a row-major copy made before the call."""
    return w.t() if layout == "view" else w.t().contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1.3e-2)])
@pytest.mark.parametrize("n,t,e", [
    (22, 256, 256), (22, 64, 512), (22, 16, 1024),  # the UNet's three shapes at B=2
    (3, 37, 64),    # ragged T (M = 111), head dim 32
    (3, 16, 1024),  # T below one 64-row tile, M = 48
])
@pytest.mark.parametrize("qkv_layout,out_layout", [
    ("view", "view"), ("view", "rowmajor"), ("rowmajor", "view"), ("rowmajor", "rowmajor")])
def test_fused_attention_kernel(gen, dtype, tol, n, t, e, qkv_layout, out_layout):
    heads = 2
    x = torch.randn((n, t, e), generator=gen, device="cuda").to(dtype)
    w_qkv = (torch.randn((3 * e, e), generator=gen, device="cuda") / math.sqrt(e)).to(dtype)
    b_qkv = (0.02 * torch.randn(3 * e, generator=gen, device="cuda")).to(dtype)
    w_out = torch.randn((e, e), generator=gen, device="cuda").to(dtype) / math.sqrt(e)
    b_out = (0.02 * torch.randn(e, generator=gen, device="cuda")).to(dtype)
    args = (x, _weight(w_qkv, qkv_layout), b_qkv, _weight(w_out, out_layout), b_out)
    before = k2.LAUNCHES
    got = k2.fused_attention(*args, heads)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + 1
    ref = multihead_attention(*[a.float() for a in args], heads)
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel_err(got, ref) <= tol


# every attention shape the JAX package runs: head dims off the wgmma core's
# instances (zero-padded weights), past 512 (the SIMT core in bf16), long
# sequences (both cores stream the keys), E off a multiple of 8 (x padded)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1.3e-2)])
@pytest.mark.parametrize("n,t,e,heads", [
    (22, 256, 128, 2), (4, 1024, 128, 2), (2, 4096, 64, 2), (8, 256, 256, 4),
    (22, 1, 2048, 2), (22, 1, 2048, 1), (3, 40, 2048, 2), (2, 64, 96, 2),
    (2, 2000, 512, 2), (3, 33, 6, 2), (2, 17, 1, 1), (2, 70, 1200, 2), (2, 5, 600, 1),
])
def test_fused_attention_kernel_at_every_shape(gen, dtype, tol, n, t, e, heads):
    x = torch.randn((n, t, e), generator=gen, device="cuda").to(dtype)
    w_qkv = (torch.randn((3 * e, e), generator=gen, device="cuda") / math.sqrt(e)).to(dtype)
    b_qkv = (0.02 * torch.randn(3 * e, generator=gen, device="cuda")).to(dtype)
    w_out = (torch.randn((e, e), generator=gen, device="cuda") / math.sqrt(e)).to(dtype)
    b_out = (0.02 * torch.randn(e, generator=gen, device="cuda")).to(dtype)
    args = (x, w_qkv.t(), b_qkv, w_out.t(), b_out)
    before = k2.LAUNCHES
    got = k2.fused_attention(*args, heads)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + 1
    ref = multihead_attention(*[a.float() for a in args], heads)
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel_err(got, ref) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_refuses_misaligned_x(gen, dtype):
    n, t, e = 2, 16, 64
    buf = torch.randn(n * t * e + 1, generator=gen, device="cuda").to(dtype)
    x = buf[1:].view(n, t, e)  # contiguous, one element past a 16-byte boundary
    w_qkv = torch.zeros((e, 3 * e), dtype=dtype, device="cuda")
    w_out = torch.zeros((e, e), dtype=dtype, device="cuda")
    before = k2.LAUNCHES
    with pytest.raises(ValueError, match="16-byte"):
        k2.fused_attention(x, w_qkv, torch.zeros(3 * e, dtype=dtype, device="cuda"), w_out,
                           torch.zeros(e, dtype=dtype, device="cuda"), 2)
    assert k2.LAUNCHES == before


# float32 runs SIMT products (no TF32): only the order of the 9 * Cin sums
# differs; bf16 rounds the float32 sum once, half an ulp: at most 2^-8 of max|y|
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -8)])
@pytest.mark.parametrize("tile", k3.TILES)
@pytest.mark.parametrize("shape", [
    (2, 64, 64, 128, 128),   # probe-like: stage A's widths, fewer images
    (3, 13, 37, 24, 40),     # ragged H and W, boxes past both edges; Cin 24, Cout < 64
    (2, 3, 3, 16, 16),       # every pixel on an edge
    (2, 1, 40, 32, 64),      # one row: the halo's rows above and below are outside
    (2, 16, 48, 72, 200),    # Cin tail past one 64-channel chunk; Cout not a multiple of 128
    (1, 20, 24, 64, 136),    # one image; Cout one channel block and 8 more
])
def test_conv3x3_kernel(gen, dtype, tol, tile, shape):
    n, h, w, cin, cout = shape
    x = torch.randn((n, h, w, cin), generator=gen, device="cuda").to(dtype)
    wgt = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda") * 0.1).to(dtype)
    before = k3.LAUNCHES
    got = k3.conv3x3(x, wgt, tile)
    torch.cuda.synchronize()
    assert k3.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == (n, h, w, cout)
    assert not torch.backends.cuda.matmul.allow_tf32  # the plain version in full float32
    assert _rel_err(got, k3.conv3x3_plain(x.float(), wgt.float())) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("tile", k3.TILES)
def test_conv3x3_float32_odd_channels(gen, tile):
    # channel counts off 8: the float32 kernel's scalar load path
    x = torch.randn((1, 7, 9, 5), generator=gen, device="cuda")
    wgt = torch.randn((3, 3, 5, 11), generator=gen, device="cuda") * 0.1
    got = k3.conv3x3(x, wgt, tile)
    assert _rel_err(got, k3.conv3x3_plain(x, wgt)) <= 1e-5


@pytest.mark.cuda
def test_conv3x3_bf16_takes_the_plan(gen):
    n, h, w, cin, cout = 2, 40, 40, 64, 128
    x = torch.randn((n, h, w, cin), generator=gen, device="cuda").to(torch.bfloat16)
    wgt = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    before = k3.LAUNCHES
    got = k3.conv3x3(x, wgt)
    assert k3.LAUNCHES == before + 1
    assert _rel_err(got, k3.conv3x3_plain(x.float(), wgt.float())) <= 2.0 ** -8


@pytest.mark.cuda
@pytest.mark.parametrize("case,match", [
    ("cin_off_8", "multiples of 8"),    # (1, 7, 9, 5 -> 11): Cin and Cout off 8
    ("cout_off_8", "multiples of 8"),
    ("misaligned_x", "16-byte"),
    ("misaligned_w", "16-byte"),
])
def test_conv3x3_bf16_refuses_what_tma_cannot_read(gen, case, match):
    bf = torch.bfloat16
    shapes = {"cin_off_8": ((1, 7, 9, 5), 11), "cout_off_8": ((1, 7, 9, 16), 12)}
    xs, cout = shapes.get(case, ((2, 8, 16, 16), 16))
    x = torch.randn(xs, generator=gen, device="cuda").to(bf)
    wgt = torch.randn((3, 3, xs[3], cout), generator=gen, device="cuda").to(bf)
    if case == "misaligned_x":  # contiguous, one element past a 16-byte boundary
        x = torch.empty(x.numel() + 1, dtype=bf, device="cuda")[1:].view(xs).copy_(x)
    if case == "misaligned_w":
        wgt = torch.empty(wgt.numel() + 1, dtype=bf, device="cuda")[1:].view(
            wgt.shape).copy_(wgt)
    before = k3.LAUNCHES
    with pytest.raises(ValueError, match=match):
        k3.conv3x3(x, wgt)
    assert k3.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1.3e-2)])
def test_vae_attention_block_on_the_card_matches_the_cpu(gen, dtype, tol):
    """The VAE's AttentionBlock over 11 x 16^2 tokens: K1 (no activation)
    and K2 once each, against the plain versions on the CPU."""
    from diffusion_model_project_tpu_torch.models.vae import AttentionBlock

    block = AttentionBlock(64, num_heads=2)
    cpu_gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=cpu_gen) * 0.1 + (p.ndim == 1) * 0.5)
    x = torch.randn((2, 64, 11, 16, 16), generator=cpu_gen)
    with torch.no_grad():
        ref = block(x)
        block.cuda()
        before = (k1.LAUNCHES, k2.LAUNCHES)
        got = block(x.cuda().to(dtype))
        torch.cuda.synchronize()
    assert (k1.LAUNCHES, k2.LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel_err(got.cpu(), ref) <= tol


@pytest.mark.cuda
def test_kernels_refuse_grad_and_bad_input(gen):
    x = torch.randn((2, 64, 8, 8), generator=gen, device="cuda", requires_grad=True)
    w = torch.ones(64, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        k1.groupnorm_act(x, w, w, 32, "silu")
    with pytest.raises(ValueError, match="contiguous"):
        k1.groupnorm_act(x.detach().transpose(2, 3), w, w, 32, "silu")
    xa = torch.randn((2, 8, 96), device="cuda")  # 96 columns do not split into 5 heads
    wq, wo = torch.zeros((96, 288), device="cuda"), torch.zeros((96, 96), device="cuda")
    with pytest.raises(ValueError, match="not divisible"):
        k2.fused_attention(xa, wq, torch.zeros(288, device="cuda"), wo,
                           torch.zeros(96, device="cuda"), 5)
    xc = torch.randn((2, 8, 16, 32), generator=gen, device="cuda")
    wc = torch.randn((3, 3, 32, 16), generator=gen, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        k3.conv3x3(xc, wc.clone().requires_grad_())
    with pytest.raises(ValueError, match="contiguous"):
        k3.conv3x3(xc.transpose(1, 2), wc)
    with pytest.raises(ValueError, match="expected x"):
        k3.conv3x3(xc, wc.permute(3, 2, 0, 1))


# --------------------------------------------------- the inference entry point


@pytest.fixture
def no_tf32(gen):
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield gen
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _tiny_predictor(**kwargs):
    from diffusion_model_project_tpu_torch.diffusion.predictor import LatentDiffusionPredictor

    # attention at the 64- and 256-wide levels: head dims 32 and 128, which K2 takes
    unet = dict(in_channels=9, out_channels=4, features=(16, 64, 256), kernel_size=3,
                padding_mode="zeros", activation="silu", final_activation=None,
                attention="2..2", dropout=0.0, time_embedding_dim=64)
    pred = LatentDiffusionPredictor.create(unet, seed=3, device="cpu", latent_channels=4,
                                           vae_features=(32, 32, 32), **kwargs)
    torch.nn.init.normal_(pred.model.final_conv.weight, std=0.05, generator=torch.Generator()
                          .manual_seed(4))
    return pred.set_normalizer({"input": [1.0], "output": [2.1e-2, 1.6e-2, 7.9e-3]})


def _tiny_inputs(s=3, hw=32, steps=10):
    g = torch.Generator().manual_seed(5)
    img = (torch.rand((1, s, 1, hw, hw), generator=g) > 0.3).float()
    vel = torch.randn((1, s, 3, hw, hw), generator=g) * 1e-2
    noise = torch.randn((s, 4, hw // 4, hw // 4), generator=g)
    table = torch.randn((steps,) + tuple(noise.shape), generator=g)
    return img, vel, noise, table


@pytest.mark.cuda
def test_conditional_vae_on_the_card(no_tf32):
    # FiLM hands K1 float32 features whatever the compute dtype
    from diffusion_model_project_tpu_torch.models.vae import DualBranchVAE

    cpu = DualBranchVAE(latent_channels=4, features=(32, 32, 32), conditional=True)
    cpu.init_parameters_(torch.Generator().manual_seed(1))
    card = DualBranchVAE(latent_channels=4, features=(32, 32, 32), conditional=True).cuda()
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(2)
    v, z = torch.randn((2, 3, 3, 32, 32), generator=g), torch.randn((2, 4, 3, 8, 8), generator=g)
    with torch.inference_mode():
        before = k1.LAUNCHES
        mu = card.encode_2d_deterministic(v.cuda())[0]
        out = card.decode_3d(z.cuda())
        torch.cuda.synchronize()
        assert k1.LAUNCHES == before + 26
        assert _rel_err(mu.cpu(), cpu.encode_2d_deterministic(v)[0]) <= 1e-4
        assert _rel_err(out.cpu(), cpu.decode_3d(z)) <= 1e-4
        out16 = card.decode_3d(z.cuda().bfloat16())
        assert torch.isfinite(out16).all() and _rel_err(out16.float().cpu(), cpu.decode_3d(z)) < 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["ddpm", "dpm"])
def test_samplers_on_the_card_match_the_cpu(no_tf32, sampler):
    import copy

    cpu = _tiny_predictor(num_timesteps=10)
    card = copy.deepcopy(cpu).to("cuda")
    img, vel, noise, table = _tiny_inputs()

    def run(p, d):
        if sampler == "ddpm":
            return p.predict(img.to(d), vel.to(d), noise=noise.to(d), step_noise=table.to(d))
        return p.predict_dpm(img.to(d), vel.to(d), num_steps=5, noise=noise.to(d))

    assert _rel_err(run(card, "cuda").cpu(), run(cpu, "cpu")) <= 1e-4


@pytest.mark.cuda
def test_ddpm_draws_from_a_card_generator(gen):
    card = _tiny_predictor(num_timesteps=10).to("cuda")
    img, vel, _, _ = _tiny_inputs()
    runs = [card.predict(img.cuda(), vel.cuda(),
                         generator=torch.Generator(device="cuda").manual_seed(seed))
            for seed in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert torch.isfinite(runs[0]).all()


# ------------------------------------------------------------------ training


def _tiny_batch(b=2, s=3, hw=32, seed=6):
    g = torch.Generator().manual_seed(seed)
    img = (torch.rand((b, s, 1, hw, hw), generator=g) > 0.3).float()
    v2d = torch.randn((b, s, 3, hw, hw), generator=g) * 1e-2
    v3d = torch.randn((b, s, 3, hw, hw), generator=g) * 1e-2
    noise = torch.randn((b * s, 4, hw // 4, hw // 4), generator=g)
    t = torch.randint(0, 1000, (b * s,), generator=g)
    return {"img": img, "U_2d": v2d, "U": v3d}, noise, t


class _GradCapture:
    def __init__(self, module):
        self.params = list(module.parameters())

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            p.grad = None

    def step(self):
        pass


@pytest.mark.cuda
def test_train_trace_launches_no_kernel_and_eval_launches_both(gen):
    """The train step (physics on) runs the plain versions under autograd
    inside train_trace(): K2 launches 0 times and K1 only for the frozen
    encodes (the E3D and E2D GroupNorms, which need no gradient); the eval
    step outside it launches them once a GroupNorm / attention call."""
    from diffusion_model_project_tpu_torch.losses.physics import PhysicsLoss
    from diffusion_model_project_tpu_torch.models.layers import GroupNorm, MultiheadSelfAttention
    from diffusion_model_project_tpu_torch.training import steps

    pred = _tiny_predictor().to("cuda")
    batch, noise, t = _tiny_batch()
    batch = {k: v.cuda() for k, v in batch.items()}
    pred.model.requires_grad_(True)
    step = steps.make_diffusion_train_step(_GradCapture(pred.model), physics=PhysicsLoss(0.1),
                                           lambda_velocity=0.1)
    encodes = sum(isinstance(m, GroupNorm) for part in (pred.vae.encoder_3d, pred.vae.encoder_2d)
                  for m in part.modules())
    before = (k1.LAUNCHES, k2.LAUNCHES)
    aux = step(pred, batch, noise=noise.cuda(), t=t.cuda())
    torch.cuda.synchronize()
    assert (k1.LAUNCHES - before[0], k2.LAUNCHES - before[1]) == (encodes, 0)
    before = (k1.LAUNCHES, k2.LAUNCHES)
    assert all(torch.isfinite(v) for v in aux.values())
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in pred.model.parameters())
    pred.model.requires_grad_(False)
    gn = sum(isinstance(m, GroupNorm) for part in (pred.vae.encoder_3d, pred.vae.encoder_2d,
                                                  pred.model, pred.vae.decoder_3d)
             for m in part.modules())
    attn = sum(isinstance(m, MultiheadSelfAttention) for m in pred.model.modules())
    metrics = steps.make_diffusion_eval_step(with_physics_metrics=True)(
        pred, batch, noise=noise.cuda(), t=t.cuda())
    torch.cuda.synchronize()
    assert (k1.LAUNCHES - before[0], k2.LAUNCHES - before[1]) == (gn, attn)
    assert all(torch.isfinite(v) for v in metrics.values())


@pytest.mark.cuda
def test_kernels_still_raise_under_grad_outside_train_trace(gen):
    from diffusion_model_project_tpu_torch.models.layers import (GroupNorm, MultiheadSelfAttention,
                                                                 train_trace)

    norm = GroupNorm(1, 64, act="silu").cuda()
    mha = MultiheadSelfAttention(64, 2).cuda()
    torch.nn.init.normal_(mha.in_proj_weight, std=0.1)
    x = torch.randn((2, 64, 8, 8), generator=gen, device="cuda", requires_grad=True)
    tokens = torch.randn((2, 16, 64), generator=gen, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        norm(x)
    with pytest.raises(RuntimeError, match="no backward"):
        mha(tokens)
    with train_trace():
        (norm(x).square().sum() + mha(tokens).square().sum()).backward()
    assert torch.isfinite(x.grad).all() and torch.isfinite(tokens.grad).all()
    with pytest.raises(RuntimeError, match="no backward"):
        norm(x)


@pytest.mark.cuda
def test_train_step_gradients_on_the_card_match_the_cpu(no_tf32):
    import copy

    from diffusion_model_project_tpu_torch.losses.physics import PhysicsLoss
    from diffusion_model_project_tpu_torch.training import steps

    cpu = _tiny_predictor()
    card = copy.deepcopy(cpu).to("cuda")
    batch, noise, t = _tiny_batch()
    grads = []
    for pred, d in ((cpu, "cpu"), (card, "cuda")):
        pred.model.requires_grad_(True)
        step = steps.make_diffusion_train_step(_GradCapture(pred.model),
                                               physics=PhysicsLoss(0.1, 0.1, 0.01, 0.01),
                                               lambda_velocity=0.1, accum_steps=2)
        step(pred, {k: v.to(d) for k, v in batch.items()}, noise=noise.to(d), t=t.to(d))
        grads.append(torch.cat([p.grad.reshape(-1).cpu() for p in pred.model.parameters()]))
    assert _rel_err(grads[1], grads[0]) <= 1e-4


@pytest.mark.cuda
def test_published_train_step_with_physics_fits(gen):
    """One train step at the published width (UNet 64..1024, VAE 128/256/512),
    256^2 x 11, B=2, float32, the physics and velocity losses on: the
    decoder's activations are rematerialized, so it fits; peak memory printed."""
    from diffusion_model_project_tpu_torch.diffusion.predictor import LatentDiffusionPredictor
    from diffusion_model_project_tpu_torch.losses.physics import PhysicsLoss
    from diffusion_model_project_tpu_torch.training import steps
    from diffusion_model_project_tpu_torch.training.train_diffusion import make_optimizer
    from diffusion_model_project_tpu_torch.utils.config import (PUBLISHED_LATENT_CHANNELS,
                                                                PUBLISHED_UNET_KWARGS)

    pred = LatentDiffusionPredictor.create(dict(PUBLISHED_UNET_KWARGS), seed=0,
                                           latent_channels=PUBLISHED_LATENT_CHANNELS)
    pred.model.requires_grad_(True)
    opt = make_optimizer(pred.model, 1e-4, ema_decay=0.999)
    step = steps.make_diffusion_train_step(opt, physics=PhysicsLoss(0.1, 0.1, 0.01, 0.01),
                                           lambda_velocity=0.1)
    g = torch.Generator().manual_seed(1)
    b, s, hw = 2, 11, 256
    batch = {"img": (torch.rand((b, s, 1, hw, hw), generator=g) > 0.3).float().cuda(),
             "U_2d": (torch.randn((b, s, 3, hw, hw), generator=g) * 1e-2).cuda(),
             "U": (torch.randn((b, s, 3, hw, hw), generator=g) * 1e-2).cuda()}
    torch.cuda.reset_peak_memory_stats()
    aux = step(pred, batch, torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"published train step with physics, B=2, 256^2 x 11, float32: peak {peak:.2f} GiB "
          f"on {torch.cuda.get_device_name(0)}")
    assert all(torch.isfinite(v) for v in aux.values()) and opt.count == 1
    assert peak < 0.9 * torch.cuda.get_device_properties(0).total_memory / 2 ** 30


# ------------------------------------------------------- the VAE trainers


def _vae_batch(b=2, s=3, hw=32, seed=8):
    g = torch.Generator().manual_seed(seed)
    mask = (torch.rand((b, 1, s, hw, hw), generator=g) > 0.3).float()
    batch = {"velocity_2d": torch.randn((b, 3, s, hw, hw), generator=g), "mask_2d": mask,
             "velocity_3d": torch.randn((b, 3, s, hw, hw), generator=g), "mask_3d": mask}
    batch["velocity_2d"][:, 2] = 0.0
    return batch, torch.randn((b, 4, s, hw // 4, hw // 4), generator=g)


def _stage2_vae():
    from diffusion_model_project_tpu_torch.models.vae import DualBranchVAE
    from diffusion_model_project_tpu_torch.training import train_vae_stage2 as s2

    vae = DualBranchVAE(3, 4, features=(32, 32, 32))
    vae.init_parameters_(torch.Generator().manual_seed(9))
    for name in s2.FROZEN:
        getattr(vae, name).requires_grad_(False)
    vae.encoder_2d.remat = vae.decoder_2d.remat = True
    return vae


@pytest.mark.cuda
def test_vae_steps_launch_k1_where_no_gradient_is_needed(gen):
    """A stage-1 train microbatch launches no kernel (all of E3D / D3D needs
    a gradient), a stage-1 validation batch K1 for E3D + D3D; a stage-2
    microbatch K1 for the frozen E3D encode, a stage-2 validation batch for
    all four networks; K2 never."""
    from diffusion_model_project_tpu_torch.training import train_vae_stage1 as s1
    from diffusion_model_project_tpu_torch.training import train_vae_stage2 as s2

    batch, noise = _vae_batch()
    batch = {k: v.cuda() for k, v in batch.items()}
    vae1 = s1.Stage1VAE(3, 4, features=(32, 32, 32)).cuda()
    t1, _, e1 = s1.make_steps(vae1, "normalized_mae_per_channel", s1.AccumAdam(vae1, 1e-4),
                              accum_steps=2)
    vae2 = _stage2_vae().cuda()
    t2, _, e2 = s2.make_steps(vae2, "normalized_mae_per_channel", s1.AccumAdam(vae2, 1e-4),
                              5.0, 50.0, accum_steps=2)
    b1 = {"velocity": batch["velocity_3d"], "microstructure": batch["mask_3d"]}
    for fn, want in ((lambda: t1(b1, 1e-3, True, noise=noise.cuda()), 0),
                     (lambda: e1(b1, 1e-3, noise=noise.cuda()), 26),
                     (lambda: t2(batch, False), 13), (lambda: e2(batch), 52)):
        before = (k1.LAUNCHES, k2.LAUNCHES)
        metrics = fn()
        torch.cuda.synchronize()
        assert (k1.LAUNCHES - before[0], k2.LAUNCHES - before[1]) == (want, 0)
        assert not bool(metrics["bad"])


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [1, 2])
def test_vae_microbatch_gradients_on_the_card_match_the_cpu(no_tf32, stage):
    import copy

    from diffusion_model_project_tpu_torch.models.layers import train_trace
    from diffusion_model_project_tpu_torch.training import train_vae_stage1 as s1
    from diffusion_model_project_tpu_torch.training import train_vae_stage2 as s2

    if stage == 1:
        cpu = s1.Stage1VAE(3, 4, features=(32, 32, 32))
        cpu.init_parameters_(torch.Generator().manual_seed(10))
    else:
        cpu = _stage2_vae()
    card = copy.deepcopy(cpu).cuda()
    batch, noise = _vae_batch()
    grads = []
    for vae, d in ((cpu, "cpu"), (card, "cuda")):
        b = {k: v.to(d) for k, v in batch.items()}
        with train_trace():
            if stage == 1:
                loss, _ = s1.make_loss_fn(vae, "normalized_mae_per_channel")(
                    {"velocity": b["velocity_3d"], "microstructure": b["mask_3d"]}, 1e-3,
                    noise=noise.to(d))
            else:
                loss, _ = s2.make_loss_fn(vae, "normalized_mae_per_channel", 5.0, 50.0)(b)
            g = torch.autograd.grad(loss, [p for p in vae.parameters() if p.requires_grad])
        grads.append(torch.cat([x.reshape(-1).cpu() for x in g]))
    assert _rel_err(grads[1], grads[0]) <= 1e-3


# ------------------------------------------------------------- registered ops


def _k2_inputs(gen, n, t, e, dtype=torch.bfloat16):
    x = torch.randn((n, t, e), generator=gen, device="cuda").to(dtype)
    w_qkv = (torch.randn((3 * e, e), generator=gen, device="cuda") / math.sqrt(e)).to(dtype)
    b_qkv = (0.02 * torch.randn(3 * e, generator=gen, device="cuda")).to(dtype)
    w_out = (torch.randn((e, e), generator=gen, device="cuda") / math.sqrt(e)).to(dtype)
    b_out = (0.02 * torch.randn(e, generator=gen, device="cuda")).to(dtype)
    return x, w_qkv.t(), b_qkv, w_out.t(), b_out  # the module's transposed views


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_registered_ops_equal_the_wrappers_bit_for_bit(gen, dtype):
    x, w, b = _k1_inputs(gen, (8, 256, 16, 16), dtype)
    before = k1.LAUNCHES
    got = torch.ops.dm_port.groupnorm_act(x, w, b, 32, "silu", 1e-5)
    assert k1.LAUNCHES == before + 1  # the op's body is the wrapper's launch
    assert torch.equal(got, k1.groupnorm_act(x, w, b, 32, "silu"))
    args = _k2_inputs(gen, 88, 64, 512, dtype)
    before = k2.LAUNCHES
    got = torch.ops.dm_port.fused_attention(*args, 2)
    assert k2.LAUNCHES == before + 1
    assert torch.equal(got, k2.fused_attention(*args, 2))


@pytest.mark.cuda
def test_registered_ops_trace_on_fake_tensors(gen):
    from torch._subclasses.fake_tensor import FakeTensorMode

    x, w, b = _k1_inputs(gen, (88, 64, 64, 64))
    args = _k2_inputs(gen, 88, 256, 256)
    before = (k1.LAUNCHES, k2.LAUNCHES)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fx, fw, fb = (mode.from_tensor(t) for t in (x, w, b))
        y = torch.ops.dm_port.groupnorm_act(fx, fw, fb, 32, "", 1e-5)
        z = torch.ops.dm_port.fused_attention(*(mode.from_tensor(t) for t in args), 2)
    assert (y.shape, y.dtype, y.device) == (x.shape, x.dtype, x.device)
    assert (z.shape, z.dtype, z.device) == (args[0].shape, args[0].dtype, args[0].device)
    assert (k1.LAUNCHES, k2.LAUNCHES) == before  # nothing launched on fake tensors
    torch.library.opcheck(torch.ops.dm_port.groupnorm_act.default, (x, w, b, 32, "silu", 1e-5),
                          test_utils=("test_schema", "test_faketensor"))
    torch.library.opcheck(torch.ops.dm_port.fused_attention.default, (*args, 2),
                          test_utils=("test_schema", "test_faketensor"))


@pytest.mark.cuda
def test_served_batch_shapes_against_the_plain_versions(gen):
    """The server's B=8 shapes: K1 on the VAE's (8, 128, 11, 256, 256) and K2
    at N = 8 x 11 = 88, bf16, within chip_smoke.py's K1_TOL / K2_TOL."""
    x, w, b = _k1_inputs(gen, (8, 128, 11, 256, 256))
    _k1_check(x, w, b, 32, "silu", tol=2.0 ** -7)
    del x
    for t, e in ((256, 256), (64, 512), (16, 1024)):
        args = _k2_inputs(gen, 88, t, e)
        before = k2.LAUNCHES
        got = k2.fused_attention(*args, 2)
        torch.cuda.synchronize()
        assert k2.LAUNCHES == before + 1
        assert _rel_err(got, multihead_attention(*[a.float() for a in args], 2)) <= 1.3e-2


# ------------------------------------------------------------------ K4 (int8)

# every int8 conv of the published UNet (in 17, features 64-1024, latent 64^2)
# at N = 2 latent slices: (Cin, Cout, H = W), 3x3, padding 1
UNET_INT8 = [(17, 64, 64), (64, 64, 64), (64, 128, 32), (128, 128, 32), (128, 256, 16),
             (256, 256, 16), (256, 512, 8), (512, 512, 8), (512, 1024, 4), (1024, 1024, 4),
             (1024, 2048, 2), (2048, 2048, 2), (2048, 1024, 4), (1024, 512, 8),
             (512, 256, 16), (256, 128, 32), (128, 64, 64)]
# every int8 conv of the published VAE (E2D and D3D, widths 128/256/512,
# 256^2) at B=1 and 3 slices: (Cin, Cout, H = W, kernel, stride, padding)
_S1, _S2 = (1, 1, 1), (1, 2, 2)
_P1, _PD, _P0 = (1, 1, 1, 1, 1, 1), (1, 1, 0, 1, 0, 1), (0,) * 6
VAE_INT8 = [(128, 128, 256, 3, _S1, _P1), (128, 128, 256, 3, _S2, _PD),
            (128, 256, 128, 3, _S1, _P1), (128, 256, 128, 1, _S1, _P0),
            (256, 256, 128, 3, _S1, _P1), (256, 256, 128, 3, _S2, _PD),
            (256, 512, 64, 3, _S1, _P1), (256, 512, 64, 1, _S1, _P0),
            (512, 512, 64, 3, _S1, _P1), (512, 256, 128, 3, _S1, _P1),
            (256, 128, 256, 3, _S1, _P1)]


def _k4_inputs(gen, n, d, h, cin, cout, k):
    cp = k4.padded_channels(cin)
    x_q = torch.randint(-127, 128, (n, d, h, h, cp), generator=gen, device="cuda",
                        dtype=torch.int8)
    x_q[..., cin:] = 0
    kd = 1 if d == 1 else k
    w_q = torch.randint(-127, 128, (cout, kd, k, k, cp), generator=gen, device="cuda",
                        dtype=torch.int8)
    w_q[..., cin:] = 0
    sw = torch.rand(cout, generator=gen, device="cuda") * 1e-4 + 1e-6
    return x_q, w_q, sw


def _k4_check(x_q, w_q, sw, stride, pads, dtype):
    before = k4.LAUNCHES
    got = k4.int8_conv(x_q, w_q, sw, stride, pads, dtype)
    torch.cuda.synchronize()
    assert k4.LAUNCHES == before + 1
    want = k4.int8_conv_plain(x_q, w_q, sw, stride, pads, dtype)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,hw", UNET_INT8)
def test_int8_conv_kernel_at_the_unet_shapes(gen, dtype, cin, cout, hw):
    x_q, w_q, sw = _k4_inputs(gen, 2, 1, hw, cin, cout, 3)
    _k4_check(x_q, w_q, sw, (1, 1, 1), (0, 0, 1, 1, 1, 1), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,hw,k,stride,pads", VAE_INT8)
def test_int8_conv_kernel_at_the_vae_shapes(gen, dtype, cin, cout, hw, k, stride, pads):
    x_q, w_q, sw = _k4_inputs(gen, 1, 3, hw, cin, cout, k)
    _k4_check(x_q, w_q, sw, stride, pads, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_conv_on_the_card_equals_the_cpu(gen, dtype):
    """The whole int8 conv (quantize on the card, K4) against the same on the
    CPU (the plain version): the quantize pass is the same IEEE arithmetic,
    the sums are exact, so the two agree bit for bit; ragged M and Cout."""
    from diffusion_model_project_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(3)
    for shape, cout, stride, pads in (((2, 17, 37, 29), 72, (1, 1), ((1, 1), (1, 1))),
                                      ((1, 48, 3, 21, 19), 40, (1, 2, 2),
                                       ((1, 1), (0, 1), (0, 1)))):
        x = (torch.randn(shape, generator=g) * 3).to(dtype)
        w = torch.randn((cout, shape[1]) + (3,) * (len(shape) - 2), generator=g) * 0.1
        before = k4.LAUNCHES
        got = quant.int8_conv(x.cuda(), w.cuda(), stride, pads, dtype)
        torch.cuda.synchronize()
        assert k4.LAUNCHES == before + 1
        assert torch.equal(got.cpu(), quant.int8_conv(x, w, stride, pads, dtype))


@pytest.mark.cuda
def test_int8_conv_refuses_what_it_cannot_take(gen):
    x_q, w_q, sw = _k4_inputs(gen, 1, 1, 8, 32, 32, 3)
    args = ((1, 1, 1), (0, 0, 1, 1, 1, 1), torch.bfloat16)
    with pytest.raises(TypeError, match="int8"):
        k4.int8_conv(x_q.float(), w_q, sw, *args)
    with pytest.raises(TypeError, match="float32"):
        k4.int8_conv(x_q, w_q, sw.half(), *args)
    with pytest.raises(ValueError, match="one device"):
        k4.int8_conv(x_q, w_q.cpu(), sw, *args)
    with pytest.raises(ValueError, match="one device"):
        k4.int8_conv(x_q, w_q, sw.cpu(), *args)
    with pytest.raises(RuntimeError, match="no backward"):
        k4.int8_conv(x_q, w_q, sw.clone().requires_grad_(), *args)
    with pytest.raises(ValueError, match="contiguous"):
        k4.int8_conv(x_q.transpose(2, 3), w_q, sw, *args)
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(x_q.numel() + 8, dtype=torch.int8, device="cuda")
        k4.int8_conv(flat[8:].view(x_q.shape), w_q, sw, *args)


@pytest.mark.cuda
def test_int8_registered_op_and_fake(gen):
    from torch._subclasses.fake_tensor import FakeTensorMode

    x_q, w_q, sw = _k4_inputs(gen, 2, 1, 16, 64, 64, 3)
    args = ([1, 1, 1], [0, 0, 1, 1, 1, 1], torch.bfloat16)
    before = k4.LAUNCHES
    got = torch.ops.dm_port.int8_conv(x_q, w_q, sw, *args)
    assert k4.LAUNCHES == before + 1
    assert torch.equal(got, k4.int8_conv(x_q, w_q, sw, *args))
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        y = torch.ops.dm_port.int8_conv(*(mode.from_tensor(t) for t in (x_q, w_q, sw)), *args)
    assert (y.shape, y.dtype) == (got.shape, got.dtype)
    torch.library.opcheck(torch.ops.dm_port.int8_conv.default, (x_q, w_q, sw, *args),
                          test_utils=("test_schema", "test_faketensor"))


@pytest.mark.cuda
def test_int8_predictor_on_the_card_matches_the_cpu(no_tf32):
    """with_vae_int8().with_unet_int8() at published widths, 128^2 x 3, B=1,
    float32, TF32 off, DDIM-5: the card's int8 result against the CPU's. The
    two float paths differ by ulps (sums in another order), and an ulp ahead
    of a quantizer flips a code now and then, so two int8 runs carry
    independent rounding noise a few int8 layers on: the card's int8
    spread from its float32 result is within 2x of the CPU's, and card
    against CPU within 2.5x of the CPU's spread (two independent errors of
    one size are 2x apart), as tests/test_torch_int8_paths.py holds the port
    to JAX."""
    import copy

    from diffusion_model_project_tpu_torch.diffusion.predictor import LatentDiffusionPredictor
    from diffusion_model_project_tpu_torch.utils.config import (PUBLISHED_LATENT_CHANNELS,
                                                                PUBLISHED_UNET_KWARGS)

    cpu = LatentDiffusionPredictor.create(dict(PUBLISHED_UNET_KWARGS), seed=3, device="cpu",
                                          latent_channels=PUBLISHED_LATENT_CHANNELS)
    torch.nn.init.normal_(cpu.model.final_conv.weight, std=0.02,
                          generator=torch.Generator().manual_seed(4))
    cpu.set_normalizer({"input": [1.0], "output": [2.1e-2, 1.6e-2, 7.9e-3]})
    card = copy.deepcopy(cpu).to("cuda")
    g = torch.Generator().manual_seed(5)
    img = (torch.rand((1, 3, 1, 128, 128), generator=g) > 0.3).float()
    vel = torch.randn((1, 3, 3, 128, 128), generator=g) * 1e-2
    noise = torch.randn((3, PUBLISHED_LATENT_CHANNELS, 32, 32), generator=g)

    def run(p, d):
        return p.predict_ddim(img.to(d), vel.to(d), num_steps=5, noise=noise.to(d)).cpu()

    def rel_mse(a, b):
        return ((a - b).pow(2).mean() / b.pow(2).mean()).item()

    before = k4.LAUNCHES
    card8 = run(card.with_vae_int8().with_unet_int8(), "cuda")
    # 16 E2D + 14 D3D convs a request, 22 a UNet forward
    assert k4.LAUNCHES == before + 30 + 22 * 5
    assert torch.isfinite(card8).all()
    cpu_f32, cpu8, card_f32 = run(cpu, "cpu"), run(cpu.with_vae_int8().with_unet_int8(), "cpu"), \
        run(card, "cuda")
    spread, card_spread = rel_mse(cpu8, cpu_f32), rel_mse(card8, card_f32)
    assert spread > 0 and 0.5 * spread <= card_spread <= 2 * spread
    assert rel_mse(card8, cpu8) <= 2.5 * spread
