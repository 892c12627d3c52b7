"""The samplers' channels-last layout, on the CPU.

On the card the samplers store their activations channels-last
(``LatentDiffusionPredictor.samples_channels_last``), so that cuDNN's convs
transpose nothing. Every op of the model code gives its output in its
input's layout. Here a tiny UNet and VAE in float64 run both layouts: the
UNet forward, the VAE's encode and decode and 2-step DDIM / DPM-Solver++
calls, fed through ``ops.basic.to_channels_last`` as the samplers are on
the card, equal the channels-first results within 1e-12, with every conv
and GroupNorm input channels-last; channels-first input (the training
path) keeps every one channels-first.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch import nn

from diffusion_model_project_tpu_torch.diffusion.predictor import LatentDiffusionPredictor
from diffusion_model_project_tpu_torch.models.layers import GroupNorm, _pad, init_module_
from diffusion_model_project_tpu_torch.models.vae import AttentionBlock
from diffusion_model_project_tpu_torch.ops.basic import group_norm, memory_format, to_channels_last
from diffusion_model_project_tpu_torch.ops.cuda import groupnorm_act as k1
from diffusion_model_project_tpu_torch.ops.resize import upsample_nearest_hw

from test_torch_train_step import one_torch_thread  # noqa: F401

L, T, B, S, H = 4, 10, 2, 3, 32
UNET_KW = dict(in_channels=2 * L + 1, out_channels=L, features=(8, 16), attention="2..2")
TOL = 1e-12


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def _is_cl(x):
    fmt = torch.channels_last if x.dim() == 4 else torch.channels_last_3d
    return x.stride(1) == 1 and x.is_contiguous(memory_format=fmt)


@pytest.fixture(scope="module")
def pred():
    p = LatentDiffusionPredictor.create(dict(UNET_KW), seed=5, device="cpu", num_timesteps=T,
                                        latent_channels=L, vae_features=(32, 32, 32),
                                        compute_dtype=torch.float64)
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for name, q in p.model.named_parameters():
            if name.startswith("final_conv") or ".proj_out." in name:
                q.copy_(torch.randn(q.shape, generator=gen) * 0.05)
        for m in p.modules():  # GroupNorm affine off the identity
            if isinstance(m, GroupNorm):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape, generator=gen))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
    return p


@pytest.fixture(scope="module")
def batch():
    r = np.random.default_rng(7)
    img = (r.random((B, S, 1, H, H)) > 0.3).astype(np.float32)
    v2d = (r.standard_normal((B, S, 3, H, H)) * 1e-2).astype(np.float32)
    noise = r.standard_normal((B * S, L, H // 4, H // 4)).astype(np.float32)
    return torch.from_numpy(img), torch.from_numpy(v2d), torch.from_numpy(noise)


class _Layouts:
    """Forward pre-hooks on every conv and GroupNorm of a module: the layout
    of each input, True for channels-last."""

    def __init__(self, module):
        self.seen = []
        self.handles = [m.register_forward_pre_hook(self._hook) for m in module.modules()
                        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, GroupNorm))]

    def _hook(self, _m, args):
        self.seen.append(_is_cl(args[0]))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def test_unet_forward_channels_last_equals_channels_first(pred):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((B * S, 2 * L + 1, H // 4, H // 4), generator=gen, dtype=torch.float64)
    t = torch.tensor([0, 3, 9, 1, 5, 7])
    with torch.no_grad(), _Layouts(pred.model) as cf:
        ref = pred.model(x, t)
    with torch.no_grad(), _Layouts(pred.model) as cl:
        got = pred.model(to_channels_last(x), t)
    assert cf.seen and not any(cf.seen)
    assert len(cl.seen) == len(cf.seen) and all(cl.seen)
    assert _is_cl(got) and _rel(got, ref) <= TOL


@pytest.mark.parametrize("branch", ["encode_2d", "decode_3d"])
def test_vae_channels_last_equals_channels_first(pred, branch):
    gen = torch.Generator().manual_seed(2)
    if branch == "encode_2d":
        x = torch.randn((B, 3, S, H, H), generator=gen, dtype=torch.float64)
        run = lambda v: pred.vae.encode_2d_deterministic(v)[0]  # noqa: E731
        module = pred.vae.encoder_2d
    else:
        x = torch.randn((B, L, S, H // 4, H // 4), generator=gen, dtype=torch.float64)
        run = pred.vae.decode_3d
        module = pred.vae.decoder_3d
    with torch.no_grad(), _Layouts(module) as cf:
        ref = run(x)
    with torch.no_grad(), _Layouts(module) as cl:
        got = run(to_channels_last(x))
    assert cf.seen and not any(cf.seen)
    assert len(cl.seen) == len(cf.seen) and all(cl.seen)
    assert _rel(got, ref) <= TOL


def test_attention_block_channels_last_equals_channels_first():
    block = AttentionBlock(32)
    init_module_(block, torch.Generator().manual_seed(3))
    x = torch.randn((2, 32, 3, 4, 4), dtype=torch.float64)
    with torch.no_grad():
        ref, got = block(x), block(to_channels_last(x))
    assert _is_cl(got) and _rel(got, ref) <= TOL


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_samplers_channels_last_equal_channels_first(pred, batch, sampler, monkeypatch):
    img, v2d, noise = batch

    def call():
        if sampler == "dpm":
            return pred.predict_dpm(img, v2d, num_steps=2, noise=noise)
        return pred.predict_ddim(img, v2d, num_steps=2, noise=noise)

    with _Layouts(pred) as cf:
        ref = call()
    monkeypatch.setattr(LatentDiffusionPredictor, "samples_channels_last", lambda self: True)
    with _Layouts(pred) as cl:
        got = call()
    assert cf.seen and not any(cf.seen)
    assert len(cl.seen) == len(cf.seen) and all(cl.seen)
    # the public output stays (B, S, 3, H, W) channels-first, contiguous
    assert got.shape == ref.shape == (B, S, 3, H, H) and got.is_contiguous()
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("device,vae_int8,unet_int8,want", [
    ("cuda", False, False, True), ("cuda", True, False, False), ("cuda", False, True, False),
    ("cuda", True, True, False), ("cpu", False, False, False)])
def test_samplers_channels_last_on_the_card_unless_int8(device, vae_int8, unet_int8, want):
    """The samplers' layout rule: channels-last on CUDA, channels-first where
    a network's convs run in int8 (K4 writes channels-first) and on the CPU."""
    state = SimpleNamespace(device=torch.device(device), vae_int8=vae_int8, unet_int8=unet_int8)
    assert LatentDiffusionPredictor.samples_channels_last(state) is want


def test_training_paths_stay_channels_first(pred, batch, monkeypatch):
    """forward / encode_target keep channels-first, whatever the samplers do."""
    monkeypatch.setattr(LatentDiffusionPredictor, "samples_channels_last", lambda self: True)
    img, v2d, _ = batch
    with torch.no_grad(), _Layouts(pred) as seen:
        x0 = pred.encode_target(v2d)
        pred.forward(img, v2d, x0, generator=torch.Generator().manual_seed(0))
    assert seen.seen and not any(seen.seen)


@pytest.mark.parametrize("shape,groups,act", [((3, 16, 5, 6), 1, "silu"),
                                              ((2, 64, 3, 4, 5), 32, ""),
                                              ((2, 64, 3, 4, 5), 32, "relu")])
def test_plain_groupnorm_keeps_the_layout(shape, groups, act):
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(shape, generator=gen) * 2 + 0.5
    w = 1 + 0.1 * torch.randn(shape[1], generator=gen)
    b = 0.1 * torch.randn(shape[1], generator=gen)
    ref = k1.groupnorm_act(x, w, b, groups, act)
    got = k1.groupnorm_act(to_channels_last(x), w, b, groups, act)
    assert _is_cl(got) and torch.equal(got, ref)
    assert memory_format(group_norm(to_channels_last(x), w, b, groups, two_pass=True)) \
        == memory_format(to_channels_last(x))


def test_upsample_and_pad_keep_the_layout():
    gen = torch.Generator().manual_seed(5)
    x3 = torch.randn((2, 8, 3, 4, 5), generator=gen)
    got = upsample_nearest_hw(to_channels_last(x3))
    assert _is_cl(got) and torch.equal(got, upsample_nearest_hw(x3))
    x = torch.randn((2, 8, 6, 7), generator=gen)
    for mode in ("reflect", "replicate", "circular"):
        got = _pad(to_channels_last(x), (1, 1, 1, 1), mode)
        assert _is_cl(got) and torch.equal(got, _pad(x, (1, 1, 1, 1), mode))


def test_to_channels_last_strides():
    m = torch.randn((4, 1, 5, 5))          # C = 1: contiguous in both layouts
    assert m.is_contiguous(memory_format=torch.channels_last)
    assert _is_cl(to_channels_last(m)) and torch.equal(to_channels_last(m), m)
    x = to_channels_last(torch.randn((2, 3, 4, 4)))
    assert to_channels_last(x) is x
    assert to_channels_last(x, torch.float64).dtype == torch.float64
    assert memory_format(torch.randn((2, 3, 4, 4))) == torch.contiguous_format
    assert memory_format(x) == torch.channels_last
