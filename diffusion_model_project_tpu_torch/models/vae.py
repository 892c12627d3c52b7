"""Dual-branch 3D VAE, channels-first ``(N, C, D, H, W)``.

Counterpart of the JAX ``models/vae.py``: ``ResidualBlock``, ``FiLM``,
``ConditionalResidualBlock``, ``Encoder``, ``Decoder`` (each optionally
FiLM-conditioned on a per-sample is-3D flag), the standard single-branch
``VariationalAutoencoder`` (state-dict keys ``encoder.*`` / ``decoder.*``),
``DualBranchVAE`` with its composite, cross and alignment paths, the logvar
clamp to [-10, 10] and the sum-form KL. Module names follow the reference
state dict (``encoder_2d.res1_1.norm1.weight``,
``decoder_3d.film_in.mlp.0.weight``, ...). Stochastic paths draw from a
caller's ``torch.Generator``. ``AttentionBlock`` (GroupNorm(32) through K1,
self-attention over D*H*W tokens through K2, residual) is part of the public
surface, though the final encoder and decoder do not use it.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.basic import get_padding
from ..ops.resize import upsample_nearest_hw
from .layers import (Conv3d, GroupNorm, Linear, MultiheadSelfAttention, init_module_,
                     uniform_)

_ASYM_PAD = ((1, 1), (0, 1), (0, 1))  # (D, H, W) pre-pad for the stride-(1,2,2) convs

REFERENCE_FEATURES = (128, 256, 512)


def validate_features(features) -> Tuple[int, int, int]:
    """Stage widths must be positive multiples of 32 (the GroupNorm groups)."""
    features = tuple(int(f) for f in features)
    bad = [f for f in features if f % 32 != 0 or f <= 0]
    if bad:
        raise ValueError(
            f"VAE stage widths {features} must be positive multiples of 32 "
            f"(the GroupNorm group count); offending values: {bad}.")
    return features


def features_from_decoder_state(decoder_sd: dict) -> Tuple[int, int, int]:
    """(f1, f2, f3) stage widths from a Decoder state dict's conv output
    channels (torch weights are (out, in, *kernel)); the counterpart of the
    JAX ``features_from_decoder_params``."""
    f3 = decoder_sd["conv_in.weight"].shape[0]
    f2 = decoder_sd["conv_up1.weight"].shape[0]
    f1 = decoder_sd["conv_up2.weight"].shape[0]
    return validate_features((f1, f2, f3))


class FiLM(nn.Module):
    """Feature-wise linear modulation: a 3-layer MLP maps the condition
    (N,) to (gamma, beta), each (N, C), applied as gamma * x + beta over the
    channel axis 1. The MLP runs in float32 whatever x's dtype."""

    def __init__(self, feature_channels: int, hidden_dim: int = 128):
        super().__init__()
        self.feature_channels = feature_channels
        self.mlp = nn.Sequential(Linear(1, hidden_dim), nn.SiLU(),
                                 Linear(hidden_dim, hidden_dim), nn.SiLU(),
                                 Linear(hidden_dim, 2 * feature_channels))

    def init_parameters_(self, generator: torch.Generator) -> None:
        """The last layer as the JAX package initializes it: xavier-uniform
        with gain 0.1 and the gamma half of the bias at 1 (identity at init)."""
        last = self.mlp[4]
        fan_out, fan_in = last.weight.shape
        uniform_(last.weight, math.sqrt(3.0 * 0.1 ** 2 / ((fan_in + fan_out) / 2)), generator)
        with torch.no_grad():
            last.bias.zero_()
            last.bias[:self.feature_channels] = 1.0

    def forward(self, x: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        h = self.mlp(condition.to(torch.float32).reshape(-1, 1))
        gamma, beta = h.chunk(2, dim=1)
        shape = (x.shape[0], self.feature_channels) + (1,) * (x.ndim - 2)
        return gamma.reshape(shape) * x + beta.reshape(shape)


class ResidualBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3):
        super().__init__()
        pad = get_padding(kernel_size)
        self.norm1 = GroupNorm(32, in_channels, act="silu")
        self.conv1 = Conv3d(in_channels, out_channels, kernel_size, padding=pad)
        self.norm2 = GroupNorm(32, out_channels, act="silu")
        self.conv2 = Conv3d(out_channels, out_channels, kernel_size, padding=pad)
        self.residual_layer = (Conv3d(in_channels, out_channels, 1)
                               if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(self.norm1(x))
        h = self.conv2(self.norm2(h))
        if self.residual_layer is not None:
            x = self.residual_layer(x)
        return h + x


class ConditionalResidualBlock(ResidualBlock):
    """ResidualBlock with FiLM after each conv (``film1``, ``film2``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3):
        super().__init__(in_channels, out_channels, kernel_size)
        self.film1 = FiLM(out_channels)
        self.film2 = FiLM(out_channels)

    def forward(self, x, condition):
        h = self.film1(self.conv1(self.norm1(x)), condition)
        h = self.film2(self.conv2(self.norm2(h)), condition)
        if self.residual_layer is not None:
            x = self.residual_layer(x)
        return h + x


class AttentionBlock(nn.Module):
    """GroupNorm(32) (no activation), full self-attention over the D*H*W
    tokens, then the residual; (N, C, D, H, W) in and out. Parameters
    ``norm.*`` and ``attention.*`` (the JAX ``AttentionBlock``'s ``norm`` and
    ``attention``, through ``utils/weights.export_attention_block``)."""

    def __init__(self, channels: int, num_heads: int = 2):
        super().__init__()
        self.norm = GroupNorm(32, channels)
        self.attention = MultiheadSelfAttention(channels, num_heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, d, h, w = x.shape
        y = self.norm(x).flatten(2).transpose(1, 2).contiguous()  # (N, DHW, C)
        y = self.attention(y)
        return x + y.transpose(1, 2).reshape(b, c, d, h, w)


def _check_condition(conditional: bool, condition, what: str) -> None:
    if conditional and condition is None:
        raise ValueError(f"conditional=True {what} requires a condition")
    if not conditional and condition is not None:
        raise ValueError(f"{what} got a condition but conditional=False")


class _Stages(nn.Module):
    """Residual blocks run with or without the condition. ``remat``: under
    autograd each residual block goes through ``torch.utils.checkpoint``, so
    its activations are recomputed in backward instead of stored (the JAX
    ``nn.remat``; differentiating through the 256^2 x 11 VAE networks does
    not fit otherwise). A block checkpoints only where its input or a
    parameter needs a gradient: a frozen network on a frozen input stores
    nothing either way. Parameters and results are unchanged."""

    remat = False

    def _res(self, block, x, condition):
        args = (x,) if condition is None else (x, condition)
        if self.remat and torch.is_grad_enabled() and (
                x.requires_grad or any(p.requires_grad for p in block.parameters())):
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def _film(self, name, x, condition):
        return x if condition is None else getattr(self, name)(x, condition)


class Encoder(_Stages):
    """(N, in_channels, D, H, W) -> (mu, logvar), each (N, latent, D, H/4, W/4).
    ``conditional``: FiLM ``film_in`` after conv_in, ``film_out`` after
    conv_out, and FiLM in every residual block."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 features: Sequence[int] = REFERENCE_FEATURES, conditional: bool = False):
        super().__init__()
        pad = get_padding(kernel_size)
        f1, f2, f3 = validate_features(features)
        self.conditional = conditional
        Res = ConditionalResidualBlock if conditional else ResidualBlock
        self.conv_in = Conv3d(in_channels, f1, kernel_size, padding=pad)
        self.res1_1 = Res(f1, f1, kernel_size)
        self.res1_2 = Res(f1, f1, kernel_size)
        self.down1 = Conv3d(f1, f1, kernel_size, stride=(1, 2, 2), extra_pad=_ASYM_PAD)
        self.res2_1 = Res(f1, f2, kernel_size)
        self.res2_2 = Res(f2, f2, kernel_size)
        self.down2 = Conv3d(f2, f2, kernel_size, stride=(1, 2, 2), extra_pad=_ASYM_PAD)
        self.res3_1 = Res(f2, f3, kernel_size)
        self.res3_2 = Res(f3, f3, kernel_size)
        self.norm_out = GroupNorm(32, f3, act="silu")
        self.conv_out = Conv3d(f3, 2 * out_channels, kernel_size, padding=pad)
        if conditional:
            self.film_in = FiLM(f1)
            self.film_out = FiLM(2 * out_channels)

    def forward(self, x, condition: Optional[torch.Tensor] = None):
        _check_condition(self.conditional, condition, "Encoder")
        c = condition
        x = self._film("film_in", self.conv_in(x), c)
        x = self._res(self.res1_2, self._res(self.res1_1, x, c), c)
        x = self.down1(x)
        x = self._res(self.res2_2, self._res(self.res2_1, x, c), c)
        x = self.down2(x)
        x = self._res(self.res3_2, self._res(self.res3_1, x, c), c)
        x = self._film("film_out", self.conv_out(self.norm_out(x)), c)
        mu, logvar = x.chunk(2, dim=1)
        return mu, logvar


class Decoder(_Stages):
    """(N, latent, D, H/4, W/4) -> (N, out_channels, D, H, W).
    ``conditional``: FiLM ``film_in`` after conv_in, ``film_pre_out`` before
    norm_out, FiLM in every residual block, and the w channel zeroed where
    the condition is 0 (a 2D sample)."""

    def __init__(self, in_channels: int, out_channels: int = 3, kernel_size: int = 3,
                 features: Sequence[int] = REFERENCE_FEATURES, conditional: bool = False):
        super().__init__()
        pad = get_padding(kernel_size)
        f1, f2, f3 = validate_features(features)
        self.conditional = conditional
        Res = ConditionalResidualBlock if conditional else ResidualBlock
        self.conv_in = Conv3d(in_channels, f3, kernel_size, padding=pad)
        self.res1_1 = Res(f3, f3, kernel_size)
        self.res1_2 = Res(f3, f3, kernel_size)
        self.conv_up1 = Conv3d(f3, f2, kernel_size, padding=pad)
        self.res2_1 = Res(f2, f2, kernel_size)
        self.res2_2 = Res(f2, f2, kernel_size)
        self.conv_up2 = Conv3d(f2, f1, kernel_size, padding=pad)
        self.res3_1 = Res(f1, f1, kernel_size)
        self.res3_2 = Res(f1, f1, kernel_size)
        self.norm_out = GroupNorm(32, f1, act="silu")
        self.conv_out = Conv3d(f1, out_channels, kernel_size, padding=pad)
        if conditional:
            self.film_in = FiLM(f3)
            self.film_pre_out = FiLM(f1)

    def forward(self, x, condition: Optional[torch.Tensor] = None):
        _check_condition(self.conditional, condition, "Decoder")
        c = condition
        x = self._film("film_in", self.conv_in(x), c)
        x = self._res(self.res1_2, self._res(self.res1_1, x, c), c)
        x = self.conv_up1(upsample_nearest_hw(x))
        x = self._res(self.res2_2, self._res(self.res2_1, x, c), c)
        x = self.conv_up2(upsample_nearest_hw(x))
        x = self._res(self.res3_2, self._res(self.res3_1, x, c), c)
        x = self._film("film_pre_out", x, c)
        x = self.conv_out(self.norm_out(x))
        if c is not None:
            is_3d = c.to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
            w_zeroed = x.clone()
            w_zeroed[:, 2] = 0.0
            x = is_3d * x + (1.0 - is_3d) * w_zeroed
        return x


def _clamp_logvar(logvar: torch.Tensor) -> torch.Tensor:
    return torch.clamp(logvar, -10.0, 10.0)


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype, device=generator.device)
    return mu + torch.exp(0.5 * logvar) * eps.to(mu.device)


class VariationalAutoencoder(nn.Module):
    """Standard single-branch VAE (reference VAE_model/src/vae/autoencoder.py);
    ``conditional``: the FiLM-conditioned encoder and decoder, which then
    take a per-sample condition."""

    def __init__(self, in_channels: int = 3, latent_channels: int = 8, kernel_size: int = 3,
                 conditional: bool = False, features: Sequence[int] = REFERENCE_FEATURES):
        super().__init__()
        self.latent_channels = latent_channels
        self.encoder = Encoder(in_channels, latent_channels, kernel_size, features, conditional)
        self.decoder = Decoder(latent_channels, in_channels, kernel_size, features, conditional)

    def encode(self, x, generator: torch.Generator, condition=None):
        mu, logvar = self.encoder(x, condition)
        logvar = _clamp_logvar(logvar)
        return reparameterize(mu, logvar, generator), (mu, logvar)

    def encode_deterministic(self, x, condition=None):
        mu, logvar = self.encoder(x, condition)
        return mu, (mu, _clamp_logvar(logvar))

    def decode(self, z, condition=None):
        return self.decoder(z, condition)

    def forward(self, x, generator: torch.Generator, condition=None):
        z, (mu, logvar) = self.encode(x, generator, condition)
        return self.decode(z, condition), (mu, logvar)


class DualBranchVAE(nn.Module):
    """Four-module dual-branch VAE; the 2D->3D inference path is
    x_2d -> encoder_2d -> [latent diffusion] -> decoder_3d.

    ``conditional``: the conditional standard VAE on the dual-branch surface.
    Its one FiLM-conditioned encoder and decoder serve both branches, and
    the branch fixes the condition: 0 for the 2D methods, 1 for the 3D
    ones, the constants the reference predictor passes at its call sites."""

    def __init__(self, in_channels: int = 3, latent_channels: int = 8, kernel_size: int = 3,
                 features: Sequence[int] = REFERENCE_FEATURES, conditional: bool = False):
        super().__init__()
        self.latent_channels = latent_channels
        self.conditional = conditional
        enc = lambda: Encoder(in_channels, latent_channels, kernel_size, features, conditional)  # noqa: E731
        dec = lambda: Decoder(latent_channels, in_channels, kernel_size, features, conditional)  # noqa: E731
        self.encoder_2d, self.decoder_2d = enc(), dec()
        self.encoder_3d, self.decoder_3d = enc(), dec()
        # the physics losses differentiate through the frozen D3D (the JAX
        # remat_decoders=True of losses/physics.py); it checkpoints only under grad
        self.decoder_3d.remat = True

    def init_parameters_(self, generator: torch.Generator) -> None:
        init_module_(self, generator)
        for m in self.modules():
            if isinstance(m, FiLM):
                m.init_parameters_(generator)

    def _cond(self, x: torch.Tensor, is_3d: bool) -> Optional[torch.Tensor]:
        """The per-sample condition of a branch (None when unconditional)."""
        if not self.conditional:
            return None
        return torch.full((x.shape[0],), float(is_3d), dtype=torch.float32, device=x.device)

    def encode_2d(self, x, generator: torch.Generator):
        mu, logvar = self.encoder_2d(x, self._cond(x, False))
        logvar = _clamp_logvar(logvar)
        return reparameterize(mu, logvar, generator), (mu, logvar)

    def encode_3d(self, x, generator: torch.Generator):
        mu, logvar = self.encoder_3d(x, self._cond(x, True))
        logvar = _clamp_logvar(logvar)
        return reparameterize(mu, logvar, generator), (mu, logvar)

    def encode_2d_deterministic(self, x):
        mu, logvar = self.encoder_2d(x, self._cond(x, False))
        return mu, (mu, _clamp_logvar(logvar))

    def encode_3d_deterministic(self, x):
        mu, logvar = self.encoder_3d(x, self._cond(x, True))
        return mu, (mu, _clamp_logvar(logvar))

    def decode_2d(self, z):
        x = self.decoder_2d(z, self._cond(z, False))
        x[:, 2] = 0.0  # w == 0 for 2D flow
        return x

    def decode_3d(self, z):
        return self.decoder_3d(z, self._cond(z, True))

    # --- composite paths -----------------------------------------------------

    def forward_2d(self, x_2d, generator: torch.Generator):
        z, (mu, logvar) = self.encode_2d(x_2d, generator)
        return self.decode_2d(z), (mu, logvar)

    def forward_2d_deterministic(self, x_2d):
        z, (mu, _) = self.encode_2d_deterministic(x_2d)
        return self.decode_2d(z), mu

    def forward_3d(self, x_3d, generator: torch.Generator):
        z, (mu, logvar) = self.encode_3d(x_3d, generator)
        return self.decode_3d(z), (mu, logvar)

    def forward_cross_2d_to_3d(self, x_2d):
        z_2d, _ = self.encode_2d_deterministic(x_2d)
        return self.decode_3d(z_2d), z_2d

    def forward_cross_3d_to_2d(self, x_3d, generator: torch.Generator):
        z_3d, _ = self.encode_3d(x_3d, generator)
        return self.decode_2d(z_3d), z_3d

    def compute_alignment_loss(self, x_2d, x_3d, mode: str = "symmetric"):
        """Mean squared distance of the two branches' deterministic latents;
        ``one_way`` / ``stop_grad`` pass no gradient into E3D."""
        if mode not in ("symmetric", "one_way", "stop_grad"):
            raise ValueError(f"Unknown alignment mode: {mode}")
        z_2d, _ = self.encode_2d_deterministic(x_2d)
        z_3d, _ = self.encode_3d_deterministic(x_3d)
        if mode != "symmetric":
            z_3d = z_3d.detach()
        return torch.mean(torch.square(z_2d - z_3d))

    def predict_2d_to_3d(self, x_2d, generator: torch.Generator):
        z_2d, _ = self.encode_2d(x_2d, generator)
        return self.decode_3d(z_2d)


def kl_divergence_sum(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Sum-form KL (reference dual_vae/model.py:380-382)."""
    return -0.5 * torch.sum(1 + logvar - torch.square(mu) - torch.exp(logvar))
