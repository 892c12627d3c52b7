"""Dual-branch 3D VAE, channels-first ``(N, C, D, H, W)``.

Counterpart of the JAX ``models/vae.py`` on the non-conditional path the
published pipeline uses: ``ResidualBlock``, ``Encoder``, ``Decoder`` and
``DualBranchVAE`` with the logvar clamp to [-10, 10]. Module names follow the
reference state dict (``encoder_2d.res1_1.norm1.weight``, ...). FiLM, the
conditional blocks, ``AttentionBlock`` and ``VariationalAutoencoder`` are
not ported yet.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops.basic import get_padding
from ..ops.resize import upsample_nearest_hw
from .layers import Conv3d, GroupNorm, init_module_

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


class Encoder(nn.Module):
    """(N, in_channels, D, H, W) -> (mu, logvar), each (N, latent, D, H/4, W/4)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 features: Sequence[int] = REFERENCE_FEATURES):
        super().__init__()
        pad = get_padding(kernel_size)
        f1, f2, f3 = validate_features(features)
        self.conv_in = Conv3d(in_channels, f1, kernel_size, padding=pad)
        self.res1_1 = ResidualBlock(f1, f1, kernel_size)
        self.res1_2 = ResidualBlock(f1, f1, kernel_size)
        self.down1 = Conv3d(f1, f1, kernel_size, stride=(1, 2, 2), extra_pad=_ASYM_PAD)
        self.res2_1 = ResidualBlock(f1, f2, kernel_size)
        self.res2_2 = ResidualBlock(f2, f2, kernel_size)
        self.down2 = Conv3d(f2, f2, kernel_size, stride=(1, 2, 2), extra_pad=_ASYM_PAD)
        self.res3_1 = ResidualBlock(f2, f3, kernel_size)
        self.res3_2 = ResidualBlock(f3, f3, kernel_size)
        self.norm_out = GroupNorm(32, f3, act="silu")
        self.conv_out = Conv3d(f3, 2 * out_channels, kernel_size, padding=pad)

    def forward(self, x):
        x = self.res1_2(self.res1_1(self.conv_in(x)))
        x = self.res2_2(self.res2_1(self.down1(x)))
        x = self.res3_2(self.res3_1(self.down2(x)))
        x = self.conv_out(self.norm_out(x))
        mu, logvar = x.chunk(2, dim=1)
        return mu, logvar


class Decoder(nn.Module):
    """(N, latent, D, H/4, W/4) -> (N, out_channels, D, H, W)."""

    def __init__(self, in_channels: int, out_channels: int = 3, kernel_size: int = 3,
                 features: Sequence[int] = REFERENCE_FEATURES):
        super().__init__()
        pad = get_padding(kernel_size)
        f1, f2, f3 = validate_features(features)
        self.conv_in = Conv3d(in_channels, f3, kernel_size, padding=pad)
        self.res1_1 = ResidualBlock(f3, f3, kernel_size)
        self.res1_2 = ResidualBlock(f3, f3, kernel_size)
        self.conv_up1 = Conv3d(f3, f2, kernel_size, padding=pad)
        self.res2_1 = ResidualBlock(f2, f2, kernel_size)
        self.res2_2 = ResidualBlock(f2, f2, kernel_size)
        self.conv_up2 = Conv3d(f2, f1, kernel_size, padding=pad)
        self.res3_1 = ResidualBlock(f1, f1, kernel_size)
        self.res3_2 = ResidualBlock(f1, f1, kernel_size)
        self.norm_out = GroupNorm(32, f1, act="silu")
        self.conv_out = Conv3d(f1, out_channels, kernel_size, padding=pad)

    def forward(self, x):
        x = self.res1_2(self.res1_1(self.conv_in(x)))
        x = self.res2_2(self.res2_1(self.conv_up1(upsample_nearest_hw(x))))
        x = self.res3_2(self.res3_1(self.conv_up2(upsample_nearest_hw(x))))
        return self.conv_out(self.norm_out(x))


def _clamp_logvar(logvar: torch.Tensor) -> torch.Tensor:
    return torch.clamp(logvar, -10.0, 10.0)


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype, device=generator.device)
    return mu + torch.exp(0.5 * logvar) * eps.to(mu.device)


class DualBranchVAE(nn.Module):
    """Four-module dual-branch VAE; the 2D->3D inference path is
    x_2d -> encoder_2d -> [latent diffusion] -> decoder_3d."""

    def __init__(self, in_channels: int = 3, latent_channels: int = 8, kernel_size: int = 3,
                 features: Sequence[int] = REFERENCE_FEATURES):
        super().__init__()
        self.latent_channels = latent_channels
        self.encoder_2d = Encoder(in_channels, latent_channels, kernel_size, features)
        self.decoder_2d = Decoder(latent_channels, in_channels, kernel_size, features)
        self.encoder_3d = Encoder(in_channels, latent_channels, kernel_size, features)
        self.decoder_3d = Decoder(latent_channels, in_channels, kernel_size, features)

    def init_parameters_(self, generator: torch.Generator) -> None:
        init_module_(self, generator)

    def encode_2d(self, x, generator: torch.Generator):
        mu, logvar = self.encoder_2d(x)
        logvar = _clamp_logvar(logvar)
        return reparameterize(mu, logvar, generator), (mu, logvar)

    def encode_3d(self, x, generator: torch.Generator):
        mu, logvar = self.encoder_3d(x)
        logvar = _clamp_logvar(logvar)
        return reparameterize(mu, logvar, generator), (mu, logvar)

    def encode_2d_deterministic(self, x):
        mu, logvar = self.encoder_2d(x)
        return mu, (mu, _clamp_logvar(logvar))

    def encode_3d_deterministic(self, x):
        mu, logvar = self.encoder_3d(x)
        return mu, (mu, _clamp_logvar(logvar))

    def decode_2d(self, z):
        x = self.decoder_2d(z)
        x[:, 2] = 0.0  # w == 0 for 2D flow
        return x

    def decode_3d(self, z):
        return self.decoder_3d(z)
