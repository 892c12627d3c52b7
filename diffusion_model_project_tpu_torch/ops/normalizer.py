"""Per-channel max normalization (counterpart of the JAX ``ops/normalizer.py``).

Divides each channel by a fixed scale factor; ``inverse`` multiplies back.
The factors are a non-trainable buffer so they travel in the state dict as
``<name>.scale_factors``.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class MaxNormalizer(nn.Module):
    def __init__(self, scale_factors: Sequence[float] = (1.0,)):
        super().__init__()
        self.register_buffer(
            "scale_factors", torch.as_tensor(scale_factors, dtype=torch.float32).reshape(-1))

    def _shaped(self, x: torch.Tensor, channel_axis: int) -> torch.Tensor:
        shape = [1] * x.ndim
        shape[channel_axis] = self.scale_factors.shape[0]
        return self.scale_factors.reshape(shape)

    def forward(self, x: torch.Tensor, channel_axis: int = 1) -> torch.Tensor:
        return self.normalize(x, channel_axis)

    def normalize(self, x: torch.Tensor, channel_axis: int = 1) -> torch.Tensor:
        return x / self._shaped(x, channel_axis)

    def inverse(self, x: torch.Tensor, channel_axis: int = 1) -> torch.Tensor:
        return x * self._shaped(x, channel_axis)
