"""Dynamic int8 quantization of the frozen networks' convolutions.

The port's copy of the JAX package's ``ops/quant.py``, channels-first.
The scheme is symmetric and dynamic, recomputed on every call:

- activations: per-INPUT-channel scales max|x[:, i]| / 127 (the maximum over
  every axis but the channel axis, the batch included), folded into the
  weight before the weight's own quantization: the conv sums over input
  channels, so a per-channel activation scale has to ride the weight;
- weights: per-output-channel scales of that folded float32 weight.

Every quantizer works in float32: round half to even, clip to +/-127, and
``+1e-30`` on the maximum. Convs with thin channel counts (in < 16 or
out < 32: the VAE's 3->128 / 8->512 stems and 512->16 / 128->3 heads, the
UNet's 64->8 head) stay on the caller's float path (``use_float_path``).

``int8_conv`` quantizes with PyTorch tensor ops (the JAX package leaves
that pass to XLA, outside any Pallas kernel), writing the activation codes
channels-last with the channels padded to a multiple of 16, and runs the
int8 x int8 -> int32 convolution and its rescale in K4
(``ops/cuda/int8_conv.py``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .cuda import int8_conv as k4

# below these channel counts the float path is kept (accuracy, and the tensor
# cores gain nothing on layouts this thin)
MIN_IN_CH = 16
MIN_OUT_CH = 32
# float32 elements the activation quantizer converts at a time: bounds its
# temporaries to 256 MB whatever the batch (a B=8 decoder conv at 128 channels
# quantizes 7.4e8 values)
QUANT_CHUNK = 2 ** 26


def use_float_path(cin: int, cout: int) -> bool:
    """Thin-channel convs stay on the caller's float path; callers check this
    before routing to :func:`int8_conv`."""
    return cin < MIN_IN_CH or cout < MIN_OUT_CH


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """(amax + 1e-30) / 127 as a true float32 division: the divisor is a
    tensor, as PyTorch's CUDA kernels multiply by the reciprocal of a Python
    scalar divisor instead (which moves some scales by an ulp)."""
    return (amax + 1e-30) / torch.full_like(amax, 127.0)


def _quantize(xf: torch.Tensor, amax: torch.Tensor, shape) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = _scale(amax)
    q = torch.clamp(torch.round(xf / scale.reshape(shape)), -127.0, 127.0).to(torch.int8)
    return q, scale


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: (x_q int8, scale float32 scalar)."""
    xf = x.float()
    return _quantize(xf, xf.abs().amax(), ())


def quantize_act_per_channel(x: torch.Tensor, axis: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel symmetric int8 along ``axis`` (channels-first: 1), the
    maximum over every other axis: (x_q int8, scale float32 (C,))."""
    xf = x.float()
    others = [d for d in range(x.ndim) if d != axis % x.ndim]
    shape = [1] * x.ndim
    shape[axis] = -1
    return _quantize(xf, xf.abs().amax(dim=others), shape)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 for torch conv weights (out, in,
    *kernel): (w_q int8, scale float32 (out,))."""
    wf = w.float()
    shape = [-1] + [1] * (w.ndim - 1)
    return _quantize(wf, wf.abs().amax(dim=list(range(1, w.ndim))), shape)


def quantize_channels_last(x: torch.Tensor, cp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_act_per_channel(x)`` written as K4 reads it: x (N, C, D, H, W)
    -> codes (N, D, H, W, cp) int8, channels past C zero; scale (C,). The
    same float32 division, rounding and clip, over at most ``QUANT_CHUNK``
    elements at a time."""
    n, c = x.shape[:2]
    # |x| in x's dtype converts to float32 exactly
    scale = _scale(x.abs().amax(dim=[0] + list(range(2, x.ndim))).float())
    xq = torch.empty((n,) + tuple(x.shape[2:]) + (cp,), dtype=torch.int8, device=x.device)
    if cp > c:
        xq[..., c:] = 0
    step = max(1, QUANT_CHUNK // max(1, x[0].numel()))
    div = scale.reshape((1, c) + (1,) * (x.ndim - 2))
    for i in range(0, n, step):
        part = x[i:i + step].to(torch.float32, copy=True)
        part.div_(div).round_().clamp_(-127.0, 127.0)
        xq[i:i + step, ..., :c] = part.movedim(1, -1)
    return xq, scale


def int8_conv(x: torch.Tensor, weight: torch.Tensor, stride: Sequence[int],
              padding: Sequence[Tuple[int, int]], out_dtype: torch.dtype) -> torch.Tensor:
    """Quantize, convolve in int8, rescale: a drop-in for one zero-padded
    ``F.conv2d`` / ``F.conv3d`` without bias (the JAX ``int8_conv``).

    x (N, Cin, [D,] H, W); weight (Cout, Cin, [kd,] kh, kw), read in
    float32 whatever x's dtype; ``stride`` per spatial dim; ``padding`` a
    (lo, hi) pair per spatial dim (asymmetric allowed). Returns
    (N, Cout, [Do,] Ho, Wo) in ``out_dtype``. The caller checks
    :func:`use_float_path` first."""
    two_d = x.ndim == 4
    if two_d:
        x, weight = x[:, :, None], weight[:, :, None]
        stride, padding = (1, *stride), ((0, 0), *padding)
    cout, cin = weight.shape[:2]
    cp = k4.padded_channels(cin)
    x_q, sx = quantize_channels_last(x, cp)
    # fold the activation scales into the float32 weight, then quantize it
    w_q, sw = quantize_weight(weight.float() * sx.reshape(1, cin, 1, 1, 1))
    w_q = w_q.permute(0, 2, 3, 4, 1)
    if cp > cin:
        w_q = F.pad(w_q, (0, cp - cin))
    pads = [p for lo_hi in padding for p in lo_hi]
    y = k4.int8_conv(x_q, w_q.contiguous(), sw, list(stride), pads, out_dtype)
    return y[:, :, 0] if two_d else y
