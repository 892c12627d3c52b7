"""K4: int8 x int8 -> int32 convolution with a per-output-channel rescale,
hand-written CUDA kernel (``csrc/int8_conv.cu``).

It replaces no Pallas kernel: the JAX package runs its int8 conv through
XLA (``lax.conv_general_dilated(int8, int8, preferred_element_type=int32)``
in ``diffusion_model_project_tpu/ops/quant.py::int8_conv``), and PyTorch
computes no such conv on the card (cuDNN's int8 convolution is not exposed,
and ``F.conv*`` on int8 tensors returns wrapped int8 sums).

Layouts are the kernel's:
  x_q (N, D, H, W, Cp) int8, channels-last; 2D is D = 1; Cp = Cin rounded up
      to a multiple of 16 with zero codes (:func:`padded_channels`);
  w_q (Cout, kd, kh, kw, Cp) int8, K contiguous;
  sw  (Cout,) float32;
  y   (N, Cout, Do, Ho, Wo) in bfloat16 or float32, the port's layout.
``stride`` is (sd, sh, sw) and ``padding`` (lo_d, hi_d, lo_h, hi_h, lo_w,
hi_w); a tap outside the input reads 0. Each output element is the exact
int32 sum, then ``float(acc) * sw[o]`` in float32, then one rounding to the
output dtype, so the kernel and :func:`int8_conv_plain` agree bit for bit.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it takes the plain version. Under ``torch.export`` the call is traced as the
registered op ``torch.ops.dm_port.int8_conv``.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from . import _lib

_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
CHANNEL_ALIGN = 16        # bytes of one cp.async row: Cp is a multiple of it
BM, BN = 128, 128         # output voxels x output channels a block (csrc BM, BN)
MAX_GRID_Y = 65535

# wrapper calls that launched the kernel (not counting CPU calls), through the
# registered op too
LAUNCHES = 0


def padded_channels(cin: int) -> int:
    """Cin rounded up to a whole number of 16-byte rows."""
    return -(-cin // CHANNEL_ALIGN) * CHANNEL_ALIGN


def output_shape(x_shape, w_shape, stride: Sequence[int], padding: Sequence[int]) -> tuple:
    """(N, Cout, Do, Ho, Wo) of the conv."""
    n, d, h, w, _ = x_shape
    cout, kd, kh, kw, _ = w_shape
    out = [(size + padding[2 * i] + padding[2 * i + 1] - k) // s + 1
           for i, (size, k, s) in enumerate(zip((d, h, w), (kd, kh, kw), stride))]
    return (n, cout, *out)


def int8_conv_plain(x_q: torch.Tensor, w_q: torch.Tensor, sw: torch.Tensor,
                    stride: Sequence[int], padding: Sequence[int],
                    out_dtype: torch.dtype) -> torch.Tensor:
    """The same function in PyTorch: the conv on the codes in float64 (every
    sum is below 27 x 2048 x 127^2 < 2^53, so exact), then the float32
    rescale and one cast."""
    x = F.pad(x_q.permute(0, 4, 1, 2, 3).double(), tuple(padding[4:6]) + tuple(padding[2:4])
              + tuple(padding[0:2]))
    acc = F.conv3d(x, w_q.permute(0, 4, 1, 2, 3).double(), stride=tuple(stride))
    return (acc.float() * sw.reshape(1, -1, 1, 1, 1)).to(out_dtype)


def _check(x_q, w_q, sw, stride, padding, out_dtype) -> None:
    if x_q.ndim != 5 or w_q.ndim != 5 or w_q.shape[4] != x_q.shape[4]:
        raise ValueError(f"int8_conv: expected x_q (N, D, H, W, Cp) and w_q (Cout, kd, kh, kw, "
                         f"Cp), got {tuple(x_q.shape)} and {tuple(w_q.shape)}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8 or sw.dtype != torch.float32:
        raise TypeError(f"int8_conv: x_q and w_q must be int8 and sw float32, got {x_q.dtype}, "
                        f"{w_q.dtype} and {sw.dtype}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"int8_conv: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if sw.shape != (w_q.shape[0],):
        raise ValueError(f"int8_conv: sw must be ({w_q.shape[0]},), got {tuple(sw.shape)}")
    if len(stride) != 3 or len(padding) != 6 or min(stride) < 1 or min(padding) < 0:
        raise ValueError(f"int8_conv: stride (sd, sh, sw) >= 1 and padding (lo, hi) x 3 >= 0, "
                         f"got {tuple(stride)} and {tuple(padding)}")
    if x_q.shape[4] % CHANNEL_ALIGN:
        raise ValueError(f"int8_conv: Cp = {x_q.shape[4]} must be a multiple of {CHANNEL_ALIGN}")
    if w_q.device != x_q.device or sw.device != x_q.device:
        raise ValueError("int8_conv: x_q, w_q and sw must be on one device")
    if torch.is_grad_enabled() and sw.requires_grad:
        raise RuntimeError("int8_conv has no backward; call it without grad")
    if min(output_shape(x_q.shape, w_q.shape, stride, padding)) < 1:
        raise ValueError(f"int8_conv: empty output for x_q {tuple(x_q.shape)}, w_q "
                         f"{tuple(w_q.shape)}, stride {tuple(stride)}, padding {tuple(padding)}")


def int8_conv(x_q: torch.Tensor, w_q: torch.Tensor, sw: torch.Tensor, stride: Sequence[int],
              padding: Sequence[int], out_dtype: torch.dtype) -> torch.Tensor:
    """(N, Cout, Do, Ho, Wo) = rescale(conv(x_q, w_q)) in ``out_dtype``; see
    the module's docstring for the layouts."""
    global LAUNCHES
    if torch.compiler.is_compiling():
        return torch.ops.dm_port.int8_conv(x_q, w_q, sw, list(stride), list(padding), out_dtype)
    _check(x_q, w_q, sw, stride, padding, out_dtype)
    if x_q.device.type == "cpu":
        return int8_conv_plain(x_q, w_q, sw, stride, padding, out_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {x_q.device}")
    if not (x_q.is_contiguous() and w_q.is_contiguous() and sw.is_contiguous()):
        raise ValueError("int8_conv: x_q, w_q and sw must be contiguous")
    if x_q.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("int8_conv: x_q and w_q must start on a 16-byte boundary (cp.async)")
    y_shape = output_shape(x_q.shape, w_q.shape, stride, padding)
    n, cout = y_shape[:2]
    m = n * y_shape[2] * y_shape[3] * y_shape[4]
    if m >= 2 ** 31 - BM or -(-cout // BN) > MAX_GRID_Y or w_q[0].numel() >= 2 ** 31:
        raise ValueError(f"int8_conv: {tuple(x_q.shape)} -> {cout} is outside the kernel's range")
    y = torch.empty(y_shape, dtype=out_dtype, device=x_q.device)
    _, d, h, w, cp = x_q.shape
    _, kd, kh, kw, _ = w_q.shape
    err = _lib.lib().dm_int8_conv(
        _OUT_CODES[out_dtype], x_q.data_ptr(), w_q.data_ptr(), sw.data_ptr(), y.data_ptr(),
        n, d, h, w, cp, cout, kd, kh, kw, *stride, padding[0], padding[2], padding[4],
        *y_shape[2:], _lib.stream_ptr(x_q))
    _lib.check(err, "int8_conv")
    LAUNCHES += 1
    return y


@torch.library.custom_op("dm_port::int8_conv", mutates_args=())
def int8_conv_op(x_q: torch.Tensor, w_q: torch.Tensor, sw: torch.Tensor, stride: List[int],
                 padding: List[int], out_dtype: torch.dtype) -> torch.Tensor:
    """K4 as a registered op, so that ``torch.export`` records the call
    instead of tracing the ``ctypes`` launch: its body is :func:`int8_conv`
    (the kernel on CUDA, the plain version on CPU)."""
    return int8_conv(x_q, w_q, sw, stride, padding, out_dtype)


@int8_conv_op.register_fake
def _int8_conv_fake(x_q, w_q, sw, stride, padding, out_dtype):
    return x_q.new_empty(output_shape(x_q.shape, w_q.shape, stride, padding), dtype=out_dtype)
