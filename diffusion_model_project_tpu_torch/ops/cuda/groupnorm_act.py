"""K1: GroupNorm + activation, hand-written CUDA kernel (``csrc/groupnorm_act.cu``).

Replaces ``diffusion_model_project_tpu/ops/pallas/groupnorm_silu.py::
fused_groupnorm_act``. On a CUDA tensor the wrapper launches the kernel or
raises; on a CPU tensor it takes the plain version
(``ops/basic.group_norm`` + activation).
"""
from __future__ import annotations

import math

import torch

from ..basic import activation_function, group_norm
from . import _lib

_ACT_CODES = {"": 0, "silu": 1, "relu": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# elements of a group that one block reduces and normalizes (a multiple of 8)
CHUNK = 8192

# wrapper calls that launched the kernel (not counting CPU calls)
LAUNCHES = 0


def groupnorm_act_plain(x, weight, bias, num_groups: int, act: str = "", eps: float = 1e-5):
    """The plain PyTorch version: one-pass float32 statistics, then the activation."""
    return activation_function(act)(group_norm(x, weight, bias, num_groups, eps))


def groupnorm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  num_groups: int, act: str = "", eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm(num_groups) + ``act`` ('' | 'silu' | 'relu') on ``(N, C, *spatial)``."""
    if x.device.type == "cpu":
        return groupnorm_act_plain(x, weight, bias, num_groups, act, eps)
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm_act: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        raise RuntimeError("groupnorm_act has no backward; call it without grad")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"groupnorm_act: dtype {x.dtype} not supported")
    if act not in _ACT_CODES:
        raise NotImplementedError(f"groupnorm_act: activation {act!r}")
    if not x.is_contiguous():
        raise ValueError("groupnorm_act: x must be contiguous (channels-first)")
    if x.ndim < 3:
        raise ValueError(f"groupnorm_act: expected (N, C, *spatial), got {tuple(x.shape)}")
    n, c = x.shape[0], x.shape[1]
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError("groupnorm_act: weight and bias must be (C,)")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("groupnorm_act: weight and bias must be on x's device")
    spatial = math.prod(x.shape[2:])
    cpg = c // num_groups
    group_len = cpg * spatial
    groups_total = n * num_groups
    # counts are carried in float32 (exact below 2**24); grid.y is 16-bit
    if group_len >= 2 ** 24 or groups_total > 65535:
        raise ValueError(f"groupnorm_act: group of {group_len} elements x {groups_total} "
                         "groups is outside the kernel's range")
    gamma = weight.float().contiguous()
    beta = bias.float().contiguous()
    y = torch.empty_like(x)
    nchunks = -(-group_len // CHUNK)
    partials = torch.empty(groups_total * nchunks * 3, dtype=torch.float32, device=x.device)
    err = _lib.lib().dm_groupnorm_act(
        _DTYPE_CODES[x.dtype], x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        y.data_ptr(), partials.data_ptr(), groups_total, group_len, spatial,
        num_groups, cpg, CHUNK, float(eps), _ACT_CODES[act], _lib.stream_ptr(x))
    _lib.check(err, "groupnorm_act")
    LAUNCHES += 1
    return y
