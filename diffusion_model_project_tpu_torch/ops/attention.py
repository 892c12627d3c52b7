"""Multi-head self-attention, plain PyTorch version (the reference for K2).

Counterpart of the JAX ``ops/attention.py::multihead_attention``, with the
JAX weight layouts ``w_qkv (E, 3E)`` and ``w_out (E, E)``. Products run in
the input dtype, scores and softmax in float32, and the probabilities are
cast to ``v.dtype`` before the product with V. The hand-written kernel is
``ops/cuda/attention.py::fused_attention``.
"""
from __future__ import annotations

import math

import torch


def multihead_attention(
    x: torch.Tensor,
    w_qkv: torch.Tensor,
    b_qkv: torch.Tensor,
    w_out: torch.Tensor,
    b_out: torch.Tensor,
    num_heads: int,
) -> torch.Tensor:
    """Self-attention on ``(N, T, E)`` tokens."""
    n, t, e = x.shape
    if e % num_heads != 0:
        raise ValueError(f"embed dim {e} not divisible by {num_heads} heads")
    hd = e // num_heads
    qkv = torch.matmul(x, w_qkv) + b_qkv  # (N, T, 3E)
    q, k, v = qkv.split(e, dim=-1)

    def heads(z):
        return z.reshape(n, t, num_heads, hd).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    scores = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(hd)
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(n, t, e)
    return torch.matmul(out, w_out) + b_out
