"""Attention at every shape the JAX package runs, on the CPU, against JAX:

- the port's plain attention (K2's reference) against JAX's
  ``multihead_attention`` at head dims 8, 48, 64 and 1,024 and at 4,096
  tokens, rtol 1e-4;
- the zero-padded weights K2's wrapper hands its kernels
  (``ops/cuda/attention.py::pad_heads``), run through the kernels' own
  arithmetic in float64 (scores over the padded heads, divided by the sqrt
  of the TRUE head dim), give the unpadded attention within 1e-12;
- the VAE's ``AttentionBlock`` with a JAX ``AttentionBlock``'s params,
  loaded ``strict=True`` through ``utils/weights.py``, against JAX (rtol
  1e-4), and the weights' round trip.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_project_tpu.models.vae import AttentionBlock as JAttentionBlock
from diffusion_model_project_tpu.ops.attention import multihead_attention as jax_mha

from diffusion_model_project_tpu_torch.models.vae import AttentionBlock
from diffusion_model_project_tpu_torch.ops.attention import multihead_attention
from diffusion_model_project_tpu_torch.ops.cuda import attention as k2
from diffusion_model_project_tpu_torch.utils import weights

from test_torch_train_step import one_torch_thread  # noqa: F401


def _inputs(n, t, e, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, t, e)).astype(np.float32)
    w_qkv = (r.standard_normal((e, 3 * e)) / math.sqrt(e)).astype(np.float32)
    b_qkv = (0.02 * r.standard_normal(3 * e)).astype(np.float32)
    w_out = (r.standard_normal((e, e)) / math.sqrt(e)).astype(np.float32)
    b_out = (0.02 * r.standard_normal(e)).astype(np.float32)
    return x, w_qkv, b_qkv, w_out, b_out


@pytest.mark.parametrize("n,t,e,heads", [
    (2, 10, 16, 2),     # head dim 8
    (2, 12, 96, 2),     # head dim 48
    (2, 9, 128, 2),     # head dim 64
    (1, 3, 2048, 2),    # head dim 1,024
    (1, 4096, 16, 2),   # 4,096 tokens (--attention 1..2 at 256^2)
])
def test_plain_attention_matches_jax_at_every_shape(n, t, e, heads):
    arrs = _inputs(n, t, e, seed=t + e)
    got = multihead_attention(*map(torch.from_numpy, arrs), heads).numpy()
    ref = np.asarray(jax.jit(jax_mha, static_argnums=5)(*map(jnp.asarray, arrs), heads))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def _kernel_arithmetic(x, w_qkv, b_qkv, w_out, b_out, heads, hd, sqrt_hd):
    """What K2's three kernels compute from the buffers they are given:
    qkv = x w_qkv + b, per head softmax(q k^T / sqrt_hd) v over ``hd``-column
    heads, then the output GEMM."""
    n, t, _ = x.shape
    qkv = x @ w_qkv + b_qkv
    q, k, v = (z.reshape(n, t, heads, hd).transpose(1, 2)
               for z in qkv.split(heads * hd, dim=-1))
    p = torch.softmax(q @ k.transpose(-1, -2) / sqrt_hd, dim=-1)
    return (p @ v).transpose(1, 2).reshape(n, t, heads * hd) @ w_out + b_out


@pytest.mark.parametrize("n,t,e,heads", [
    (2, 7, 96, 2),      # hd 48 -> the 64 instance
    (2, 5, 6, 2),       # hd 3 -> 32; E off a multiple of 8 -> x padded to 8
    (1, 4, 1, 1),       # hd 1
    (1, 3, 1200, 2),    # hd 600 -> the SIMT core, already a multiple of 8
    (1, 2, 1026, 2),    # hd 513 -> 520
    (2, 6, 256, 2),     # hd 128: nothing to pad
])
def test_padded_weights_give_the_unpadded_attention(n, t, e, heads):
    x, w_qkv, b_qkv, w_out, b_out = (torch.from_numpy(a).double()
                                     for a in _inputs(n, t, e, seed=e))
    p = k2.plan(n, t, e, heads, torch.bfloat16)
    hd = e // heads
    assert p.hd >= hd and p.ex >= e and p.ex % 8 == 0 and (heads * p.hd) % 8 == 0
    assert (p.hd in k2.HEAD_DIMS) == (p.core.simt == 0)
    if p.hd == hd and p.ex == e:
        padded = (x, w_qkv, b_qkv, w_out, b_out)
    else:
        padded = k2.pad_heads(x, w_qkv.t().contiguous().t(), b_qkv, w_out, b_out, heads,
                              p.hd, p.ex)
        assert padded[0].shape == (n, t, p.ex)
        assert padded[1].shape == (p.ex, 3 * heads * p.hd)
        assert padded[3].shape == (heads * p.hd, p.ex)
    got = _kernel_arithmetic(*padded, heads, p.hd, math.sqrt(hd))[..., :e]
    ref = _kernel_arithmetic(x, w_qkv, b_qkv, w_out, b_out, heads, hd, math.sqrt(hd))
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def block_pair():
    """Params of a JAX AttentionBlock on (2, 2, 4, 4, 64), drawn from a seed
    in its tree layout (no flax init), and the port's block holding them."""
    c = 64
    r = np.random.default_rng(6)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    params = {"norm": {"weight": f32(1 + 0.1 * r.standard_normal(c)),
                       "bias": f32(0.1 * r.standard_normal(c))},
              "attention": {"in_proj_weight": f32(r.standard_normal((c, 3 * c)) / 8),
                            "in_proj_bias": f32(0.02 * r.standard_normal(3 * c)),
                            "out_proj_weight": f32(r.standard_normal((c, c)) / 8),
                            "out_proj_bias": f32(0.02 * r.standard_normal(c))}}
    block = AttentionBlock(c, num_heads=2)
    block.load_state_dict(weights.to_tensors(weights.export_attention_block(params)),
                          strict=True)
    x = f32(r.standard_normal((2, 2, 4, 4, c)))
    return JAttentionBlock(num_heads=2), params, block, x


def test_attention_block_matches_jax(block_pair):
    jblock, params, block, x = block_pair
    ref = np.asarray(jax.jit(jblock.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = block(torch.from_numpy(np.moveaxis(x, -1, 1).copy())).numpy()
    got = np.moveaxis(got, 1, -1)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_attention_block_weights_round_trip(block_pair):
    _, params, block, _ = block_pair
    back = jax.tree_util.tree_map(lambda v: np.asarray(v),
                                  weights.attention_block_to_flax(block.state_dict()))
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        got = back
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got, leaf)
