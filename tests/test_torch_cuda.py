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
from diffusion_model_project_tpu_torch.ops.cuda import groupnorm_act as k1


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1.3e-2)])
@pytest.mark.parametrize("n,t,e", [(22, 256, 256), (22, 64, 512), (22, 16, 1024), (3, 37, 64)])
def test_fused_attention_kernel(gen, dtype, tol, n, t, e):
    heads = 2
    x = torch.randn((n, t, e), generator=gen, device="cuda").to(dtype)
    w_qkv = (torch.randn((3 * e, e), generator=gen, device="cuda") / math.sqrt(e)).to(dtype)
    b_qkv = (0.02 * torch.randn(3 * e, generator=gen, device="cuda")).to(dtype)
    w_out = torch.randn((e, e), generator=gen, device="cuda").to(dtype) / math.sqrt(e)
    b_out = (0.02 * torch.randn(e, generator=gen, device="cuda")).to(dtype)
    # a transposed view (as the module passes) and a row-major weight
    args = (x, w_qkv.t(), b_qkv, w_out.t().contiguous(), b_out)
    before = k2.LAUNCHES
    got = k2.fused_attention(*args, heads)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + 1
    ref = multihead_attention(*[a.float() for a in args], heads)
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel_err(got, ref) <= tol


@pytest.mark.cuda
def test_kernels_refuse_grad_and_bad_input(gen):
    x = torch.randn((2, 64, 8, 8), generator=gen, device="cuda", requires_grad=True)
    w = torch.ones(64, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        k1.groupnorm_act(x, w, w, 32, "silu")
    with pytest.raises(ValueError, match="contiguous"):
        k1.groupnorm_act(x.detach().transpose(2, 3), w, w, 32, "silu")
    xa = torch.randn((2, 8, 96), device="cuda")  # head dim 48 is not supported
    wq, wo = torch.zeros((96, 288), device="cuda"), torch.zeros((96, 96), device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        k2.fused_attention(xa, wq, torch.zeros(288, device="cuda"), wo,
                           torch.zeros(96, device="cuda"), 2)
