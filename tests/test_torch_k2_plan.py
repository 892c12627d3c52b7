"""K2's launch planner and the kernel build's hash, on the CPU.

The planner (``ops/cuda/attention.py::plan``) is plain Python: it picks each
of K2's three launches' tile, ring stages and shared memory, and these tests
hold it to the H100's limits at every attention shape the published UNet
meets. The build hash must cover the ``.cuh`` headers the sources include.
"""
import math

import pytest

from diffusion_model_project_tpu_torch.models.unet import eval_expression
from diffusion_model_project_tpu_torch.ops.cuda import _lib
from diffusion_model_project_tpu_torch.ops.cuda import attention as k2
from diffusion_model_project_tpu_torch.utils.config import PUBLISHED_UNET_KWARGS

from test_torch_train_step import one_torch_thread  # noqa: F401

LATENT_HW = 64  # 256^2 slices, VAE latent at a quarter of the side


def _published_attention_shapes(n):
    """(N, T, E, heads) of each attention level of the published UNet."""
    feats = PUBLISHED_UNET_KWARGS["features"]
    heads = eval_expression(PUBLISHED_UNET_KWARGS["attention"], len(feats))
    return [(n, (LATENT_HW >> k) ** 2, f, h) for k, (f, h) in enumerate(zip(feats, heads))
            if h is not None]


def test_published_shapes_are_the_three_main_path_shapes():
    assert _published_attention_shapes(22) == [
        (22, 256, 256, 2), (22, 64, 512, 2), (22, 16, 1024, 2)]


@pytest.mark.parametrize("batch", [2, 8])  # N = 22 and 88 slices
def test_plan_covers_each_gemm_and_fits_the_card(batch):
    for n, t, e, heads in _published_attention_shapes(batch * 11):
        plans = k2.plan(n, t, e, heads)
        for p, cols in ((plans.qkv, 3 * e), (plans.out, e)):
            assert (p.bm, p.bn) in k2.GEMM_TILES
            rows_tiles, col_tiles = p.grid
            assert rows_tiles * p.bm >= n * t > (rows_tiles - 1) * p.bm
            assert col_tiles * p.bn >= cols > (col_tiles - 1) * p.bn
            assert p.stages >= 3
            assert p.smem == k2.gemm_smem(p.bm, p.bn, p.stages) <= k2.SMEM_LIMIT
        if batch == 2:  # every SM gets a block of the QKV GEMM at the main path's N
            assert math.prod(plans.qkv.grid) >= k2.SMS
        core = plans.core
        assert core.grid == (math.ceil(t / 64), heads, n)
        assert core.stages >= 2
        assert core.smem == k2.core_smem(e // heads, core.stages) <= k2.SMEM_LIMIT


@pytest.mark.parametrize("hd", k2.HEAD_DIMS)
def test_plan_core_fits_every_head_dim_at_the_longest_sequence(hd):
    core = k2.plan(3, k2.MAX_TOKENS, 2 * hd, 2).core
    assert core.stages >= 2 and core.smem <= k2.SMEM_LIMIT


@pytest.mark.parametrize("n,t,e,heads", [
    (2, 16, 96, 2),                  # head dim 48
    (2, 16, 100, 3),                 # E not divisible by the heads
    (2, k2.MAX_TOKENS + 1, 256, 2),  # too many tokens
    (k2.MAX_BATCH + 1, 16, 256, 2),  # past the core's grid
    (0, 16, 256, 2),
])
def test_plan_raises_outside_the_range(n, t, e, heads):
    with pytest.raises(ValueError):
        k2.plan(n, t, e, heads)


def test_digest_covers_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_lib, "SRC_DIR", tmp_path)
    assert [p.name for p in _lib.sources()] == ["k.cu"]
    before = _lib._digest()
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _lib._digest() != before
