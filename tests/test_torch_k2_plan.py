"""K2's launch planner and the kernel build's hash, on the CPU.

The planner (``ops/cuda/attention.py::plan``) is plain Python: it picks each
of K2's three launches' tile, ring stages and shared memory, and these tests
hold it to the H100's limits at every attention shape the published UNet
meets, and at every shape the JAX package runs elsewhere (other feature
stacks and ``--attention`` levels at 256^2 and 128^2, the optimize space's
widest bottom, the VAE's AttentionBlock): any head dim and any T plan; only
E not divisible by the heads and N past the cores' grid raise. The build
hash must cover the ``.cuh`` headers the sources include.
"""
import math

import pytest
import torch

from diffusion_model_project_tpu_torch.models.unet import eval_expression
from diffusion_model_project_tpu_torch.ops.cuda import _lib
from diffusion_model_project_tpu_torch.ops.cuda import attention as k2
from diffusion_model_project_tpu_torch.utils.config import PUBLISHED_UNET_KWARGS

from test_torch_train_step import one_torch_thread  # noqa: F401

LATENT_HW = 64  # 256^2 slices, VAE latent at a quarter of the side


def _attention_shapes(n, feats, attention, latent_hw=LATENT_HW):
    """(N, T, E, heads) of each attention level of a UNet of ``feats``."""
    heads = eval_expression(attention, len(feats))
    return [(n, (latent_hw >> k) ** 2, f, h) for k, (f, h) in enumerate(zip(feats, heads))
            if h is not None and latent_hw >> k]


def _published_attention_shapes(n):
    """(N, T, E, heads) of each attention level of the published UNet."""
    return _attention_shapes(n, PUBLISHED_UNET_KWARGS["features"],
                             PUBLISHED_UNET_KWARGS["attention"])


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


# the AttentionBlock's D*H*W tokens at 11 x 32^2: no limit on T remains
LONGEST = 11 * 32 * 32


@pytest.mark.parametrize("hd", k2.HEAD_DIMS)
def test_plan_core_fits_every_head_dim_at_the_longest_sequence(hd):
    core = k2.plan(3, LONGEST, 2 * hd, 2).core
    assert core.simt == 0 and core.stages >= 2 and core.smem <= k2.SMEM_LIMIT
    assert core.grid == (math.ceil(LONGEST / 64), 2, 3)


# (N, T, E, heads) that the JAX package runs beyond the published UNet's
# shapes: the grid's stacks and --attention 3..4 / 1..2 at 256^2
# (latent 64^2) and 128^2 (latent 32^2), optimize's 7-level space, whose
# bottom is 2048 wide at T = 1, and the VAE AttentionBlock
def _wide_shapes():
    out = set()
    for hw in (64, 32):
        for feats, attention in (([32, 64, 128, 256], "3..2"),
                                 ([32, 64, 128, 256, 512], "3..2"),
                                 ([64, 128, 256, 512, 1024], "3..4"),
                                 ([64, 128, 256, 512, 1024], "1..2"),
                                 ([2048 >> k for k in reversed(range(7))], "3..2"),
                                 ([2048 >> k for k in reversed(range(7))], "3..1")):
            out.update(_attention_shapes(22, feats, attention, hw))
    out.update({(22, 4096, 64, 2), (22, 1, 2048, 1), (2, 64, 96, 2), (2, 11264, 512, 2),
                (88, 256, 256, 4), (2, LONGEST, 128, 2)})
    return sorted(out)


def test_wide_shapes_include_the_motivating_cases():
    shapes = set(_wide_shapes())
    for case in [(22, 256, 128, 2), (22, 64, 128, 2), (22, 256, 256, 4), (22, 4096, 64, 2),
                 (22, 1024, 128, 2), (22, 1, 2048, 2), (22, 1, 2048, 1)]:
        assert case in shapes


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,t,e,heads", _wide_shapes())
def test_plan_takes_every_shape_the_jax_package_runs(n, t, e, heads, dtype):
    p = k2.plan(n, t, e, heads, dtype)
    hd = e // heads
    bf16 = dtype == torch.bfloat16
    assert p.hd >= hd and p.ex >= e
    if bf16:  # TMA rows: multiples of 16 bytes
        assert p.ex % 8 == 0 and (heads * p.hd) % 8 == 0
    else:     # the SIMT kernels take the shape as it is
        assert (p.hd, p.ex) == (hd, e)
    core = p.core
    assert core.smem <= k2.SMEM_LIMIT
    if core.simt == 0:  # the bf16 wgmma core at one of its instances
        assert bf16 and p.hd in k2.HEAD_DIMS and p.hd == min(d for d in k2.HEAD_DIMS if d >= hd)
        assert core.stages >= 2 and core.smem == k2.core_smem(p.hd, core.stages)
        assert core.grid == (math.ceil(t / 64), heads, n)
    else:               # the SIMT core: float32, or bf16 past 512
        assert not bf16 or hd > k2.HEAD_DIMS[-1]
        assert core.simt in k2.SIMT_CHUNKS and core.smem == k2.simt_smem(core.simt)
        splits = math.ceil(p.hd / core.simt)
        assert core.simt >= p.hd or core.simt == k2.SIMT_CHUNKS[-1]
        assert core.grid == (math.ceil(t / k2.SIMT_BQ), heads * splits, n)
    for g, cols in ((p.qkv, 3 * heads * p.hd), (p.out, p.ex)):
        assert g.grid == (math.ceil(n * t / g.bm), math.ceil(cols / g.bn))


@pytest.mark.parametrize("n,t,e,heads", [
    (2, 16, 96, 2), (2, 1025, 256, 2)])  # head dim 48; past the old 1,024-token limit
def test_plan_takes_head_dim_48_and_1025_tokens(n, t, e, heads):
    for dtype in (torch.bfloat16, torch.float32):
        assert k2.plan(n, t, e, heads, dtype).core.smem <= k2.SMEM_LIMIT


def test_published_shapes_keep_their_plans():
    """The published UNet's shapes: no padding and the wgmma core in bf16,
    three launches a call as before."""
    for n, t, e, heads in _published_attention_shapes(22):
        p = k2.plan(n, t, e, heads)
        assert (p.hd, p.ex, p.core.simt) == (e // heads, e, 0)


@pytest.mark.parametrize("n,t,e,heads", [
    (2, 16, 100, 3),                 # E not divisible by the heads
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
