"""K3's launch planner, on the CPU.

The planner (``ops/cuda/conv3x3.py::plan``) is plain Python: it picks the
bf16 kernel's tile, ring stages, shared memory and persistent grid. These
tests hold it to the H100's limits and to the design's L2 traffic at the
conv probe's three stages, for the probe's 4 volumes (N = 44 images) and
the TPU bench's batch of 8 (N = 88).
"""
import pytest

from diffusion_model_project_tpu_torch.ops.cuda import _sm90
from diffusion_model_project_tpu_torch.ops.cuda import conv3x3 as k3
from diffusion_model_project_tpu_torch.scripts import perf_probe_conv as probe

from test_torch_train_step import one_torch_thread  # noqa: F401

SHAPES = [(n, *shape[1:]) for shape in probe.STAGES.values() for n in (44, 88)]


def _covered(p, n, h, w, cout):
    """Every (image, output pixel, Cout block) the plan's tiles reach, tile by tile."""
    th, tw = p.tile
    tiles_h, tiles_w, ncb = -(-h // th), -(-w // tw), -(-cout // p.bn)
    seen = set()
    for t in range(p.tiles):  # the kernel's order: Cout blocks fastest, then (n, row, column)
        cb, pix = t % ncb, t // ncb
        key = (pix // (tiles_w * tiles_h), pix // tiles_w % tiles_h * th, pix % tiles_w * tw,
               cb * p.bn)
        assert key not in seen
        seen.add(key)
    return seen, tiles_h, tiles_w, ncb


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_every_output_once(shape):
    n, h, w, cin, cout = shape
    p = k3.plan(*shape)
    seen, tiles_h, tiles_w, ncb = _covered(p, n, h, w, cout)
    th, tw = p.tile
    assert p.tiles == n * tiles_h * tiles_w * ncb == len(seen)
    # the tiles reach every pixel and channel, and none starts past the edge
    assert tiles_h * th >= h > (tiles_h - 1) * th
    assert tiles_w * tw >= w > (tiles_w - 1) * tw
    assert ncb * p.bn >= cout > (ncb - 1) * p.bn
    # a persistent block per SM walks tiles blockIdx, blockIdx + grid, ...
    assert p.grid == min(p.tiles, k3.SMS)
    walked = sorted(t for b in range(p.grid) for t in range(b, p.tiles, p.grid))
    assert walked == list(range(p.tiles))


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_fits_the_card_and_the_design(shape):
    p = k3.plan(*shape)
    th, tw = p.tile
    assert p.tile in k3.TILES
    assert p.smem == k3.conv_smem(th, tw, p.stages_a, p.stages_b) <= _sm90.SMEM_LIMIT
    assert p.stages_a >= 3 and p.stages_b >= 3
    # row shifts move whole 1024-byte swizzle atoms; TMA boxes are at most 256 a side
    assert tw % 8 == 0
    assert max(64, tw, th + 2, th // 2) <= k3.MAX_BOX
    # each of the two consumer warpgroups owns whole m64 blocks of pixels
    assert (th * tw) % 128 == 0
    # the halo reuse's operations per L2 byte at this tile (design note)
    assert k3.ops_per_l2_byte(th, tw, p.bn) >= 128


def test_ops_per_l2_byte_matches_the_design_note():
    # 9 / (9 / BM + 3 (TH+2) / (TH BN)): 146 at 16x16, 150 at 32x8, 90 at 8x16
    assert k3.ops_per_l2_byte(16, 16) == pytest.approx(146.29, abs=0.01)
    assert k3.ops_per_l2_byte(32, 8) == pytest.approx(149.85, abs=0.01)
    assert k3.ops_per_l2_byte(8, 16) == pytest.approx(90.35, abs=0.01)
    # the same from bytes and operations of one 64-channel chunk of a tile
    th, tw, bn = 16, 16, 128
    ops = 2 * 9 * 64 * th * tw * bn
    moved = 3 * k3.halo_bytes(th, tw) + 9 * 64 * bn * 2
    assert k3.ops_per_l2_byte(th, tw, bn) == pytest.approx(ops / moved)


@pytest.mark.parametrize("sms", [132, 114, 7])
def test_plan_grid_follows_the_sm_count(sms):
    # one persistent block per SM of the card in use, never more than the tiles
    p = k3.plan(44, 256, 256, 128, 128, None, sms)
    assert p.grid == sms and p.tiles > sms
    assert k3.plan(1, 8, 16, 64, 64, None, sms).grid == 1


@pytest.mark.parametrize("tile", k3.TILES)
def test_every_compiled_tile_fits(tile):
    p = k3.plan(44, 256, 256, 128, 128, tile)
    assert p.tile == tile and p.stages_b >= 3 and p.smem <= _sm90.SMEM_LIMIT


@pytest.mark.parametrize("shape,tile", [
    ((1, 7, 9, 5, 11), None),        # Cin and Cout off 8
    ((1, 7, 9, 16, 12), None),       # Cout off 8
    ((1, 7, 9, 12, 16), None),       # Cin off 8
    ((0, 7, 9, 16, 16), None),       # zero sizes
    ((1, 0, 9, 16, 16), None),
    ((1, 7, 9, 16, 0), None),
    ((2 ** 20, 256, 256, 64, 1024), None),  # more tiles than the kernel's 32-bit index
    ((1, 7, 9, 16, 16), (8, 8)),     # not a compiled tile
])
def test_plan_raises_outside_the_range(shape, tile):
    with pytest.raises(ValueError):
        k3.plan(*shape, tile)
