"""K1's launch planner, on the CPU.

The planner (``ops/cuda/groupnorm_act.py::plan``) is plain Python: it picks
the path (``cluster``: one launch, each group held in a thread-block
cluster's shared memory; ``split``: statistics, then apply), the cluster
size, each block's slice, the shared memory and the grid. These tests hold
it to the H100's limits at the 19 (shape, act) pairs of a published
``predict_ddim(50)`` request, at batch 2 and 8, for cards that schedule
clusters of 16 and of 8; and emulate, at small shapes, how the kernel
reduces a group over the plan's slices.
"""
import math

import numpy as np
import pytest
import torch

from diffusion_model_project_tpu_torch.ops.cuda import _sm90
from diffusion_model_project_tpu_torch.ops.cuda import groupnorm_act as k1
from diffusion_model_project_tpu_torch.scripts import k1_device_time as pairs_mod

from test_torch_train_step import one_torch_thread  # noqa: F401

CASES = [(shape, groups, mc) for batch in (2, 8) for shape, groups, _, _ in pairs_mod.pairs(batch)
         for mc in (16, 8)]
ids = [f"{'x'.join(map(str, s))}-G{g}-mc{mc}" for s, g, mc in CASES]


def _plan(shape, groups, mc, elem_bytes=2, aligned=True):
    return k1.plan(shape[0], shape[1], math.prod(shape[2:]), groups, elem_bytes, aligned, mc)


def _spans(p):
    """The element ranges [lo, hi) of one group that the plan's blocks hold."""
    blocks = p.k if p.path == "cluster" else p.grid[0]
    return [(min(p.group_len, b * p.slice), min(p.group_len, (b + 1) * p.slice))
            for b in range(blocks)]


def test_the_published_request_has_19_pairs_and_1926_calls():
    assert len(pairs_mod.pairs(2)) == 19
    assert sum(c for *_, c in pairs_mod.pairs(2)) == 1926


@pytest.mark.parametrize("shape,groups,mc", CASES, ids=ids)
def test_plan_covers_every_element_once(shape, groups, mc):
    p = _plan(shape, groups, mc)
    spans = _spans(p)
    # consecutive, disjoint, from 0 to L, no block empty
    assert spans[0][0] == 0 and spans[-1][1] == p.group_len
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(hi > lo for lo, hi in spans)
    assert p.group_len == shape[1] // groups * math.prod(shape[2:])
    groups_total = shape[0] * groups
    if p.path == "cluster":
        assert p.grid == (groups_total * p.k, 1)
    else:
        assert p.grid == (len(spans), groups_total)


@pytest.mark.parametrize("shape,groups,mc", CASES, ids=ids)
def test_plan_fits_the_card(shape, groups, mc):
    p = _plan(shape, groups, mc)
    # every slice starts on a 16-byte boundary: bulk copies and 16-byte vectors
    assert p.aligned and p.slice * 2 % 16 == 0 and p.group_len * 2 % 16 == 0
    # k a power of two, at most what the card schedules, dividing the grid
    assert p.k & (p.k - 1) == 0 and 1 <= p.k <= mc and p.grid[0] % p.k == 0
    # shared memory as the C layout lays it out, within a block's cap
    spatial = math.prod(shape[2:])
    channels = k1.table_channels(p.slice, spatial) if p.path == "cluster" else 0
    assert p.smem == k1.gn_smem(p.slice, 2, channels) <= _sm90.SMEM_LIMIT == 232448
    assert p.smem == (768 + -(-p.slice * 2 // 16) * 16 + -(-8 * channels // 16) * 16)
    # the slice's channels fit the (gamma, beta) table
    if p.path == "cluster":
        assert max(-(-hi // spatial) - lo // spatial for lo, hi in _spans(p)) <= channels
    assert p.kernels == (1 if p.path == "cluster" else 2)


@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("mc", [16, 8])
def test_plan_paths_are_the_design_notes(batch, mc):
    plans = {(s, a): _plan(s, g, mc) for s, g, a, _ in pairs_mod.pairs(batch)}
    unet = [p for (s, _), p in plans.items() if len(s) == 4]
    assert len(unet) == 14 and all((p.path, p.kernels) == ("cluster", 1) for p in unet)
    # the VAE's 5.5 MB groups are past a cluster of 16 x 227 KB
    assert plans[((batch, 128, 11, 256, 256), "silu")].path == "split"
    # 2.75 MB groups need 16 blocks: split on a card that schedules 8
    big = plans[((batch, 256, 11, 128, 128), "silu")]
    assert (big.path, big.k) == (("cluster", 16) if mc == 16 else ("split", 1))
    for shape in [(batch, 128, 11, 128, 128), (batch, 256, 11, 64, 64), (batch, 512, 11, 64, 64)]:
        assert plans[(shape, "silu")].path == "cluster"


def test_plan_at_the_published_batch_matches_the_design_note():
    # the design note (PERF.md): k = 4 at every UNet pair but the 8 KB groups; the VAE's
    # 0.69 and 1.38 MB groups in 88 KB slices
    got = {s: (p.path, p.k, p.slice * 2)
           for s, g, _, _ in pairs_mod.pairs(2) for p in [_plan(s, g, 16)]}
    assert got[(22, 64, 64, 64)] == ("cluster", 4, 128 * 1024)
    assert got[(22, 1024, 2, 2)] == ("cluster", 2, 4096)
    assert {v[1] for s, v in got.items() if len(s) == 4 and s != (22, 1024, 2, 2)} == {4}
    assert got[(2, 512, 11, 64, 64)] == ("cluster", 16, 88 * 1024)
    assert got[(2, 256, 11, 64, 64)] == ("cluster", 8, 88 * 1024)
    assert got[(2, 256, 11, 128, 128)] == ("cluster", 16, 176 * 1024)


@pytest.mark.parametrize("elem_bytes", [2, 4])
def test_plan_unaligned_groups_take_the_scalar_variant(elem_bytes):
    # (3, 96, 5, 7) at G = 32: L = 105, not a whole number of 16-byte rows
    p = k1.plan(3, 96, 35, 32, elem_bytes, True)
    assert not p.aligned and p.path == "cluster"
    assert p.smem == k1.gn_smem(p.slice, elem_bytes, k1.table_channels(p.slice, 35))
    # an x that starts off a 16-byte boundary does too, whatever L
    assert not k1.plan(4, 64, 256, 1, elem_bytes, False).aligned


@pytest.mark.parametrize("args", [
    (0, 8, 16, 1, 2, True, 16),              # an empty batch
    (2, 8, 0, 1, 2, True, 16),               # no spatial elements
    (2, 12, 16, 8, 2, True, 16),             # C not divisible by G
    (2, 8, 16, 1, 8, True, 16),              # 8-byte elements
    (2, 8, 16, 1, 2, True, 12),              # max_cluster not a power of two
    (2, 8, 16, 1, 2, True, 32),              # max_cluster past 16
    (1, 2 ** 24, 1, 1, 2, True, 16),         # L = 2^24: counts are float32
    (65536, 32, 4, 32, 2, True, 16),         # more than 65535 groups
])
def test_plan_raises_outside_the_range(args):
    with pytest.raises(ValueError):
        k1.plan(*args)


# ----------------------------------------------------------- emulation

def _merge(a, b):
    """Chan's merge of (count, mean, M2), as the kernel's ``merge``, in float32."""
    n = a[0] + b[0]
    if n == 0:
        return a
    d = b[1] - a[1]
    fb = np.float32(b[0] / n)
    return (n, np.float32(a[1] + d * fb), np.float32(a[2] + b[2] + d * d * a[0] * fb))


def _butterfly(lanes, op):
    """An xor-shuffle reduction over len(lanes) lanes with ``op``: lane 0's result."""
    lanes = list(lanes)
    off = 1
    while off < len(lanes):
        lanes = [op(lanes[i], lanes[i ^ off]) for i in range(len(lanes))]
        off *= 2
    return lanes[0]


THREADS = 512  # the kernel's threads a block (csrc kThreads)


def _block_stats(xs, vec):
    """One block's (count, mean, M2) as the kernel reduces its slice: thread t
    sums vectors t, t + THREADS, ... of x - shift and (x - shift)^2, the shift
    the slice's first element; the warps, then the block add the sums by
    butterflies, in float32."""
    shift = xs[0]
    vecs = xs.reshape(-1, vec) - shift
    sums = [vecs[t::THREADS].sum(dtype=np.float32) for t in range(THREADS)]
    sq = [(vecs[t::THREADS] ** 2).sum(dtype=np.float32) for t in range(THREADS)]
    add = lambda a, b: (np.float32(a[0] + b[0]), np.float32(a[1] + b[1]))  # noqa: E731
    warps = [_butterfly(list(zip(sums, sq))[w:w + 32], add) for w in range(0, THREADS, 32)]
    s1, s2 = _butterfly(warps + [(np.float32(0), np.float32(0))] * (32 - len(warps)), add)
    m = np.float32(s1 / np.float32(xs.size))
    return np.float32(xs.size), np.float32(shift + m), np.float32(max(s2 - s1 * m, 0))


@pytest.mark.parametrize("shape,groups,elem_bytes", [
    ((2, 64, 32, 32), 1, 2),      # 64 KB groups over a cluster
    ((3, 96, 5, 7), 32, 4),       # unaligned: one element a step
    ((2, 32, 3, 24, 24), 8, 4),   # 3-D, float32
])
def test_emulated_reduction_matches_group_norm_statistics(shape, groups, elem_bytes):
    rng = np.random.default_rng(0)
    x = (0.5 + rng.standard_normal(shape)).astype(np.float32)
    spatial = math.prod(shape[2:])
    p = k1.plan(shape[0], shape[1], spatial, groups, elem_bytes,
                shape[1] // groups * spatial * elem_bytes % 16 == 0, 16)
    assert p.path == "cluster"
    vec = 16 // elem_bytes if p.aligned else 1
    xg = x.reshape(shape[0] * groups, -1)
    ref = torch.from_numpy(x).double().reshape(shape[0] * groups, -1)
    for g in range(xg.shape[0]):
        n, mean, m2 = _butterfly([_block_stats(xg[g, lo:hi], vec) for lo, hi in _spans(p)],
                                 _merge)
        assert n == p.group_len
        rm, rv = ref[g].mean().item(), ref[g].var(unbiased=False).item()
        assert abs(mean - rm) <= 1e-6 * abs(rm) and abs(m2 / n - rv) <= 1e-6 * rv


# ------------------------------------------------------- channels-last

def _plan_cl(shape, groups, mc, elem_bytes=2, aligned=True):
    return k1.plan(shape[0], shape[1], math.prod(shape[2:]), groups, elem_bytes, aligned, mc,
                   channels_last=True)


def _ranges(p, spatial):
    """The row ranges [lo, hi) of one sample that path rows' blocks take."""
    return [(min(spatial, b * p.slice), min(spatial, (b + 1) * p.slice)) for b in range(p.grid[0])]


@pytest.mark.parametrize("shape,groups,mc", CASES, ids=ids)
def test_channels_last_plan_paths(shape, groups, mc):
    p, cf = _plan_cl(shape, groups, mc), _plan(shape, groups, mc)
    assert p.channels_last and not cf.channels_last
    if groups == 1:
        # a sample is one contiguous group: the UNet pairs keep their cluster and k
        assert (p.path, p.k, p.kernels) == ("cluster", cf.k, 1) == (cf.path, cf.k, cf.kernels)
    else:
        # the VAE's GN(32): groups strided by C take the two-launch path
        assert (p.path, p.k, p.kernels) == ("rows", 1, 2)


@pytest.mark.parametrize("shape,groups,mc", CASES, ids=ids)
def test_channels_last_plan_covers_every_element_once_and_fits_the_card(shape, groups, mc):
    p = _plan_cl(shape, groups, mc)
    n, c, spatial = shape[0], shape[1], math.prod(shape[2:])
    assert p.aligned and p.group_len == c // groups * spatial
    if p.path == "cluster":
        spans = _spans(p)
        assert spans[0][0] == 0 and spans[-1][1] == p.group_len == c * spatial
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert all(hi > lo for lo, hi in spans)
        assert p.grid == (n * p.k, 1) and p.slice * 2 % 16 == 0
        # every block keeps all C (gamma, beta) pairs
        assert p.smem == k1.gn_smem(p.slice, 2, c) <= _sm90.SMEM_LIMIT
        return
    # each range of rows holds every channel of its rows: ranges cover [0, spatial) once
    ranges = _ranges(p, spatial)
    assert ranges[0][0] == 0 and ranges[-1][1] == spatial
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(hi > lo for lo, hi in ranges)
    assert p.grid[1] == n and p.grid[0] * groups <= k1.MAX_PARTIALS
    # a thread a 16-byte vector of channels, every vector of a row held
    vec = 8
    assert c % vec == 0 and c // vec <= k1.THREADS
    lanes = k1.THREADS // (c // vec)
    assert p.smem == k1.rows_smem(c, vec) == (-(-8 * lanes * c // 16) * 16
                                              + -(-8 * c // 16) * 16) <= _sm90.SMEM_LIMIT
    # about two waves of two blocks an SM
    assert p.grid[0] * n <= k1.ROWS_BLOCKS + n


def test_channels_last_plan_at_the_published_batch():
    got = [(s, _plan_cl(s, g, 16)) for s, g, _, _ in pairs_mod.pairs(2)]
    assert {(p.path, p.kernels) for s, p in got if len(s) == 5} == {("rows", 2)}
    assert sum(p.kernels for _, p in got) == 14 + 2 * 5
    # a G = 1 sample past a cluster takes path rows too
    big = k1.plan(2, 64, 256 * 256, 1, 4, True, 16, channels_last=True)
    assert (big.path, big.kernels, big.grid) == ("rows", 2, (264, 2))


def test_channels_last_unaligned_rows_take_the_scalar_variant():
    # rows of 24 bf16 channels are 48 bytes: 16-byte vectors; 20 channels are not
    assert k1.plan(2, 24, 35, 8, 2, True, 16, channels_last=True).aligned
    p = k1.plan(2, 20, 35, 4, 2, True, 16, channels_last=True)
    assert not p.aligned and p.smem == k1.rows_smem(20, 1)
    # an x that starts off a 16-byte boundary does too
    assert not k1.plan(2, 64, 35, 32, 2, False, 16, channels_last=True).aligned
    # a thread a channel: at most THREADS channels a row
    with pytest.raises(ValueError, match="outside"):
        k1.plan(2, 1024, 35, 32, 2, False, 16, channels_last=True)


@pytest.mark.parametrize("make", [
    lambda x: x.transpose(2, 3),                  # neither layout
    lambda x: x[:, :, ::2],                       # strided
    lambda x: x.permute(0, 2, 1, 3),              # channels in the middle
])
def test_channels_last_other_strides_are_refused(make):
    x = torch.randn(2, 8, 6, 4)
    with pytest.raises(ValueError, match="contiguous"):
        k1.is_channels_last(make(x))
    assert not k1.is_channels_last(x)
    assert k1.is_channels_last(x.contiguous(memory_format=torch.channels_last))
    x5 = torch.randn(2, 8, 3, 6, 4)
    assert k1.is_channels_last(x5.contiguous(memory_format=torch.channels_last_3d))
    # contiguous in both layouts (C = 1): channels-first
    assert not k1.is_channels_last(torch.randn(2, 1, 6, 4))


def _rows_stats(xs, p, groups, vec):
    """Path rows' reduction of one sample xs (spatial, C), in float32: each
    range's partial (count, mean, M2) of each group, from per-channel sums of
    x - shift down the row lanes (the shift the group's first element of the
    range), then over the lanes, then over the group's channels; Chan's merge
    over the ranges in their order."""
    spatial, c = xs.shape
    cpg, lanes = c // groups, k1.THREADS // (c // vec)
    out = [(np.float32(0), np.float32(0), np.float32(0))] * groups
    for lo, hi in _ranges(p, spatial):
        rows = xs[lo:hi]
        shift = np.repeat(rows[0, ::cpg], cpg)
        t = rows - shift
        pad = -len(t) % lanes
        t = np.concatenate([t, np.zeros((pad, c), np.float32)]).reshape(-1, lanes, c)
        s1 = t.sum(axis=0, dtype=np.float32).sum(axis=0, dtype=np.float32)
        s2 = (t * t).sum(axis=0, dtype=np.float32).sum(axis=0, dtype=np.float32)
        a = s1.reshape(groups, cpg).sum(axis=1, dtype=np.float32)
        b = s2.reshape(groups, cpg).sum(axis=1, dtype=np.float32)
        n = np.float32((hi - lo) * cpg)
        m = a / n
        part = [(n, np.float32(shift[g * cpg] + m[g]), np.float32(max(b[g] - a[g] * m[g], 0)))
                for g in range(groups)]
        out = [_merge(o, q) for o, q in zip(out, part)]
    return out


@pytest.mark.parametrize("shape,groups,elem_bytes,aligned", [
    ((4, 256, 64, 64), 32, 4, True),      # four rows a lane, float32 vectors of 4
    ((2, 64, 3, 8, 8), 32, 2, True),      # 3-D, bf16 vectors of 8
    ((3, 96, 5, 7), 32, 4, False),        # one element a thread
])
def test_emulated_channels_last_reduction_matches_group_norm_statistics(shape, groups,
                                                                         elem_bytes, aligned):
    rng = np.random.default_rng(1)
    x = (0.5 + rng.standard_normal(shape)).astype(np.float32)
    n, c, spatial = shape[0], shape[1], math.prod(shape[2:])
    p = k1.plan(n, c, spatial, groups, elem_bytes, aligned, 16, channels_last=True)
    assert p.path == "rows" and p.aligned == aligned
    vec = 16 // elem_bytes if aligned else 1
    xcl = np.moveaxis(x.reshape(n, c, spatial), 1, 2)  # (n, spatial, C)
    ref = torch.from_numpy(x).double().reshape(n, groups, -1)
    for s in range(n):
        for g, (cnt, mean, m2) in enumerate(_rows_stats(xcl[s], p, groups, vec)):
            assert cnt == p.group_len
            rm, rv = ref[s, g].mean().item(), ref[s, g].var(unbiased=False).item()
            assert abs(mean - rm) <= 1e-6 * abs(rm) and abs(m2 / cnt - rv) <= 1e-6 * rv
