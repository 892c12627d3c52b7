"""K1: GroupNorm + activation, hand-written CUDA kernel (``csrc/groupnorm_act.cu``).

Replaces ``diffusion_model_project_tpu/ops/pallas/groupnorm_silu.py::
fused_groupnorm_act``. On a CUDA tensor the wrapper launches the kernel or
raises; on a CPU tensor it takes the plain version
(``ops/basic.group_norm`` + activation). x is contiguous channels-first or
channels-last (``torch.channels_last`` / ``channels_last_3d``, the
sampler's layout on the card), and y takes x's layout.

:func:`plan` picks the launch: path ``cluster`` (one launch; each group
held in the shared memory of a thread-block cluster, x read once),
``split`` (statistics, then apply, for groups past a cluster's capacity)
or, on channels-last x, ``cluster`` at G = 1 (a sample is one contiguous
group) and ``rows`` otherwise (statistics of every group over ranges of
rows, then apply over the same ranges). It is plain Python, so the CPU
tests hold it to the card's limits. The wrapper validates and plans once
per (shape, dtype, device, groups, act, alignment, layout, weight and bias
shapes and devices) and keeps the launch's integers in a cached array.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from ..basic import activation_function, group_norm, memory_format
from . import _lib
from ._sm90 import SMEM_LIMIT, SMS, cdiv

_ACT_CODES = {"": 0, "silu": 1, "relu": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEADER = 768                 # bytes of a block's shared memory before its slice (csrc kHeader)
# the cluster size k: a slice past MAX_SLICE_BYTES halves (two blocks an SM
# overlap one's load with the other's stores); k also doubles while 2 x groups
# x k <= SMS, the doubled slice holding MIN_SLICE_BYTES (more SMs pull a small
# group). Both from a sweep of k on the H100 at the published pairs (PERF.md).
MAX_SLICE_BYTES = 128 * 1024
MIN_SLICE_BYTES = 4 * 1024
SPLIT_CHUNK_BYTES = 64 * 1024  # bytes of a group each block of the split path takes
THREADS = 512                # a block's threads (csrc kThreads)
# path rows: about ROWS_BLOCKS blocks a call (two waves at two blocks an SM),
# at most MAX_PARTIALS (count, mean, M2) a sample for each block to merge
ROWS_BLOCKS = 4 * SMS
MAX_PARTIALS = 8192
MAX_CLUSTER = 16             # the largest cluster the kernel is launched with (non-portable)
MAX_GROUP_LEN = 2 ** 24      # counts are carried in float32, exact below this
MAX_GROUPS = 65535           # the split path's grid.y

# wrapper calls that launched the kernel (not counting CPU calls), through the
# registered op too; LAUNCHES_CHANNELS_LAST those of them on channels-last x
LAUNCHES = 0
LAUNCHES_CHANNELS_LAST = 0


@dataclass(frozen=True)
class GNPlan:
    path: str        # "cluster" (one launch), "split" or "rows" (statistics, then apply)
    k: int           # blocks a cluster (1 on split and rows)
    slice: int       # elements of a group each block holds (the last block the rest);
                     # rows: rows of (C,) elements each block takes
    smem: int        # dynamic shared memory a block, bytes (split: the statistics kernel's)
    grid: tuple      # (x, y) blocks: cluster (groups x k, 1); split (chunks a group,
                     # groups); rows (ranges a sample, samples)
    kernels: int     # kernels a call launches
    group_len: int   # elements a group: (C / G) x prod(spatial)
    aligned: bool    # 16-byte rows: bulk copies and 16-byte vectors, else the scalar variant
    channels_last: bool = False  # x is (N, *spatial, C) in memory


def gn_smem(slice_: int, elem_bytes: int, channels: int) -> int:
    """A block's dynamic shared memory: the header (the pieces' mbarriers,
    the block's (count, mean, M2), reduction scratch), its slice and
    ``channels`` (gamma, beta) float pairs, each rounded up to 16 bytes
    (``csrc`` ``gn_smem``)."""
    return HEADER + cdiv(slice_ * elem_bytes, 16) * 16 + cdiv(8 * channels, 16) * 16


def table_channels(slice_: int, spatial: int) -> int:
    """The (gamma, beta) pairs a cluster block keeps: its slice's channels at most."""
    return slice_ // spatial + 2


def rows_smem(channels: int, vec: int) -> int:
    """Path rows' dynamic shared memory a block (``csrc`` ``rows_smem``): the
    statistics kernel's (s1, s2) float pairs of each (row lane, channel) and
    of each channel; the apply kernel's G (mean, rstd) pairs fit in it."""
    lanes = THREADS // (channels // vec)
    return cdiv(8 * lanes * channels, 16) * 16 + cdiv(8 * channels, 16) * 16


@functools.lru_cache(maxsize=256)
def plan(n: int, c: int, spatial: int, groups: int, elem_bytes: int, aligned: bool,
         max_cluster: int = MAX_CLUSTER, channels_last: bool = False) -> GNPlan:
    """Launch plan of K1 on x (n, c, *spatial) with ``spatial`` = prod(spatial),
    ``groups`` groups, ``elem_bytes`` bytes an element. ``aligned``: x starts
    on a 16-byte boundary (channels-first: every group does if also L x
    elem_bytes % 16 == 0). ``max_cluster``: the largest cluster the card
    schedules at full shared memory (:func:`max_cluster`). ``channels_last``:
    x is stored (n, *spatial, c), element i of a sample in channel i % c.
    Raises outside the kernel's range.

    The rule for the cluster size k, a power of two, on L = (C/G) x spatial
    elements a group:
      1. k starts at the smallest power of two whose slice, cdiv(L, k)
         rounded up to 16 bytes, fits a block with the header and its
         channels' (gamma, beta) (:func:`gn_smem` <= SMEM_LIMIT);
      2. if that k exceeds ``max_cluster``, the group takes the split path;
      3. else k doubles, up to ``max_cluster``, while the slice holds more
         than MAX_SLICE_BYTES, or while 2 x groups x k <= SMS and the doubled
         slice still holds MIN_SLICE_BYTES.
    At the published pairs this gives k = 4 at every UNet pair but the 8 KB
    groups (k = 2) and 88 KB slices at the VAE's 0.69 and 1.38 MB groups.
    The split path takes SPLIT_CHUNK_BYTES of a group a block, in two launches.
    Channels-last x at G = 1 (a sample is one contiguous group) takes the
    same rule with all c (gamma, beta) pairs in each block; past a cluster, and
    at G > 1 (groups strided by c), it takes path rows (:func:`_plan_rows`).
    """
    if min(n, c, spatial, groups) < 1:
        raise ValueError(f"groupnorm_act: empty shape {(n, c, spatial)} or groups {groups}")
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    if elem_bytes not in (2, 4):
        raise ValueError(f"groupnorm_act: {elem_bytes}-byte elements not supported")
    if max_cluster < 1 or max_cluster > MAX_CLUSTER or max_cluster & (max_cluster - 1):
        raise ValueError(f"groupnorm_act: max_cluster {max_cluster} is not a power of two "
                         f"<= {MAX_CLUSTER}")
    group_len = c // groups * spatial
    groups_total = n * groups
    if group_len >= MAX_GROUP_LEN or groups_total > MAX_GROUPS:
        raise ValueError(f"groupnorm_act: group of {group_len} elements x {groups_total} "
                         "groups is outside the kernel's range")
    if channels_last and groups > 1:
        return _plan_rows(n, c, spatial, groups, elem_bytes, aligned)
    x_aligned = aligned
    aligned = bool(aligned) and group_len * elem_bytes % 16 == 0
    align = 16 // elem_bytes if aligned else 1

    def slice_of(k: int) -> int:
        return cdiv(cdiv(group_len, k), align) * align

    def smem_of(k: int) -> int:
        channels = c if channels_last else table_channels(slice_of(k), spatial)
        return gn_smem(slice_of(k), elem_bytes, channels)

    k = 1
    while k <= max_cluster and smem_of(k) > SMEM_LIMIT:
        k *= 2
    if k > max_cluster:
        if channels_last:
            return _plan_rows(n, c, spatial, groups, elem_bytes, x_aligned)
        chunk = SPLIT_CHUNK_BYTES // elem_bytes
        return GNPlan("split", 1, chunk, gn_smem(chunk, elem_bytes, 0),
                      (cdiv(group_len, chunk), groups_total), 2, group_len, aligned)
    while 2 * k <= max_cluster and (
            slice_of(k) * elem_bytes > MAX_SLICE_BYTES
            or (2 * groups_total * k <= SMS
                and slice_of(2 * k) * elem_bytes >= MIN_SLICE_BYTES)):
        k *= 2
    return GNPlan("cluster", k, slice_of(k), smem_of(k), (groups_total * k, 1), 1,
                  group_len, aligned, channels_last)


def _plan_rows(n: int, c: int, spatial: int, groups: int, elem_bytes: int,
               aligned: bool) -> GNPlan:
    """Path ``rows`` on channels-last x: each of a sample's ranges of rows (a
    row is c elements) is one block of both launches; a thread keeps one
    vector of channels (16 bytes where rows start on 16-byte boundaries, else
    one element), so c / vec <= THREADS. About ROWS_BLOCKS blocks a call, at
    most MAX_PARTIALS // groups ranges a sample."""
    aligned = bool(aligned) and c * elem_bytes % 16 == 0
    vec = 16 // elem_bytes if aligned else 1
    if c // vec > THREADS:
        raise ValueError(f"groupnorm_act: channels-last rows of {c} channels are outside "
                         "the kernel's range")
    ranges = max(1, min(cdiv(ROWS_BLOCKS, n), MAX_PARTIALS // groups, spatial))
    rows = cdiv(spatial, ranges)
    return GNPlan("rows", 1, rows, rows_smem(c, vec), (cdiv(spatial, rows), n), 2,
                  c // groups * spatial, aligned, True)


@functools.lru_cache(maxsize=None)
def max_cluster(index: int) -> int:
    """The largest cluster (16 or less) that CUDA device ``index`` schedules at
    full shared memory, asked of the card once (``cudaOccupancyMaxActiveClusters``)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        _lib.check(_lib.lib().dm_groupnorm_max_cluster(ctypes.byref(out)),
                   "groupnorm_act max_cluster")
    if out.value < 1:
        raise RuntimeError(f"groupnorm_act: device {index} schedules no cluster")
    return out.value


# cfg[] of dm_groupnorm_act, in this order (csrc enum Cfg)
_CFG = ("dtype", "vec", "act", "split", "k", "slice", "smem", "grid_x", "grid_y",
        "group_len", "spatial", "groups", "cpg", "layout")


def is_channels_last(x: torch.Tensor) -> bool:
    """Whether x is stored channels-last (N, *spatial, C); False for
    contiguous channels-first x (and for x that is both, as at C = 1).
    Raises on any other strides."""
    if memory_format(x) != torch.contiguous_format:
        return True
    if x.is_contiguous():
        return False
    raise ValueError("groupnorm_act: x must be contiguous channels-first or channels-last")


@functools.lru_cache(maxsize=256)
def _launch(shape, dtype, device: int, num_groups: int, act: str, aligned: bool,
            weight_shape, weight_device: int, bias_shape, bias_device: int,
            channels_last: bool = False):
    """Validate a CUDA call by its key (``get_device()`` indices) and plan its
    launch, once a key: (plan, the launch's integers). Raises what the kernel
    refuses."""
    if device < 0:
        raise ValueError("groupnorm_act: x must be on a CUDA device")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"groupnorm_act: dtype {dtype} not supported")
    if act not in _ACT_CODES:
        raise NotImplementedError(f"groupnorm_act: activation {act!r}")
    if len(shape) < 3:
        raise ValueError(f"groupnorm_act: expected (N, C, *spatial), got {tuple(shape)}")
    n, c = shape[0], shape[1]
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    if weight_shape != (c,) or bias_shape != (c,):
        raise ValueError("groupnorm_act: weight and bias must be (C,)")
    if weight_device != device or bias_device != device:
        raise ValueError("groupnorm_act: weight and bias must be on x's device")
    spatial = math.prod(shape[2:])
    p = plan(n, c, spatial, num_groups, 4 if dtype == torch.float32 else 2, aligned,
             max_cluster(device), channels_last)
    vals = dict(dtype=_DTYPE_CODES[dtype], vec=int(p.aligned), act=_ACT_CODES[act],
                split=int(p.kernels == 2), k=p.k, slice=p.slice, smem=p.smem,
                grid_x=p.grid[0], grid_y=p.grid[1], group_len=p.group_len, spatial=spatial,
                groups=num_groups, cpg=c // num_groups, layout=int(channels_last))
    return p, (ctypes.c_int * len(_CFG))(*(vals[f] for f in _CFG))


def launch_plan(x: torch.Tensor, num_groups: int, act: str = "") -> GNPlan:
    """The plan a call of :func:`groupnorm_act` on CUDA tensor ``x`` launches
    (its layout read from x's strides)."""
    c, dev = (x.shape[1],), x.get_device()
    return _launch(x.shape, x.dtype, dev, num_groups, act, x.data_ptr() % 16 == 0,
                   c, dev, c, dev, is_channels_last(x))[0]


def groupnorm_act_plain(x, weight, bias, num_groups: int, act: str = "", eps: float = 1e-5):
    """The plain PyTorch version: one-pass float32 statistics, then the activation."""
    return activation_function(act)(group_norm(x, weight, bias, num_groups, eps))


def groupnorm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  num_groups: int, act: str = "", eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm(num_groups) + ``act`` ('' | 'silu' | 'relu') on ``(N, C, *spatial)``,
    stored contiguous channels-first or channels-last; y is stored as x is.

    Under ``torch.export`` the call is traced as the
    registered op ``torch.ops.dm_port.groupnorm_act``, whose body is this
    function; eager calls skip the op's dispatcher."""
    if torch.compiler.is_compiling():
        return torch.ops.dm_port.groupnorm_act(x, weight, bias, num_groups, act, eps)
    if x.device.type == "cpu":
        return groupnorm_act_plain(x, weight, bias, num_groups, act, eps)
    global LAUNCHES, LAUNCHES_CHANNELS_LAST
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        raise RuntimeError("groupnorm_act has no backward; call it without grad")
    channels_last = is_channels_last(x)
    p, cfg = _launch(x.shape, x.dtype, x.get_device(), num_groups, act, x.data_ptr() % 16 == 0,
                     weight.shape, weight.get_device(), bias.shape, bias.get_device(),
                     channels_last)
    gamma = weight if weight.dtype == torch.float32 and weight.is_contiguous() \
        else weight.float().contiguous()
    beta = bias if bias.dtype == torch.float32 and bias.is_contiguous() \
        else bias.float().contiguous()
    y = torch.empty_like(x)  # x's layout
    partials = None  # (count, mean, M2) of each chunk (split) or range and group (rows)
    if p.kernels == 2:
        per_block = num_groups if p.path == "rows" else 1
        partials = torch.empty(p.grid[0] * p.grid[1] * per_block * 3, dtype=torch.float32,
                               device=x.device)
    err = _lib.lib().dm_groupnorm_act(
        cfg, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        0 if partials is None else partials.data_ptr(), eps, _lib.stream_ptr(x))
    _lib.check(err, "groupnorm_act")
    LAUNCHES += 1
    LAUNCHES_CHANNELS_LAST += channels_last
    return y


@torch.library.custom_op("dm_port::groupnorm_act", mutates_args=())
def groupnorm_act_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     num_groups: int, act: str, eps: float) -> torch.Tensor:
    """K1 as a registered op, so that ``torch.export`` records the call
    instead of tracing the ``ctypes`` launch: its body is
    :func:`groupnorm_act` (the kernel on CUDA, the plain version on CPU)."""
    return groupnorm_act(x, weight, bias, num_groups, act, eps)


@groupnorm_act_op.register_fake
def _groupnorm_act_fake(x, weight, bias, num_groups, act, eps):
    return torch.empty_like(x)
