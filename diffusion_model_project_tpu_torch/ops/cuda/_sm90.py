"""The sm_90 limits that K2's and K3's launch planners share."""
from __future__ import annotations

import functools

import torch

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90
SMS = 132            # streaming multiprocessors of an H100 SXM
ALIGN_SLACK = 1024   # the kernels align their tiles to 1024 bytes in shared memory


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count
