"""Sampler calls' model FLOPs in the window over the window, % of bf16's 989 TFLOP/s."""
from h100_bench.readers import mfu_pct


def read(r):
    return mfu_pct(r)
