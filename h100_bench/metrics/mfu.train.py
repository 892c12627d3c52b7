"""Train steps' model FLOPs (3 x forward) in the window over the window, % of TF32's 495 TFLOP/s."""
from h100_bench.readers import mfu_pct


def read(r):
    return mfu_pct(r)
