"""K1 (GroupNorm + activation) against its roofline in the traced calls, %."""
from h100_bench.readers import roofline_pct


def read(r):
    return roofline_pct(r, "k1")
