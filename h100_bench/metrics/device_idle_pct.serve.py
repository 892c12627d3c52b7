"""Share of the traced stretch's wall time with no kernel running on the device, %."""
from h100_bench.readers import idle_pct


def read(r):
    return idle_pct(r)
