"""The control of each cell comes out not correct.

The control is the port's own int8 path (both flags) in the sampler and
serve cells, and the plain reference under bfloat16 autocast in the
training cell: the nearest precision below each configuration's. On the
CPU at a tiny size the control reads far above the program; on the card
(``cuda`` marker) it fails the cell's limit at the cell's own size, on a
seed of its own.
"""
import pytest
import torch

from h100_bench import calibrate, core, run
from h100_bench.tests import tiny

BENCH = run.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")
    return torch.device("cuda")


def _sides(rows, key):
    prog = max(r[key] for r in rows if r["side"] == "program")
    ctl = min(r[key] for r in rows if r["side"] == "control")
    return prog, ctl


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_far_above_the_program_on_the_cpu(cell):
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ctx = tiny.ctx(cell)
        rows = calibrate.readings(ctx.cfg, ctx.wl, [tiny.SEED], [tiny.SEED], seconds=1.5,
                                  device="cpu")
    finally:
        torch.set_num_threads(prev)
    keys = [k for k in ctx.limits if k in rows[0]]
    assert keys and any(_sides(rows, k)[1] > 100 * _sides(rows, k)[0] for k in keys), rows


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit_on_the_card(cell, card):
    entry = run.cell_entry(BENCH, cell)
    cfg = core.load_json("configs", entry["config"] + ".json")
    wl = core.load_json("workloads", entry["traffic"] + ".json")
    limits = core.load_json("limits", cell + ".json")
    rows = calibrate.readings(cfg, wl, [], [20260], seconds=8.0, device=card)
    ctl = [r for r in rows if r["side"] == "control"][0]
    assert any(ctl[k] > lim for k, lim in limits.items() if k in ctl), (ctl, limits)
