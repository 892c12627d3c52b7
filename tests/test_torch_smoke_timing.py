"""``chip_smoke.py``'s device time per call, on the CPU with stand-in traces.

On an H100, once a process has profiled a UNet forward, torch.profiler
leaves the first kernels of each later trace out of it. The script starts
every trace with sentinel kernels of its own, takes only traces that hold
every kernel of the calls (:func:`complete`), and divides their sum by the
number of calls: no launch is ever filled in.
"""
import importlib.util
import pathlib

import pytest

from test_torch_train_step import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
SPIN = "at::cuda::spin_kernel(long)"  # the sentinel, as the trace names it


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def no_card(smoke, monkeypatch):
    """The stand-in traces need no card: nothing to wait for."""
    monkeypatch.setattr(smoke.torch.cuda, "synchronize", lambda: None)


@pytest.mark.parametrize("kernels,launched,per_launch,whole", [
    ([("conv", 1.0)] * 5, 5, 1, True),                      # one kernel a call
    ([("conv", 1.0)] * 4, 5, 1, False),                     # one of five launches left out
    ([("conv", 1.0)] * 5, 4, 1, False),                     # the wrapper counted another number
    ([("a", 0.25), ("b", 0.5)] * 5, 5, 2, True),            # two kernels a launch
    ([("a", 0.25), ("b", 0.5)] * 4 + [("b", 0.5)], 5, 2, False),
    ([("a", 0.25)] * 10 + [("b", 0.5)] * 5, None, 1, True),  # "a" twice a call, no counter
    ([], None, 1, False),                                   # an empty trace
])
def test_complete_holds_every_launch(smoke, kernels, launched, per_launch, whole):
    assert smoke.complete(kernels, 5, None, launched, per_launch) is whole


def test_complete_counts_only_the_wrappers_kernels_against_its_launches(smoke):
    # a library kernel beside the wrapper's own (three a launch) in every call
    kernels = [("memset", 0.01), ("gemm_bias", 0.1), ("core", 0.2), ("gemm_bias", 0.1)] * 5
    own = lambda name: name != "memset"  # noqa: E731
    assert smoke.complete(kernels, 5, own, 5, 3)
    assert not smoke.complete(kernels, 5, None, 5, 3)


@pytest.mark.parametrize("sentinel_kept", [True, False])
def test_device_ms_drops_the_sentinel_and_retakes_an_incomplete_trace(
        smoke, monkeypatch, no_card, sentinel_kept):
    head = [(SPIN, 0.002)] * smoke.SENTINELS if sentinel_kept else []
    traces = iter([
        (head + [("conv", 1.0)] * 4, 5),   # a launch left out: taken again
        (head + [("conv", 1.1)] * 5, 5),
    ])
    monkeypatch.setattr(smoke, "_trace", lambda fn, iters, counter: next(traces))
    monkeypatch.setitem(smoke.PROFILER, "traces", 0)
    monkeypatch.setitem(smoke.PROFILER, "first_left_out", 0)
    got = smoke.device_ms(lambda: None, iters=5, warmup=0, counter=lambda: 0)
    assert got == pytest.approx(1.1)
    assert smoke.PROFILER == {"traces": 2, "first_left_out": 0 if sentinel_kept else 2}


@pytest.mark.parametrize("tries", [5, 3])
def test_device_kernels_raises_after_its_tries(smoke, monkeypatch, no_card, tries):
    monkeypatch.setattr(smoke, "_trace", lambda fn, iters, counter: ([("conv", 1.0)] * 4, 5))
    monkeypatch.setitem(smoke.PROFILER, "traces", 0)
    kw = {} if tries == 5 else {"tries": tries}  # 5 by default
    with pytest.raises(RuntimeError, match="4 CUDA kernels in 5 calls"):
        smoke.device_kernels(lambda: None, 5, counter=lambda: 0, warmup=0, **kw)
    assert smoke.PROFILER["traces"] == tries


def test_library_device_ms_is_none_without_a_complete_trace(smoke, monkeypatch, no_card):
    monkeypatch.setattr(smoke, "_trace", lambda fn, iters, counter: ([("xmma", 1.0)] * 7, None))
    assert smoke.library_device_ms(lambda: None, iters=5, warmup=0) is None
    monkeypatch.setattr(smoke, "_trace", lambda fn, iters, counter: ([("xmma", 1.0)] * 5, None))
    assert smoke.library_device_ms(lambda: None, iters=5, warmup=0) == pytest.approx(1.0)
