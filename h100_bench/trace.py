"""The traced part of a ``--trace 1`` run: kernels from ``torch.profiler``, spans from hooks.

Rules frozen from the port's device-time scripts:
- every trace starts with ``SENTINELS`` ``torch.cuda._sleep`` kernels, since
  on the H100 the profiler has left the first kernels of a trace out; a
  trace that lost one of them is not complete;
- a kernel wrapper's kernels in a complete trace equal its launch counter's
  change times its kernels a launch.
Only CUDA activity is traced (CUPTI), so the host runs as it does untraced.
Host spans come from forward hooks the benchmark registers on the port's
modules, on the host's clock; one marker kernel launched on an idle device
right after the sentinels ties that clock to the trace's.

Kernel kinds (for ``breakdown``) follow the port's train-step classifier.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

SENTINEL = "spin_kernel"   # torch.cuda._sleep's kernel
SENTINELS = 16
KINDS = (("k1", ("gn_cluster", "gn_partial", "gn_apply")),
         ("k2", ("attention_core", "gemm_bias")),
         ("k4", ("int8_conv",)),
         ("conv_gemm", ("xmma", "gemm", "conv", "dgrad", "wgrad", "fprop", "cutlass")),
         ("layout", ("nchwToNhwc", "nhwcToNchw")),
         ("optimizer", ("multi_tensor_apply", "Adam")),
         ("reduction", ("reduce_kernel",)),
         ("elementwise", ("elementwise_kernel",)),
         ("copy", ("Memcpy", "Memset", "memcpy", "memset")))


def kind(name: str) -> str:
    for k, keys in KINDS:
        if any(s in name for s in keys):
            return k
    return "other"


def is_k1(name: str) -> bool:
    return "::gn_cluster" in name or "::gn_partial" in name or "::gn_apply" in name


def is_k2(name: str) -> bool:
    return "::gemm_bias" in name or "::attention_core" in name


class Spans:
    """Host spans (name, thread, start, end) on ``time.perf_counter``, from
    forward pre/post hooks on named modules, and the shapes of calls into
    K1/K2 modules that carry a shape hook."""

    def __init__(self):
        self.spans = []
        self.calls = []          # (kind, shape, dtype name, extra)
        self._open = threading.local()
        self._handles = []

    def hook(self, module, name: str) -> None:
        def pre(_m, _args):
            stack = getattr(self._open, "stack", None)
            if stack is None:
                stack = self._open.stack = []
            stack.append(time.perf_counter())

        def post(_m, _args, _out):
            t1 = time.perf_counter()
            t0 = self._open.stack.pop()
            self.spans.append((name, threading.get_ident(), t0, t1))

        self._handles += [module.register_forward_pre_hook(pre),
                          module.register_forward_hook(post)]

    def shape_hook(self, module, kind_: str, extra) -> None:
        """Record (kind, shape, dtype, extra(x)) of each call."""
        def pre(_m, args):
            x = args[0]
            self.calls.append((kind_, tuple(x.shape), str(x.dtype).replace("torch.", ""),
                               extra(x)))

        self._handles.append(module.register_forward_pre_hook(pre))

    def between(self, name: str, t0: float, t1: float) -> list:
        return [(a, b) for n, _, a, b in self.spans if n == name and a >= t0 and b <= t1]

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


class Trace:
    """One profiled stretch: kernels (name, start_s, end_s) on the host's
    clock, the stretch's bounds, and whether it is complete."""

    def __init__(self, kernels, t0, t1, sentinels_kept, delimiters=()):
        self.kernels = kernels
        self.t0, self.t1 = t0, t1
        self.sentinels_kept = sentinels_kept
        self.delimiters = list(delimiters)   # starts of the block's own _sleep kernels

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        """Seconds in which a kernel ran, the union of their intervals in the stretch."""
        busy, end = 0.0, self.t0
        for _, a, b in sorted(self.kernels, key=lambda k: k[1]):
            a, b = max(a, end, self.t0), min(b, self.t1)
            if b > a:
                busy += b - a
                end = b
        return busy

    def gaps(self) -> list:
        """Idle stretches (start, end) between the union of the kernels."""
        out, end = [], self.t0
        for _, a, b in sorted(self.kernels, key=lambda k: k[1]):
            if a > end:
                out.append((end, min(a, self.t1)))
            end = max(end, b)
        if self.t1 > end:
            out.append((end, self.t1))
        return [(a, b) for a, b in out if b > a]

    def by_kind(self) -> dict:
        out = {}
        for name, a, b in self.kernels:
            k = kind(name)
            out[k] = out.get(k, 0.0) + (b - a)
        return out

    def narrowed(self, t0: float, t1: float) -> "Trace":
        """The same trace within [t0, t1]."""
        kernels = [(n, max(a, t0), min(b, t1)) for n, a, b in self.kernels]
        return Trace([k for k in kernels if k[2] > k[1]], t0, t1, self.sentinels_kept)

    def seconds(self, keep) -> tuple:
        """(seconds, count) of the kernels whose name ``keep`` accepts."""
        sel = [b - a for name, a, b in self.kernels if keep(name)]
        return sum(sel), len(sel)


class _Block:
    """What a profiled block may do: mark a point with a tiny kernel of its own."""

    def __init__(self):
        self.delimiters = 0

    def delimit(self) -> None:
        """Queue a ``_sleep`` kernel: the trace gives its start as a delimiter."""
        torch.cuda._sleep(1)
        self.delimiters += 1


@contextlib.contextmanager
def profiled(out: list, idle_device: bool = True):
    """Profile CUDA activity of the block; append a :class:`Trace` to ``out``.
    ``idle_device``: the block starts and ends with the device drained; a
    served cell's stretch runs amid the server's work instead, with the
    sentinels and the marker on a stream of their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    side = None if idle_device else torch.cuda.Stream()
    wait = torch.cuda.synchronize if idle_device else side.synchronize
    block = _Block()
    wait()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
            for _ in range(SENTINELS):
                torch.cuda._sleep(1000)
            wait()
            t_mark = time.perf_counter()
            torch.cuda._sleep(1)              # the marker: ties the trace's clock to the host's
            wait()
        t0 = time.perf_counter()
        yield block
        if idle_device:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    spins = [e for e in evs if SENTINEL in e.name]
    if len(spins) <= block.delimiters:
        out.append(Trace([], t0, t1, 0))
        return
    marker = spins[len(spins) - block.delimiters - 1]
    offset = t_mark - marker.time_range.start / 1e6   # trace us -> host s
    kernels = [(e.name, max(t0, e.time_range.start / 1e6 + offset),
                min(t1, e.time_range.end / 1e6 + offset))
               for e in evs if SENTINEL not in e.name]
    delims = [e.time_range.start / 1e6 + offset for e in spins[len(spins) - block.delimiters:]]
    out.append(Trace([k for k in kernels if k[2] > k[1]], t0, t1,
                     len(spins) - block.delimiters - 1, delims))


def label_gaps(tr: Trace, spans: list, order: tuple) -> dict:
    """Idle seconds by what the host was doing: the first name of ``order``
    with a span over the gap's middle, else 'host outside the model'."""
    out = {}
    for a, b in tr.gaps():
        mid = 0.5 * (a + b)
        label = "host outside the model"
        for name in order:
            if any(n == name and s0 <= mid <= s1 for n, _, s0, s1 in spans):
                label = name
                break
        out[label] = out.get(label, 0.0) + (b - a)
    return out
