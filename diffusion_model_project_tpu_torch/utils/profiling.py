"""Profiling and debugging utilities (the port's copy of the JAX
``utils/profiling.py``, on ``torch.profiler`` and module hooks).

  - ``profile_trace(dir)``: a ``torch.profiler`` trace (host and, on the
    card, CUDA activity) written to ``dir`` by the TensorBoard trace handler
    (view with TensorBoard's profiler plugin or Perfetto);
  - ``annotate(name)``: a labelled region inside a trace
    (``torch.profiler.record_function``);
  - ``enable_nan_debugging()``: the counterpart of ``jax_debug_nans``. JAX
    raises at the first primitive that makes a NaN; here a global forward
    hook raises ``FloatingPointError`` at the first module whose output
    holds a NaN or Inf, naming the module, and in backward a hook on each
    module's output raises it where the gradient reaching that module is
    not finite, while ``torch.autograd.set_detect_anomaly(True)`` stops at
    the first backward function that returns a NaN (its ``RuntimeError``
    names the function and prints the forward traceback that made it);
  - ``span(name, ident)``: a host span of the sampler's and the serving
    daemon's stages, recorded while ``enable_spans(True)`` and drained by
    ``take_spans()`` (below).
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch

_NAN_HOOKS: list = []
SPAN_CAPACITY = 1 << 16   # spans the recorder keeps until they are taken


@contextlib.contextmanager
def profile_trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    return torch.profiler.record_function(name)


def _finite(t) -> bool:
    return not (isinstance(t, torch.Tensor) and t.is_floating_point()
                and not bool(torch.isfinite(t).all()))


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    if isinstance(out, dict):
        return [t for o in out.values() for t in _tensors(o)]
    return []


def _module_name(module) -> str:
    return f"{type(module).__module__}.{type(module).__qualname__}"


def _forward_hook(module, args, output):
    for t in _tensors(output):
        if not _finite(t):
            raise FloatingPointError(
                f"NaN or Inf in the forward output of module {_module_name(module)}")
        if t.requires_grad:
            def check(grad, module=module):
                if not _finite(grad):
                    raise FloatingPointError(
                        f"NaN or Inf in the gradient of the output of module "
                        f"{_module_name(module)}")
            t.register_hook(check)


def enable_nan_debugging(enabled: bool = True) -> None:
    """Raise at the first module whose forward output, or the gradient of
    it, holds a NaN or Inf, and at the first backward function that returns
    a NaN (anomaly mode). Every check reads a flag back from the device, so
    a step runs much slower: a debugging switch, off by default."""
    while _NAN_HOOKS:
        _NAN_HOOKS.pop().remove()
    if enabled:
        _NAN_HOOKS.append(torch.nn.modules.module.register_module_forward_hook(_forward_hook))
    torch.autograd.set_detect_anomaly(enabled)


class Span(NamedTuple):
    """One recorded span. ``t0`` / ``t1`` are ``time.perf_counter()`` seconds;
    ``parent_id`` is the span that was open on the same thread when it
    opened (None at the top); ``ident`` is the request's or the batch's id,
    or None."""
    name: str
    span_id: int
    parent_id: Optional[int]
    ident: object
    thread_id: int
    t0: float
    t1: float


class _NoSpan:
    """What ``span`` returns while recording is off: one shared object that
    does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Spans:
    """The recorder's state: a bounded buffer, the count of spans dropped
    since recording was switched on, and each thread's stack of open spans."""

    def __init__(self):
        self.buffer: list = []
        self.dropped = 0
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def add(self, s: tuple) -> None:
        with self.lock:
            if len(self.buffer) < SPAN_CAPACITY:
                self.buffer.append(s)
            else:
                self.dropped += 1


_NO_SPAN = _NoSpan()
_RECORDER: Optional[_Spans] = None   # None: recording is off


class _OpenSpan:
    __slots__ = ("rec", "stack", "name", "ident", "span_id", "parent_id", "t0")

    def __init__(self, rec: _Spans, name: str, ident):
        self.rec, self.name, self.ident = rec, name, ident

    def __enter__(self):
        st = self.stack = self.rec.stack()
        self.parent_id = st[-1] if st else None
        self.span_id = next(self.rec.ids)
        st.append(self.span_id)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.stack.pop()
        # a plain tuple here; take_spans() makes it a Span
        self.rec.add((self.name, self.span_id, self.parent_id, self.ident,
                      threading.get_ident(), self.t0, t1))
        return False


def span(name: str, ident=None):
    """A context manager that records a host span while recording is on.

    Off (the default) it reads one module global and returns a shared no-op:
    no clock read, no allocation, no lock. On, it reads ``time.perf_counter``
    twice and touches nothing on the device: no CUDA call, no event, no
    profiler range, so a trace of the device's activity holds only the
    program's own kernels, and the host clock is the one a trace can be tied
    to."""
    rec = _RECORDER
    if rec is None:
        return _NO_SPAN
    return _OpenSpan(rec, name, ident)


def record_span(name: str, ident, t0: float, t1: float,
                thread_id: Optional[int] = None) -> None:
    """Record a span, with no parent, whose ends were stamped elsewhere (one
    that starts on one thread and ends on another, as a request's wait in the
    queue)."""
    rec = _RECORDER
    if rec is not None:
        rec.add((name, next(rec.ids), None, ident,
                 threading.get_ident() if thread_id is None else thread_id, t0, t1))


def enable_spans(on: bool = True) -> None:
    """Switch recording on (with an empty buffer of ``SPAN_CAPACITY`` spans and
    the dropped count at 0) or off. Spans still open when it switches are not
    recorded by the new recorder."""
    global _RECORDER
    _RECORDER = _Spans() if on else None


def take_spans() -> list:
    """Drain the buffer: the spans recorded since the last take, in the order
    they closed ([] while off)."""
    rec = _RECORDER
    if rec is None:
        return []
    with rec.lock:
        out, rec.buffer = rec.buffer, []
    return [Span._make(s) for s in out]


def spans_dropped() -> int:
    """Spans dropped on a full buffer since recording was switched on."""
    rec = _RECORDER
    return 0 if rec is None else rec.dropped
