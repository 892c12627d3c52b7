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
  - ``StepTimer``: EMA per-step wall-clock timing for training loops.
"""
from __future__ import annotations

import contextlib
import time

import torch

_NAN_HOOKS: list = []


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


class StepTimer:
    """Exponential-moving-average step timer with steps/sec reporting."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema = None
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.ema = dt if self.ema is None else (1 - self.alpha) * self.ema + self.alpha * dt
        return dt

    @property
    def steps_per_sec(self) -> float:
        return 1.0 / self.ema if self.ema else 0.0
