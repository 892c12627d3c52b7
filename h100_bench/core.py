"""What every entry shares: the run's context, the timed window of back-to-back
calls, and the readings the per-layer metric readers take."""
from __future__ import annotations

import gc
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import traffic

HERE = Path(__file__).resolve().parent


def load_json(*parts) -> dict:
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


@dataclass
class Ctx:
    cell: str
    cfg: dict
    wl: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float                      # host clock at the run's start (set-up from here)
    limits: dict = field(default_factory=dict)
    setup_s: float = 0.0
    readings: dict = field(default_factory=dict)   # what the per-layer readers read
    breakdown: dict = field(default_factory=dict)
    device_info: dict = field(default_factory=dict)

    def mark_setup(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.setup_s = time.perf_counter() - self.t_start


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from the seed."""

    def __init__(self, k: int, seed: int, key: int):
        self.k, self.items, self.n = k, [], 0
        self.rng = np.random.default_rng(traffic.seed_int(seed, traffic.PICK, key))

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.n + 1))
            if j < self.k:
                self.items[j] = item
        self.n += 1


def timed_calls(call, seconds: float, units: int, keep=None, in_flight: int = 2) -> dict:
    """Calls ``call(k)`` back to back, at most ``in_flight`` queued on the
    device and no wait between them, until the first call that completes at
    or after ``seconds``; that completion closes the window. A completion
    thread sleeps on each call's CUDA event (a blocking event: no core spins
    beside the dispatching thread) and reads the host clock when it wakes.
    Returns {'calls', 'units', 'window_s', 'rate', 'dispatched'}: calls
    completed in the window, units (``units`` a call) over the window.
    ``keep(k, out)`` sees every completed call's output."""
    slots = threading.Semaphore(in_flight)
    pending: "queue.Queue" = queue.Queue()
    closed = threading.Event()
    done = []
    errors = []
    t0 = time.perf_counter()
    deadline = t0 + seconds

    def completion():
        while True:
            item = pending.get()
            if item is None:
                return
            k, ev, out = item
            try:
                if ev is not None:
                    ev.synchronize()
            except Exception as exc:  # a kernel's failure surfaces at the wait
                errors.append(exc)
                closed.set()
                slots.release()
                continue
            t = time.perf_counter()
            if not closed.is_set():
                done.append((k, t))
                if keep is not None:
                    keep(k, out)
                if t >= deadline:
                    closed.set()
            slots.release()

    th = threading.Thread(target=completion, name="bench-completion", daemon=True)
    th.start()
    k = 0
    try:
        while not closed.is_set():
            slots.acquire()
            if closed.is_set():
                break
            out = call(k)
            ev = None
            if torch.cuda.is_available() and isinstance(out, torch.Tensor) and out.is_cuda:
                ev = torch.cuda.Event(blocking=True)
                ev.record()
            pending.put((k, ev, out))
            k += 1
    finally:
        pending.put(None)
        th.join()
    if errors:
        raise errors[0]
    t_close = done[-1][1]
    return {"calls": len(done), "units": units * len(done), "window_s": t_close - t0,
            "rate": units * len(done) / (t_close - t0), "dispatched": k, "t0": t0,
            "t_close": t_close}


def free(device: torch.device) -> None:
    """Collect what was let go, and hand the device's cached blocks back."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def check_keys(wl: dict, keys: frozenset) -> None:
    """A traffic file may hold only the keys its entry reads: a parameter
    that nothing reads would be set and silently not run."""
    unknown = sorted(set(wl) - keys)
    if unknown:
        raise ValueError(f"traffic keys that entry {wl.get('entry')!r} does not read: {unknown}")


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref||, in float64."""
    got, ref = got.double(), ref.double().to(got.device)
    return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))


def percentile(values: list, q: float) -> float:
    """Nearest rank: the smallest value with at least q of the values at or below it."""
    v = sorted(values)
    return v[max(0, int(np.ceil(q * len(v))) - 1)]
