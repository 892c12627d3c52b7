"""Graceful-preemption handling for the training loops (the port's own copy
of the JAX package's ``utils/preempt.py``).

Preemptible/spot VMs get a SIGTERM with a short grace window (~30 s)
before the machine disappears. Python's default disposition kills the
process on the spot: the async checkpoint writer's queued writes are lost
(up to a full epoch of state) and the run ends without a resume hint. The
reference torch code (train.py, train_3d_vae_only.py, train_2d_with_cross.py)
has no preemption story at all — a kill mid-epoch loses whatever the OS
buffers dropped.

`GracefulShutdown` converts the FIRST SIGTERM/SIGINT into a cooperative stop
request. The trainers poll it between batches (via ``run_epoch``'s
``should_stop`` -> `PreemptStop`) and between epochs, so they stop within
one step time, drain the checkpoint writer (every completed epoch's
model/train_state lands on disk), print the `--resume` hint, and return
normally. A SECOND signal restores the default disposition and re-raises it
— the escape hatch when a clean stop hangs.

In-flight partial epochs are intentionally discarded: resume granularity is
the epoch boundary (train_state.msgpack), matching what `--resume` replays.
"""
from __future__ import annotations

import signal
import threading


class PreemptStop(Exception):
    """Raised by run_epoch's should_stop hook to unwind out of a partial
    epoch; caught at the trainer's epoch loop, never propagates to users."""


# active contexts, outermost first. A signal is delivered to the innermost
# installed handler, which marks EVERY active context so enclosing loops
# (optimize() trials, CV folds) also stop instead of starting the next unit.
_ACTIVE: list = []


class GracefulShutdown:
    """Context manager: trap SIGTERM/SIGINT into a `requested` flag.

    Only installs handlers in the main thread (signal.signal raises
    elsewhere); in worker threads it degrades to an always-False flag so
    library code stays usable under test runners and grid searches.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._previous: dict = {}
        self._event = threading.Event()

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def __call__(self) -> bool:
        """Alias so the instance itself is a ``should_stop`` callable."""
        return self.requested

    def _handle(self, signum, frame):
        if self._event.is_set():
            # second signal: restore default behavior and deliver it
            self._restore()
            signal.raise_signal(signum)
            return
        for ctx in _ACTIVE:
            ctx._event.set()
        self._event.set()
        name = signal.Signals(signum).name
        print(f"\n{name} received — finishing the current step, saving state, "
              f"then exiting cleanly. Send {name} again to force-kill.",
              flush=True)

    def _restore(self):
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._previous.clear()

    def __enter__(self) -> "GracefulShutdown":
        if threading.current_thread() is threading.main_thread():
            for sig in self._signals:
                self._previous[sig] = signal.signal(sig, self._handle)
            _ACTIVE.append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        self._restore()
        if self in _ACTIVE:
            _ACTIVE.remove(self)
        return False
