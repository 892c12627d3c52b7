"""Asynchronous, atomic checkpoint writing (the port's counterpart of the JAX
package's ``utils/async_ckpt.py``).

The reference saves with a blocking ``torch.save`` every epoch. This writer
moves the device-to-host copy, the serialization and the disk write onto one
background thread, so the training loop goes on to the next epoch while the
previous epoch's weights stream out.

torch's optimizer updates parameters, Adam moments and the EMA IN PLACE (the
counterpart of the JAX step's buffer donation). A tree queued on the writer
must therefore be a snapshot taken before ``submit`` returns:
``device_snapshot`` clones every tensor on its device, on the current
stream, ahead of the next step's in-place update; the writer thread copies
the clones to the host.

Writes are atomic (pid-suffixed temp file + ``os.replace``): a run killed
mid-write never leaves a truncated checkpoint behind. Writes land in FIFO
order; ``join()`` drains the queue and re-raises the first writer error
(also re-raised by the next ``submit``, and by ``close()``).
"""
from __future__ import annotations

import atexit
import os
import queue
import threading
from typing import Any, Callable, Optional

import torch

from .flax_msgpack import msgpack_serialize


def atomic_write(path: str, data: bytes) -> None:
    """Write ``data`` to a pid-suffixed temp file and ``os.replace`` it onto
    ``path``: a kill mid-write leaves the previous complete file, and two
    processes writing one run dir never truncate each other's temp file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def device_snapshot(tree: Any) -> Any:
    """A copy of ``tree`` whose tensor leaves are clones on their own devices
    (dicts and lists rebuilt, other leaves passed through)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: device_snapshot(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [device_snapshot(v) for v in tree]
    return tree


class AsyncCheckpointWriter:
    """One background thread writing trees to disk atomically, in order.

    The queue is bounded (1 pending + 1 in flight): a queued snapshot holds
    device memory, so when the writer falls behind ``submit`` blocks instead
    (toward the reference's synchronous save, with memory bounded at about
    two snapshots)."""

    def __init__(self, serialize: Callable[[Any], bytes] = msgpack_serialize):
        self._serialize = serialize
        self._q: "queue.Queue[Optional[tuple]]" = queue.Queue(maxsize=1)
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name="ckpt-writer", daemon=True)
        self._thread.start()
        # if the owner exits without close() (an exception unwinding the
        # training loop), still drain queued writes at exit
        self._atexit = atexit.register(self._q.join)

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                # acknowledge the shutdown sentinel too, or a later q.join()
                # (a second close(), the atexit drain) would wait forever
                self._q.task_done()
                return
            path, tree, serialize = item
            try:
                atomic_write(path, (serialize or self._serialize)(tree))
            except BaseException as e:  # surfaced on join()/close()/next submit()
                if self._error is None:
                    self._error = e
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {err!r}") from err

    def submit(self, path: str, tree: Any,
               serialize: Optional[Callable[[Any], bytes]] = None) -> None:
        """Queue ``tree`` for an atomic write to ``path`` (FIFO: weights
        submitted before the log land before it). ``serialize`` overrides the
        writer's default for this item (e.g. JSON for the log). Blocks while an
        item is queued. The caller snapshots mutable tensors first
        (``device_snapshot``)."""
        self._raise_pending()
        if not self._thread.is_alive():
            raise RuntimeError("AsyncCheckpointWriter already closed")
        self._q.put((path, tree, serialize))

    def join(self) -> None:
        """Block until every queued write has landed; re-raise any failure."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain, stop the thread, re-raise any failure. Idempotent."""
        if not self._thread.is_alive():
            self._raise_pending()
            return
        self._q.join()
        self._q.put(None)
        self._thread.join()
        atexit.unregister(self._atexit)
        self._raise_pending()

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        # on an exception unwind, still drain (queued checkpoints are valid)
        # without masking the original exception with a write error
        if exc and exc[0] is not None:
            try:
                self.close()
            except RuntimeError:
                pass
        else:
            self.close()
