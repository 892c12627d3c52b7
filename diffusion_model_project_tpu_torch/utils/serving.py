"""Serving: request micro-batching over the in-process predictor, plus a
stdlib HTTP front end (the port's copy of the JAX ``utils/serving.py``).

The reference deploys by re-running its inference script once per volume,
which pays model load and dispatch per request and never batches. This
daemon keeps one predictor resident and batches requests:

- each request is ONE volume (binary microstructure + 2D velocity + seed);
  a batcher thread coalesces up to ``max_batch`` queued requests (waiting at
  most ``max_wait_ms`` after the first arrives) into ONE call of the
  sampler (``predict_ddim(eta=0)`` or ``predict_dpm``, eager, under
  ``inference_mode``). The sampler loop is host-dispatched, so the batcher
  thread spends a batch's time enqueuing kernels; right after them it
  enqueues the device-to-host copy of the result into pinned memory and
  records a CUDA event. The inputs reach the card the same way, from pinned
  memory without blocking, so the batcher never waits for the device. A completion thread waits on that event only (a
  plain ``.cpu()`` on the shared stream would wait for the NEXT batch's
  kernels, already queued behind it) and resolves the futures.
- partial batches are padded by repeating the last request, up to the
  smallest size of the batch-size ladder that fits (the eval CLI's chunk
  padding); padded outputs are dropped before results are delivered.
- per-request initial latents come from ``torch.Generator("cpu")`` seeded
  with the request's seed (:func:`request_noise`), drawn as
  (ld, C, H/4, W/4) and moved to the device, so a request's result does not
  depend on which batch it landed in (deterministic samplers only), and is
  the same on the card and on the CPU up to compute differences. The JAX
  server draws from ``jax.random.key(seed)``: the bits differ by design, as
  with the eval CLI's ``--torch-noise``.

The MFR1 raw frame format is byte for byte the JAX package's, so clients of
either server talk to both.

While span recording is on (``utils.profiling.enable_spans``) the daemon
records:
- per request, on the submitting thread: ``serve.queued`` (submit to the
  batcher taking the request, its id paired with its batch's);
- on the batcher, with the batch's id: ``serve.wait`` (on an empty queue),
  ``serve.coalesce`` (first request taken to the window's close),
  ``serve.dispatch`` holding ``serve.assemble`` (the staged inputs and the
  noise), the sampler's ``sampler.call`` and ``serve.copy_out``, then
  ``serve.backpressure`` (blocked with two batches in flight).
Queue waits are kept for ``stats()`` whether recording is on or off.
"""
from __future__ import annotations

import io
import itertools
import json
import math
import queue
import struct
import sys
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .profiling import record_span, span

_SHUTDOWN = object()

# Hard cap on an HTTP request body. A (11, 3, 256, 256) float32 volume pair
# is about 11 MB as npz; 256 MB leaves about 20x headroom for bigger
# geometries while keeping an oversized or hostile POST from exhausting host
# memory.
MAX_BODY_BYTES = 256 * 1024 * 1024


# ---------------------------------------------------------------- raw frames
# A raw frame is a fixed 32-byte header plus raw little-endian buffers: no
# npz or zlib work on the serving host in either direction (the transport's
# Content-Encoding can still compress for a WAN client). Frames are
# self-describing (magic "MFR1"), so /v1/predict dispatches on the first 4
# bytes: "PK\3\4" -> npz, "MFR1" -> raw.
#
# Request frame (little-endian):
#   0:4   magic b"MFR1"
#   4:5   img dtype code (0=float32, 1=float16)
#   5:6   v2d dtype code
#   6:7   resp dtype code (response velocity dtype the client wants)
#   7:8   reserved (0)
#   8:12  S   12:16  H   16:20  W   (uint32)
#   20:28 seed (int64)
#   28:32 reserved (0)
#   32:   img bytes (S*1*H*W * itemsize), then v2d bytes (S*3*H*W * itemsize)
# Response frame:
#   0:4   magic b"MFR1"
#   4:5   velocity dtype code   5:8 reserved
#   8:12  S   12:16  H   16:20  W
#   20:   velocity bytes (S*3*H*W * itemsize)

RAW_MAGIC = b"MFR1"
_RAW_DTYPES = {0: np.float32, 1: np.float16}
_RAW_CODES = {np.dtype(np.float32): 0, np.dtype(np.float16): 1}


def encode_raw_request(img: np.ndarray, v2d: np.ndarray, *, seed: int = 0,
                       resp_dtype: str = "float32") -> bytes:
    """Client-side encoder for the raw frame: header + raw buffers."""
    img = np.ascontiguousarray(img)
    v2d = np.ascontiguousarray(v2d)
    s, _, h, w = img.shape
    head = struct.pack(
        "<4sBBBBIIIqI", RAW_MAGIC, _RAW_CODES[img.dtype],
        _RAW_CODES[v2d.dtype], _RAW_CODES[np.dtype(resp_dtype)], 0,
        s, h, w, int(seed), 0)
    return head + img.tobytes() + v2d.tobytes()


def decode_raw_request(body: bytes):
    """-> (img, v2d, seed, resp_dtype_str); raises ValueError on malformed
    frames (wrong magic, unknown dtype code, size mismatch)."""
    if len(body) < 32 or body[:4] != RAW_MAGIC:
        raise ValueError("not a raw MFR1 frame")
    (_, c_img, c_v2d, c_resp, _z0, s, h, w, seed, _z1) = struct.unpack(
        "<4sBBBBIIIqI", body[:32])
    for c in (c_img, c_v2d, c_resp):
        if c not in _RAW_DTYPES:
            raise ValueError(f"unknown dtype code {c}")
    dt_img = np.dtype(_RAW_DTYPES[c_img])
    dt_v2d = np.dtype(_RAW_DTYPES[c_v2d])
    n_img = s * 1 * h * w * dt_img.itemsize
    n_v2d = s * 3 * h * w * dt_v2d.itemsize
    if len(body) != 32 + n_img + n_v2d:
        raise ValueError(
            f"raw frame size {len(body)} != 32 + {n_img} + {n_v2d} for "
            f"shape ({s},{h},{w})")
    img = np.frombuffer(body, dt_img, count=s * h * w, offset=32
                        ).reshape(s, 1, h, w)
    v2d = np.frombuffer(body, dt_v2d, count=s * 3 * h * w, offset=32 + n_img
                        ).reshape(s, 3, h, w)
    return img, v2d, int(seed), np.dtype(_RAW_DTYPES[c_resp]).name


def encode_raw_response(velocity: np.ndarray) -> bytes:
    velocity = np.ascontiguousarray(velocity)
    s, _, h, w = velocity.shape
    head = struct.pack("<4sBBBBIII", RAW_MAGIC, _RAW_CODES[velocity.dtype],
                       0, 0, 0, s, h, w)
    return head + velocity.tobytes()


def decode_raw_response(body: bytes) -> np.ndarray:
    if len(body) < 20 or body[:4] != RAW_MAGIC:
        raise ValueError("not a raw MFR1 frame")
    _, code, _a, _b, _c, s, h, w = struct.unpack("<4sBBBBIII", body[:20])
    if code not in _RAW_DTYPES:
        raise ValueError(f"unknown dtype code {code}")
    dt = np.dtype(_RAW_DTYPES[code])
    if len(body) != 20 + s * 3 * h * w * dt.itemsize:
        raise ValueError("raw response size mismatch")
    return np.frombuffer(body, dt, count=s * 3 * h * w, offset=20
                         ).reshape(s, 3, h, w)


def request_noise(seed: int, shape: Tuple[int, int, int, int]) -> torch.Tensor:
    """A request's initial latents (ld, C, lh, lw), float32 on the CPU, from
    ``torch.Generator("cpu").manual_seed(seed)``."""
    return torch.randn(shape, generator=torch.Generator("cpu").manual_seed(int(seed)))


class ServerBusy(RuntimeError):
    """Raised by submit() when the pending queue is at max_pending.

    Backpressure instead of unbounded queueing: every pending request pins
    its (S,1,H,W)+(S,3,H,W) host arrays, and an unbounded producer outruns
    the device."""


@dataclass
class _Request:
    img: np.ndarray  # (S, 1, H, W) float32, binary microstructure
    v2d: np.ndarray  # (S, 3, H, W) float32, 2D velocity conditioning
    seed: int
    future: Future
    rid: int          # the request's id, in order of submission
    t_arrive: float   # time.perf_counter() at submit
    thread: int       # the submitting thread


def _summary(values) -> dict:
    """p50 / p99 (nearest rank: ceil(0.99n)-1; int(0.99n) is n-1 for every
    n <= 100, which would just alias max) / max / window of ``values``."""
    ms = sorted(values)
    return {"p50": round(ms[len(ms) // 2], 1),
            "p99": round(ms[max(0, math.ceil(0.99 * len(ms)) - 1)], 1),
            "max": round(ms[-1], 1),
            "window": len(ms)}


class InferenceServer:
    """Micro-batching inference daemon over a LatentDiffusionPredictor.

    ``submit()`` is thread-safe and returns a ``concurrent.futures.Future``
    resolving to the (S, 3, H, W) channels-first predicted velocity volume
    (numpy float32). ``predict()`` is the blocking convenience wrapper. Only
    the deterministic samplers are served: a batched DDPM loop shares its
    per-step ancestral noise stream across the batch, which would make
    results depend on co-batched requests (the eval CLI refuses DDPM batches
    for the same reason). The server runs on the predictor's device.
    """

    def __init__(self, predictor, *, sampler: str = "ddim",
                 num_steps: int = 50, max_batch: Optional[int] = None,
                 max_wait_ms: float = 5.0,
                 max_pending: Optional[int] = None,
                 expected_shape: Optional[Tuple[int, int, int]] = None,
                 batch_sizes: Optional[Sequence[int]] = None):
        if sampler not in ("ddim", "dpm"):
            raise ValueError(
                f"sampler must be ddim|dpm (deterministic given the seeded "
                f"initial latents), got {sampler!r}")
        if max_batch is not None and max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")

        self._pred = predictor
        self.device = predictor.device
        self.sampler = sampler
        self.num_steps = int(num_steps)
        # batch_sizes: the ladder of batch shapes. Default is one shape
        # (max_batch) that every dispatch pads to. A ladder like (1, 8) is
        # the LATENCY mode: a lone request runs at B=1 instead of paying the
        # 8-padded dispatch, while bursts still coalesce at 8. warmup() runs
        # every size once; per-request seeded latents keep results identical
        # across sizes.
        if batch_sizes is None:
            batch_sizes = (int(max_batch) if max_batch is not None else 8,)
        sizes = sorted({int(s) for s in batch_sizes})
        if not sizes or sizes[0] < 1:
            raise ValueError(f"batch_sizes must be positive, got {batch_sizes}")
        # an explicit max_batch that disagrees with the ladder's top would
        # silently change the coalescing cap: refuse instead
        if max_batch is not None and int(max_batch) != sizes[-1]:
            raise ValueError(
                f"max_batch={max_batch} != max(batch_sizes)={sizes[-1]}; "
                f"the ladder's top IS the coalescing cap — drop max_batch "
                f"or make them agree")
        self.batch_sizes = tuple(sizes)
        self.max_batch = self.batch_sizes[-1]
        self._max_wait_s = float(max_wait_ms) / 1000.0
        if max_pending is not None and max_pending < self.max_batch:
            raise ValueError(
                f"max_pending={max_pending} < max_batch={self.max_batch} "
                f"could never fill a batch")
        self._max_pending = max_pending
        if sampler == "dpm":
            self._fn = lambda p, i, v, n: p.predict_dpm(
                i, v, num_steps=self.num_steps, noise=n)
        else:
            self._fn = lambda p, i, v, n: p.predict_ddim(
                i, v, num_steps=self.num_steps, eta=0.0, noise=n)

        self._queue: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        # One volume geometry per server. Preferably pinned here from the
        # CLI / predictor config (expected_shape), so a malformed FIRST
        # request can never pin a geometry every later request fails
        # against; first-request pinning remains the fallback for embedded
        # use, but an unproven pin is dropped again if its first batch fails
        # (see _deliver_failure).
        self._shape: Optional[Tuple[int, int, int]] = None  # (S, H, W)
        self._pinned_by_config = False
        # shapes that completed at least one successful batch. A SET keyed by
        # shape, not a single bool: around an unproven-pin drop and re-pin, a
        # still-in-flight success from the OLD shape must not mark the NEW
        # (never-executed) pin as proven
        self._proven_shapes: set = set()
        if expected_shape is not None:
            self._shape = self._validate_geometry(tuple(map(int, expected_shape)))
            self._pinned_by_config = True
        # queued_while_busy: batches whose kernels were queued while the
        # previous batch's result was not yet copied back (the pipeline's
        # overlap; 0 on the CPU, where a batch has finished when its call
        # returns)
        self._stats = {"requests": 0, "batches": 0, "padded_slots": 0,
                       "errors": 0, "rejected": 0, "queued_while_busy": 0}
        # dispatch->completion wall time of the last 100 batches (the
        # sampler AND the result's copy to the host): the operator-facing
        # half of per-request latency, surfaced via stats()/healthz
        self._batch_ms = deque(maxlen=100)
        # submit->taken into a batch of the last 100 requests: the other half
        self._queue_wait_ms = deque(maxlen=100)
        self._rids = itertools.count()
        self._closed = False
        # two-stage pipeline: the batcher thread collects and enqueues a
        # batch's kernels and its copy to pinned host memory, the completion
        # thread waits on the copy's event and resolves futures, so the next
        # batch's kernels are queued while a finished one is delivered.
        # maxsize bounds in-flight batches: each slot pins one batch of host
        # and device memory.
        self._inflight: "queue.Queue" = queue.Queue(maxsize=2)
        self._last_done = None  # the last dispatched batch's event (batcher only)
        self._bids = itertools.count()  # batch ids (batcher only)
        self._thread = threading.Thread(
            target=self._loop, name="inference-batcher", daemon=True)
        self._completion = threading.Thread(
            target=self._completion_loop, name="inference-completion",
            daemon=True)
        self._thread.start()
        self._completion.start()

    # ------------------------------------------------------------- client

    def _validate_geometry(self, shape: Tuple[int, int, int]):
        """Reject (S, H, W) the model could never run: the VAE halves H and W
        twice (so both must divide by 4) and shrinks depth by
        vae_depth_factor (so S must divide by it). Raises ValueError."""
        s, h, w = shape
        df = self._pred.vae_depth_factor
        if s <= 0 or h <= 0 or w <= 0:
            raise ValueError(f"non-positive volume geometry (S,H,W)={shape}")
        if h % 4 or w % 4:
            raise ValueError(
                f"H and W must be divisible by 4 (two stride-2 VAE stages), "
                f"got (S,H,W)={shape}")
        if s % df:
            raise ValueError(
                f"S must be divisible by vae_depth_factor={df}, "
                f"got (S,H,W)={shape}")
        return shape

    def submit(self, img: np.ndarray, v2d: np.ndarray,
               seed: int = 0) -> Future:
        """Queue one request; the future carries the request's id as
        ``request_id``."""
        img = np.asarray(img, np.float32)
        v2d = np.asarray(v2d, np.float32)
        if img.ndim != 4 or img.shape[1] != 1:
            raise ValueError(
                f"img must be (S, 1, H, W) channels-first, got {img.shape}")
        if v2d.ndim != 4 or v2d.shape[1] != 3:
            raise ValueError(
                f"v2d must be (S, 3, H, W) channels-first, got {v2d.shape}")
        shape = (img.shape[0], img.shape[2], img.shape[3])
        if (v2d.shape[0], v2d.shape[2], v2d.shape[3]) != shape:
            raise ValueError(
                f"img {img.shape} and v2d {v2d.shape} disagree on (S, H, W)")
        self._validate_geometry(shape)
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("InferenceServer is closed")
            if (self._max_pending is not None
                    and self._queue.qsize() >= self._max_pending):
                self._stats["rejected"] += 1
                raise ServerBusy(
                    f"{self._queue.qsize()} requests pending "
                    f"(max_pending={self._max_pending}); retry later")
            # one volume geometry per server: reject another shape loudly
            if self._shape is None:
                self._shape = shape
            elif shape != self._shape:
                raise ValueError(
                    f"request shape (S,H,W)={shape} != the server's pinned "
                    f"{self._shape}; run one server per volume geometry")
            self._stats["requests"] += 1
            rid = fut.request_id = next(self._rids)
            # enqueue under the lock: close() also holds it while putting the
            # shutdown sentinel, so no request can land AFTER the sentinel
            # (which would leave its future forever unresolved)
            self._queue.put(_Request(img, v2d, int(seed), fut, rid, time.perf_counter(),
                                     threading.get_ident()))
        return fut

    def predict(self, img: np.ndarray, v2d: np.ndarray,
                seed: int = 0) -> np.ndarray:
        return self.submit(img, v2d, seed).result()

    def warmup(self) -> None:
        """Run every batch size of the ladder once (requires a config-pinned
        shape), so the first request of each size pays no first-call cost
        (cuDNN's algorithm search, the kernels' plans, the allocator)."""
        if self._shape is None:
            raise RuntimeError(
                "warmup() needs expected_shape pinned at construction")
        s, h, w = self._shape
        ld = s // self._pred.vae_depth_factor
        img = torch.zeros((s, 1, h, w))
        img[:, :, 0, 0] = 1.0  # one fluid voxel keeps the EDT finite
        v2d = torch.zeros((s, 3, h, w))
        for size in self.batch_sizes:
            noise = torch.zeros((size, ld, self._pred.latent_channels,
                                 h // 4, w // 4), device=self.device)
            self._fn(self._pred, torch.stack([img] * size).to(self.device),
                     torch.stack([v2d] * size).to(self.device), noise)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats, queue_depth=self._queue.qsize(),
                       sampler=self.sampler, num_steps=self.num_steps,
                       max_batch=self.max_batch)
            if self._batch_ms:
                out["batch_ms"] = _summary(self._batch_ms)
            if self._queue_wait_ms:
                out["queue_wait_ms"] = _summary(self._queue_wait_ms)
            return out

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop accepting requests, drain everything queued, join.

        Joins WITHOUT a deadline by default, so every accepted future
        resolves before the process exits. Pass a timeout only if the caller
        can tolerate abandoned requests; a timed-out join logs their count."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(_SHUTDOWN)
        self._thread.join(timeout=timeout)
        # the batcher forwards the sentinel downstream after its last
        # dispatch, so joining the completion thread drains every in-flight
        # batch before close() returns
        self._completion.join(timeout=timeout)
        if self._thread.is_alive() or self._completion.is_alive():
            print(f"WARNING: InferenceServer.close(timeout={timeout}) timed "
                  f"out with {self._queue.qsize()} queued and "
                  f"{self._inflight.qsize()} in-flight batch(es); their "
                  f"futures will never resolve", file=sys.stderr, flush=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------ batcher

    def _enter_device(self) -> None:
        """Make the predictor's device current in the calling thread (the
        current device, like ``inference_mode``, is per thread)."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def _loop(self) -> None:
        self._enter_device()
        held = None  # a differently-shaped request deferred to its own batch
        while True:
            bid = next(self._bids)
            req = held
            if req is None:
                with span("serve.wait", bid):
                    req = self._queue.get()
            held = None
            if req is _SHUTDOWN:
                self._inflight.put(_SHUTDOWN)
                return
            taken = [time.perf_counter()]
            batch = [req]
            shape0 = (req.img.shape[0], *req.img.shape[2:])
            deadline = time.monotonic() + self._max_wait_s
            stop = False
            with span("serve.coalesce", bid):
                while len(batch) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self._queue.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if nxt is _SHUTDOWN:
                        stop = True
                        break
                    # never co-batch mixed shapes: around an unproven-pin drop
                    # and re-pin, old-shape and new-shape requests can coexist
                    # in the queue; stacking them would fail BOTH — the
                    # straggler opens the next batch
                    if (nxt.img.shape[0], *nxt.img.shape[2:]) != shape0:
                        held = nxt
                        break
                    batch.append(nxt)
                    taken.append(time.perf_counter())
            self._queued(batch, taken, bid)
            self._dispatch_batch(batch, bid)
            if stop:
                if held is not None:  # straggler raced the shutdown sentinel
                    bid = next(self._bids)
                    self._queued([held], [time.perf_counter()], bid)
                    self._dispatch_batch([held], bid)
                self._inflight.put(_SHUTDOWN)
                return

    def _queued(self, batch, taken, bid: int) -> None:
        """Keep each request's wait from submit to being taken into batch
        ``bid`` (and record it as a ``serve.queued`` span)."""
        with self._lock:
            self._queue_wait_ms.extend((t - r.t_arrive) * 1e3 for r, t in zip(batch, taken))
        for r, t in zip(batch, taken):
            record_span("serve.queued", (r.rid, bid), r.t_arrive, t, r.thread)

    def _dispatch_batch(self, batch, bid: int) -> None:
        """Stage 1: assemble the batch, enqueue the sampler's kernels and the
        result's copy to pinned host memory, record an event, and hand the
        batch to the completion thread; blocks only when 2 batches are
        already in flight. Errors raised while enqueuing surface here, errors
        of the kernels at the completion thread's wait: both deliver to the
        futures."""
        true_n = len(batch)
        # smallest ladder size that fits (the latency ladder)
        size = next(s for s in self.batch_sizes if s >= true_n)
        padded = batch + [batch[-1]] * (size - true_n)
        t_dispatch = time.monotonic()
        try:
            with torch.inference_mode(), span("serve.dispatch", bid):
                with span("serve.assemble", bid):
                    img = self._stage([r.img for r in padded])
                    v2d = self._stage([r.v2d for r in padded])
                    # geometry from the batch itself, not self._shape: after an
                    # unproven pin is dropped, an old-shape failure and a
                    # new-shape batch can be in flight around the same re-pin
                    s, h, w = batch[0].img.shape[0], *batch[0].img.shape[2:]
                    # latent geometry: two stride-2 encoder stages -> /4 spatial,
                    # depth shrinks by vae_depth_factor (the eval CLI's noise)
                    ld = s // self._pred.vae_depth_factor
                    shape = (ld, self._pred.latent_channels, h // 4, w // 4)
                    noise = self._stage([request_noise(r.seed, shape).numpy() for r in padded])
                # the inputs' copies are queued, not waited for: the previous
                # batch may still be on the device while this one is queued
                prev = self._last_done
                overlapped = prev is not None and not prev.query()
                out_dev = self._fn(self._pred, img, v2d, noise)
                with span("serve.copy_out", bid):
                    out, done = self._copy_out(out_dev)
        except Exception as exc:
            self._deliver_failure(batch, exc)
            return
        self._last_done = done
        with span("serve.backpressure", bid):
            self._inflight.put((out, done, batch, size - true_n, t_dispatch, overlapped))

    def _stage(self, arrays) -> torch.Tensor:
        """Stack host arrays into one batch on the device. On the card the
        stack is written into pinned memory and copied without blocking the
        host (a copy from pageable memory would wait for every kernel already
        queued); the caching host allocator keeps the buffer until the copy
        is done."""
        if self.device.type != "cuda":
            return torch.from_numpy(np.stack(arrays))
        host = torch.empty((len(arrays), *arrays[0].shape), dtype=torch.float32,
                           pin_memory=True)
        np.stack(arrays, out=host.numpy())
        return host.to(self.device, non_blocking=True)

    def _copy_out(self, out_dev: torch.Tensor):
        """Queue the result's copy to pinned host memory and an event after
        it: ``(host tensor, event)``; on the CPU the result is on the host
        already and there is no event."""
        if out_dev.device.type != "cuda":
            return out_dev, None
        out = torch.empty(out_dev.shape, dtype=out_dev.dtype, pin_memory=True)
        out.copy_(out_dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return out, done

    def _completion_loop(self) -> None:
        """Stage 2: wait on each in-flight batch's copy to the host and
        resolve its futures, while the batcher enqueues the next batch."""
        self._enter_device()
        while True:
            item = self._inflight.get()
            if item is _SHUTDOWN:
                return
            out, done, batch, n_padded, t_dispatch, overlapped = item
            try:
                if done is not None:
                    done.synchronize()
                out = out.numpy()
            except Exception as exc:  # a kernel's failure surfaces at the wait
                self._deliver_failure(batch, exc)
                continue
            with self._lock:
                self._stats["batches"] += 1
                self._stats["padded_slots"] += n_padded
                self._stats["queued_while_busy"] += int(overlapped)
                self._batch_ms.append((time.monotonic() - t_dispatch) * 1e3)
                b0 = batch[0].img
                self._proven_shapes.add((b0.shape[0], *b0.shape[2:]))
            for i, r in enumerate(batch):
                if not r.future.cancelled():
                    r.future.set_result(out[i])

    def _deliver_failure(self, batch, exc) -> None:
        with self._lock:
            self._stats["errors"] += 1
            # a first-request pin that never produced a successful batch
            # is dropped again, so one bad request cannot brick the
            # server for all subsequent well-formed ones (config pins
            # are authoritative and stay). Drop only when the FAILED
            # batch's shape IS the current unproven pin — a late old-shape
            # failure arriving after a re-pin must not unpin the new shape
            b0 = batch[0].img
            failed = (b0.shape[0], *b0.shape[2:])
            if (not self._pinned_by_config and self._shape == failed
                    and failed not in self._proven_shapes):
                self._shape = None
        for r in batch:
            if not r.future.cancelled():
                r.future.set_exception(exc)


# ------------------------------------------------------------------- HTTP

def build_http_server(server: InferenceServer, host: str = "127.0.0.1",
                      port: int = 8000):
    """Wrap an InferenceServer in a stdlib ThreadingHTTPServer.

    Endpoints:
      GET  /healthz      -> JSON: status + live batching stats
      POST /v1/predict   -> body: .npz with ``img`` (S,1,H,W), ``v2d``
                            (S,3,H,W), optional scalar ``seed``;
                            response: .npz with ``velocity`` (S,3,H,W)

    Payload options:
      - requests may send ``img``/``v2d`` as float16 and/or use
        ``np.savez_compressed`` — both are handled transparently
        (``submit()`` upcasts to float32);
      - responses honor two optional request fields: ``resp_dtype``
        ("float16" halves the body; default "float32") and
        ``resp_compress`` (nonzero -> ``savez_compressed``; masked
        velocity fields are mostly zeros in the solid and deflate well).

    Raw-bytes mode: a request body starting with the ``MFR1`` magic is a
    fixed-header raw frame (``encode_raw_request``) and gets a raw-frame
    response (``decode_raw_response``): no npz or zlib work in either
    direction.

    ThreadingHTTPServer gives one handler thread per connection; concurrent
    requests therefore overlap in ``submit()`` and coalesce into shared
    device batches — that is the whole point of the daemon.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet: stats live in /healthz
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj: dict) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path != "/healthz":
                return self._send_json(404, {"error": "unknown path"})
            self._send_json(200, {"status": "ok", **server.stats()})

        def do_POST(self):
            if self.path != "/v1/predict":
                return self._send_json(404, {"error": "unknown path"})
            raw_mode = False
            try:
                length = int(self.headers.get("Content-Length", "0"))
                # a volume request is about 11 MB of float32 npz; anything
                # near the cap is malformed or hostile: refuse before
                # buffering it
                if length > MAX_BODY_BYTES:
                    return self._send_json(413, {
                        "error": f"body {length} bytes exceeds the "
                                 f"{MAX_BODY_BYTES}-byte request cap"})
                body = self.rfile.read(length)
                resp_compress = False
                if body[:4] == RAW_MAGIC:
                    raw_mode = True
                    img, v2d, seed, resp_dtype = decode_raw_request(body)
                else:
                    with np.load(io.BytesIO(body), allow_pickle=False) as z:
                        img, v2d = z["img"], z["v2d"]
                        seed = int(z["seed"]) if "seed" in z.files else 0
                        resp_dtype = (str(z["resp_dtype"])
                                      if "resp_dtype" in z.files else "float32")
                        resp_compress = bool(
                            "resp_compress" in z.files
                            and int(z["resp_compress"]))
                if resp_dtype not in ("float32", "float16"):
                    return self._send_json(400, {
                        "error": f"resp_dtype must be float32|float16, "
                                 f"got {resp_dtype!r}"})
            except Exception as exc:
                # catch-all: truncated PK archives raise zipfile.BadZipFile,
                # raw-frame mismatches raise ValueError, etc. — every
                # body-decode failure is the client's 400, never a dropped
                # connection
                return self._send_json(400, {"error": str(exc)})
            try:
                fut = server.submit(img, v2d, seed=seed)
            except (KeyError, ValueError, OSError) as exc:
                return self._send_json(400, {"error": str(exc)})
            except ServerBusy as exc:  # bounded queue full -> backpressure
                return self._send_json(429, {"error": str(exc)})
            except RuntimeError as exc:  # server closed
                return self._send_json(503, {"error": str(exc)})
            try:
                velocity = fut.result()
            except Exception as exc:  # the batch failed
                return self._send_json(500, {"error": str(exc)})
            if resp_dtype == "float16":
                velocity = velocity.astype(np.float16)
            if raw_mode:  # raw in -> raw out: header + buffer, no zlib
                return self._send(200, encode_raw_response(velocity),
                                  "application/x-mfr1")
            buf = io.BytesIO()
            (np.savez_compressed if resp_compress else np.savez)(
                buf, velocity=velocity)
            self._send(200, buf.getvalue(), "application/octet-stream")

    return ThreadingHTTPServer((host, port), Handler)
