"""The port's span recorder (``utils/profiling.span``) and the spans of the
sampler (``diffusion/predictor.py``) and the serving daemon
(``utils/serving.py``) on the CPU.

Off, ``span`` reads no clock and nothing is recorded. On, a sampler call is
one ``sampler.call`` holding one ``sampler.prepare``, one ``sampler.step`` a
UNet evaluation and one ``sampler.decode``, nested on one thread; requests
through the HTTP front end carry their id on ``serve.queued``, paired with
their batch's id, and every batch its id on the batcher's spans. Outputs are
bit-equal with recording on and off. The tiny predictor and the 3 x 32^2
volumes of ``tests/test_torch_serving.py``, 4 steps.
"""
import threading
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch

from diffusion_model_project_tpu_torch.utils import profiling
from diffusion_model_project_tpu_torch.utils.serving import (InferenceServer, build_http_server,
                                                              decode_raw_response,
                                                              encode_raw_request)

from test_torch_serving import S, STEPS, _noise, _post, _volume
from test_torch_train_step import one_torch_thread, port_predictor  # noqa: F401

@pytest.fixture(scope="module")
def pred():
    return port_predictor(seed=3)


@pytest.fixture(autouse=True)
def spans_off():
    profiling.enable_spans(False)
    yield
    profiling.enable_spans(False)


def _call(pred, sampler):
    img, v2d = _volume(0)
    i, v, n = torch.from_numpy(img[None]), torch.from_numpy(v2d[None]), _noise(0)
    if sampler == "dpm":
        return pred.predict_dpm(i, v, num_steps=STEPS, noise=n)
    return pred.predict_ddim(i, v, num_steps=STEPS, eta=0.0, noise=n)


def _no_clock():
    raise AssertionError("a span read the clock while recording was off")


@pytest.fixture(scope="module")
def outputs_off(pred):
    """Each sampler's output with recording off, the clock made to raise."""
    mp = pytest.MonkeyPatch()
    try:
        profiling.enable_spans(False)
        mp.setattr(profiling.time, "perf_counter", _no_clock)
        return {sampler: _call(pred, sampler) for sampler in ("ddim", "dpm")}
    finally:
        mp.undo()


def test_off_reads_no_clock_and_records_nothing(outputs_off, monkeypatch):
    monkeypatch.setattr(profiling.time, "perf_counter", _no_clock)
    with profiling.span("x", 1):
        pass
    profiling.record_span("y", 3, 0.0, 1.0)
    monkeypatch.undo()
    assert profiling.take_spans() == [] and profiling.spans_dropped() == 0
    assert profiling.span("a") is profiling.span("b")   # one shared no-op


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_sampler_spans_nest_and_leave_outputs_bit_equal(pred, outputs_off, sampler):
    off = outputs_off[sampler]
    profiling.enable_spans(True)
    on = _call(pred, sampler)
    spans = profiling.take_spans()
    assert torch.equal(on, off)
    assert Counter(s.name for s in spans) == {"sampler.call": 1, "sampler.prepare": 1,
                                              "sampler.step": STEPS, "sampler.decode": 1}
    (call,) = [s for s in spans if s.name == "sampler.call"]
    assert call.parent_id is None
    inner = sorted((s for s in spans if s is not call), key=lambda s: s.t0)
    assert [s.name for s in inner] == ["sampler.prepare"] + ["sampler.step"] * STEPS + [
        "sampler.decode"]
    assert {s.thread_id for s in spans} == {threading.get_ident()}
    assert len({s.span_id for s in spans}) == len(spans)
    for s in inner:
        assert s.parent_id == call.span_id and s.ident is None
        assert call.t0 <= s.t0 <= s.t1 <= call.t1
    for a, b in zip(inner, inner[1:]):
        assert a.t1 <= b.t0


def test_full_buffer_drops_and_counts():
    profiling.enable_spans(True)
    with profiling.span("outer", 7):
        for _ in range(profiling.SPAN_CAPACITY + 1):
            with profiling.span("inner"):
                pass
    profiling.record_span("late", 8, 0.0, 1.0)
    spans = profiling.take_spans()
    assert len(spans) == profiling.SPAN_CAPACITY and {s.name for s in spans} == {"inner"}
    assert profiling.spans_dropped() == 3       # one inner, outer, late
    with profiling.span("after"):
        pass
    assert [s.name for s in profiling.take_spans()] == ["after"]
    profiling.enable_spans(True)
    assert profiling.spans_dropped() == 0


def _serve(pred, vols, spans_on: bool):
    """Each volume posted as an MFR1 frame from a thread of its own, through a
    ladder of (1,) so that every request is its own batch: (replies, spans)."""
    profiling.enable_spans(spans_on)
    server = InferenceServer(pred, sampler="ddim", num_steps=STEPS, batch_sizes=(1,),
                             max_wait_ms=1.0, expected_shape=(S, 32, 32))
    httpd = build_http_server(server, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    replies = [None] * len(vols)

    def client(i):
        _, _, body = _post(port, encode_raw_request(*vols[i], seed=i), timeout=120)
        replies[i] = decode_raw_response(body)

    try:
        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(vols))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
        assert not any(c.is_alive() for c in clients)
        stats = server.stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=60)
        server.close()
    return replies, profiling.take_spans(), stats


def test_served_requests_and_batches_carry_their_ids(pred):
    vols = [_volume(i) for i in range(2)]
    off, none, stats = _serve(pred, vols, False)
    on, spans, _ = _serve(pred, vols, True)
    assert none == [] and stats["queue_wait_ms"]["window"] == 2
    for a, b in zip(on, off):
        assert np.array_equal(a, b)
    by_id = {s.span_id: s for s in spans}
    queued = {s.ident[0]: s for s in spans if s.name == "serve.queued"}
    assert sorted(queued) == [0, 1]
    batcher = {s.thread_id for s in spans if s.name == "serve.dispatch"}
    assert len(batcher) == 1
    for q in queued.values():
        assert q.parent_id is None and q.t0 <= q.t1 and q.thread_id not in batcher
    batch = defaultdict(Counter)
    for s in spans:
        if s.name.startswith("serve.") and isinstance(s.ident, int):
            batch[s.ident][s.name] += 1
    bids = sorted(q.ident[1] for q in queued.values())
    assert len(set(bids)) == 2                      # a batch a request at a ladder of (1,)
    for bid in bids:
        for name in ("serve.coalesce", "serve.dispatch", "serve.assemble", "serve.copy_out",
                     "serve.backpressure"):
            assert batch[bid][name] == 1, (bid, name, batch[bid])
        (dispatch,) = [s for s in spans if s.name == "serve.dispatch" and s.ident == bid]
        kids = sorted((s for s in spans if s.parent_id == dispatch.span_id), key=lambda s: s.t0)
        assert [s.name for s in kids] == ["serve.assemble", "sampler.call", "serve.copy_out"]
        assert all(dispatch.t0 <= s.t0 <= s.t1 <= dispatch.t1 for s in kids)
        steps = [s for s in spans if s.name == "sampler.step"
                 and by_id[s.parent_id].parent_id == dispatch.span_id]
        assert len(steps) == STEPS
        (q,) = [s for s in queued.values() if s.ident[1] == bid]
        assert q.t1 <= dispatch.t0
