"""The port's serving daemon (``utils/serving.py``) and serve CLI on the CPU.

Every case of ``tests/test_serving.py`` runs on the port: a request's result
is the same whether it ran alone, co-batched or as batch padding, because
each request's initial latents come from its own seed
(``serving.request_noise``: ``torch.Generator("cpu")``). Here, as there,
the tiny predictor runs 3 x 32^2 volumes for 4 steps; it has one attention
level, so K2's plain version is on the path. The served results are held
against the JAX package's ``predict_ddim`` / ``predict_dpm`` given the
noise the port's rule drew (within 1e-4 of max|JAX|), and the MFR1 frames
against the JAX package's codec byte for byte.
"""
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_project_tpu.utils import serving as jserving

from diffusion_model_project_tpu_torch.scripts import serve as serve_cli
from diffusion_model_project_tpu_torch.utils import serving
from diffusion_model_project_tpu_torch.utils.serving import (InferenceServer, ServerBusy,
                                                              build_http_server)

from test_torch_train_step import (L, NORM_OUTPUT, T, UNET_KW, jax_twin,  # noqa: F401
                                  one_torch_thread, port_predictor)

S, H, W = 3, 32, 32
STEPS = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pred():
    return port_predictor(seed=3)


def _volume(i):
    r = np.random.default_rng(100 + i)
    img = (r.random((S, 1, H, W)) > 0.3).astype(np.float32)
    img[:, :, 0, 0] = 0.0
    v2d = (r.standard_normal((S, 3, H, W)) * 1e-2).astype(np.float32)
    v2d[:, 2] = 0.0
    return img, v2d


def _noise(seed, s=S):
    return serving.request_noise(seed, (s, L, H // 4, W // 4))


def _direct(pred, img, v2d, seed, sampler="ddim"):
    """Single-sample ground truth: the same sampler on the seed's latents."""
    i, v, n = torch.from_numpy(img[None]), torch.from_numpy(v2d[None]), _noise(seed, len(img))
    if sampler == "dpm":
        return pred.predict_dpm(i, v, num_steps=STEPS, noise=n)[0].numpy()
    return pred.predict_ddim(i, v, num_steps=STEPS, eta=0.0, noise=n)[0].numpy()


def assert_close(got, want, tol=1e-5):
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(got - want).max()) <= tol * scale


def test_request_noise_is_the_seeded_cpu_generator():
    got = serving.request_noise(7, (3, 4, 8, 8))
    want = torch.randn((3, 4, 8, 8), generator=torch.Generator("cpu").manual_seed(7))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert torch.equal(got, want)


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_served_results_match_jax_alone_cobatched_and_padding(pred, sampler):
    """JAX's sampler on the noise the port's per-seed rule drew; the port's
    server alone (B=1), co-batched (3 requests at B=4, one padded slot) and
    as padding of another request's batch, each within 1e-4 of max|JAX|."""
    jpred = jax_twin(pred)
    if sampler == "dpm":
        fn = jax.jit(lambda p, i, v, n: p.predict_dpm(i, v, num_steps=STEPS, noise=n))
    else:
        fn = jax.jit(lambda p, i, v, n: p.predict_ddim(i, v, num_steps=STEPS, eta=0.0,
                                                        noise=n))
    vols = [_volume(i) for i in range(3)]
    expected = [np.asarray(fn(jpred, jnp.asarray(img[None]), jnp.asarray(v2d[None]),
                              jnp.asarray(_noise(i).numpy()[None])))[0]
                for i, (img, v2d) in enumerate(vols)]
    with InferenceServer(pred, sampler=sampler, num_steps=STEPS, batch_sizes=(1, 4),
                         max_wait_ms=200.0, expected_shape=(S, H, W)) as server:
        alone = server.predict(*vols[0], seed=0)
        assert server.stats()["padded_slots"] == 0
        futs = [server.submit(img, v2d, seed=i) for i, (img, v2d) in enumerate(vols)]
        cobatched = [f.result(timeout=300) for f in futs]
        stats = server.stats()
    assert stats["batches"] == 2 and stats["padded_slots"] == 1, stats
    # the last request of the co-batched call was also its padding
    for got in (alone, cobatched[0]):
        assert_close(got, expected[0], 1e-4)
    for got, want in zip(cobatched, expected):
        assert got.shape == (S, 3, H, W)
        assert_close(got, want, 1e-4)
    with InferenceServer(pred, sampler=sampler, num_steps=STEPS, max_batch=4,
                         max_wait_ms=1.0) as server:
        padded = server.predict(*vols[2], seed=2)  # B=4 of one request and three copies
        assert server.stats()["padded_slots"] == 3
    assert_close(padded, expected[2], 1e-4)


def test_next_batch_is_queued_while_the_previous_one_is_busy(pred):
    """The two-stage pipeline with a stand-in for the card's event: batch 1's
    result is ready only once batch 2's sampler call has begun, so the
    batcher must queue batch 2 without waiting for batch 1 (the completion
    thread's wait fails otherwise); ``queued_while_busy`` counts that
    overlap, and the results are the direct call's."""
    second = threading.Event()

    class Event:  # the two methods of torch.cuda.Event the server calls
        def __init__(self):
            self.fired = False

        def query(self):
            return self.fired

        def synchronize(self):
            assert second.wait(timeout=120), "batch 2 was not queued while batch 1 was busy"
            self.fired = True

    vols = [_volume(i) for i in range(4)]
    with InferenceServer(pred, num_steps=STEPS, max_batch=2, max_wait_ms=200.0) as server:
        fn, calls = server._fn, []

        def counted(*args):
            calls.append(len(calls))
            if len(calls) == 2:
                second.set()
            return fn(*args)

        server._fn = counted
        server._copy_out = lambda out: (out, Event())
        futs = [server.submit(img, v2d, seed=i) for i, (img, v2d) in enumerate(vols)]
        got = [f.result(timeout=300) for f in futs]
        stats = server.stats()
    assert stats["batches"] == 2 and stats["queued_while_busy"] == 1, stats
    for i, (img, v2d) in enumerate(vols):
        assert_close(got[i], _direct(pred, img, v2d, seed=i))


def test_concurrent_requests_coalesce_and_match_direct(pred):
    volumes = [_volume(i) for i in range(9)]
    expected = [_direct(pred, img, v2d, seed=i) for i, (img, v2d) in enumerate(volumes)]

    with InferenceServer(pred, sampler="ddim", num_steps=STEPS,
                         max_batch=4, max_wait_ms=50.0) as server:
        futs = [server.submit(img, v2d, seed=i)
                for i, (img, v2d) in enumerate(volumes)]
        results = [f.result(timeout=300) for f in futs]
        stats = server.stats()

    assert stats["requests"] == 9
    assert 3 <= stats["batches"] <= 9
    assert stats["errors"] == 0
    for got, want in zip(results, expected):
        assert got.shape == (S, 3, H, W)
        assert_close(got, want)


def test_single_request_is_padded_not_retraced(pred):
    img, v2d = _volume(42)
    with InferenceServer(pred, sampler="ddim", num_steps=STEPS,
                         max_batch=4, max_wait_ms=1.0) as server:
        got = server.predict(img, v2d, seed=42)
        stats = server.stats()
    assert stats["batches"] == 1
    assert stats["padded_slots"] == 3  # padded to the one batch shape
    assert stats["batch_ms"]["window"] == 1
    assert stats["batch_ms"]["p50"] > 0
    # submit -> taken into a batch, well under the batch's own time
    wait = stats["queue_wait_ms"]
    assert wait["window"] == 1 and 0 <= wait["p50"] == wait["max"] <= stats["batch_ms"]["p50"]
    assert_close(got, _direct(pred, img, v2d, seed=42))


def test_request_validation(pred):
    img, v2d = _volume(0)
    with pytest.raises(ValueError, match="ddim|dpm"):
        InferenceServer(pred, sampler="ddpm")
    with InferenceServer(pred, num_steps=STEPS, max_batch=2) as server:
        with pytest.raises(ValueError, match="channels-first"):
            server.submit(img[:, 0], v2d)  # dropped channel dim
        with pytest.raises(ValueError, match="disagree"):
            server.submit(img, v2d[:, :, :16])
        server.predict(img, v2d, seed=0)  # pins (S, H, W)
        with pytest.raises(ValueError, match="pinned"):
            server.submit(img[:2], v2d[:2])
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(img, v2d)
    with pytest.raises(ValueError, match="max_batch=2 != max"):
        InferenceServer(pred, max_batch=2, batch_sizes=(1, 4))


def test_geometry_validation_and_config_pin(pred):
    img, v2d = _volume(0)
    with InferenceServer(pred, num_steps=STEPS, max_batch=2) as server:
        with pytest.raises(ValueError, match="divisible by 4"):
            server.submit(img[:, :, :30, :], v2d[:, :, :30, :])
        assert server._shape is None  # nothing pinned by the reject
        server.predict(img, v2d, seed=0)
    with InferenceServer(pred, num_steps=STEPS, max_batch=2,
                         expected_shape=(S, H, W)) as server:
        with pytest.raises(ValueError, match="pinned"):
            server.submit(img[:, :, : H // 2], v2d[:, :, : H // 2])
        server.predict(img, v2d, seed=0)  # the configured shape still works
    with pytest.raises(ValueError, match="divisible by 4"):
        InferenceServer(pred, num_steps=STEPS, expected_shape=(S, 30, W))


def test_failed_unproven_pin_is_dropped(pred):
    """A first request whose dispatch fails must not brick the server: its
    never-successful pin is dropped so later well-formed requests re-pin."""
    img, v2d = _volume(1)
    with InferenceServer(pred, num_steps=STEPS, max_batch=1,
                         max_wait_ms=0.0) as server:
        real_fn, server._fn = server._fn, None  # TypeError on first dispatch
        with pytest.raises(TypeError):
            server.predict(img[:1], v2d[:1], seed=0)  # pins (1, H, W), fails
        server._fn = real_fn
        out = server.predict(img, v2d, seed=0)  # another valid geometry re-pins
        assert out.shape == (S, 3, H, W)
        assert server.stats()["errors"] == 1


def test_batch_size_ladder_latency_mode(pred):
    """batch_sizes=(1, 4): a lone request runs at B=1 (zero padded slots), a
    burst coalesces at 4, and results equal the direct call."""
    img, v2d = _volume(3)
    with InferenceServer(pred, num_steps=STEPS, batch_sizes=(1, 4),
                         max_wait_ms=1.0, expected_shape=(S, H, W)) as server:
        server.warmup()  # runs both sizes once
        got = server.predict(img, v2d, seed=3)
        stats1 = server.stats()
        assert stats1["batches"] == 1 and stats1["padded_slots"] == 0
        assert_close(got, _direct(pred, img, v2d, seed=3))

        gate = threading.Event()
        real_fn = server._fn

        def gated(p, i, v, n):
            gate.wait(timeout=60)
            return real_fn(p, i, v, n)

        server._fn = gated
        futs = [server.submit(*_volume(10 + i), seed=i) for i in range(3)]
        gate.set()
        for f in futs:
            f.result(timeout=300)
        server._fn = real_fn
        stats2 = server.stats()
        assert stats2["batches"] - stats1["batches"] <= 3
        assert stats2["queue_wait_ms"]["window"] == 4  # every request, no warm-up
        assert server.batch_sizes == (1, 4)
    with pytest.raises(ValueError, match="positive"):
        InferenceServer(pred, batch_sizes=(0, 4))


def test_mixed_shape_queue_never_cobatches(pred):
    """Around an unproven-pin drop and re-pin, old-shape and new-shape
    requests can coexist in the queue; they must land in SEPARATE batches."""
    img, v2d = _volume(4)
    with InferenceServer(pred, num_steps=STEPS, max_batch=4,
                         max_wait_ms=200.0) as server:
        gate = threading.Event()
        real_fn = server._fn

        def gated(p, i, v, n):
            gate.wait(timeout=120)
            return real_fn(p, i, v, n)

        server._fn = gated
        fut_a = server.submit(img, v2d, seed=1)
        time.sleep(0.3)  # the batcher is now blocked inside the dispatch
        server._shape = None  # simulate the unpin window
        fut_b = server.submit(img[:1], v2d[:1], seed=2)  # re-pins S=1
        server._shape = (S, H, W)  # and another original-shape request
        fut_c = server.submit(img, v2d, seed=3)
        gate.set()
        a = fut_a.result(timeout=300)
        b = fut_b.result(timeout=300)
        c = fut_c.result(timeout=300)
    assert a.shape == (S, 3, H, W)
    assert b.shape == (1, 3, H, W)
    assert c.shape == (S, 3, H, W)
    assert server.stats()["errors"] == 0
    assert server.stats()["batches"] == 3  # the S=1 straggler got its own batch


def test_many_submitting_threads_each_get_their_own_result(pred):
    """A stress test of the server's shared state: 24 threads (more than
    the machine's cores) submit 5 requests each with a short switch
    interval; a stub sampler marks each slot with its latents' sum, so every
    future must resolve to its own seed's mark, and the counts must add up."""
    img, v2d = _volume(7)
    n_threads, per_thread = 24, 5
    results, lock = {}, threading.Lock()
    with InferenceServer(pred, num_steps=STEPS, batch_sizes=(1, 2, 4),
                         max_wait_ms=2.0, max_pending=512) as server:
        server._fn = lambda p, i, v, n: n.sum(dim=(1, 2, 3, 4)).view(-1, 1, 1, 1, 1).expand(
            n.shape[0], S, 3, H, W).clone()

        def client(t):
            for k in range(per_thread):
                seed = 1000 * t + k
                out = server.submit(img, v2d, seed=seed).result(timeout=60)
                with lock:
                    results[seed] = float(out[0, 0, 0, 0])

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        stats = server.stats()
    assert len(results) == n_threads * per_thread
    for seed, mark in results.items():
        assert mark == pytest.approx(float(_noise(seed).sum()), rel=1e-5, abs=1e-4)
    assert stats["requests"] == n_threads * per_thread and stats["errors"] == 0
    assert stats["queue_depth"] == 0


def test_warmup_requires_pinned_shape(pred):
    with InferenceServer(pred, num_steps=STEPS) as server:
        with pytest.raises(RuntimeError, match="expected_shape"):
            server.warmup()


def test_backpressure_bounded_queue(pred):
    img, v2d = _volume(9)
    with pytest.raises(ValueError, match="max_pending"):
        InferenceServer(pred, max_batch=4, max_pending=2)
    with InferenceServer(pred, num_steps=STEPS, max_batch=1,
                         max_wait_ms=0.0, max_pending=2) as server:
        gate = threading.Event()

        def slow_fn(p, i, v, n):
            gate.wait(timeout=60)
            return torch.zeros((1, S, 3, H, W))

        server._fn = slow_fn
        futs = [server.submit(img, v2d, seed=0)]   # dequeued -> in flight
        time.sleep(0.2)                            # batcher now blocked in gate
        futs += [server.submit(img, v2d, seed=i) for i in (1, 2)]  # fills queue
        with pytest.raises(ServerBusy, match="retry later"):
            server.submit(img, v2d, seed=3)
        assert server.stats()["rejected"] == 1
        gate.set()
        for f in futs:
            assert f.result(timeout=60).shape == (S, 3, H, W)
    assert server.stats()["requests"] == 3


def _post(port, body, timeout=300):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/predict", data=body)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


def _http_code(port, body):
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        _post(port, body, timeout=60)
    return exc_info.value.code


def test_http_round_trip(pred):
    img, v2d = _volume(5)
    expected = _direct(pred, img, v2d, seed=7)
    server = InferenceServer(pred, sampler="ddim", num_steps=STEPS,
                             max_batch=2, max_wait_ms=1.0)
    httpd = build_http_server(server, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        buf = io.BytesIO()
        np.savez(buf, img=img, v2d=v2d, seed=7)
        status, _, body = _post(port, buf.getvalue())
        assert status == 200
        assert_close(np.load(io.BytesIO(body))["velocity"], expected)

        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok"
        assert health["requests"] == 1
        assert health["sampler"] == "ddim"

        assert _http_code(port, b"not an npz") == 400

        # float16 compressed request, float16 compressed response
        buf = io.BytesIO()
        np.savez_compressed(buf, img=img.astype(np.float16), v2d=v2d.astype(np.float16),
                            seed=7, resp_dtype="float16", resp_compress=1)
        small = buf.getvalue()
        _, _, body = _post(port, small)
        got16 = np.load(io.BytesIO(body))["velocity"]
        assert got16.dtype == np.float16
        f32_buf = io.BytesIO()
        np.savez(f32_buf, img=img, v2d=v2d, seed=7)
        assert len(small) < len(f32_buf.getvalue())
        assert_close(got16.astype(np.float32), expected, 5e-2)

        # MFR1 in -> MFR1 out, the same numbers as the npz path
        status, ctype, body = _post(port, serving.encode_raw_request(img, v2d, seed=7))
        assert status == 200 and ctype == "application/x-mfr1"
        assert_close(serving.decode_raw_response(body), expected)
        _, _, body = _post(port, serving.encode_raw_request(
            img.astype(np.float16), v2d.astype(np.float16), seed=7, resp_dtype="float16"))
        vel16 = serving.decode_raw_response(body)
        assert vel16.dtype == np.float16
        assert_close(vel16.astype(np.float32), expected, 5e-2)

        assert _http_code(port, b"MFR1" + b"\0" * 12) == 400  # truncated frame
        buf = io.BytesIO()
        np.savez(buf, img=img, v2d=v2d, resp_dtype="float64")
        assert _http_code(port, buf.getvalue()) == 400  # unsupported resp_dtype
        assert _http_code(port, b"PK\x03\x04" + b"\x00" * 32) == 400  # truncated zip
        buf = io.BytesIO()
        np.savez(buf, img=img[:, :, :16], v2d=v2d[:, :, :16])
        assert _http_code(port, buf.getvalue()) == 400  # another geometry than the pin

        import http.client
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.putrequest("POST", "/v1/predict")
        conn.putheader("Content-Length", str(1 << 40))
        conn.endheaders()
        assert conn.getresponse().status == 413
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()


def test_http_busy_and_closed_replies(pred):
    """429 when the queue is full, 503 once the server is closed, 500 when
    the batch fails."""
    img, v2d = _volume(6)
    buf = io.BytesIO()
    np.savez(buf, img=img, v2d=v2d, seed=1)
    body = buf.getvalue()
    server = InferenceServer(pred, num_steps=STEPS, max_batch=1, max_wait_ms=0.0,
                             max_pending=1)
    httpd = build_http_server(server, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    gate = threading.Event()
    try:
        def blocked(p, i, v, n):
            gate.wait(timeout=60)
            raise RuntimeError("device lost")

        server._fn = blocked
        codes = []
        first = threading.Thread(target=lambda: codes.append(_http_code(port, body)))
        first.start()
        time.sleep(0.3)  # in flight, blocked in the gate
        second = threading.Thread(target=lambda: codes.append(_http_code(port, body)))
        second.start()
        time.sleep(0.3)  # queued: the queue is full
        assert _http_code(port, body) == 429
        gate.set()
        first.join(60)
        second.join(60)
        assert codes == [500, 500]
        server.close()
        assert _http_code(port, body) == 503
    finally:
        gate.set()
        httpd.shutdown()
        httpd.server_close()
        server.close()


@pytest.mark.parametrize("dtypes", [("float32", "float32", "float32"),
                                    ("float16", "float32", "float16"),
                                    ("float16", "float16", "float32")])
def test_mfr1_frames_are_byte_equal_to_jax(dtypes):
    """The MFR1 codec is the JAX package's byte for byte, and each side
    decodes the other's frames."""
    di, dv, resp = dtypes
    r = np.random.default_rng(0)
    img = (r.random((5, 1, 12, 16)) > 0.5).astype(di)
    v2d = r.standard_normal((5, 3, 12, 16)).astype(dv)
    ours = serving.encode_raw_request(img, v2d, seed=-123456789, resp_dtype=resp)
    theirs = jserving.encode_raw_request(img, v2d, seed=-123456789, resp_dtype=resp)
    assert ours == theirs
    for decode in (serving.decode_raw_request, jserving.decode_raw_request):
        i2, v2, seed, rd = decode(theirs)
        np.testing.assert_array_equal(i2, img)
        np.testing.assert_array_equal(v2, v2d)
        assert (seed, rd) == (-123456789, resp)
    vel = r.standard_normal((5, 3, 12, 16)).astype(resp)
    assert serving.encode_raw_response(vel) == jserving.encode_raw_response(vel)
    np.testing.assert_array_equal(
        serving.decode_raw_response(jserving.encode_raw_response(vel)), vel)
    np.testing.assert_array_equal(
        jserving.decode_raw_response(serving.encode_raw_response(vel)), vel)


def test_raw_frame_codec_round_trip():
    r = np.random.default_rng(0)
    img = (r.random((5, 1, 12, 12)) > 0.5).astype(np.float32)
    v2d = r.standard_normal((5, 3, 12, 12)).astype(np.float16)
    body = serving.encode_raw_request(img, v2d, seed=123, resp_dtype="float16")
    assert len(body) == 32 + img.nbytes + v2d.nbytes
    i2, v2, seed, rd = serving.decode_raw_request(body)
    np.testing.assert_array_equal(i2, img)
    np.testing.assert_array_equal(v2, v2d)
    assert (seed, rd) == (123, "float16")
    vel = r.standard_normal((5, 3, 12, 12)).astype(np.float32)
    np.testing.assert_array_equal(
        serving.decode_raw_response(serving.encode_raw_response(vel)), vel)
    with pytest.raises(ValueError):
        serving.decode_raw_request(b"XXXX" + bytes(60))
    with pytest.raises(ValueError):
        serving.decode_raw_request(body[:-1])
    with pytest.raises(ValueError):
        serving.decode_raw_response(serving.encode_raw_response(vel)[:-3])


# ---------------------------------------------------------------- serve CLI


def test_serve_cli_flags_and_refusals(pred, tmp_path):
    args = serve_cli.parse_args(["--model-dir", "x"])
    assert args.device == "cuda" and args.compute_dtype == "bfloat16" and not args.int8
    assert (args.sampler, args.steps, args.max_wait_ms, args.max_pending) == ("ddim", 50,
                                                                              20.0, 64)
    with pytest.raises(SystemExit):
        serve_cli.main(["--model-dir", "x", "--vae-encoder-path", "e", "--device", "cpu"])
    # --int8 serves with_vae_int8() of the run dir's predictor; a request's
    # result is the predictor's own on the batch it was served in
    run = write_run_dir(tmp_path, pred)
    predictor, server, httpd = serve_cli.build_server(serve_cli.parse_args(
        ["--model-dir", str(run), "--device", "cpu", "--int8", "--port", "0",
         "--image-size", str(H), "--steps", "2", "--batch-sizes", "1",
         "--compute-dtype", "float32"]))
    try:
        assert predictor.vae_int8 and not predictor.unet_int8
        img, v2d = _volume(0)
        got = server.predict(img, v2d, seed=5)
    finally:
        httpd.server_close()
        server.close()
    want = predictor.predict_ddim(torch.from_numpy(img[None]), torch.from_numpy(v2d[None]),
                                  num_steps=2, noise=_noise(5)[None])[0].numpy()
    np.testing.assert_array_equal(got, want)
    float_out = pred.predict_ddim(torch.from_numpy(img[None]), torch.from_numpy(v2d[None]),
                                  num_steps=2, noise=_noise(5)[None])[0].numpy()
    assert not np.array_equal(got, float_out)


def write_run_dir(root, pred):
    """A run dir in the reference layout (``best_model.pt`` and a ``vae.pt``
    VAE dir) holding ``pred``'s weights."""
    run, vae = root / "run", root / "vae"
    run.mkdir()
    vae.mkdir()
    torch.save({k: v for k, v in pred.state_dict().items()
                if k.startswith(("model.", "normalizer."))}, run / "best_model.pt")
    torch.save(pred.vae.state_dict(), vae / "vae.pt")
    (vae / "vae_log.json").write_text(json.dumps({"norm_factors": NORM_OUTPUT}))
    predictor = {"model_name": "UNet", "model_kwargs": dict(UNET_KW), "distance_transform": True,
                 "num_slices": S, "num_timesteps": T, "vae_path": str(vae)}
    (run / "log.json").write_text(json.dumps({"params": {"training": {
        "predictor_type": "latent-diffusion", "predictor": predictor}}}))
    return run


def test_serve_cli_answers_and_stops_on_sigterm(pred, tmp_path):
    """The CLI as a process on a run dir: one npz and one MFR1 request over
    HTTP, each equal to the run dir's predictor on the request's seeded
    latents, then SIGTERM: exit 0 with the final stats."""
    run = write_run_dir(tmp_path, pred)
    s, hw = S, H
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "diffusion_model_project_tpu_torch.scripts.serve",
         "--model-dir", str(run), "--device", "cpu", "--port", "0", "--image-size", str(hw),
         "--steps", "2", "--batch-sizes", "1,2", "--compute-dtype", "float32"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving "):
                break
        port = int(lines[-1].split("http://127.0.0.1:")[1].split()[0])
        r = np.random.default_rng(1)
        img = (r.random((s, 1, hw, hw)) > 0.3).astype(np.float32)
        v2d = (r.standard_normal((s, 3, hw, hw)) * 1e-2).astype(np.float32)
        want = pred.predict_ddim(torch.from_numpy(img[None]), torch.from_numpy(v2d[None]),
                                 num_steps=2, noise=serving.request_noise(
                                     5, (s, pred.latent_channels, hw // 4, hw // 4)))[0].numpy()
        buf = io.BytesIO()
        np.savez(buf, img=img, v2d=v2d, seed=5)
        _, _, body = _post(port, buf.getvalue())
        assert_close(np.load(io.BytesIO(body))["velocity"], want)
        _, _, body = _post(port, serving.encode_raw_request(img, v2d, seed=5))
        assert_close(serving.decode_raw_response(body), want)
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    out = "".join(lines) + rest
    assert proc.returncode == 0, out
    assert "serving stopped; final stats:" in out and "'requests': 2" in out, out
