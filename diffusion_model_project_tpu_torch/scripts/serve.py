"""Serving daemon CLI: HTTP inference with request micro-batching (the port's
copy of the root ``scripts/serve.py``).

Loads a run directory (native msgpack or reference ``.pt``, the same chain
as the inference CLI) onto ``--device`` (default cuda), runs every batch
size of the ladder once, and serves POST /v1/predict (npz or MFR1 raw
frames in and out) with concurrent requests coalesced into device batches
(``utils/serving.py``).

    python -m diffusion_model_project_tpu_torch.scripts.serve \\
        --model-dir runs/<run> --port 8000 --sampler dpm --steps 10 --batch-sizes 1,8

Client (npz):
  buf = io.BytesIO(); np.savez(buf, img=img, v2d=v2d, seed=7)
  r = urllib.request.urlopen(urllib.request.Request(
      "http://host:8000/v1/predict", data=buf.getvalue()))
  velocity = np.load(io.BytesIO(r.read()))["velocity"]   # (S, 3, H, W)
Client (MFR1): send ``encode_raw_request(img, v2d, seed=7)`` and read the
reply with ``decode_raw_response`` (both in ``utils/serving.py``).

SIGTERM or SIGINT (installed before the warm-up) stops the HTTP server,
drains every accepted request and prints the final stats. ``--int8`` serves
``predictor.with_vae_int8()``: the frozen VAE's convs in dynamic int8 (K4).
Its scales are taken over the whole device batch, so an int8 result
depends on the requests it is co-batched with and on the padding slots.
"""
from __future__ import annotations

import argparse
import signal
import threading

import torch

def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-dir", required=True,
                   help="Run directory (log.json + weights)")
    p.add_argument("--vae-path", default=None)
    p.add_argument("--vae-encoder-path", default=None)
    p.add_argument("--vae-decoder-path", default=None)
    p.add_argument("--use-ema", action="store_true",
                   help="Prefer ema_model.msgpack weights")
    p.add_argument("--sampler", choices=("ddim", "dpm"), default="ddim")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--image-size", type=int, default=256,
                   help="Square volume H=W the server pins")
    p.add_argument("--max-batch", type=int, default=None,
                   help="Coalescing cap when --batch-sizes is not given "
                        "(default 8). With --batch-sizes, the ladder's max "
                        "IS the cap; passing a disagreeing --max-batch is "
                        "an error rather than a silent override")
    p.add_argument("--batch-sizes", default=None,
                   help="Comma-separated ladder of batch shapes, e.g. '1,8': "
                        "lone requests run at B=1 (latency) while bursts "
                        "coalesce at the max (throughput). Default: one shape "
                        "(--max-batch)")
    p.add_argument("--no-warmup", action="store_true",
                   help="Skip running the batch-size ladder once at startup "
                        "(the first request of each size then pays its "
                        "first-call cost)")
    p.add_argument("--max-wait-ms", type=float, default=20.0,
                   help="How long the batcher waits to fill a batch after "
                        "the first request arrives")
    p.add_argument("--max-pending", type=int, default=64,
                   help="Bound on queued requests; beyond it submits get "
                        "HTTP 429 (backpressure, not unbounded memory)")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=("float32", "bfloat16"),
                   help="dtype of the networks' conv and matmul compute")
    p.add_argument("--int8", action="store_true",
                   help="int8 frozen-VAE fast path (dynamic per-channel scales, shared "
                        "by the requests of a device batch)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the kernels' plain versions)")
    return p.parse_args(argv)


def build_server(args):
    """The predictor, the ``InferenceServer`` and its HTTP server of ``args``
    (not yet serving, not warmed up)."""
    if bool(args.vae_encoder_path) != bool(args.vae_decoder_path):
        raise SystemExit(
            "--vae-encoder-path and --vae-decoder-path must be given "
            "together (one alone would be silently ignored and the run "
            "dir's recorded VAE paths used instead)")

    from ..utils.checkpoint import predictor_from_directory
    from ..utils.serving import InferenceServer, build_http_server

    overrides = None
    if args.vae_path or (args.vae_encoder_path and args.vae_decoder_path):
        overrides = {"vae_path": args.vae_path,
                     "vae_encoder_path": args.vae_encoder_path,
                     "vae_decoder_path": args.vae_decoder_path}
    predictor, params = predictor_from_directory(
        args.model_dir, device=args.device, vae_path_overrides=overrides,
        use_ema=args.use_ema)
    predictor.compute_dtype = getattr(torch, args.compute_dtype)
    if args.int8:
        predictor = predictor.with_vae_int8()
    num_slices = int(params["training"]["predictor"].get("num_slices", 11))

    batch_sizes = None
    if args.batch_sizes:
        batch_sizes = [int(s) for s in args.batch_sizes.split(",")]
    server = InferenceServer(
        predictor, sampler=args.sampler, num_steps=args.steps,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        max_pending=args.max_pending, batch_sizes=batch_sizes,
        # pin the served geometry from the CLI config, not from whatever
        # request happens to arrive first
        expected_shape=(num_slices, args.image_size, args.image_size))
    httpd = build_http_server(server, host=args.host, port=args.port)
    return predictor, server, httpd


def main(argv=None):
    args = parse_args(argv)
    predictor, server, httpd = build_server(args)

    # handlers BEFORE the warm-up: a stop signal during it must not kill the
    # process with batches on the device; request a graceful stop instead
    stopping = threading.Event()

    def _shutdown(signum, frame):
        stopping.set()
        # shutdown() must come from another thread than serve_forever()'s
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)

    if not args.no_warmup:
        print(f"warming up batch sizes {server.batch_sizes} ...", flush=True)
        server.warmup()
    if stopping.is_set():
        httpd.server_close()
        server.close()
        print("stopped during warmup; final stats:", server.stats(), flush=True)
        return

    # server.max_batch, not args.max_batch: with --batch-sizes the ladder's
    # top is the real coalescing cap
    print(f"serving {args.model_dir} on http://{args.host}:{httpd.server_address[1]} "
          f"({args.sampler}-{args.steps}, max_batch={server.max_batch}, "
          f"{args.compute_dtype}{', int8 VAE' if args.int8 else ''}, {predictor.device})",
          flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        server.close()
        print("serving stopped; final stats:", server.stats(), flush=True)


if __name__ == "__main__":
    main()
