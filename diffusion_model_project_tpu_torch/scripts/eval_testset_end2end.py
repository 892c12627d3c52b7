"""End-to-end evaluation of the latent diffusion pipeline on the test set (the
port's counterpart of the root ``scripts/eval_testset_end2end.py``).

    python -m diffusion_model_project_tpu_torch.scripts.eval_testset_end2end \
        --diffusion-model-path RUN_DIR --dataset-dir DATA \
        [--sampler ddim|dpm|ddpm] [--steps N] [--batch-size N] \
        [--sanity-mode | --cross-mode] [--device cpu]

Flag-compatible with the reference script: end-to-end diffusion (2D input ->
E2D -> DDIM / DPM-Solver++ / DDPM -> D3D), ``--sanity-mode`` (GT -> E3D ->
D3D) or ``--cross-mode`` (2D input -> E2D -> D3D); per-sample seeded initial
latents; the masked metric suite of ``losses/eval_metrics.py``; mean / std /
min / max aggregation; the JSON report, an optional CSV, the per-sample
print and the steady-state samples/s line. Runs on ``cuda`` unless
``--device cpu``.

Chunks of ``--batch-size`` samples are pipelined: chunk i+1 is dispatched
before chunk i's prediction is copied to the host, and a short last chunk is
padded by repeating its last sample. Each sample's initial latents come
from ``torch.manual_seed(seed + idx)`` then ``torch.randn(ld, C, lh, lw)`` on
the CPU (the reference's stream, eval:806-810), or from ``--noise-dir``, so
the deterministic samplers give per-sample results that do not depend on the
batch size. ``--int8`` runs the samplers on ``with_vae_int8()``, whose
activation scales are taken over a whole chunk, so there a sample's result
does depend on the samples (and the padding) it is chunked with;
``--sanity-mode`` and ``--cross-mode`` call the VAE directly and stay float.
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import os
import os.path as osp
import sys
import time
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from ..losses.eval_metrics import compute_accuracy_score, compute_all_metrics

# --precision: whether cuBLAS matmuls and cuDNN convolutions may take TF32
# (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
PRECISION_ALLOWS_TF32 = {"default": True, "high": True, "highest": False}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="End-to-end evaluation of latent diffusion pipeline on test set")
    parser.add_argument("--diffusion-model-path", type=str, required=True,
                        help="Path to trained diffusion model directory")
    parser.add_argument("--vae-path", type=str, default=None)
    parser.add_argument("--vae-encoder-path", type=str, default=None)
    parser.add_argument("--vae-decoder-path", type=str, default=None)
    parser.add_argument("--dataset-dir", type=str, required=True)
    parser.add_argument("--split", type=str, default="test",
                        choices=["train", "valid", "test"])
    parser.add_argument("--index", type=int, default=None)
    parser.add_argument("--num-samples", type=int, default=None)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--sampler", type=str, default="ddim",
                        choices=["ddpm", "ddim", "dpm"],
                        help="dpm = DPM-Solver++(2M), beyond the reference: "
                             "~DDIM-50 quality in ~10 steps")
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--batch-size", type=int, default=1,
                        help="Samples predicted per dispatch (per-sample seeded noise is "
                             "preserved, so deterministic-sampler results are "
                             "batch-size-independent; ddpm needs 1)")
    parser.add_argument("--save-csv", type=str, default=None)
    parser.add_argument("--save-npz-preds", action="store_true")
    parser.add_argument("--output-dir", type=str, default=None)
    parser.add_argument("--sanity-mode", action="store_true",
                        help="VAE-ONLY mode: bypass diffusion, test VAE reconstruction only")
    parser.add_argument("--cross-mode", action="store_true",
                        help="VAE-ONLY cross path: 2D input -> E2D -> D3D, no diffusion "
                             "(the conditioning + decode ceiling between --sanity-mode and "
                             "the sampler rows)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu runs the plain versions)")
    parser.add_argument("--int8", action="store_true",
                        help="int8 frozen-VAE path for the samplers (with_vae_int8); "
                             "--sanity-mode and --cross-mode stay float")
    parser.add_argument("--use-ema", action="store_true",
                        help="Prefer ema_model.msgpack (written by train.py --ema-decay) "
                             "over best_model/model weights")
    parser.add_argument("--noise-dir", type=str, default=None,
                        help="Directory with <sample_idx>.npy initial-noise tensors "
                             "(channels-first) for exact parity with reference runs")
    parser.add_argument("--torch-noise", action="store_true",
                        help="Accepted for the JAX script's flag and changes nothing: the "
                             "initial noise always comes from torch.manual_seed(seed+idx) "
                             "then torch.randn, as in the reference (eval:806-810)")
    parser.add_argument("--precision", type=str, default=None,
                        choices=sorted(PRECISION_ALLOWS_TF32),
                        help="float32 matmul / conv precision: default and high let cuBLAS "
                             "and cuDNN use TF32, highest turns TF32 off; unset leaves "
                             "torch's settings. The hand-written kernels compute full "
                             "float32 whatever it says")
    args = parser.parse_args(argv)
    if bool(args.vae_encoder_path) != bool(args.vae_decoder_path):
        parser.error(
            "--vae-encoder-path and --vae-decoder-path must be given "
            "together (one alone would be silently ignored and the model "
            "dir's logged VAE paths used instead)")
    return args


def load_model_and_config(args):
    """The predictor of ``--diffusion-model-path`` on ``--device`` and the
    norm factors the metrics divide by: the VAE's ``vae_log.json`` ones
    where given, else statistics.json's (which then also become the
    predictor's output normalizer)."""
    from ..training.helper import get_norm_params
    from ..utils.checkpoint import (build_predictor, diffusion_weight_chain,
                                    load_diffusion_torch_checkpoint, load_predictor_state)

    with open(osp.join(args.diffusion_model_path, "log.json")) as f:
        log_data = json.load(f)
    predictor_kwargs = dict(log_data["params"]["training"]["predictor"])
    # VAE paths from the command line override the (machine-specific) logged ones
    if args.vae_path or (args.vae_encoder_path and args.vae_decoder_path):
        predictor_kwargs["vae_path"] = args.vae_path
        predictor_kwargs["vae_encoder_path"] = args.vae_encoder_path
        predictor_kwargs["vae_decoder_path"] = args.vae_decoder_path
    pred, vae_norm_factors = build_predictor(predictor_kwargs, device=args.device)

    # best_model first (reference inference.py:48-55); --use-ema prefers EMA weights
    for name in diffusion_weight_chain(use_ema=args.use_ema, folder=args.diffusion_model_path):
        path = osp.join(args.diffusion_model_path, name)
        if osp.exists(path):
            if name.endswith(".msgpack"):
                pred = load_predictor_state(pred, path)
            else:
                pred = load_diffusion_torch_checkpoint(pred, path)
            print(f"Loaded diffusion weights from {path}")
            break
    else:
        raise FileNotFoundError(f"No model weights in {args.diffusion_model_path}")

    if vae_norm_factors is not None:
        norm_factors = tuple(vae_norm_factors)
    else:
        stats_file = osp.join(args.dataset_dir, "statistics.json")
        norm_factors = tuple(get_norm_params(stats_file)["output"])
        pred = pred.set_normalizer({"output": list(norm_factors)})
    if getattr(args, "int8", False):
        # the frozen VAE's convs in dynamic int8 on the samplers' paths; the
        # VAE-only modes call the VAE directly and stay float, as in JAX
        pred = pred.with_vae_int8()
        print("int8 frozen-VAE path enabled")
    return pred, norm_factors


@torch.inference_mode()
def vae_reconstruct(pred, img: torch.Tensor, source: torch.Tensor, from_2d: bool
                    ) -> torch.Tensor:
    """The VAE-only paths: ``source`` (B,S,3,H,W) normalized with the output
    normalizer, E2D (``from_2d``, the cross path) or E3D deterministic mu,
    D3D, denormalized and masked -> (B,S,3,H,W)."""
    v = pred.normalizer["output"].normalize(source, channel_axis=2).transpose(1, 2)
    encode = pred.vae.encode_2d_deterministic if from_2d else pred.vae.encode_3d_deterministic
    mu, _ = encode(v.to(pred.compute_dtype))
    recon = pred.normalizer["output"].inverse(pred.vae.decode_3d(mu).float(), channel_axis=1)
    return recon.transpose(1, 2) * img


def sample_noise(seed: int, sample_idx: int, shape) -> torch.Tensor:
    """One sample's initial latents, (ld, C, lh, lw): the reference's
    ``torch.manual_seed(seed + idx); torch.randn(...)`` on the CPU, from a
    generator of its own (the global generator is left as it is)."""
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed + sample_idx))


def run_evaluation(predictor, test_dataset, norm_factors, *, sampler="ddim",
                   num_steps=50, seed=42, sanity_mode=False, cross_mode=False,
                   num_samples=None, single_index=None, noise_dir=None, torch_noise=False,
                   save_npz_dir=None, batch_size=1):
    """Per-sample metrics and the sanity statistics over the samples chosen
    from ``test_dataset``. ``torch_noise`` is accepted and changes nothing
    (the noise is always the reference's torch stream)."""
    del torch_noise
    if sanity_mode and cross_mode:
        raise ValueError("--sanity-mode and --cross-mode are exclusive")
    if sampler == "ddpm" and batch_size > 1:
        raise ValueError(
            "--sampler ddpm requires --batch-size 1: the ancestral noise "
            "stream is seeded per sample, which a shared batched scan cannot "
            "preserve (per-sample results would depend on batch position). "
            "Use ddim/dpm for batched evaluation.")
    per_sample_results = []
    sanity_stats = {k: [] for k in (
        "pred_min", "pred_max", "pred_mean", "pred_std",
        "target_min", "target_max", "target_mean", "target_std")}

    total_available = len(test_dataset)
    if single_index is not None:
        if not 0 <= single_index < total_available:
            raise ValueError(f"Index {single_index} out of range [0, {total_available - 1}]")
        sample_indices = [single_index]
    elif num_samples is not None:
        sample_indices = list(range(min(num_samples, total_available)))
    else:
        sample_indices = list(range(total_available))
    total = len(sample_indices)

    print("=" * 60)
    if sanity_mode:
        print(f"VAE-ONLY SANITY CHECK on {total} sample(s)  (GT -> E3D -> D3D)")
    elif cross_mode:
        print(f"VAE-ONLY CROSS CHECK on {total} sample(s)  (2D -> E2D -> D3D)")
    else:
        print(f"END-TO-END DIFFUSION EVALUATION on {total} sample(s)")
        print(f"    2D input -> E2D -> {sampler.upper()} ({num_steps} steps) -> D3D")
    print("=" * 60)

    dev = predictor.device

    def predict_fn(img, v2d, target, noise, first_idx):
        if sanity_mode:
            return vae_reconstruct(predictor, img, target, from_2d=False)
        if cross_mode:
            return vae_reconstruct(predictor, img, v2d, from_2d=True)
        if sampler == "ddim":
            return predictor.predict_ddim(img, v2d, num_steps=num_steps, eta=0.0, noise=noise)
        if sampler == "dpm":
            return predictor.predict_dpm(img, v2d, num_steps=num_steps, noise=noise)
        # the generator drives the per-step ancestral noise, seeded per sample
        gen = torch.Generator(device=dev).manual_seed(seed + first_idx)
        return predictor.predict(img, v2d, noise=noise, generator=gen)

    def _sample_noise(sample_idx, ld, lh, lw):
        """(latent_depth, C, lh, lw): the reference probes the VAE's latent
        depth (eval:793-810), so a vae_depth_factor > 1 model draws
        ld = S // factor slices."""
        if noise_dir is not None:
            return torch.from_numpy(np.load(osp.join(noise_dir, f"{sample_idx}.npy")))
        return sample_noise(seed, sample_idx, (ld, predictor.latent_channels, lh, lw))

    def _dispatch(chunk):
        """Host-side prep of a chunk and its dispatch to the device. A chunk
        shorter than batch_size is padded by repeating its last sample; the
        caller drops the padded outputs."""
        padded = list(chunk) + [chunk[-1]] * (batch_size - len(chunk))
        datas = [test_dataset[i] for i in padded]
        img = np.stack([d["microstructure"] for d in datas])
        velocity_2d = np.stack([d["velocity_input"] for d in datas])
        target = np.stack([d["velocity"] for d in datas])
        noise = None
        if not (sanity_mode or cross_mode):  # the VAE-only paths take no latents
            ld = velocity_2d.shape[1] // predictor.vae_depth_factor
            lh, lw = img.shape[-2] // 4, img.shape[-1] // 4
            noise = torch.stack([_sample_noise(i, ld, lh, lw) for i in padded]).to(dev)
        to_dev = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        pred_dev = predict_fn(to_dev(img), to_dev(velocity_2d),
                              to_dev(target) if sanity_mode else None, noise, chunk[0])
        return img, target, pred_dev

    chunks = [sample_indices[i:i + batch_size] for i in range(0, total, batch_size)]

    # Pipelined: chunk i+1 is dispatched BEFORE chunk i's result is copied to
    # the host. time_sec is the per-sample pipeline time (the gap between
    # consecutive result completions / chunk size); the first chunk's time
    # carries one-off costs, which the steady-state rate excludes.
    start_time = time.time()
    inflight = None
    last_done = start_time
    eval_idx = 0
    for step in range(len(chunks) + 1):
        nxt = None
        if step < len(chunks):
            chunk = chunks[step]
            img, target, pred_dev = _dispatch(chunk)
            nxt = (chunk, img, target, pred_dev)
        if inflight is None:
            inflight = nxt
            continue
        chunk, img, target, pred_dev = inflight
        inflight = nxt

        predictions = pred_dev.cpu().numpy()  # waits for the device
        now = time.time()
        sample_time = (now - last_done) / len(chunk)
        last_done = now

        if predictions.shape[1:] != target.shape[1:]:
            raise RuntimeError(f"Shape mismatch: pred {predictions.shape} vs target "
                               f"{target.shape}")
        for j, sample_idx in enumerate(chunk):
            prediction = predictions[j:j + 1]
            target_np = target[j:j + 1]
            metrics = compute_all_metrics(prediction, target_np, norm_factors,
                                          mask=img[j:j + 1], compute_optional=True)
            metrics["sample_id"] = sample_idx
            metrics["time_sec"] = sample_time
            metrics["accuracy_score"] = compute_accuracy_score(metrics["nmae_total"])
            per_sample_results.append(metrics)

            if save_npz_dir is not None:
                np.savez(osp.join(save_npz_dir, f"pred_{sample_idx:04d}.npz"),
                         prediction=prediction, target=target_np)

            sanity_stats["pred_min"].append(float(prediction.min()))
            sanity_stats["pred_max"].append(float(prediction.max()))
            sanity_stats["pred_mean"].append(float(prediction.mean()))
            sanity_stats["pred_std"].append(float(prediction.std()))
            sanity_stats["target_min"].append(float(target_np.min()))
            sanity_stats["target_max"].append(float(target_np.max()))
            sanity_stats["target_mean"].append(float(target_np.mean()))
            sanity_stats["target_std"].append(float(target_np.std()))

            eval_idx += 1
            elapsed = time.time() - start_time
            samples_per_sec = eval_idx / elapsed if elapsed > 0 else 0
            mode_prefix = ("[VAE]" if sanity_mode
                           else "[XVAE]" if cross_mode else "[DIFF]")
            print(f"{mode_prefix} Sample {sample_idx:4d} ({eval_idx}/{total}) | "
                  f"nMAE={metrics['nmae_total']:.4f} | "
                  f"Acc={metrics['accuracy_score']:.4f} | "
                  f"Time={sample_time:.2f}s | "
                  f"Speed={samples_per_sec:.2f} samples/sec")

    total_time = time.time() - start_time
    print(f"\nTotal evaluation time: {total_time:.2f}s")
    print(f"Average time per sample: {total_time / max(1, len(per_sample_results)):.2f}s")
    steady = steady_seconds(per_sample_results, len(chunks[0]) if chunks else 0)
    if steady is not None:
        print(f"Steady-state (excl. first chunk): {steady:.2f}s/sample "
              f"({1.0 / max(steady, 1e-9):.2f} samples/sec)")
    return per_sample_results, sanity_stats


def steady_seconds(per_sample_results, first_chunk: int) -> Optional[float]:
    """Mean ``time_sec`` of the samples after the first chunk of
    ``first_chunk`` samples (None when there is no later one): the first
    chunk carries one-off costs."""
    if not per_sample_results or len(per_sample_results) <= first_chunk:
        return None
    return float(np.mean([r["time_sec"] for r in per_sample_results[first_chunk:]]))


def aggregate_results(per_sample_results):
    if not per_sample_results:
        return {}
    keys = [k for k in per_sample_results[0] if k != "sample_id"]
    out = {}
    for key in keys:
        vals = [r[key] for r in per_sample_results if key in r]
        if vals:
            out[f"{key}_mean"] = float(np.mean(vals))
            out[f"{key}_std"] = float(np.std(vals))
            out[f"{key}_min"] = float(np.min(vals))
            out[f"{key}_max"] = float(np.max(vals))
    return out


def save_results(per_sample_results, aggregated, sanity_stats, args, output_dir):
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    mode_str = ("vae_only" if args.sanity_mode
                else "vae_cross" if args.cross_mode
                else f"diffusion_{args.sampler}_{args.steps}steps")
    results = {
        "timestamp": timestamp,
        "evaluation_mode": ("VAE_ONLY_SANITY_CHECK" if args.sanity_mode
                            else "VAE_CROSS_CHECK" if args.cross_mode
                            else "END_TO_END_DIFFUSION"),
        "pipeline": ("GT -> E3D -> D3D -> compare" if args.sanity_mode
                     else "2D input -> E2D -> D3D -> compare" if args.cross_mode
                     else f"2D input -> E2D -> {args.sampler.upper()} ({args.steps} steps) "
                          "-> D3D -> compare"),
        "args": vars(args),
        "summary": aggregated,
        "sanity_stats": {k: {"mean": float(np.mean(v)), "std": float(np.std(v))}
                         for k, v in sanity_stats.items()},
        "accuracy_definition": "Accuracy = 1 / (1 + normalized_MAE_total), bounded in (0, 1], "
                               "higher is better",
        "per_sample_results": per_sample_results,
    }
    json_path = osp.join(output_dir, f"eval_results_{mode_str}_{timestamp}.json")
    with open(json_path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"\nResults saved to: {json_path}")

    if args.save_csv:
        csv_path = (args.save_csv if osp.isabs(args.save_csv)
                    else osp.join(output_dir, args.save_csv))
        os.makedirs(osp.dirname(csv_path) or ".", exist_ok=True)
        fieldnames = ["sample_id", "mae_u", "mae_v", "mae_w", "nmae_total",
                      "rmse_total", "cosine_similarity", "iou_top10", "time_sec",
                      "accuracy_score"]
        with open(csv_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=fieldnames, extrasaction="ignore")
            writer.writeheader()
            writer.writerows(per_sample_results)
        print(f"CSV saved to: {csv_path}")
    return json_path


@dataclasses.dataclass
class Result:
    per_sample: list
    aggregated: dict
    sanity: dict
    json_path: str
    predictor: object
    steady_seconds: Optional[float]  # per sample after the first chunk; None with one chunk
    args: argparse.Namespace


def run(argv=None) -> Result:
    """Parse ``argv``, load the run dir, evaluate the chosen split and write
    the report."""
    args = parse_args(argv)
    if args.precision:
        allow = PRECISION_ALLOWS_TF32[args.precision]
        torch.backends.cuda.matmul.allow_tf32 = allow
        torch.backends.cudnn.allow_tf32 = allow
    from ..data import get_loader

    loaders = get_loader(root_dir=args.dataset_dir, batch_size=args.batch_size,
                         use_3d=True, seed=2024)
    train_loader, val_loader, test_loader = loaders[0]
    dataset = {"train": train_loader, "valid": val_loader,
               "test": test_loader}[args.split].dataset
    predictor, norm_factors = load_model_and_config(args)
    print(f"Normalization factors (max_u, max_v, max_w): {norm_factors}")

    output_dir = args.output_dir or args.diffusion_model_path
    os.makedirs(output_dir, exist_ok=True)
    npz_dir = None
    if args.save_npz_preds:
        npz_dir = osp.join(output_dir, "predictions_npz")
        os.makedirs(npz_dir, exist_ok=True)

    batch_size = max(1, args.batch_size)
    per_sample, sanity = run_evaluation(
        predictor, dataset, norm_factors,
        sampler=args.sampler, num_steps=args.steps, seed=args.seed,
        sanity_mode=args.sanity_mode, cross_mode=args.cross_mode,
        num_samples=args.num_samples, single_index=args.index, noise_dir=args.noise_dir,
        torch_noise=args.torch_noise, save_npz_dir=npz_dir, batch_size=batch_size)
    aggregated = aggregate_results(per_sample)

    print("\n--- Total Metrics ---")
    print(f"  nMAE_total: {aggregated.get('nmae_total_mean', 0):.6f} "
          f"+/- {aggregated.get('nmae_total_std', 0):.6f}")
    print(f"  Accuracy = 1/(1+nMAE_total) = {aggregated.get('accuracy_score_mean', 0):.4f}")
    json_path = save_results(per_sample, aggregated, sanity, args, output_dir)
    steady = steady_seconds(per_sample, batch_size)
    return Result(per_sample, aggregated, sanity, json_path, predictor, steady, args)


def main(argv=None):
    run(argv)


if __name__ == "__main__":
    main(sys.argv[1:])
