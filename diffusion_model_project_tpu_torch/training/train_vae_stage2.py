"""Stage-2 VAE trainer: E2D + D2D with alignment and cross-reconstruction
(the port's copy of the JAX package's ``training/train_vae_stage2.py``,
after the reference VAE_model/train_2d_with_cross.py).

Same behaviour:
  - ``PairedDataset`` yields the 2D and 3D views of one microstructure;
  - the stage-1 E3D / D3D are loaded and FROZEN (gradients flow into E2D
    through the frozen D3D in the cross loss), their checksums verified
    every epoch;
  - per-batch losses:
      recon_2d = per-channel loss of the deterministic E2D -> D2D
      align    = MSE(mu2d, mu3d) + 0.1 * (1 - cos over channels), mu3d
                 without a gradient
      cross    = loss(D3D(mu2d) * mask3d, target3d * mask3d)
      total    = recon_2d + lambda_align * align + lambda_cross * cross
    (published recipe: lambda_align 5, lambda_cross 50; the defaults 0.1 /
    1.0 are the reference's);
  - gradient accumulation with the clip-after-every-backward semantics of
    ``training/accum.py`` and ``optax.adam``'s update; no KL term;
  - ``model.msgpack`` / ``best_model.msgpack`` (all four branches),
    ``vae_log.json`` with the norm factors and lambdas, and
    ``train_state.msgpack`` (full-state ``--resume``).

The loss is deterministic. It departs from the JAX trainer as stage 1's
does (``train_vae_stage1.py``): eager microbatches over the resident or
streamed batches, the bad-batch flag read at a boundary, one device.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys
import time

import numpy as np
import torch

from ..data.dataset import MicroFlowDatasetVAE, NumpyLoader
from ..models.layers import train_trace
from ..models.vae import DualBranchVAE, features_from_decoder_state
from ..utils import flax_msgpack
from ..utils import torch_import as ti
from ..utils.async_ckpt import AsyncCheckpointWriter
from ..utils.checkpoint import (host_copy, load_strict, load_vae_params, save_tree,
                                vae_params, vae_state_dicts)
from ..utils.config import str_to_bool
from ..utils.device import resolve_device
from .train_vae_stage1 import (LOSS_FUNCTIONS, AccumAdam, build_device_store, fetch_metrics,
                               loader_batches, loader_shuffle_order, norm_factors_from_stats,
                               store_batches, torch_random_split_indices)

TRAINABLE = ("encoder_2d", "decoder_2d")
FROZEN = ("encoder_3d", "decoder_3d")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train 2D VAE with alignment and cross-reconstruction (Stage 2)")
    parser.add_argument("--dataset-dir", type=str, required=True)
    parser.add_argument("--save-dir", type=str, default="trained/dual_vae_stage2_2d")
    parser.add_argument("--stage1-checkpoint", type=str, required=True,
                        help="Path to stage 1 checkpoint dir (E3D+D3D)")
    parser.add_argument("--in-channels", type=int, default=3)
    parser.add_argument("--latent-channels", type=int, default=8)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--num-epochs", type=int, default=50)
    parser.add_argument("--learning-rate", type=float, default=5e-5)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a CUDA device) or cpu")
    parser.add_argument("--augment", action="store_true")
    parser.add_argument("--loss-function", type=str, default="normalized_mae_per_channel",
                        choices=sorted(LOSS_FUNCTIONS))
    parser.add_argument("--beta-kl", type=float, default=1e-3,
                        help="logged as kl_coeff; the stage-2 KL term is 0")
    parser.add_argument("--lambda-align", type=float, default=0.1)
    parser.add_argument("--lambda-cross", type=float, default=1.0)
    parser.add_argument("--norm-mode", type=str, default="max", choices=["max", "mean"])
    parser.add_argument("--grad-accum", type=int, default=5)
    parser.add_argument("--seed", type=int, default=2024)
    parser.add_argument("--data-parallel", type=str_to_bool, default=True,
                        help="data parallelism is not ported: one device trains "
                             "whatever this says")
    parser.add_argument("--resume", action="store_true",
                        help="continue from save-dir/train_state.msgpack (trainable "
                             "params, optimizer moments, the cross-epoch accumulated-"
                             "grad buffer, epoch and best-loss counters)")
    parser.add_argument("--cache-data", default="auto", choices=["auto", "true", "false"],
                        help="keep the normalized TRAIN pair volumes resident on the "
                             "device (the shared microstructure once, as uint8) and "
                             "gather batches there in the loader's shuffle order; "
                             "validation streams. Incompatible with --augment")
    parser.add_argument("--cache-data-cap-gb", type=float, default=0.5,
                        help="--cache-data auto threshold on the resident bytes (train split)")
    parser.add_argument("--ckpt-freq", type=int, default=1,
                        help="write the checkpoint set every N epochs (default 1, the "
                             "reference contract); the final epoch, a new best on the "
                             "grid and a graceful stop always write")
    parser.add_argument("--tensorboard", type=str_to_bool, nargs="?", const=True,
                        default=False,
                        help="mirror the vae_log.json loss scalars into TensorBoard "
                             "events under <save-dir>/tb/")
    return parser.parse_args(argv)


def load_stage1_params(folder: str) -> dict:
    """The stage-1 E3D / D3D as state dicts ``{'encoder_3d': sd,
    'decoder_3d': sd}`` from native msgpack or a reference ``.pt``;
    ``best_model`` first, like the reference stage-2 trainer
    (train_2d_with_cross.py:249-252) and the split encoder / decoder loaders
    of ``utils/checkpoint.py``: one stage-1 dir gives the same weights to
    stage-2 training and to the diffusion side."""
    for name in ("best_model.msgpack", "vae.msgpack", "model.msgpack"):
        path = osp.join(folder, name)
        if osp.exists(path):
            state = flax_msgpack.load(path)
            return vae_state_dicts({b: state[b] for b in FROZEN}, path)
    sd = ti.load_torch_state_dict(ti.find_model_file(
        folder, ("best_model.pt", "vae.pt", "model.pt")))
    flavor = ti.detect_vae_checkpoint_type(sd)
    if flavor in ("dual_stage1_3d", "dual_full"):
        prefixes = ("encoder_3d.", "decoder_3d.")
    elif flavor == "standard":
        prefixes = ("encoder.", "decoder.")
    else:
        raise ValueError(f"Unsupported stage-1 checkpoint flavor: {flavor}")
    return {b: ti.vae_branch_state_dict(ti.strip_prefix(sd, p), decoder=b.startswith("decoder"))
            for b, p in zip(FROZEN, prefixes)}


def checksum(module: torch.nn.Module) -> float:
    """Sum of the per-tensor sums, one host fetch."""
    return float(torch.stack([p.detach().sum() for p in module.parameters()])
                 .to(torch.float64).sum())


class PairedDataset:
    """Returns the 2D and 3D views of the same microstructure."""

    def __init__(self, base: MicroFlowDatasetVAE, paired_indices):
        self.base = base
        self.paired_indices = paired_indices

    def __len__(self):
        return len(self.paired_indices)

    def set_epoch(self, epoch):  # deterministic-resume augmentation
        self.base.set_epoch(epoch)

    def __getitem__(self, idx):
        idx_2d, idx_3d = self.paired_indices[idx]
        s2d = self.base[idx_2d]
        s3d = self.base[idx_3d]
        if int(s2d["original_idx"]) != int(s3d["original_idx"]):
            raise AssertionError(
                f"Pairing mismatch: 2D={s2d['original_idx']}, 3D={s3d['original_idx']}")
        return {
            "velocity_2d": s2d["velocity"], "mask_2d": s2d["microstructure"],
            "velocity_3d": s3d["velocity"], "mask_3d": s3d["microstructure"],
        }


def make_loss_fn(vae: DualBranchVAE, loss_name: str, lambda_align: float,
                 lambda_cross: float):
    """losses(batch) -> (total, metrics) on a paired batch (channels-first,
    normalized velocities); the metrics stay on the device."""
    loss_fn = LOSS_FUNCTIONS[loss_name]

    def losses(batch):
        x2d, m2d = batch["velocity_2d"], batch["mask_2d"]
        x3d, m3d = batch["velocity_3d"], batch["mask_3d"]

        # loss 1: deterministic 2D reconstruction
        recon2d, mu2d = vae.forward_2d_deterministic(x2d)
        recon_loss = loss_fn(recon2d * m2d, x2d * m2d, mask=m2d)

        # loss 2: latent alignment; the frozen E3D's mu3d needs no gradient
        with torch.no_grad():
            mu3d, _ = vae.encode_3d_deterministic(x3d)
        # cosine similarity over the channel axis 1
        dot = torch.sum(mu2d * mu3d, dim=1)
        denom = (torch.linalg.vector_norm(mu2d, dim=1) * torch.linalg.vector_norm(mu3d, dim=1)
                 + 1e-8)
        cos = torch.mean(dot / denom)
        align_loss = torch.mean(torch.square(mu2d - mu3d)) + 0.1 * (1.0 - cos)

        # loss 3: cross reconstruction through the frozen D3D
        cross = vae.decode_3d(mu2d)
        cross_loss = loss_fn(cross * m3d, x3d * m3d, mask=m3d)

        total = recon_loss + lambda_align * align_loss + lambda_cross * cross_loss
        return total, {"recons_2d": recon_loss.detach(), "align": align_loss.detach(),
                       "cross": cross_loss.detach(), "kl_2d": torch.zeros_like(total.detach()),
                       "bad": ~torch.isfinite(mu2d).all()}

    return losses


def make_steps(vae: DualBranchVAE, loss_name: str, optimizer: AccumAdam,
               lambda_align: float, lambda_cross: float, accum_steps: int = 5):
    """(train_step, apply_step, eval_step), as stage 1's ``make_steps``:
    train_step(batch, boundary) runs one microbatch inside ``train_trace()``
    with the optimizer step on the boundary of a good batch."""
    losses = make_loss_fn(vae, loss_name, lambda_align, lambda_cross)

    def train_step(batch, boundary):
        with train_trace():
            total, metrics = losses(batch)
            grads = torch.autograd.grad(total, optimizer.params, materialize_grads=True)
        optimizer.accumulate(grads, ~metrics["bad"], accum_steps)
        # the host reads the flag at a boundary only: one sync per window
        if boundary and not bool(metrics["bad"]):
            optimizer.apply()
        return metrics

    @torch.no_grad()
    def eval_step(batch):
        return losses(batch)[1]

    return train_step, optimizer.apply, eval_step


def scan_train_metrics(metricses, keys=("recons_2d", "align", "cross", "kl_2d")):
    """Replay the reference's per-batch host decisions over an epoch's
    fetched metrics (train_2d_with_cross.py:433-454): skipped (NaN) batches
    are left out of the running sums. Returns (sums_dict, skipped_indices)."""
    running = {k: 0.0 for k in keys}
    skipped = []
    for bi, m in enumerate(metricses):
        if bool(m["bad"]):
            skipped.append(bi)
        else:
            for k in keys:
                running[k] += float(m[k])
    return running, skipped


def _gather(store: dict, idx: torch.Tensor) -> dict:
    # the shared per-pair microstructure is stored once as uint8 (0/1);
    # the cast back is exact and fills both mask slots
    mask = store["mask"].index_select(0, idx).to(torch.float32)
    return {"velocity_2d": store["velocity_2d"].index_select(0, idx), "mask_2d": mask,
            "velocity_3d": store["velocity_3d"].index_select(0, idx), "mask_3d": mask}


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    print("=" * 60 + "\nSTAGE 2: Training E2D + D2D with alignment + cross\n" + "=" * 60)
    if not os.path.exists(args.stage1_checkpoint):
        print(f"ERROR: Stage 1 checkpoint not found: {args.stage1_checkpoint}")
        sys.exit(1)
    os.makedirs(args.save_dir, exist_ok=True)

    base = MicroFlowDatasetVAE(args.dataset_dir, augment=args.augment)
    n = base.num_microstructures
    pairs = [(i, i + n) for i in range(n)]
    train_size = int(0.7 * n)
    val_size = int(0.15 * n)
    test_size = n - train_size - val_size
    tr, va, te = torch_random_split_indices(n, (train_size, val_size, test_size),
                                            seed=args.seed)
    mk = lambda idx, sh: NumpyLoader(  # noqa: E731
        PairedDataset(base, [pairs[i] for i in idx]), args.batch_size, shuffle=sh,
        seed=args.seed)
    train_loader, val_loader = mk(tr, True), mk(va, False)
    print(f"Train pairs: {train_size}, Val pairs: {val_size}, Test pairs: {test_size}")

    with open(osp.join(args.dataset_dir, "statistics.json")) as f:
        statistics = json.load(f)
    norm_factors = norm_factors_from_stats(statistics, args.norm_mode)
    nf = norm_factors.reshape(1, 3, 1, 1, 1)

    # the stage widths come from the stage-1 weights (the fresh E2D / D2D
    # must share them for the latent spaces to align)
    frozen = load_stage1_params(args.stage1_checkpoint)
    features = features_from_decoder_state(frozen["decoder_3d"])
    vae = DualBranchVAE(in_channels=args.in_channels, latent_channels=args.latent_channels,
                        features=features)
    vae.init_parameters_(torch.Generator().manual_seed(args.seed))
    for name, sd in frozen.items():
        load_strict(getattr(vae, name), sd, f"{name} from {args.stage1_checkpoint}")
        getattr(vae, name).requires_grad_(False)
    # stage 2 differentiates through E2D, D2D and the frozen D3D at full
    # resolution: their blocks are recomputed in backward, not stored
    vae.encoder_2d.remat = vae.decoder_2d.remat = vae.decoder_3d.remat = True
    vae.to(device)
    e3d_checksum = checksum(vae.encoder_3d)
    d3d_checksum = checksum(vae.decoder_3d)
    print(f"Loaded + froze stage-1 E3D/D3D (checksums {e3d_checksum:.6f}/{d3d_checksum:.6f})")
    # the frozen branches of every weights file, copied to the host once
    frozen_tree = host_copy(vae_params(vae, FROZEN))

    optimizer = AccumAdam(vae, args.learning_rate)
    train_step, apply_step, eval_step = make_steps(
        vae, args.loss_function, optimizer, args.lambda_align, args.lambda_cross,
        accum_steps=args.grad_accum)

    log_dict = {
        "loss": {"recons_2d_train": [], "recons_2d_val": [], "kl_2d_train": [],
                 "kl_2d_val": [], "align_train": [], "align_val": [],
                 "cross_train": [], "cross_val": [], "kl_coeff": []},
        "in_channels": args.in_channels,
        "latent_channels": args.latent_channels,
        "features": list(features),  # informational; loaders derive from the weights
        "model_type": "dual",
        "norm_mode": args.norm_mode,
        "norm_factors": norm_factors.tolist(),
        "lambda_align": args.lambda_align,
        "lambda_cross": args.lambda_cross,
        "beta_kl": args.beta_kl,
        "loss_function": args.loss_function,
        "epoch_time": [],  # wall seconds an epoch (the reference's log has none)
    }
    best_val_loss = float("inf")

    def normalize(b):
        return {"velocity_2d": b["velocity_2d"] / nf, "mask_2d": b["mask_2d"],
                "velocity_3d": b["velocity_3d"] / nf, "mask_3d": b["mask_3d"]}

    ckpt_writer = AsyncCheckpointWriter()

    def save(path):
        # all four branches: the trainable ones copied on the device now,
        # the frozen host copy as it is
        save_tree(path, {**vae_params(vae, TRAINABLE), **frozen_tree}, ckpt_writer)

    start_epoch = 0
    state_path = osp.join(args.save_dir, "train_state.msgpack")
    if args.resume:
        state = flax_msgpack.load(state_path)
        load_vae_params(vae, state["trainable"], state_path, TRAINABLE)
        optimizer.load(state["opt_state"], state["g_acc"], state_path)
        start_epoch = int(state["epoch"]) + 1
        best_val_loss = float(state["best_val_loss"])
        with open(osp.join(args.save_dir, "vae_log.json")) as f:
            prev = json.load(f)
        for key in log_dict["loss"]:
            log_dict["loss"][key] = prev["loss"].get(key, [])[:start_epoch]
        log_dict["epoch_time"] = prev.get("epoch_time", [])[:start_epoch]
        print(f"Resumed from {state_path} at epoch {start_epoch} "
              f"(best val loss {best_val_loss:.6f})")

    # best among epochs whose checkpoint actually wrote (--ckpt-freq gating)
    best_saved_loss = best_val_loss

    from ..utils.tb import TensorBoardLogger
    tb = TensorBoardLogger(osp.join(args.save_dir, "tb") if args.tensorboard else None,
                           purge_step=start_epoch if args.resume else None)

    if args.data_parallel and device.type == "cuda" and torch.cuda.device_count() > 1:
        print(f"Data parallelism is not ported (ROADMAP.md Queue 1 item 8): "
              f"training on {device} alone")

    # --cache-data: the train split's normalized pair volumes resident on the
    # device, the shared microstructure once as uint8; validation streams
    sample0 = base[0]
    sample_bytes = (2 * sample0["velocity"].nbytes + sample0["microstructure"].nbytes // 4)
    est_bytes = train_size * sample_bytes
    cache_data = (args.cache_data == "true"
                  or (args.cache_data == "auto"
                      and est_bytes <= args.cache_data_cap_gb * 2**30))
    if args.augment and cache_data:
        if args.cache_data == "true":
            raise ValueError(
                "--cache-data true is incompatible with --augment (flips "
                "are applied host-side in the streaming path); drop one")
        cache_data = False
    train_store = None
    if cache_data:
        t0s = time.time()
        nf0 = nf[0]  # (3, 1, 1, 1): per-sample == batched divide
        tx = lambda s: {  # noqa: E731
            "velocity_2d": (s["velocity_2d"] / nf0).astype(np.float32),
            "velocity_3d": (s["velocity_3d"] / nf0).astype(np.float32),
            "mask": s["mask_3d"].astype(np.uint8)}
        train_store = build_device_store(train_loader.dataset, tx, device)
        mb = sum(v.numel() * v.element_size() for v in train_store.values()) / 2**20
        print(f"Device data store: {train_size} train pairs, {mb:.0f} MB resident "
              f"(val streams; {time.time() - t0s:.1f}s one-time build+upload)")
    elif args.cache_data == "auto" and not args.augment:
        print(f"--cache-data auto: {est_bytes / 2**30:.1f} GB exceeds the "
              f"{args.cache_data_cap_gb:.1f} GB cap; streaming batches")

    def train_batches(epoch):
        if cache_data:
            return store_batches(train_store, loader_shuffle_order(
                train_size, args.seed, epoch, shuffle=True), args.batch_size, _gather)
        return loader_batches(train_loader, normalize, device)

    from ..utils.preempt import GracefulShutdown
    preempted = False
    with GracefulShutdown() as shutdown:
        for epoch in range(start_epoch, args.num_epochs):
            t0 = time.time()
            # deterministic resume: the shuffle order and the augmentation
            # draws are pure functions of (seed, epoch); the losses draw nothing
            for loader in (train_loader, val_loader):
                loader.set_epoch(epoch)
            kl_coeff = args.beta_kl  # the KL term itself is 0 in stage 2
            metricses = []
            i = -1
            for i, batch in enumerate(train_batches(epoch)):
                if shutdown.requested:
                    preempted = True
                    break
                metricses.append(train_step(batch, (i + 1) % args.grad_accum == 0))
            if preempted:
                break  # partial epoch discarded; state is at the last boundary
            running, skipped_batches = scan_train_metrics(fetch_metrics(metricses))
            for bi in skipped_batches:
                print(f"WARNING: NaN/Inf in mean_2d at batch {bi}")
            if i >= 0 and (i + 1) % args.grad_accum != 0:
                apply_step()
            num_train = max(i + 1, 1)

            val_metricses = []
            j = -1
            for j, batch in enumerate(loader_batches(val_loader, normalize, device)):
                if shutdown.requested:
                    preempted = True
                    break
                val_metricses.append(eval_step(batch))
            if preempted:
                break
            val = {"recons_2d": 0.0, "align": 0.0, "cross": 0.0, "kl_2d": 0.0}
            for m in fetch_metrics(val_metricses):
                for k in val:
                    val[k] += float(m[k])
            num_val = max(j + 1, 1)

            for k in ("recons_2d", "kl_2d", "align", "cross"):
                log_dict["loss"][f"{k}_train"].append(running[k] / num_train)
                log_dict["loss"][f"{k}_val"].append(val[k] / num_val)
            log_dict["loss"]["kl_coeff"].append(kl_coeff)
            log_dict["epoch_time"].append(time.time() - t0)
            tb.add_scalars(epoch, {k: v[-1] for k, v in log_dict["loss"].items()},
                           prefix="loss/")

            # frozen-weight checksums (reference train_2d_with_cross.py:602-608)
            if abs(checksum(vae.encoder_3d) - e3d_checksum) > 1e-5:
                print("  WARNING: E3D weights changed!")
            if abs(checksum(vae.decoder_3d) - d3d_checksum) > 1e-5:
                print("  WARNING: D3D weights changed!")

            current_val_loss = (val["recons_2d"] / num_val
                                + kl_coeff * val["kl_2d"] / num_val
                                + args.lambda_align * val["align"] / num_val
                                + args.lambda_cross * val["cross"] / num_val)
            # best tracked every epoch; the write is best-on-grid under --ckpt-freq
            if current_val_loss < best_val_loss:
                best_val_loss = current_val_loss
            ckpt_freq = max(1, int(args.ckpt_freq or 1))
            save_this_epoch = epoch % ckpt_freq == 0 or epoch == args.num_epochs - 1

            def write_checkpoint_set():
                nonlocal best_saved_loss
                save(osp.join(args.save_dir, "model.msgpack"))
                if current_val_loss < best_saved_loss:
                    best_saved_loss = current_val_loss
                    save(osp.join(args.save_dir, "best_model.msgpack"))
                # FIFO order weights -> vae_log.json -> train_state.msgpack:
                # the resume state can lag the log by one epoch, never lead it
                ckpt_writer.submit(osp.join(args.save_dir, "vae_log.json"),
                                   json.dumps(log_dict, indent=2).encode(), serialize=bytes)
                save_tree(state_path, {
                    "trainable": vae_params(vae, TRAINABLE),
                    "opt_state": optimizer.state_tree(),
                    "g_acc": optimizer.g_acc_tree(),
                    "epoch": np.asarray(epoch, np.int64),
                    "best_val_loss": np.asarray(best_val_loss, np.float64),
                }, ckpt_writer)

            if save_this_epoch:
                write_checkpoint_set()
            print(f"Epoch {epoch + 1}/{args.num_epochs}: "
                  f"recons2d {running['recons_2d'] / num_train:.6f}/"
                  f"{val['recons_2d'] / num_val:.6f} "
                  f"align {running['align'] / num_train:.6f} "
                  f"cross {running['cross'] / num_train:.6f} time {time.time() - t0:.1f}s")
            if shutdown.requested:
                # a graceful stop leaves THIS epoch on disk even when
                # --ckpt-freq gated the regular write above
                if not save_this_epoch:
                    write_checkpoint_set()
                preempted = True
                break

    try:
        ckpt_writer.close()  # every queued write landed (or raises its failure)
    finally:
        tb.close()

    if preempted and osp.exists(state_path):
        print(f"Preempted; completed epochs are on disk. Resume with:\n"
              f"  --save-dir {args.save_dir} --resume", flush=True)
    return vae, log_dict
