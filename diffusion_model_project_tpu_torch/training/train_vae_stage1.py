"""Stage-1 VAE trainer: E3D + D3D on 3D velocity samples only (the port's
copy of the JAX package's ``training/train_vae_stage1.py``, after the
reference VAE_model/train_3d_vae_only.py).

Same behaviour:
  - the 3D-only subset of MicroFlowDatasetVAE (indices >= N), 70/15/15 split
    with ``torch.Generator().manual_seed(seed)`` membership;
  - per-component norm factors = max over the U and U_2d statistics;
  - KL annealing 1e-5 -> ``--max-kl-coeff`` over the warm-up epochs; mean-form KL;
  - gradient accumulation with the reference's clip-after-every-backward
    semantics (``training/accum.py``) and ``optax.adam``'s update
    (``torch.optim.Adam``, no weight decay);
  - mask-multiplied predictions and targets before the per-channel loss;
  - NaN/Inf health checks (skip batch) and the KL-explosion abort (> 1000,
    exit 1);
  - per-epoch ``vae.msgpack`` + ``vae_log.json``, ``best_model.msgpack`` on
    the validation loss and ``train_state.msgpack`` (full-state
    ``--resume``), all in the JAX package's formats.

Where it departs from the JAX trainer: the microbatch runs eagerly, and
``--cache-data`` keeps the normalized volumes resident on the device and runs
the same per-step loop over them (JAX fuses the epoch into one ``lax.scan``
to cut its dispatch); the host reads a microbatch's bad-batch flag at an
accumulation boundary only, to decide the optimizer step; one device trains
(no mesh); the reparameterization noise comes from a ``torch.Generator``
seeded from (seed + 1, epoch), drawn in the JAX trainer's order (the train
batches, then the validation batches), so a resumed run and a cached one
draw exactly what the uninterrupted streamed run drew.
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
from torch import nn

from ..data.dataset import MicroFlowDatasetVAE, NumpyLoader
from ..losses.metrics import (kl_divergence, mae_loss_per_channel,
                              normalized_mae_loss_per_channel, normalized_mse_per_channel)
from ..models.layers import init_module_, train_trace
from ..models.vae import (REFERENCE_FEATURES, Decoder, Encoder, _clamp_logvar, reparameterize,
                          validate_features)
from ..utils import flax_msgpack, weights
from ..utils.async_ckpt import AsyncCheckpointWriter
from ..utils.checkpoint import load_vae_params, save_tree, vae_params, vae_state_dicts
from ..utils.config import str_to_bool
from ..utils.device import resolve_device
from .accum import accumulate_clipped
from .train_diffusion import epoch_generator

LOSS_FUNCTIONS = {
    "mae_per_channel": mae_loss_per_channel,
    "normalized_mae_per_channel": normalized_mae_loss_per_channel,
    "normalized_mse_per_channel": normalized_mse_per_channel,
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train 3D VAE only (Stage 1)")
    parser.add_argument("--dataset-dir", type=str, required=True)
    parser.add_argument("--save-dir", type=str, default="trained/dual_vae_stage1_3d")
    parser.add_argument("--in-channels", type=int, default=3)
    parser.add_argument("--latent-channels", type=int, default=8)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--num-epochs", type=int, default=100)
    parser.add_argument("--learning-rate", type=float, default=1e-4)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a CUDA device) or cpu")
    parser.add_argument("--augment", action="store_true")
    parser.add_argument("--loss-function", type=str, default="normalized_mae_per_channel",
                        choices=sorted(LOSS_FUNCTIONS))
    parser.add_argument("--norm-mode", type=str, default="max", choices=["max", "mean"])
    parser.add_argument("--conditional", action="store_true",
                        help="accepted for the reference's CLI; stage 1 trains the "
                             "unconditional E3D + D3D whatever it says")
    parser.add_argument("--debug-latent", action="store_true")
    parser.add_argument("--debug-batches", type=int, default=3)
    parser.add_argument("--kl-warmup-epochs", type=int, default=10)
    parser.add_argument("--max-kl-coeff", type=float, default=1e-3)
    parser.add_argument("--grad-accum", type=int, default=10)
    parser.add_argument("--seed", type=int, default=2024)
    parser.add_argument("--features", type=int, nargs=3, default=None,
                        help="stage widths (default: the reference's hardwired "
                             "128 256 512; each must divide by the GroupNorm's 32 groups)")
    parser.add_argument("--resume", action="store_true",
                        help="continue from save-dir/train_state.msgpack (params, "
                             "optimizer moments, the cross-epoch accumulated-grad "
                             "buffer, epoch and best-loss counters)")
    parser.add_argument("--cache-data", default="auto", choices=["auto", "true", "false"],
                        help="keep the normalized train/val volumes resident on the "
                             "device and gather batches there in the loader's shuffle "
                             "order (same batches, same numbers as streaming). 'auto' "
                             "caches when they fit the cap; incompatible with --augment "
                             "(host-side flips)")
    parser.add_argument("--cache-data-cap-gb", type=float, default=4.0,
                        help="--cache-data auto threshold on the resident bytes (train+val)")
    parser.add_argument("--ckpt-freq", type=int, default=1,
                        help="write the checkpoint set every N epochs (default 1, the "
                             "reference contract); the final epoch, a new best on the "
                             "grid and a graceful stop always write")
    parser.add_argument("--data-parallel", type=str_to_bool, default=True,
                        help="data parallelism is not ported: one device trains "
                             "whatever this says")
    parser.add_argument("--tensorboard", type=str_to_bool, nargs="?", const=True,
                        default=False,
                        help="mirror the vae_log.json loss scalars into TensorBoard "
                             "events under <save-dir>/tb/")
    return parser.parse_args(argv)


def torch_random_split_indices(n: int, sizes, seed: int = 2024):
    """``torch.utils.data.random_split`` membership: a permutation from a CPU
    generator whatever the training device, so the split is the JAX
    trainer's (and the reference's)."""
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed)).tolist()
    out, ofs = [], 0
    for size in sizes:
        out.append(perm[ofs:ofs + size])
        ofs += size
    return out


def norm_factors_from_stats(stats: dict, norm_mode: str = "max") -> np.ndarray:
    """Per-component normalization = max over U and U_2d stats per channel
    (reference train_3d_vae_only.py:203-251)."""
    if "U_per_component" in stats:
        pc = stats["U_per_component"]
        pc2 = stats.get("U_2d_per_component", {})
        if norm_mode == "max":
            return np.array([
                max(pc["max_u"], pc2.get("max_u", 0)),
                max(pc["max_v"], pc2.get("max_v", 0)),
                max(pc["max_w"], pc2.get("max_w", 0)),
            ], np.float32)
        return np.array([
            max(pc.get("mean_u", pc["max_u"]), pc2.get("mean_u", pc2.get("max_u", 0))),
            max(pc.get("mean_v", pc["max_v"]), pc2.get("mean_v", pc2.get("max_v", 0))),
            max(pc.get("mean_w", pc["max_w"]), pc2.get("mean_w", pc2.get("max_w", 0))),
        ], np.float32)
    max_u2d = stats.get("U_2d", stats["U"])["max"]
    mv = max(max_u2d, stats["U"]["max"])
    return np.array([mv, mv, mv], np.float32)


class Stage1VAE(nn.Module):
    """E3D + D3D with the reference's ``VAE3DWrapper`` state-dict layout
    (``encoder_3d.*``, ``decoder_3d.*``). ``remat``: each residual block is
    recomputed in backward instead of stored (full-scale 256^2 x 11 training
    does not fit otherwise)."""

    def __init__(self, in_channels: int = 3, latent_channels: int = 8, remat: bool = True,
                 features=None):
        super().__init__()
        self.features = validate_features(features or REFERENCE_FEATURES)
        self.latent_channels = latent_channels
        self.encoder_3d = Encoder(in_channels, latent_channels, features=self.features)
        self.decoder_3d = Decoder(latent_channels, in_channels, features=self.features)
        self.encoder_3d.remat = self.decoder_3d.remat = remat

    def init_parameters_(self, generator: torch.Generator) -> None:
        """The JAX package's initializers, drawn from ``generator``."""
        init_module_(self, generator)

    def forward(self, x, generator=None, noise=None):
        """(recon, (mu, logvar)); z = mu + exp(logvar / 2) * noise, the noise
        drawn from ``generator`` unless given (channels-first, mu's shape)."""
        mu, logvar = self.encoder_3d(x)
        logvar = _clamp_logvar(logvar)
        if noise is None:
            z = reparameterize(mu, logvar, generator)
        else:
            z = mu + torch.exp(0.5 * logvar) * noise
        return self.decoder_3d(z), (mu, logvar)


class AccumAdam:
    """``optax.adam(lr)`` over ``module``'s trainable parameters, with the
    accumulated gradient buffer (the JAX trainers' ``g_acc``):
    ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)`` without weight
    decay. The buffer persists across epochs like the reference's ``.grad``
    buffers and is zeroed only after an optimizer step; microbatch gradients
    never touch ``.grad``. ``state_tree`` / ``g_acc_tree`` give the state in
    the JAX trainers' ``train_state.msgpack`` layout: optax's
    ``to_state_dict`` of ``adam`` (``{'0': {count, mu, nu}, '1': {}}``) and
    the buffer, as flax trees keyed by VAE branch."""

    def __init__(self, module: nn.Module, learning_rate: float):
        named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.adam = torch.optim.Adam(self.params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
        self.g_acc = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def accumulate(self, grads, keep, accum_steps: int) -> None:
        self.g_acc = accumulate_clipped(self.g_acc, grads, keep, accum_steps)

    @torch.no_grad()
    def apply(self) -> None:
        """One optimizer step with the accumulated gradient, then zero it."""
        for p, g in zip(self.params, self.g_acc):
            p.grad = g
        self.adam.step()
        for p in self.params:
            p.grad = None
        self.count += 1
        torch._foreach_zero_(self.g_acc)

    def _tree(self, tensors) -> dict:
        return weights.dual_vae_to_flax(dict(zip(self.names, tensors)))

    def state_tree(self) -> dict:
        """optax's ``adam`` state; the tensors are views of the live state."""
        def moment(key):
            return self._tree([self.adam.state[p][key] if key in self.adam.state[p]
                               else torch.zeros_like(p) for p in self.params])

        return {"0": {"count": np.asarray(self.count, np.int32), "mu": moment("exp_avg"),
                      "nu": moment("exp_avg_sq")}, "1": {}}

    def g_acc_tree(self) -> dict:
        return self._tree(self.g_acc)

    def _tensors(self, tree: dict, what: str) -> list:
        """A flax tree of the trainable branches as tensors in ``names``' order."""
        sd = {f"{b}.{k}": v for b, branch in vae_state_dicts(tree, what).items()
              for k, v in branch.items()}
        shapes = {n: tuple(p.shape) for n, p in zip(self.names, self.params)}
        got = {n: tuple(v.shape) for n, v in sd.items()}
        if got != shapes:
            differ = sorted(k for k in set(got) & set(shapes) if got[k] != shapes[k])
            raise ValueError(f"{what} does not match the trainable parameters: missing "
                             f"{sorted(set(shapes) - set(got))[:6]}, unexpected "
                             f"{sorted(set(got) - set(shapes))[:6]}, shapes differ at {differ[:6]}")
        # in the parameter's own layout: the clip's norm sums in memory order,
        # and a resumed run must sum as the uninterrupted one did
        return [torch.empty_like(p).copy_(sd[n]) for n, p in zip(self.names, self.params)]

    def load(self, opt_tree: dict, g_acc_tree: dict, what: str) -> None:
        """Restore ``state_tree`` and ``g_acc_tree`` (the port's or optax's)."""
        if set(opt_tree) != {"0", "1"} or opt_tree["1"] or \
                set(opt_tree["0"]) != {"count", "mu", "nu"}:
            raise ValueError(f"opt_state of {what} is not optax.adam's state")
        adam = opt_tree["0"]
        mu = self._tensors(adam["mu"], f"opt_state mu of {what}")
        nu = self._tensors(adam["nu"], f"opt_state nu of {what}")
        self.count = int(adam["count"])
        for p, m, v in zip(self.params, mu, nu):
            self.adam.state[p] = {"step": torch.tensor(float(self.count), dtype=torch.float32),
                                  "exp_avg": m, "exp_avg_sq": v}
        self.g_acc = self._tensors(g_acc_tree, f"g_acc of {what}")


def make_loss_fn(vae: Stage1VAE, loss_name: str):
    """losses(batch, kl_coeff, generator=None, noise=None) -> (total, metrics):
    ``batch`` holds 'velocity' (B, 3, D, H, W), normalized, and
    'microstructure' (B, 1, D, H, W); the reparameterization noise is
    ``noise`` or drawn from ``generator``. The metrics stay on the device."""
    loss_fn = LOSS_FUNCTIONS[loss_name]

    def losses(batch, kl_coeff, generator=None, noise=None):
        x, mask = batch["velocity"], batch["microstructure"]
        recon, (mu, logvar) = vae(x, generator, noise)
        recon_loss = loss_fn(recon * mask, x * mask, mask=mask)
        kl = kl_divergence(mu, logvar=logvar)
        total = recon_loss + kl_coeff * kl
        bad = ~(torch.isfinite(mu).all() & torch.isfinite(logvar).all())
        return total, {"recons": recon_loss.detach(), "kl": kl.detach(), "bad": bad,
                       "mu_absmax": mu.detach().abs().max()}

    return losses


def make_steps(vae: Stage1VAE, loss_name: str, optimizer: AccumAdam, accum_steps: int = 10):
    """(train_step, apply_step, eval_step).

    train_step(batch, kl_coeff, boundary, generator=None, noise=None) runs one
    microbatch inside ``train_trace()``: the gradient, the skip-aware
    accumulation and, on an accumulation boundary of a good batch, the
    optimizer step (a bad batch there suppresses the step, like the
    reference's skip ``continue``). apply_step() is the end-of-epoch
    remainder step; eval_step(...) the metrics without a gradient."""
    losses = make_loss_fn(vae, loss_name)

    def train_step(batch, kl_coeff, boundary, generator=None, noise=None):
        with train_trace():
            total, metrics = losses(batch, kl_coeff, generator, noise)
            grads = torch.autograd.grad(total, optimizer.params, materialize_grads=True)
        optimizer.accumulate(grads, ~metrics["bad"], accum_steps)
        # the host reads the flag at a boundary only: one sync per window
        if boundary and not bool(metrics["bad"]):
            optimizer.apply()
        return metrics

    @torch.no_grad()
    def eval_step(batch, kl_coeff, generator=None, noise=None):
        return losses(batch, kl_coeff, generator, noise)[1]

    return train_step, optimizer.apply, eval_step


def fetch_metrics(metricses: list) -> list:
    """An epoch's per-batch metric dicts on the host, one copy a key."""
    if not metricses:
        return []
    cols = {k: torch.stack([m[k] for m in metricses]).tolist() for k in metricses[0]}
    return [{k: v[i] for k, v in cols.items()} for i in range(len(metricses))]


def scan_train_metrics(metricses, kl_abort: float = 1000.0):
    """Replay the reference's per-batch host decisions over an epoch's
    fetched metrics (train_3d_vae_only.py:399-433): skipped batches are left
    out of the running sums; the first kept batch whose KL exceeds
    ``kl_abort`` stops the scan (the reference exits there mid-epoch;
    nothing after the explosion is saved either way).

    Returns (recons_sum, kl_sum, skipped_indices, exploded_kl_or_None)."""
    recons_sum = kl_sum = 0.0
    skipped = []
    for bi, m in enumerate(metricses):
        if bool(m["bad"]):
            skipped.append(bi)
        elif float(m["kl"]) > kl_abort:
            return recons_sum, kl_sum, skipped, float(m["kl"])
        else:
            recons_sum += float(m["recons"])
            kl_sum += float(m["kl"])
    return recons_sum, kl_sum, skipped, None


def loader_shuffle_order(n: int, seed: int, epoch: int, shuffle: bool) -> np.ndarray:
    """NumpyLoader's ``set_epoch`` shuffle stream without a loader: the
    resident-data path visits exactly the batches the streaming path would."""
    order = np.arange(n)
    if shuffle:
        np.random.default_rng((seed, epoch)).shuffle(order)
    return order


def build_device_store(subset, transform, device) -> dict:
    """One pass over an indexable subset -> stacked tensors on ``device``
    (row i == subset sample i); ``transform(sample)`` returns the (already
    normalized) numpy arrays to store."""
    rows = [transform(subset[i]) for i in range(len(subset))]
    return {k: torch.from_numpy(np.ascontiguousarray(np.stack([r[k] for r in rows]))).to(device)
            for k in rows[0]}


def store_batches(store: dict, order, batch_size: int, gather=None):
    """Batches of the rows ``order`` lists, gathered on the device;
    ``gather(store, idx)`` maps the store to the step's batch keys."""
    device = next(iter(store.values())).device
    for i in range(0, len(order), batch_size):
        idx = torch.as_tensor(np.asarray(order[i:i + batch_size]), device=device)
        yield (gather(store, idx) if gather else
               {k: v.index_select(0, idx) for k, v in store.items()})


def loader_batches(loader, normalize, device):
    """The loader's batches, normalized on the host, on ``device``, in C
    order as the resident store holds them: the items are transposed views,
    and a conv's backward sums in an order that follows its input's layout."""
    for b in loader:
        yield {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in normalize(b).items()}


class IndexSubset:
    """The samples ``indices`` of ``dataset``, re-indexed from 0."""

    def __init__(self, dataset, indices):
        self.dataset, self.idx = dataset, list(indices)

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        return self.dataset[self.idx[i]]

    def set_epoch(self, epoch):  # deterministic-resume augmentation
        self.dataset.set_epoch(epoch)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    print("=" * 60 + "\nSTAGE 1: Training 3D VAE Only\n" + "=" * 60)

    if not os.path.exists(args.dataset_dir):
        print(f"ERROR: Dataset directory not found: {args.dataset_dir}")
        sys.exit(1)
    os.makedirs(args.save_dir, exist_ok=True)

    full_dataset = MicroFlowDatasetVAE(args.dataset_dir, augment=args.augment)
    n = full_dataset.num_microstructures
    indices_3d = list(range(n, 2 * n))  # is_2d == False <=> idx >= N
    num = len(indices_3d)
    train_size = int(0.7 * num)
    val_size = int(0.15 * num)
    test_size = num - train_size - val_size
    tr, va, te = torch_random_split_indices(num, (train_size, val_size, test_size),
                                            seed=args.seed)
    subset = lambda idx: IndexSubset(full_dataset, [indices_3d[i] for i in idx])  # noqa: E731
    train_loader = NumpyLoader(subset(tr), args.batch_size, shuffle=True, seed=args.seed)
    val_loader = NumpyLoader(subset(va), args.batch_size)
    test_loader = NumpyLoader(subset(te), args.batch_size)
    print(f"Train: {train_size}, Val: {val_size}, Test: {test_size}")

    stats_file = osp.join(args.dataset_dir, "statistics.json")
    if not os.path.exists(stats_file):
        print(f"ERROR: statistics.json not found at {stats_file}")
        sys.exit(1)
    with open(stats_file) as f:
        statistics = json.load(f)
    norm_factors = norm_factors_from_stats(statistics, args.norm_mode)
    nf = norm_factors.reshape(1, 3, 1, 1, 1)

    vae = Stage1VAE(args.in_channels, args.latent_channels, features=args.features)
    vae.init_parameters_(torch.Generator().manual_seed(args.seed))
    vae.to(device)
    optimizer = AccumAdam(vae, args.learning_rate)
    train_step, apply_step, eval_step = make_steps(
        vae, args.loss_function, optimizer, accum_steps=args.grad_accum)

    log_dict = {
        "loss": {"recons_train": [], "recons_val": [], "kl_train": [],
                 "kl_val": [], "kl_coeff": []},
        "in_channels": args.in_channels,
        "latent_channels": args.latent_channels,
        # stage widths (the reference hardwires (128, 256, 512)); loaders
        # derive widths from the weights' shapes, this is informational
        "features": list(vae.features),
        "per_component_norm": True,
        "norm_mode": args.norm_mode,
        "norm_factors": norm_factors.tolist(),
        "conditional": False,  # stage 1 overrides conditional to False
        "loss_function": args.loss_function,
        "epoch_time": [],  # wall seconds an epoch (the reference's log has none)
    }
    best_val_loss = float("inf")
    min_kl = 1e-5

    ckpt_writer = AsyncCheckpointWriter()

    def save(folder, log):
        # weights then log through the same FIFO writer: a crash can leave
        # the log an epoch behind the weights but never ahead (the log is
        # encoded now because log_dict changes next epoch)
        save_tree(osp.join(folder, "vae.msgpack"), vae_params(vae), ckpt_writer)
        ckpt_writer.submit(osp.join(folder, "vae_log.json"),
                           json.dumps(log, indent=2).encode(), serialize=bytes)

    start_epoch = 0
    state_path = osp.join(args.save_dir, "train_state.msgpack")
    if args.resume:
        state = flax_msgpack.load(state_path)
        load_vae_params(vae, state["params"], state_path)
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

    # best among epochs whose checkpoint actually wrote (--ckpt-freq gating);
    # resume seeds it from the restored best, which errs safe: the saved
    # best_model is never overwritten by a worse epoch
    best_saved_loss = best_val_loss

    from ..utils.tb import TensorBoardLogger
    tb = TensorBoardLogger(osp.join(args.save_dir, "tb") if args.tensorboard else None,
                           purge_step=start_epoch if args.resume else None)

    if args.data_parallel and device.type == "cuda" and torch.cuda.device_count() > 1:
        print(f"Data parallelism is not ported (ROADMAP.md Queue 1 item 8): "
              f"training on {device} alone")

    # --cache-data: the normalized volumes go to the device once and each
    # batch is gathered there in the loader's shuffle order. The host divides
    # as the streaming path does, so both feed bit-identical batches
    sample0 = full_dataset[indices_3d[0]]
    sample_bytes = sample0["velocity"].nbytes + sample0["microstructure"].nbytes
    est_bytes = (train_size + val_size) * sample_bytes
    cache_data = (args.cache_data == "true"
                  or (args.cache_data == "auto"
                      and est_bytes <= args.cache_data_cap_gb * 2**30))
    if args.augment and cache_data:
        if args.cache_data == "true":
            raise ValueError(
                "--cache-data true is incompatible with --augment (flips "
                "are applied host-side in the streaming path); drop one")
        cache_data = False

    def normalize(b):
        return {"velocity": b["velocity"] / nf, "microstructure": b["microstructure"]}

    train_store = val_store = None
    if cache_data:
        t0s = time.time()
        nf0 = nf[0]  # (3, 1, 1, 1): per-sample == batched divide
        tx = lambda s: {  # noqa: E731
            "velocity": (s["velocity"] / nf0).astype(np.float32),
            "microstructure": s["microstructure"]}
        train_store = build_device_store(train_loader.dataset, tx, device)
        val_store = build_device_store(val_loader.dataset, tx, device)
        mb = sum(v.numel() * v.element_size() for st in (train_store, val_store)
                 for v in st.values()) / 2**20
        print(f"Device data store: {train_size}+{val_size} volumes, {mb:.0f} MB resident "
              f"({time.time() - t0s:.1f}s one-time build+upload)")
    elif args.cache_data == "auto" and not args.augment:
        print(f"--cache-data auto: {est_bytes / 2**30:.1f} GB exceeds the "
              f"{args.cache_data_cap_gb:.1f} GB cap; streaming batches")

    def train_batches(epoch):
        if cache_data:
            return store_batches(train_store, loader_shuffle_order(
                train_size, args.seed, epoch, shuffle=True), args.batch_size)
        return loader_batches(train_loader, normalize, device)

    def val_batches():
        if cache_data:
            return store_batches(val_store, np.arange(val_size), args.batch_size)
        return loader_batches(val_loader, normalize, device)

    # SIGTERM/SIGINT stops within one batch, discards the partial epoch,
    # drains the writer and exits cleanly
    from ..utils.preempt import GracefulShutdown
    preempted = False
    with GracefulShutdown() as shutdown:
        for epoch in range(start_epoch, args.num_epochs):
            t0 = time.time()
            # deterministic resume: the noise stream, the shuffle order and
            # the augmentation draws are pure functions of (seed, epoch)
            generator = epoch_generator(args.seed, epoch, device)
            for loader in (train_loader, val_loader):
                loader.set_epoch(epoch)
            if epoch < args.kl_warmup_epochs:
                kl_coeff = min_kl + (args.max_kl_coeff - min_kl) * (epoch / args.kl_warmup_epochs)
            else:
                kl_coeff = args.max_kl_coeff
            print(f"\nEpoch {epoch + 1}/{args.num_epochs} - KL coefficient: {kl_coeff:.6f}")

            # the metrics stay on the device; one fetch after the loop
            metricses = []
            i = -1
            for i, batch in enumerate(train_batches(epoch)):
                if shutdown.requested:
                    preempted = True
                    break
                metricses.append(train_step(batch, kl_coeff, (i + 1) % args.grad_accum == 0,
                                            generator=generator))
            if preempted:
                break  # partial epoch discarded; state is at the last boundary
            running_recons, running_kl, skipped_batches, exploded_kl = \
                scan_train_metrics(fetch_metrics(metricses))
            for bi in skipped_batches:
                print(f"  Skipping batch {bi} due to bad mu/logvar values")
            if exploded_kl is not None:
                # nothing after the explosion is saved, so the exit at the end
                # of the epoch leaves what the reference's mid-epoch one does
                print(f"  ERROR: KL loss exploded to {exploded_kl:.2f}! Training unstable.")
                sys.exit(1)
            if i >= 0 and (i + 1) % args.grad_accum != 0:
                apply_step()
            if i == -1:
                print("ERROR: No training batches found!")
                continue
            avg_recons_train = running_recons / (i + 1)
            avg_kl_train = running_kl / (i + 1)

            val_metricses = []
            j = -1
            for j, batch in enumerate(val_batches()):
                if shutdown.requested:
                    preempted = True
                    break
                val_metricses.append(eval_step(batch, kl_coeff, generator=generator))
            if preempted:
                break
            val_recons = val_kl = 0.0
            for m in fetch_metrics(val_metricses):
                val_recons += float(m["recons"])
                val_kl += float(m["kl"])
            avg_recons_val = val_recons / max(j + 1, 1)
            avg_kl_val = val_kl / max(j + 1, 1)

            log_dict["loss"]["recons_train"].append(avg_recons_train)
            log_dict["loss"]["kl_train"].append(avg_kl_train)
            log_dict["loss"]["recons_val"].append(avg_recons_val)
            log_dict["loss"]["kl_val"].append(avg_kl_val)
            log_dict["loss"]["kl_coeff"].append(kl_coeff)
            log_dict["epoch_time"].append(time.time() - t0)
            tb.add_scalars(epoch, {k: v[-1] for k, v in log_dict["loss"].items()},
                           prefix="loss/")

            val_loss = avg_recons_val + kl_coeff * avg_kl_val
            # best tracked every epoch (resume semantics); the write is
            # best-on-grid under --ckpt-freq, as in the diffusion trainer
            if val_loss < best_val_loss:
                best_val_loss = val_loss
            ckpt_freq = max(1, int(args.ckpt_freq or 1))
            save_this_epoch = epoch % ckpt_freq == 0 or epoch == args.num_epochs - 1

            def write_checkpoint_set():
                nonlocal best_saved_loss
                save(args.save_dir, log_dict)
                if val_loss < best_saved_loss:
                    best_saved_loss = val_loss
                    save_tree(osp.join(args.save_dir, "best_model.msgpack"), vae_params(vae),
                              ckpt_writer)
                save_tree(state_path, {
                    "params": vae_params(vae),
                    "opt_state": optimizer.state_tree(),
                    "g_acc": optimizer.g_acc_tree(),
                    "epoch": np.asarray(epoch, np.int64),
                    "best_val_loss": np.asarray(best_val_loss, np.float64),
                }, ckpt_writer)

            if save_this_epoch:
                write_checkpoint_set()
            print(f"Epoch {epoch + 1}: recons {avg_recons_train:.6f}/{avg_recons_val:.6f} "
                  f"kl {avg_kl_train:.2f}/{avg_kl_val:.2f} time {time.time() - t0:.1f}s")
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

    if preempted:
        if os.path.exists(state_path):
            print(f"Preempted; completed epochs are on disk. Resume with:\n"
                  f"  --save-dir {args.save_dir} --resume", flush=True)
        else:
            print("Preempted before the first epoch completed; nothing saved.", flush=True)
        return vae, log_dict

    # the test evaluation, on a noise stream of its own
    generator = epoch_generator(args.seed, args.num_epochs, device)
    test_metricses = [eval_step(batch, args.max_kl_coeff, generator=generator)
                      for batch in loader_batches(test_loader, normalize, device)]
    if test_metricses:
        test_recons = sum(float(m["recons"]) for m in fetch_metrics(test_metricses))
        print(f"\nTest reconstruction loss: {test_recons / len(test_metricses):.6f}")
    return vae, log_dict
