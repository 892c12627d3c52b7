"""Diffusion training driver (the port's copy of the JAX package's
``training/train_diffusion.py``, after the reference Diffusion_model/train.py).

Same behaviour: Adam with torch's coupled L2 weight decay, an optional
per-epoch exponential LR decay (gamma=0.95499), an optional EMA of the
weights, per-epoch ``model.msgpack`` + ``best_model.msgpack`` + ``log.json``
(full config, losses, physics-metric history) + ``train_state.msgpack``
written in the JAX package's formats, full-state ``--resume``, a graceful
preemption stop, and the test evaluation with the best checkpoint.
``--cache-latents`` encodes the dataset once through the frozen VAE into a
card-resident cache and runs UNet-only epochs. Modes train and CV live in
the port's ``train.py``; ``optimize`` (TPE search over batch size, kernel
size, level count and learning rate, with Optuna's MedianPruner rule,
``study.json`` resumable by trial) is :func:`optimize` here.
"""
from __future__ import annotations

import contextlib
import json
import math
import os.path as osp
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..utils import weights
from ..utils.async_ckpt import AsyncCheckpointWriter, atomic_write
from ..utils.checkpoint import (frozen_vae_params, load_predictor_state, load_train_state,
                                save_predictor, save_train_state)
from ..utils.config import make_log_folder, process_args, refuse_unported
from ..utils.device import resolve_device
from .helper import (_PHYSICS_LOSS_KEYS, _PHYSICS_METRIC_KEYS, _batch_dict,
                     build_latent_cache, flip_variant_draws, run_epoch, run_epoch_cached,
                     set_model)
from .steps import make_diffusion_eval_step

# log.json's "physics_metrics" keys
_PHYSICS_LOG_KEYS = [*_PHYSICS_METRIC_KEYS, *(f"loss_{k}" for k in _PHYSICS_LOSS_KEYS)]


def _shapes(tree, path: str = "") -> Dict[str, tuple]:
    if isinstance(tree, dict):
        out = {path + "/": ()} if not tree else {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{path}/{k}"))
        return out
    return {path: tuple(np.shape(tree))}


class DiffusionOptimizer:
    """``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay)``
    over a module's parameters, and an optional EMA of them.

    The counterpart of the JAX ``make_optimizer``'s optax chain
    ``inject_hyperparams(chain(add_decayed_weights?, scale_by_adam,
    scale_by_learning_rate, ema?))``: torch's coupled L2 adds
    ``weight_decay * p`` to the gradient before the moments, as
    ``add_decayed_weights`` does before ``scale_by_adam``; the EMA,
    ``ema = d * ema + (1 - d) * params``, is taken after each step from a
    copy of the parameters at construction. The parameters, moments and
    EMA change in place. ``state_tree`` / ``load_state_tree`` read and
    write the state in the layout optax's state gets from flax's
    ``to_state_dict`` (``count``, ``hyperparams.learning_rate``,
    ``inner_state`` with Adam's ``mu`` / ``nu`` and the ``ema`` tree), the
    trees in the flax UNet layout."""

    def __init__(self, unet: torch.nn.Module, learning_rate: float,
                 weight_decay: float = 0.0, ema_decay: float = 0.0):
        named = list(unet.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.weight_decay, self.ema_decay = float(weight_decay), float(ema_decay)
        self.adam = torch.optim.Adam(self.params, lr=learning_rate, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=self.weight_decay)
        self.count = 0
        self.ema = ([p.detach().clone() for p in self.params] if self.ema_decay > 0
                    else None)

    @property
    def learning_rate(self) -> float:
        return self.adam.param_groups[0]["lr"]

    @learning_rate.setter
    def learning_rate(self, lr: float) -> None:
        for group in self.adam.param_groups:
            group["lr"] = lr

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.adam.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        self.adam.step()
        self.count += 1
        if self.ema is not None:
            torch._foreach_mul_(self.ema, self.ema_decay)
            torch._foreach_add_(self.ema, self.params, alpha=1.0 - self.ema_decay)

    def _moment(self, key: str) -> Dict[str, torch.Tensor]:
        return {n: self.adam.state[p][key] if key in self.adam.state[p]
                else torch.zeros_like(p) for n, p in zip(self.names, self.params)}

    def _layout(self) -> list:
        """The chain's parts: the index of Adam's and of the EMA's state."""
        parts = (["decay"] if self.weight_decay > 0 else []) + ["adam", "lr"]
        return parts + (["ema"] if self.ema is not None else [])

    def state_tree(self) -> dict:
        """The optimizer state in optax's ``to_state_dict`` layout, its
        tensors views of the live state (snapshot before the next step)."""
        count = np.asarray(self.count, np.int32)
        inner = {}
        for i, part in enumerate(self._layout()):
            if part == "adam":
                inner[str(i)] = {"count": count,
                                 "mu": weights.unet_to_flax(self._moment("exp_avg")),
                                 "nu": weights.unet_to_flax(self._moment("exp_avg_sq"))}
            elif part == "ema":
                inner[str(i)] = {"ema": weights.unet_to_flax(ema_params(self))}
            else:
                inner[str(i)] = {}
        return {"count": count,
                "hyperparams": {"learning_rate": np.asarray(self.learning_rate, np.float32)},
                "hyperparams_states": {}, "inner_state": inner}

    def load_state_tree(self, tree: dict) -> None:
        """Restore a ``state_tree`` (the port's or optax's); a tree of another
        structure or other shapes raises ValueError."""
        expected, got = _shapes(self.state_tree()), _shapes(tree)
        if expected != got:
            missing = sorted(set(expected) - set(got))
            unexpected = sorted(set(got) - set(expected))
            bad = sorted(k for k in set(expected) & set(got) if expected[k] != got[k])
            raise ValueError(f"missing {missing[:6]}, unexpected {unexpected[:6]}, "
                             f"shapes differ at {bad[:6]}")
        count = int(tree["count"])
        self.count = count
        self.learning_rate = float(tree["hyperparams"]["learning_rate"])
        layout = self._layout()
        adam_state = tree["inner_state"][str(layout.index("adam"))]
        mu = weights.to_tensors(weights.export_unet(adam_state["mu"]))
        nu = weights.to_tensors(weights.export_unet(adam_state["nu"]))
        for n, p in zip(self.names, self.params):
            self.adam.state[p] = {
                "step": torch.tensor(float(int(adam_state["count"])), dtype=torch.float32),
                "exp_avg": mu[n].to(p.device, p.dtype),
                "exp_avg_sq": nu[n].to(p.device, p.dtype)}
        if self.ema is not None:
            ema = weights.to_tensors(weights.export_unet(
                tree["inner_state"][str(layout.index("ema"))]["ema"]))
            with torch.no_grad():
                for n, e in zip(self.names, self.ema):
                    e.copy_(ema[n])


def make_optimizer(unet: torch.nn.Module, learning_rate: float, weight_decay: float = 0.0,
                   ema_decay: float = 0.0) -> DiffusionOptimizer:
    """torch.optim.Adam semantics: L2 penalty added to the gradient BEFORE the
    Adam moments (not AdamW's decoupled decay). ``ema_decay > 0`` also
    tracks an exponential moving average of the weights (an extension over
    the reference)."""
    return DiffusionOptimizer(unet, learning_rate, weight_decay, ema_decay)


def ema_params(optimizer: DiffusionOptimizer) -> Optional[Dict[str, torch.Tensor]]:
    """The EMA weights by parameter name (a UNet state dict), or None
    without ``ema_decay``."""
    return None if optimizer.ema is None else dict(zip(optimizer.names, optimizer.ema))


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The noise stream of one epoch, a pure function of (seed, epoch) (the
    JAX trainer's ``fold_in(key(seed + 1), epoch)``): a resumed run draws
    exactly what the uninterrupted one did."""
    state = np.random.SeedSequence((seed + 1, epoch)).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


def train(args, train_loader, val_loader, test_loader=None, *, report_fn=None,
          seed: int = 0, should_stop=None):
    """Train the UNet of a latent-diffusion predictor for
    ``args.num_epochs`` epochs on ``args.device`` (default cuda). Returns
    (avg_train_loss, avg_val_loss) of the last epoch.
    ``report_fn(epoch, val_loss)`` is called after each epoch's checkpoints
    and may raise (``TrialPruned``) to prune a hyperparameter-search trial.

    ``should_stop`` (e.g. a utils.preempt.GracefulShutdown installed by the
    CLI) is polled before every batch and after every epoch: when it turns
    true the loop stops within one step, the partial epoch is discarded,
    every completed epoch's checkpoints drain to disk, and the ``--resume``
    hint is printed."""
    refuse_unported(args)
    device = resolve_device(args.device)
    param_dict = process_args(args)
    log_dict = {
        "params": param_dict,
        "epoch": [], "train_loss": [], "val_loss": [], "time": [],
        "learning_rate_history": [],
        "physics_metrics": {k: [] for k in _PHYSICS_LOG_KEYS},
    }
    # a resumed run keeps writing into its original dir
    log_folder = getattr(args, "resume", None) or make_log_folder(param_dict)

    root_dir = param_dict["dataset"]["root_dir"]
    td = param_dict["training"]
    learning_rate = td["learning_rate"]

    predictor = set_model(type=td["predictor_type"], kwargs=td["predictor"],
                          norm_file=osp.join(root_dir, "statistics.json"), seed=seed,
                          device=device)
    if getattr(args, "compute_dtype", "float32") != "float32":
        predictor.compute_dtype = getattr(torch, args.compute_dtype)
        print(f"Network compute dtype: {args.compute_dtype}")
    predictor.model.requires_grad_(True)

    ema_decay = float(getattr(args, "ema_decay", 0.0) or 0.0)
    optimizer = make_optimizer(predictor.model, learning_rate, td["weight_decay"],
                               ema_decay=ema_decay)
    if ema_decay > 0:
        print(f"Tracking EMA weights (decay {ema_decay}) -> ema_model.msgpack")
    if getattr(args, "data_parallel", True) and device.type == "cuda" \
            and torch.cuda.device_count() > 1:
        print(f"Data parallelism is not ported (ROADMAP.md Queue 1 item 8): "
              f"training on {device} alone")

    best_loss = float("inf")
    start_epoch = 0
    avg_train_loss = avg_val_loss = float("nan")

    resume_dir = getattr(args, "resume", None)
    if resume_dir:
        state_path = osp.join(resume_dir, "train_state.msgpack")
        predictor, optimizer, start_epoch, best_loss = load_train_state(
            state_path, predictor, optimizer)
        with open(osp.join(resume_dir, "log.json")) as f:
            prev = json.load(f)
        for key in ("epoch", "train_loss", "val_loss", "time", "learning_rate_history"):
            log_dict[key] = prev.get(key, [])[:start_epoch]
        for key in log_dict["physics_metrics"]:
            log_dict["physics_metrics"][key] = \
                prev.get("physics_metrics", {}).get(key, [])[:start_epoch]
        if log_dict["train_loss"]:
            # a resume that trains no further epoch still returns the real losses
            avg_train_loss = log_dict["train_loss"][-1]
            avg_val_loss = log_dict["val_loss"][-1]
        print(f"Resumed from {state_path} at epoch {start_epoch} "
              f"(best val loss {best_loss:.6f})")

    # --cache-latents: the VAE is frozen, so the target and conditioning
    # latents are the same in every epoch: encode the dataset once into a
    # cache on the card and run UNet-only epochs (training/steps.py)
    cache_latents = bool(getattr(args, "cache_latents", False))
    if cache_latents:
        if (td["lambda_div"] or td["lambda_flow"] or td["lambda_smooth"]
                or td["lambda_laplacian"] or td["lambda_velocity"]
                or td["velocity_loss_primary"]):
            raise ValueError(
                "--cache-latents supports the plain noise-prediction "
                "configuration only: physics/velocity losses decode full-"
                "resolution velocity every step and need the raw volumes")
        # --augment: every flip variant is encoded once, and each epoch the
        # dataset's own augmentation draws select the rows
        cache_augment = bool(getattr(getattr(train_loader, "dataset", None), "augment", False))
        t_cache = time.time()
        latent_caches = build_latent_cache((train_loader, val_loader), predictor,
                                           flip_variants=cache_augment)
        print(f"Latent caches built in {time.time() - t_cache:.1f}s (one frozen-VAE encode "
              f"pass{', 4 flip variants' if cache_augment else ''})")

    model_path = osp.join(log_folder, "model.msgpack")
    best_model_path = osp.join(log_folder, "best_model.msgpack")
    log_path = osp.join(log_folder, "log.json")

    # the VAE is frozen during diffusion training (reference predictor.py:
    # 604-607): one host copy of its params serves every checkpoint
    frozen_vae = frozen_vae_params(predictor)

    # optional TensorBoard mirror of the log.json scalars; purge_step on
    # resume drops a crashed run's abandoned-epoch events like the log's
    # truncation above
    from ..utils.tb import TensorBoardLogger
    tb = TensorBoardLogger(
        osp.join(log_folder, "tb") if getattr(args, "tensorboard", False) else None,
        purge_step=start_epoch if resume_dir else None)

    # checkpoints stream out on a background thread (atomic tmp + rename)
    from ..utils.preempt import PreemptStop
    ckpt_writer = AsyncCheckpointWriter()
    preempted = False

    # best among epochs whose checkpoint actually wrote (--ckpt-freq gating).
    # Resume seeds it from the restored best_loss, which errs on the safe
    # side: the saved best_model is never overwritten by a worse epoch
    best_saved_loss = best_loss
    for epoch in range(start_epoch, td["num_epochs"]):
        current_lr = learning_rate * (
            td["scheduler"]["gamma"] ** epoch if td["scheduler"]["flag"] else 1.0)
        optimizer.learning_rate = current_lr

        start_time = time.time()
        # deterministic resume: the noise stream, the loader's shuffle order
        # and its augmentation draws are pure functions of (seed, epoch)
        generator = epoch_generator(seed, epoch, device)
        for loader in (train_loader, val_loader):
            if hasattr(loader, "set_epoch"):
                loader.set_epoch(epoch)
        # --profile-dir: a torch.profiler trace of epoch 0, as the JAX trainer
        # traces its first epoch
        profile_ctx = contextlib.nullcontext()
        if epoch == 0 and getattr(args, "profile_dir", None):
            from ..utils.profiling import profile_trace
            profile_ctx = profile_trace(args.profile_dir)
        try:
            with profile_ctx:
                if cache_latents:
                    variant_idx = (flip_variant_draws(train_loader.dataset, epoch)
                                   if cache_augment else None)
                    avg_train_loss, avg_val_loss, physics_metrics = run_epoch_cached(
                        latent_caches, predictor, optimizer, generator=generator,
                        batch_size=param_dict["dataset"]["batch_size"],
                        cost_name=td["cost_function"], should_stop=should_stop,
                        variant_idx=variant_idx, n_train=len(train_loader.dataset),
                        n_val=len(val_loader.dataset))
                else:
                    avg_train_loss, avg_val_loss, physics_metrics = run_epoch(
                        (train_loader, val_loader), predictor, optimizer,
                        generator=generator,
                        cost_name=td["cost_function"],
                        lambda_div=td["lambda_div"],
                        lambda_flow=td["lambda_flow"],
                        lambda_smooth=td["lambda_smooth"],
                        lambda_laplacian=td["lambda_laplacian"],
                        physics_loss_freq=td["physics_loss_freq"],
                        lambda_velocity=td["lambda_velocity"],
                        weight_u=td["weight_u"], weight_v=td["weight_v"],
                        weight_w=td["weight_w"],
                        velocity_loss_primary=td["velocity_loss_primary"],
                        should_stop=should_stop,
                    )
        except PreemptStop as e:
            print(f"Epoch {epoch} abandoned ({e}); state is at epoch "
                  f"{epoch - 1 if epoch else 'none (no epoch completed)'}")
            preempted = True
            break
        dtime = time.time() - start_time

        log_dict["epoch"].append(epoch)
        log_dict["time"].append(dtime)
        log_dict["train_loss"].append(avg_train_loss)
        log_dict["val_loss"].append(avg_val_loss)
        log_dict["learning_rate_history"].append(current_lr)
        for key in log_dict["physics_metrics"]:
            if key in physics_metrics:
                log_dict["physics_metrics"][key].append(physics_metrics[key])
            elif key.replace("loss_", "") in physics_metrics:
                log_dict["physics_metrics"][key].append(
                    physics_metrics[key.replace("loss_", "")])
            else:
                log_dict["physics_metrics"][key].append(0.0)

        tb.add_scalars(epoch, {
            "train_loss": avg_train_loss, "val_loss": avg_val_loss,
            "learning_rate": current_lr, "epoch_time": dtime,
        })
        tb.add_scalars(
            epoch, {k: v[-1] for k, v in log_dict["physics_metrics"].items()},
            prefix="physics/")

        # --ckpt-freq N (default 1, the reference's every-epoch contract):
        # best_loss tracks EVERY epoch (report/resume semantics);
        # best_model.msgpack is gated on best_SAVED_loss, the best among
        # epochs that wrote, and the first save never consults the
        # filesystem (which would race the async writer)
        ckpt_freq = max(1, int(getattr(args, "ckpt_freq", 1) or 1))
        save_this_epoch = (epoch % ckpt_freq == 0 or epoch == td["num_epochs"] - 1)
        if avg_val_loss < best_loss:
            best_loss = avg_val_loss

        def write_checkpoint_set():
            nonlocal best_saved_loss
            save_predictor(predictor, model_path, writer=ckpt_writer, frozen_vae=frozen_vae)
            if ema_decay > 0:
                save_predictor(predictor, osp.join(log_folder, "ema_model.msgpack"),
                               writer=ckpt_writer, frozen_vae=frozen_vae,
                               unet_state=ema_params(optimizer))
            if avg_val_loss < best_saved_loss:
                best_saved_loss = avg_val_loss
                save_predictor(predictor, best_model_path, writer=ckpt_writer,
                               frozen_vae=frozen_vae)
            # FIFO order model.msgpack -> log.json -> train_state.msgpack: a
            # crash between the last two leaves train_state one epoch behind
            # the log, and resume re-trains that epoch deterministically
            # after truncating the log to start_epoch
            ckpt_writer.submit(log_path, json.dumps(log_dict, indent=4).encode(),
                               serialize=bytes)
            save_train_state(osp.join(log_folder, "train_state.msgpack"), predictor,
                             optimizer, epoch, best_loss, writer=ckpt_writer,
                             frozen_vae=frozen_vae)

        if save_this_epoch:
            write_checkpoint_set()

        print(f"Epoch {epoch}: train_loss={avg_train_loss:.6f} | "
              f"val_loss={avg_val_loss:.6f} | time={dtime:.2f} s")

        if report_fn is not None:
            try:
                report_fn(epoch, avg_val_loss)
            except BaseException:
                # pruning unwinds the loop as routine control flow (a search
                # runs many train() calls in one process): drain and release
                # the writer thread without masking the prune signal
                try:
                    ckpt_writer.close()
                except RuntimeError:
                    pass
                finally:
                    tb.close()
                raise

        if should_stop is not None and should_stop():
            # a graceful stop leaves THIS epoch on disk even when --ckpt-freq
            # gated the regular write above
            if not save_this_epoch:
                write_checkpoint_set()
            preempted = True
            break

    try:
        ckpt_writer.close()  # every queued write landed (or raises its failure)
    except BaseException:
        tb.close()
        raise

    if preempted:
        state_path = osp.join(log_folder, "train_state.msgpack")
        if osp.exists(state_path):
            print(f"Preempted; all completed epochs are on disk. Resume with:"
                  f"\n  --resume {log_folder}", flush=True)
        else:
            print("Preempted before the first epoch completed; nothing saved.", flush=True)
        tb.close()
        return avg_train_loss, avg_val_loss

    # test evaluation with the best checkpoint, on a noise stream of its own
    if test_loader is not None and not math.isinf(best_loss):
        predictor.model.requires_grad_(False)
        load_predictor_state(predictor, best_model_path)
        eval_step = make_diffusion_eval_step(cost_name=td["cost_function"])
        generator = epoch_generator(seed, td["num_epochs"], device)
        losses = [eval_step(predictor, _batch_dict(data, device), generator)["val_loss"]
                  for data in test_loader]
        avg_test_loss = (sum(torch.stack(losses).tolist()) / len(losses) if losses
                         else 0.0)
        log_dict["test_loss"] = avg_test_loss
        # atomic like every checkpoint write: a kill mid-rewrite must not
        # corrupt the log of an otherwise complete run
        atomic_write(log_path, json.dumps(log_dict, indent=4).encode())
        tb.add_scalars(td["num_epochs"], {"test_loss": avg_test_loss})
        print(f"\nTest Loss: {avg_test_loss}")

    tb.close()
    return avg_train_loss, avg_val_loss


class TrialPruned(Exception):
    pass


def find_resumable_run(pattern: str, require_state: bool = True):
    """Newest run dir matching glob ``pattern`` with a readable log.json.

    With ``require_state`` (default) the dir must ALSO hold
    train_state.msgpack: the writer's FIFO order (log before state) means a
    dir holding a state holds a log at least as new, so a state-only dir is
    a corrupt or foreign artifact. ``require_state=False`` is the
    COMPLETENESS check: a finished run whose state file was deleted still
    counts as done by its log alone.

    Returns ``(run_dir, completed_epochs)`` or ``(None, 0)``.
    """
    import glob as _glob

    for d in sorted(_glob.glob(pattern), reverse=True):
        if not osp.exists(osp.join(d, "log.json")):
            continue
        if require_state and not osp.exists(osp.join(d, "train_state.msgpack")):
            continue
        try:
            with open(osp.join(d, "log.json")) as f:
                done = len(json.load(f).get("epoch", []))
        except (OSError, ValueError):
            continue
        return d, done
    return None, 0


class MedianPruner:
    """Optuna's MedianPruner rule, the default pruner of the reference's
    study: a trial is pruned at epoch e when its best intermediate value so
    far is strictly worse (greater) than the median of the completed
    trials' values at epoch e. Pruning is off until ``n_startup_trials``
    trials have completed, and for the first ``n_warmup_steps`` epochs of
    each trial."""

    def __init__(self, n_startup_trials: int = 5, n_warmup_steps: int = 0):
        self.n_startup_trials = n_startup_trials
        self.n_warmup_steps = n_warmup_steps
        self._completed: list = []

    def make_report_fn(self):
        """A trial's ``report_fn(epoch, value)``; raises TrialPruned to prune."""
        intermediates: dict = {}

        def report(epoch: int, value: float):
            intermediates[epoch] = value
            if len(self._completed) < self.n_startup_trials:
                return
            if epoch < self.n_warmup_steps:
                return
            at_step = [t[epoch] for t in self._completed if epoch in t]
            if not at_step:
                return
            best_so_far = min(v for e, v in intermediates.items() if e <= epoch)
            if best_so_far > float(np.median(at_step)):
                raise TrialPruned(
                    f"epoch {epoch}: best {best_so_far:.6f} > median "
                    f"{float(np.median(at_step)):.6f} of {len(at_step)} trials")

        report.intermediates = intermediates
        return report

    def complete_trial(self, report_fn):
        self._completed.append(dict(report_fn.intermediates))

    def seed_completed(self, intermediates: dict):
        """Re-feed one recorded trial's {epoch: value} curve (study resume)."""
        self._completed.append({int(e): float(v) for e, v in intermediates.items()})


def optimize(args, get_loader_fn, n_trials: Optional[int] = None,
             n_startup_trials: int = 5, should_stop=None):
    """The reference's Optuna study (its default sampler is TPE): the same
    search space (batch size, odd kernel size, level count -> feature stack,
    log-uniform learning rate), MedianPruner's rule, and the independent-
    Parzen TPE of ``training/tpe.py`` (``--search-algo random``: random
    search). ``should_stop`` stops the study at the next trial boundary; the
    running trial stops within one step through train() and is not recorded.

    Crash-safe: a restarted study reloads ``study.json``, skips the recorded
    trials (any retried draw is a pure function of (seed, trial index,
    recorded history)), re-feeds the pruner their intermediate values, and
    resumes an interrupted trial in place from its run dir's
    train_state.msgpack, replaying its logged epochs into the pruner."""
    from ..utils.config import run_descr
    from .tpe import RandomSampler, TPESampler, diffusion_search_space

    space = diffusion_search_space(args)
    algo = getattr(args, "search_algo", "tpe") or "tpe"
    sampler = (RandomSampler(space, seed=2024) if algo == "random"
               else TPESampler(space, seed=2024))
    n_trials = n_trials or args.n_trials
    study_path = osp.join(args.save_dir, "study.json")
    results = []
    if osp.exists(study_path):
        with open(study_path) as f:
            results = json.load(f)
        if results:
            print(f"Resuming study: {len(results)} trials already recorded in {study_path}")
    pruner = MedianPruner(n_startup_trials=n_startup_trials)
    legacy = 0
    for r in results:
        if r["state"] == "COMPLETE":
            inter = r.get("intermediates", {})
            if inter:
                pruner.seed_completed(inter)
            else:
                # an empty curve would count toward n_startup_trials while
                # adding nothing to the medians
                legacy += 1
    if legacy:
        print(f"{legacy} recorded trials predate intermediate-value persistence; "
              f"pruning medians rebuild from new trials only")

    history = [(r["params"], r["value"]) for r in results]
    for trial_idx in range(n_trials):
        if should_stop is not None and should_stop():
            print(f"Study preempted after {trial_idx} recorded trials; "
                  f"{study_path} is current.", flush=True)
            break
        if trial_idx < len(results):
            continue  # recorded: its params feed the sampler through `history`
        params = sampler.suggest(trial_idx, history)
        args.batch_size = int(params["batch_size"])
        args.kernel_size = int(params["kernel_size"])
        levels = int(params["levels"])
        factors = [2 ** v for v in range(levels)]
        if args.top_bottom:
            args.features = [args.top_feature_channels * v for v in factors]
        else:
            args.features = [int(args.bottom_feature_channels / v) for v in reversed(factors)]
        args.learning_rate = float(params["learning_rate"])

        # an interrupted attempt of THIS trial left a run dir: resume it. The
        # match key is the whole hyperparameter blob of the dirname (minus
        # the epoch budget), so another trial's or another mode's run dir in
        # save_dir is never resumed into this config
        descr = run_descr(process_args(args), with_epochs=False)
        args.resume, _ = find_resumable_run(osp.join(args.save_dir, f"*{descr}*"))
        if args.resume:
            print(f"Trial {trial_idx} resuming from {args.resume}")

        train_loader, val_loader, test_loader = get_loader_fn(args)[0]
        report_fn = pruner.make_report_fn()
        if args.resume:
            # replay the interrupted attempt's epochs so pruning sees the whole curve
            try:
                with open(osp.join(args.resume, "log.json")) as f:
                    prev = json.load(f)
                for e, v in zip(prev.get("epoch", []), prev.get("val_loss", [])):
                    report_fn.intermediates[int(e)] = float(v)
            except (OSError, ValueError):
                pass
        try:
            _, val_loss = train(args, train_loader, val_loader, test_loader,
                                report_fn=report_fn, should_stop=should_stop)
            if should_stop is not None and should_stop():
                print(f"Trial {trial_idx} interrupted mid-run; not recorded.")
                break
            state = "COMPLETE"
            pruner.complete_trial(report_fn)
        except TrialPruned as e:
            print(f"Trial {trial_idx} pruned: {e}")
            val_loss, state = float("nan"), "PRUNED"
        finally:
            args.resume = None
        results.append({
            "trial": trial_idx, "state": state, "value": val_loss,
            "params": {"batch_size": args.batch_size, "kernel_size": args.kernel_size,
                       "levels": levels, "learning_rate": args.learning_rate},
            # persisted so that a resumed study rebuilds the pruner's medians
            "intermediates": dict(report_fn.intermediates),
        })
        history.append((results[-1]["params"], results[-1]["value"]))
        with open(study_path, "w") as f:
            json.dump(results, f, indent=2)

    complete = [r for r in results if r["state"] == "COMPLETE"]
    pruned = [r for r in results if r["state"] == "PRUNED"]
    best = min(complete, key=lambda r: r["value"]) if complete else None
    print("Study statistics:")
    print("\t Number of finished trials: ", len(results))
    print("\t Number of pruned trials: ", len(pruned))
    print("\t Number of complete trials: ", len(complete))
    if best:
        print("Best trial:")
        print("\t Value: ", best["value"])
        print("\t Params:")
        for key, value in best["params"].items():
            print(f"\t {key}: {value}")
    return results
