"""Training helpers (the port's copy of the JAX package's ``training/helper.py``,
after the reference Diffusion_model/src/helper.py):
  - get_norm_params: statistics.json -> per-component (max_u, max_v, max_w)
    output scales, preferring U_per_component (helper.py:38-102)
  - set_model: build the predictor, initialize its UNet, set the
    normalizers (helper.py:105-122)
  - get_model: build a predictor and load weights from a file (helper.py:125-148)
  - select_input_output: batch dict -> ((img, U_2d), U) (helper.py:151-176)
  - run_epoch: one training epoch and one validation pass, with the physics
    and velocity losses and their metrics (helper.py:179-560); updates the
    UNet in place.
  - flip_variant_draws, build_latent_cache, run_epoch_cached: --cache-latents
    (a card-resident cache of the frozen VAE's latents, UNet-only epochs).
    One device: the JAX package's mesh-sharded cache rows have no counterpart.
"""
from __future__ import annotations

import json
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..losses.physics import PhysicsLoss
from .steps import batch_tensors, make_diffusion_eval_step, make_diffusion_train_step

_PHYSICS_METRIC_KEYS = (
    "div_mean", "div_std", "flow_rate_cv", "vel_in_solid", "vel_mean_fluid",
    "gradient_smooth", "laplacian_smooth", "vel_u_mean", "vel_v_mean",
    "vel_w_mean", "vel_u_max", "vel_v_max", "vel_w_max",
)
_PHYSICS_LOSS_KEYS = ("divergence", "flow_rate", "smoothness", "laplacian")
_COMPONENT_KEYS = ("loss_u", "loss_v", "loss_w")


def get_norm_params(file: str, option: str = "latent-diffusion") -> dict:
    with open(file) as f:
        stats = json.load(f)
    if option != "latent-diffusion":
        raise ValueError(f"Unknown option: {option}")

    if "U_per_component" in stats:
        pc = stats["U_per_component"]
        max_u = pc["max_u"]
        max_v = pc["max_v"]
        max_w = pc.get("max_w", max_u)
        return {"input": None, "output": (max_u, max_v, max_w)}

    if "U" in stats:
        max_velocity = stats["U"]["max"]
    elif "velocity" in stats:
        max_velocity = stats["velocity"]["max"]
    elif "U_2d" in stats and "U_3d" in stats:
        max_velocity = max(stats["U_2d"]["max"], stats["U_3d"]["max"])
    elif "U_2d" in stats:
        max_velocity = stats["U_2d"]["max"]
    elif "U_3d" in stats:
        max_velocity = stats["U_3d"]["max"]
    else:
        max_velocity = 1.0
    return {"input": None, "output": (max_velocity,) * 3}


def set_model(type: str, kwargs: dict, norm_file: str, *, seed: int = 0, device="cuda"):
    """A predictor for training: the VAE from the kwargs' paths (frozen), the
    UNet with the JAX package's initializers drawn from a
    ``torch.Generator`` seeded with ``seed``, the normalizers from
    statistics.json. The VAE's own norm_factors (vae_log.json) win over
    statistics.json for the output normalizer (reference predictor.py:615-629)."""
    from ..utils.checkpoint import build_predictor

    if type != "latent-diffusion":
        raise ValueError(f"Unknown model type: {type}")
    predictor, vae_norm_factors = build_predictor(kwargs, device=device)
    predictor.model.init_parameters_(torch.Generator().manual_seed(seed))
    norm_params = get_norm_params(norm_file, option=type)
    if vae_norm_factors is not None:
        norm_params = {**norm_params, "output": None}  # keep the VAE's norm_factors
    return predictor.set_normalizer(norm_params)


def get_model(type: str, kwargs: dict, model_path: str, *, device="cuda"):
    """A predictor built from ``kwargs`` with the weights of ``model_path``
    (native .msgpack or reference .pt; reference helper.py:125-148)."""
    from ..utils.checkpoint import (build_predictor, load_diffusion_torch_checkpoint,
                                    load_predictor_state)

    if type != "latent-diffusion":
        raise ValueError(f"Unknown model type: {type}")
    predictor, _ = build_predictor(kwargs, device=device)
    if model_path.endswith(".msgpack"):
        return load_predictor_state(predictor, model_path)
    return load_diffusion_torch_checkpoint(predictor, model_path)


def select_input_output(data: Dict, option: str = "latent-diffusion"):
    if option != "latent-diffusion":
        raise ValueError(f"Unknown option: {option}")
    return (data["microstructure"], data["velocity_input"]), data["velocity"]


def _batch_dict(data, device) -> Dict[str, torch.Tensor]:
    """A loader batch as the steps' {'img', 'U_2d', 'U'} float32 tensors on ``device``."""
    (img, v2d), targets = select_input_output(data)
    return batch_tensors({"img": img, "U_2d": v2d, "U": targets}, device)


def _fetch(dicts: list) -> list:
    """The host values of a list of {name: 0-d tensor} dicts, in one copy."""
    keys = [sorted(d) for d in dicts]
    flat = [d[k].reshape(()).float() for d, ks in zip(dicts, keys) for k in ks]
    values = torch.stack(flat).tolist() if flat else []
    out, i = [], 0
    for ks in keys:
        out.append(dict(zip(ks, values[i:i + len(ks)])))
        i += len(ks)
    return out


def _stop(should_stop, where: str) -> None:
    if should_stop is not None and should_stop():
        from ..utils.preempt import PreemptStop

        raise PreemptStop(f"stop requested at {where}")


def run_epoch(
    loaders,
    predictor,
    optimizer,
    *,
    generator: torch.Generator,
    cost_name: str = "normalized_mse_loss_per_component",
    lambda_div: float = 0.0,
    lambda_flow: float = 0.0,
    lambda_smooth: float = 0.0,
    lambda_laplacian: float = 0.0,
    physics_loss_freq: int = 1,
    lambda_velocity: float = 0.0,
    weight_u: float = 1.0,
    weight_v: float = 1.0,
    weight_w: float = 1.0,
    velocity_loss_primary: bool = False,
    verbose: bool = False,
    should_stop: Optional[Callable[[], bool]] = None,
):
    """One training epoch and one validation pass; the UNet is updated in
    place through ``optimizer``. Every step draws its noise then its
    timesteps from ``generator``, train batches first, then validation.
    The losses stay on the device until the epoch ends and come to the host
    in one copy. ``should_stop`` (e.g. a utils.preempt.GracefulShutdown) is
    polled before every batch; when it turns true the partial epoch unwinds
    with PreemptStop.

    Returns (avg_train_loss, avg_val_loss, all_metrics)."""
    train_loader, val_loader = loaders
    physics = PhysicsLoss(
        lambda_div=lambda_div, lambda_flow=lambda_flow,
        lambda_smooth=lambda_smooth, lambda_laplacian=lambda_laplacian,
        normalize_smoothness=True,
    )
    use_physics = physics.is_active()
    use_velocity = lambda_velocity > 0 or velocity_loss_primary
    common = dict(cost_name=cost_name, velocity_weights=(weight_u, weight_v, weight_w),
                  velocity_loss_primary=velocity_loss_primary)
    train_full = make_diffusion_train_step(optimizer, physics=physics,
                                           lambda_velocity=lambda_velocity, **common)
    train_plain = make_diffusion_train_step(optimizer, physics=None, lambda_velocity=0.0,
                                            **common)
    eval_step = make_diffusion_eval_step(cost_name=cost_name,
                                         with_physics_metrics=use_physics or use_velocity)
    device = predictor.device

    # ---- training set -----------------------------------------------------
    train_auxes, heavy_flags = [], []
    for i, data in enumerate(train_loader):
        _stop(should_stop, f"train batch {i}")
        if verbose:
            print(f"Training set: batch [{i + 1}/{len(train_loader)}]")
        heavy = (use_physics or use_velocity) and physics_loss_freq > 0 \
            and (i % physics_loss_freq == 0)
        step = train_full if heavy else train_plain
        train_auxes.append(step(predictor, _batch_dict(data, device), generator))
        heavy_flags.append(heavy)
    num_train = len(train_auxes)
    running_loss = 0.0
    phys_components = {k: 0.0 for k in _PHYSICS_LOSS_KEYS}
    comp_metrics = {k: 0.0 for k in _COMPONENT_KEYS}
    n_phys = 0
    for aux, heavy in zip(_fetch(train_auxes), heavy_flags):
        # reference semantics: log the PRIMARY loss, excluding physics/aux terms
        running_loss += aux.get("primary_loss", aux["noise_loss"])
        if heavy:
            n_phys += 1
            for k in _PHYSICS_LOSS_KEYS:
                if k in aux:
                    phys_components[k] += aux[k]
        # velocity_loss_primary reconstructs velocity EVERY batch (it IS the
        # primary loss), so the reference accumulates loss_u/v/w every batch
        # (helper.py:353-355); the aux-velocity variant only on heavy batches
        # (helper.py:413-415)
        if heavy or velocity_loss_primary:
            for k in _COMPONENT_KEYS:
                if k in aux:
                    comp_metrics[k] += aux[k]
    avg_train_loss = running_loss / max(num_train, 1)
    # the reference divides by floor(num/freq), NOT the heavy-batch count
    # ceil(num/freq) (helper.py:455,459): log.json and the printed lines stay
    # comparable number for number
    n_norm = max(1, num_train // physics_loss_freq) if physics_loss_freq > 0 \
        else max(1, n_phys)
    for k in phys_components:
        phys_components[k] /= n_norm
    for k in comp_metrics:
        comp_metrics[k] /= n_norm
    if use_velocity and (n_phys > 0 or velocity_loss_primary):
        print(f"  Train velocity loss components: u={comp_metrics['loss_u']:.6f}, "
              f"v={comp_metrics['loss_v']:.6f}, w={comp_metrics['loss_w']:.6f}")

    # ---- validation set ---------------------------------------------------
    val_metricses = []
    for j, data in enumerate(val_loader):
        _stop(should_stop, f"val batch {j}")
        if verbose:
            print(f"Validation set: batch [{j + 1}/{len(val_loader)}]")
        val_metricses.append(eval_step(predictor, _batch_dict(data, device), generator))
    val_loss = 0.0
    acc = {k: 0.0 for k in _PHYSICS_METRIC_KEYS}
    val_phys_count = 0
    for metrics in _fetch(val_metricses):
        val_loss += metrics["val_loss"]
        if use_physics or use_velocity:
            for k in _PHYSICS_METRIC_KEYS:
                if k in metrics:
                    acc[k] += metrics[k]
            val_phys_count += 1
    # NaN, not 0.0, for a zero-batch val loader: 0.0 would win best-model
    # gating with unvalidated weights
    avg_val_loss = val_loss / len(val_metricses) if val_metricses else float("nan")
    if val_phys_count > 0:
        acc = {k: v / val_phys_count for k, v in acc.items()}

    # reference all_metrics = val physics metrics + loss_<physics components>
    # ONLY (helper.py:555-558): loss_u/v/w are printed above but never logged,
    # so log.json keeps the reference's key set
    all_metrics = {**acc, **{f"loss_{k}": v for k, v in phys_components.items()}}
    return avg_train_loss, avg_val_loss, all_metrics


def flip_variant_draws(dataset, epoch: int) -> np.ndarray:
    """The dataset's per-sample augmentation draws for ``epoch``, replayed
    without reading a sample: v[i] = flip_h + 2 * flip_z from the same
    (seed, epoch, idx) stream, in the same order, that
    ``MicroFlowDataset._augment_sample`` consumes, so the flip-variant cache
    selects the sample the regular loader would have produced."""
    dataset.set_epoch(epoch)
    out = np.empty(len(dataset), np.int32)
    for i in range(len(dataset)):
        rng = dataset._aug_rng(i)
        fh = rng.random() < 0.5
        fz = dataset.use_3d and rng.random() < 0.5
        out[i] = int(fh) + 2 * int(fz)
    return out


def _natural_order_batches(loader):
    """A loader's dataset in index order (whatever its shuffle state), so
    cache row i is sample i: the identity the flip-variant draws key on."""
    ds, bs = loader.dataset, loader.batch_size
    n = len(ds)
    for k in range(0, n, bs):
        samples = [ds[i] for i in range(k, min(k + bs, n))]
        yield {key: np.stack([s[key] for s in samples]) for key in samples[0]}


#: variant-major row order of the flip cache: row = v * n + i with
#: v = flip_h + 2 * flip_z
FLIP_VARIANTS = ((False, False), (True, False), (False, True), (True, True))


def build_latent_cache(loaders, predictor, *, flip_variants: bool = False):
    """One pass of (train_loader, val_loader) through the frozen VAE ->
    (train_cache, val_cache): dicts of x0 / z / m tensors on the predictor's
    device (``steps.precompute_latent_cache``), rows in dataset index order.

    ``flip_variants`` (``--cache-latents --augment``) also encodes every
    (flip_h, flip_z) variant of the TRAIN samples, variant-major (row =
    v * n + i, four times the cache); the val split is never augmented."""
    from .steps import flip_variant_batch, precompute_latent_cache

    device = predictor.device
    out = []
    for name, loader in zip(("train", "val"), loaders):
        variants = (FLIP_VARIANTS if flip_variants and name == "train"
                    else FLIP_VARIANTS[:1])
        # encode the unaugmented samples: the variants are applied on the card
        ds = loader.dataset
        saved_augment = getattr(ds, "augment", False)
        if saved_augment:
            ds.augment = False
        try:
            parts = {v: [] for v in variants}
            for data in _natural_order_batches(loader):
                raw = _batch_dict(data, device)
                for v in variants:
                    parts[v].append(precompute_latent_cache(
                        predictor, flip_variant_batch(raw, *v) if any(v) else raw))
        finally:
            if saved_augment:
                ds.augment = saved_augment
        if not parts[variants[0]]:
            # an empty val split: an empty cache keeps the val loop a no-op;
            # an empty train split is an error
            if not out:
                raise ValueError("--cache-latents: the train loader yielded no batches")
            out.append({k: v[:0] for k, v in out[0].items()})
            print(f"  latent cache [{name}]: 0 samples (empty split)")
            continue
        cache = {k: torch.cat([p[k] for v in variants for p in parts[v]], dim=0)
                 for k in parts[variants[0]][0]}
        mb = sum(v.numel() * v.element_size() for v in cache.values()) / 2**20
        aug = f" ({len(variants)} flip variants)" if len(variants) > 1 else ""
        print(f"  latent cache [{name}]: {cache['x0'].shape[0]} rows{aug}, {mb:.0f} MB on "
              f"{device}")
        out.append(cache)
    return tuple(out)


def run_epoch_cached(
    caches,
    predictor,
    optimizer,
    *,
    generator: torch.Generator,
    batch_size: int,
    cost_name: str = "normalized_mse_loss_per_component",
    should_stop: Optional[Callable[[], bool]] = None,
    variant_idx=None,
    n_train: Optional[int] = None,
    n_val: Optional[int] = None,
):
    """The cached-latent counterpart of :func:`run_epoch` (plain
    noise-prediction configuration; the trainer refuses the rest). The
    epoch's shuffle is a ``torch.randperm`` of the cache rows drawn from
    ``generator`` on its device, each batch a gather of rows, and each step
    then draws its noise and timesteps from ``generator``; the losses come
    to the host once, at the end.

    ``variant_idx``: the epoch's flip variant of each sample
    (:func:`flip_variant_draws`) over a variant-major flip cache, where
    sample i of variant v is row v * n + i.

    Returns (avg_train_loss, avg_val_loss, {})."""
    from .steps import make_cached_latent_eval_step, make_cached_latent_train_step

    train_cache, val_cache = caches
    train_step = make_cached_latent_train_step(optimizer, cost_name=cost_name)
    eval_step = make_cached_latent_eval_step(cost_name=cost_name)
    device = train_cache["x0"].device
    n = int(n_train) if n_train is not None else int(train_cache["x0"].shape[0])
    perm = torch.randperm(n, generator=generator, device=generator.device).to(device)
    v_dev = (None if variant_idx is None
             else torch.as_tensor(np.asarray(variant_idx, np.int64)).to(device))
    auxes = []
    for k in range(0, n, batch_size):
        _stop(should_stop, f"cached train batch {k // batch_size}")
        idx = perm[k:k + batch_size]
        if v_dev is not None:  # variant-major flip cache: row = v * n + i
            idx = idx + n * v_dev[idx]
        batch = {key: v[idx] for key, v in train_cache.items()}
        auxes.append(train_step(predictor, batch, generator))
    running = sum(a["primary_loss"] for a in _fetch(auxes))
    avg_train_loss = running / max(len(auxes), 1)

    m = int(n_val) if n_val is not None else int(val_cache["x0"].shape[0])
    val_metricses = []
    for k in range(0, m, batch_size):
        _stop(should_stop, f"cached val batch {k // batch_size}")
        batch = {key: v[k:min(k + batch_size, m)] for key, v in val_cache.items()}
        val_metricses.append(eval_step(predictor, batch, generator))
    if not val_metricses:
        # NaN, not 0.0: an empty val split must not win best-model gating
        return avg_train_loss, float("nan"), {}
    avg_val_loss = sum(mm["val_loss"] for mm in _fetch(val_metricses)) / len(val_metricses)
    return avg_train_loss, avg_val_loss, {}
