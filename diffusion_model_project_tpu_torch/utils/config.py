"""CLI argument surface of the port's ``train.py`` (the port's copy of the
JAX package's ``utils/config.py``).

Flag-for-flag compatible with the reference Diffusion_model/config.py:39-512
and the JAX package: the same 64 flags, names, defaults (``--device``
defaults to ``cuda``) and choices, the same nested param dict from
``process_args`` (persisted verbatim into log.json: the checkpoint IS the
config store), and the same ``make_log_folder`` run-dirname encoding.
Flags whose feature the port does not have yet parse, and
``refuse_unported`` refuses them, naming the ROADMAP.md item that ports it.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
from datetime import datetime

# UNet of the published checkpoint: in 17 (latent 8 + E2D latent 8 + mask 1),
# out 8, five levels 64..1024, 2-head attention from level 3 down.
PUBLISHED_UNET_KWARGS = dict(
    in_channels=17, out_channels=8, features=(64, 128, 256, 512, 1024),
    kernel_size=3, padding_mode="zeros", activation="silu",
    final_activation=None, attention="3..2", dropout=0.0,
    time_embedding_dim=64,
)
PUBLISHED_LATENT_CHANNELS = 8


def str_to_bool(value):
    if isinstance(value, bool):
        return value
    if value.lower() in ("true", "t", "yes", "y", "1"):
        return True
    if value.lower() in ("false", "f", "no", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"Boolean value expected, got '{value}'")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--name", type=str, default="unet",
                        help="Arbitrary title describing the dataset used or model being trained.")
    parser.add_argument("--save-dir", type=str, default="./trained/",
                        help="Directory where to save results.")
    parser.add_argument("--mode", type=str, default="train",
                        choices=["train", "CV", "optimize"],
                        help="Train, cross-validate, or optimize hyperparameters.")

    group_dataset = parser.add_argument_group("Dataset Parameters")
    group_train = parser.add_argument_group("Training Parameters")
    group_optim = parser.add_argument_group("Optimization Parameters")

    group_dataset.add_argument("--root-dir", type=str, required=True)
    group_dataset.add_argument("--batch-size", type=int, default=10)
    group_dataset.add_argument("--augment", type=str_to_bool, default=False)
    group_dataset.add_argument("--shuffle", type=str_to_bool, default=False)
    group_dataset.add_argument("--k-folds", type=int, default=5)

    group_train.add_argument("--device", type=str, default="cuda",
                             help="torch device to train on (default cuda; cpu runs the "
                                  "kernels' plain versions)")
    # multi-host launch (beyond the reference; parallel/distributed.py):
    # every host runs the same command with its own --process-id
    group_train.add_argument("--coordinator", type=str, default=None,
                             help="multi-host coordinator host:port (not ported: refused)")
    group_train.add_argument("--num-processes", type=int, default=None)
    group_train.add_argument("--process-id", type=int, default=None)
    group_train.add_argument("--model-parallel", type=int, default=1,
                             help="tensor-parallel degree: shard conv/dense "
                                  "weights over a 'model' mesh axis "
                                  "(not ported: values > 1 are refused)")
    group_train.add_argument("--fsdp", type=str_to_bool, default=False,
                             help="fully-sharded data parallelism: shard "
                                  "params + Adam moments over the 'data' "
                                  "axis (not ported: refused)")
    group_train.add_argument("--learning-rate", type=float, default=1e-4)
    group_train.add_argument("--weight-decay", type=float, default=0.0)
    group_train.add_argument("--scheduler-flag", type=str_to_bool, default=False)
    group_train.add_argument("--scheduler-gamma", type=float, default=0.95499)
    group_train.add_argument("--num-epochs", type=int, default=100)
    group_train.add_argument(
        "--cost-function", type=str, default="normalized_mse_loss_per_component",
        choices=["normalized_mae_loss", "normalized_mse_loss", "mae_loss",
                 "mse_loss", "huber_loss", "normalized_mae_loss_per_component",
                 "mae_loss_per_component", "mse_loss_per_component",
                 "normalized_mse_loss_per_component"])
    group_train.add_argument("--lambda-div", type=float, default=0.0)
    group_train.add_argument("--lambda-flow", type=float, default=0.0)
    group_train.add_argument("--lambda-smooth", type=float, default=0.0)
    group_train.add_argument("--lambda-laplacian", type=float, default=0.0)
    group_train.add_argument("--physics-loss-freq", type=int, default=1)
    group_train.add_argument("--weight-u", type=float, default=1.0)
    group_train.add_argument("--weight-v", type=float, default=1.0)
    group_train.add_argument("--weight-w", type=float, default=1.0)
    group_train.add_argument("--lambda-velocity", type=float, default=0.0)
    group_train.add_argument("--velocity-loss-primary", type=str_to_bool, default=False)
    group_train.add_argument("--predictor-type", type=str, default="latent-diffusion",
                             choices=["latent-diffusion"])
    group_train.add_argument("--model-name", type=str, default="UNet")
    group_train.add_argument("--in-channels", type=int, required=True)
    group_train.add_argument("--out-channels", type=int, required=True)
    group_train.add_argument("--features", type=int, nargs="+",
                             default=[64, 128, 256, 512, 1024])
    group_train.add_argument("--kernel-size", type=int, default=3)
    group_train.add_argument("--padding-mode", type=str, default="zeros")
    group_train.add_argument("--activation", type=str, default="silu",
                             choices=["silu", "relu", "leakyrelu", "softplus"])
    group_train.add_argument("--final-activation", type=str, default=None,
                             choices=["silu", "relu", "leakyrelu", "softplus"])
    group_train.add_argument("--attention", type=str, default="")
    group_train.add_argument("--dropout", type=float, default=0.0)
    group_train.add_argument("--distance-transform", type=str_to_bool, default=True)
    group_train.add_argument("--vae-path", type=str, default=None)
    group_train.add_argument("--vae-encoder-path", type=str, default=None)
    group_train.add_argument("--vae-decoder-path", type=str, default=None)
    group_train.add_argument("--num-slices", type=int, default=11)
    group_train.add_argument("--use-3d", type=str_to_bool, default=True)
    group_train.add_argument("--num-timesteps", type=int, default=1000)
    # extensions beyond the reference CLI
    group_train.add_argument("--profile-dir", type=str, default=None,
                             help="Capture a torch.profiler trace of the first epoch into "
                                  "this dir (TensorBoard trace handler).")
    group_train.add_argument("--debug-nans", type=str_to_bool, default=False,
                             help="Raise at the first module whose output (or its "
                                  "gradient) holds a NaN/Inf; anomaly mode in backward.")
    group_train.add_argument("--resume", type=str, default=None,
                             help="Resume training from this run dir's train_state.msgpack "
                                  "(full state incl. optimizer; the reference only ever "
                                  "reloads weights).")
    group_train.add_argument("--compute-dtype", type=str, default="float32",
                             choices=["float32", "bfloat16"],
                             help="Network compute dtype (scheduler/normalization stay f32).")
    group_train.add_argument("--ema-decay", type=float, default=0.0,
                             help="Track an exponential moving average of the UNet weights "
                                  "(saved per epoch as ema_model.msgpack; 0 = off). "
                                  "Standard diffusion practice the reference lacks.")
    group_train.add_argument("--ckpt-freq", type=int, default=1,
                             help="Write the checkpoint set (model/best/log/train_state) "
                                  "every N epochs instead of every epoch (default 1 = the "
                                  "reference contract). best-val tracking still sees every "
                                  "epoch; the saved best is the best on the N-grid.")
    group_train.add_argument("--cache-latents", type=str_to_bool, default=False,
                             help="Train the UNet on latents encoded once by the frozen VAE "
                                  "(not ported: refused).")
    group_train.add_argument("--data-parallel", type=str_to_bool, default=True,
                             help="Data parallelism over all visible devices (not ported: "
                                  "the port trains on the one --device).")
    group_train.add_argument("--tensorboard", type=str_to_bool, nargs="?",
                             const=True, default=False,
                             help="Mirror every scalar appended to log.json into "
                                  "TensorBoard events under <run_dir>/tb/ "
                                  "(additive; the JSON contract stays canonical; "
                                  "bare flag or an explicit true/false).")

    group_optim.add_argument("--n-trials", type=int, default=100)
    group_optim.add_argument("--range-batch-size", type=int, default=[10, 40], nargs=2)
    group_optim.add_argument("--range-kernel-size", type=int, default=[3, 7], nargs=2)
    group_optim.add_argument("--range-level", type=int, default=[1, 7], nargs=2)
    group_optim.add_argument("--top-bottom", type=str_to_bool, default=True, nargs=2)
    group_optim.add_argument("--top-feature-channels", type=int, default=32)
    group_optim.add_argument("--bottom-feature-channels", type=int, default=2048)
    group_optim.add_argument("--range-learning-rate", type=float,
                             default=[1e-7, 1e-3], nargs=2)
    # extension: sampler choice for mode=optimize. 'tpe' (default) matches
    # the reference's actual searcher — optuna.create_study's default
    # TPESampler (reference train.py:376-407) — via training/tpe.py;
    # 'random' keeps the rounds-1/2 log-uniform random search.
    group_optim.add_argument("--search-algo", choices=("tpe", "random"),
                             default="tpe")
    return parser


parser = build_parser()


def process_args(args: argparse.Namespace) -> dict:
    """Nested param dict persisted into log.json (reference config.py:390-466)."""
    out = {
        "name": args.name,
        "mode": args.mode,
        "save_dir": args.save_dir,
        "dataset": {
            "root_dir": args.root_dir,
            "batch_size": args.batch_size,
            "augment": args.augment,
            "shuffle": args.shuffle,
            "k_folds": args.k_folds,
            "use_3d": args.use_3d,
        },
        "training": {
            "device": args.device,
            "learning_rate": args.learning_rate,
            "weight_decay": args.weight_decay,
            "scheduler": {"flag": args.scheduler_flag, "gamma": args.scheduler_gamma},
            "num_epochs": args.num_epochs,
            "cost_function": args.cost_function,
            "lambda_div": args.lambda_div,
            "lambda_flow": args.lambda_flow,
            "lambda_smooth": args.lambda_smooth,
            "lambda_laplacian": args.lambda_laplacian,
            "physics_loss_freq": args.physics_loss_freq,
            "weight_u": args.weight_u,
            "weight_v": args.weight_v,
            "weight_w": args.weight_w,
            "lambda_velocity": args.lambda_velocity,
            "velocity_loss_primary": args.velocity_loss_primary,
            "predictor_type": args.predictor_type,
            "predictor": {
                "model_name": args.model_name,
                "model_kwargs": {
                    "in_channels": args.in_channels,
                    "out_channels": args.out_channels,
                    "features": args.features,
                    "kernel_size": args.kernel_size,
                    "padding_mode": args.padding_mode,
                    "activation": args.activation,
                    "final_activation": args.final_activation,
                    "attention": args.attention,
                    "dropout": args.dropout,
                },
                "distance_transform": args.distance_transform,
                "vae_path": args.vae_path,
                "vae_encoder_path": args.vae_encoder_path,
                "vae_decoder_path": args.vae_decoder_path,
                "num_slices": args.num_slices,
                "num_timesteps": args.num_timesteps,
            },
        },
        "optimization": {
            "n_trials": args.n_trials,
            "range_batch_size": args.range_batch_size,
            "range_kernel_size": args.range_kernel_size,
            "range_level": args.range_level,
            "range_learning_rate": args.range_learning_rate,
            "top_bottom": args.top_bottom,
            "top_feature_channels": args.top_feature_channels,
            "bottom_feature_channels": args.bottom_feature_channels,
        },
    }
    # extension flags recorded only when active: log.json stays dict-equal
    # with the reference for reference-flag runs, but ema_model.msgpack's
    # provenance is never lost
    if getattr(args, "ema_decay", 0.0):
        out["training"]["ema_decay"] = args.ema_decay
    if getattr(args, "search_algo", "tpe") != "tpe":
        out["optimization"]["search_algo"] = args.search_algo
    return out


def run_descr(param_dict: dict, with_epochs: bool = True) -> str:
    """The run-dirname's hyperparameter blob (reference config.py:469-512).

    ``with_epochs=False`` drops the trailing ``-ep-N``: the key the
    crash-safe CV matches existing run dirs by (every hyperparameter
    identifies the run; the epoch budget may grow between invocations)."""
    dataset_kwargs = param_dict["dataset"]
    train_kwargs = param_dict["training"]
    mk = train_kwargs["predictor"]["model_kwargs"]
    descr = (
        f"in-{mk['in_channels']}-out-{mk['out_channels']}-"
        f"f-{len(mk['features'])}-k-{mk['kernel_size']}-p-{mk['padding_mode']}-"
        f"a-{mk['attention']}-dr-{mk['dropout']}-"
        f"wd-{train_kwargs['weight_decay']:.2e}-"
        f"b-{dataset_kwargs['batch_size']}-"
        f"lr-{train_kwargs['learning_rate']:.2e}"
    )
    if with_epochs:
        descr += f"-ep-{train_kwargs['num_epochs']}"
    return descr


def make_log_folder(param_dict: dict) -> str:
    """Run-dirname encoding identical to reference config.py:469-512."""
    name = param_dict["name"]
    save_dir = param_dict["save_dir"]
    predictor_type = param_dict["training"]["predictor_type"]

    time_stamp = datetime.now().strftime("%Y%m%d")
    log_folder = osp.join(
        save_dir,
        time_stamp + f"_{name}_{predictor_type}_" + run_descr(param_dict))
    if not osp.exists(log_folder):
        os.makedirs(log_folder)
    return log_folder


# flags whose feature is not ported yet, and the ROADMAP.md item that ports it
_PARALLEL = "ROADMAP.md Queue 1 item 8 (parallel: DDP, FSDP, process groups)"


def refuse_unported(args: argparse.Namespace) -> None:
    """Raise ``NotImplementedError`` naming each flag set in ``args`` whose
    feature the port does not have yet, with its ROADMAP.md item: such a
    flag is refused, never silently ignored."""
    found = []
    if args.model_parallel > 1:
        found.append((f"--model-parallel {args.model_parallel}", _PARALLEL))
    if args.fsdp:
        found.append(("--fsdp", _PARALLEL))
    if args.coordinator is not None or args.num_processes is not None:
        found.append(("--coordinator / --num-processes", _PARALLEL))
    if found:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(f"{flag} ({item})" for flag, item in found))
