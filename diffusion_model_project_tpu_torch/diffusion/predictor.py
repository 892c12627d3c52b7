"""LatentDiffusionPredictor: frozen dual-branch VAE + UNet + scheduler.

Counterpart of the JAX ``diffusion/predictor.py`` on its inference paths:
  img (B,S,1,H,W), velocity_2d (B,S,3,H,W)
    -> EDT + normalize the mask, bilinear to the latent grid
    -> E2D encode (deterministic mu) of the normalized 2D velocity
    -> T-step DDPM (``predict``), N-step DDIM (``predict_ddim``) or N-step
       DPM-Solver++ (``predict_dpm``) on the B*ld latent slices
    -> D3D decode, denormalize, trilinear back to S slices where the VAE
       compresses depth, mask -> (B,S,3,H,W).
The public contract is channels-first, as in the JAX package; inside, the
VAE sees (B, C, S, H, W) and the UNet (B*ld, C, lh, lw). On the card the
samplers store them channels-last (``torch.channels_last_3d`` /
``channels_last``, :meth:`LatentDiffusionPredictor.samples_channels_last`):
cuDNN's convs then take and give NDHWC / NHWC without transposing, K1 reads
and writes that layout, and the reshapes between the latent slices and the
volume are views. The training step's ``forward`` / ``encode_target``, the
int8 predictors and every CPU call stay channels-first. Module names follow
the reference predictor state dict (``model.*``, ``vae.*``, ``scheduler.*``,
``normalizer.{input,output}.scale_factors``, ``distance_transform``).
Each sampler is a host loop of UNet calls (one dispatch a step). The
noise-prediction step of training and evaluation (``encode_target`` the
target with E3D, ``forward`` one UNet evaluation at one timestep a latent
slice) returns its tensors in the port's layout, (B*ld, C, lh, lw).
``with_vae_int8()`` / ``with_unet_int8()`` return a predictor that shares
these modules and runs the frozen VAE's / UNet's convs in dynamic int8
(``models.layers.int8_convs``); int8 never trains.
Each sampler call records host spans (``utils.profiling.span``) while
recording is on: ``sampler.call`` holding ``sampler.prepare`` (EDT, E2D,
initial latents), one ``sampler.step`` a UNet evaluation with its scheduler
update, and ``sampler.decode`` (D3D).
"""
from __future__ import annotations

import contextlib
import copy
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.layers import int8_convs
from ..models.unet import UNet
from ..models.vae import REFERENCE_FEATURES, DualBranchVAE
from ..ops.basic import to_channels_last
from ..ops.distance import distance_transform_edt
from ..ops.normalizer import MaxNormalizer
from ..ops.resize import interpolate_bilinear, interpolate_trilinear
from ..utils.device import resolve_device
from ..utils.profiling import span
from .scheduler import DiffusionScheduler, ddim_timesteps, dpm_solver_coefficients

CLIP = (-30.0, 30.0)  # the samplers' x0 clip (reference predictor.py:823-884)


def _refresh_host_values(predictor, _incompatible_keys) -> None:
    predictor._read_host_values()


class LatentDiffusionPredictor(nn.Module):
    def __init__(self, model_kwargs: dict, *, num_timesteps: int = 1000,
                 distance_transform: bool = True, latent_channels: Optional[int] = None,
                 vae_features: Optional[Sequence[int]] = None, vae_conditional: bool = False,
                 vae_depth_factor: int = 1,
                 compute_dtype: torch.dtype = torch.float32, device="cuda"):
        """Modules with torch's default init on ``device`` (default 'cuda';
        raises without CUDA unless device='cpu'); ``create`` gives them the
        JAX package's initializers, ``load_state_dict`` given weights.
        ``vae_conditional``: the FiLM-conditioned standard VAE (condition 0
        on the 2D branch, 1 on the 3D branch). ``vae_depth_factor``: the
        VAE's depth compression (latent depth = S // factor); the shipped
        VAE preserves depth (1)."""
        super().__init__()
        device = resolve_device(device)
        model_kwargs = dict(model_kwargs)
        model_kwargs.setdefault("time_embedding_dim", 64)
        latent_channels = latent_channels or model_kwargs.get("out_channels", 4)
        with device:  # torch's default init runs where the weights will live
            self.model = UNet(**model_kwargs)
            self.vae = DualBranchVAE(latent_channels=latent_channels,
                                     features=vae_features or REFERENCE_FEATURES,
                                     conditional=vae_conditional)
        self.scheduler = DiffusionScheduler(num_timesteps)
        self.normalizer = nn.ModuleDict({"input": MaxNormalizer([1.0]),
                                         "output": MaxNormalizer([1.0] * 3)})
        self.register_buffer("distance_transform",
                             torch.tensor([1.0 if distance_transform else 0.0]))
        self.num_timesteps = num_timesteps
        self.vae_depth_factor = vae_depth_factor
        # dtype of conv and matmul compute; scheduler math, normalization and
        # GroupNorm statistics stay float32
        self.compute_dtype = compute_dtype
        # run the frozen VAE's / UNet's convs in dynamic int8 (with_vae_int8,
        # with_unet_int8); the VAE path is the serving and evaluation knob,
        # the UNet's error feeds back through the sampler
        self.vae_int8 = False
        self.unet_int8 = False
        self.to(device)
        self._read_host_values()
        self.register_load_state_dict_post_hook(_refresh_host_values)

    @classmethod
    def create(cls, model_kwargs: dict, *, seed: int = 0, device="cuda",
               compute_dtype: torch.dtype = torch.float32, **kwargs) -> "LatentDiffusionPredictor":
        """A frozen predictor with the JAX package's initializers, drawn from a
        ``torch.Generator`` seeded with ``seed``, on ``device`` (default
        'cuda'; raises without CUDA unless device='cpu')."""
        pred = cls(model_kwargs, compute_dtype=compute_dtype, device=device, **kwargs)
        gen = torch.Generator().manual_seed(seed)
        pred.model.init_parameters_(gen)
        pred.vae.init_parameters_(gen)
        return pred.requires_grad_(False).eval()

    @classmethod
    def from_directory(cls, folder: str, **kwargs) -> "LatentDiffusionPredictor":
        """A predictor from a run dir's ``log.json`` and weights
        (``utils.checkpoint.predictor_from_directory``; default 'cuda')."""
        from ..utils.checkpoint import predictor_from_directory

        predictor, _ = predictor_from_directory(folder, **kwargs)
        return predictor

    def _with_flags(self, **flags) -> "LatentDiffusionPredictor":
        """A predictor that shares this one's modules, parameters and buffers
        (so its state dict has the same keys and tensors) with ``flags`` set;
        this one is unchanged (the JAX ``dataclasses.replace``)."""
        new = copy.copy(self)
        new._load_state_dict_post_hooks = type(self._load_state_dict_post_hooks)()
        new.register_load_state_dict_post_hook(_refresh_host_values)
        for name, value in flags.items():
            setattr(new, name, bool(value))
        return new

    def with_vae_int8(self, enabled: bool = True) -> "LatentDiffusionPredictor":
        return self._with_flags(vae_int8=enabled)

    def with_unet_int8(self, enabled: bool = True) -> "LatentDiffusionPredictor":
        return self._with_flags(unet_int8=enabled)

    @staticmethod
    def _int8(enabled: bool):
        """The context a frozen network's calls run in: ``int8_convs()`` where
        its int8 flag is set (the JAX ``_vae_apply`` and ``_unet_eps``)."""
        return int8_convs() if enabled else contextlib.nullcontext()

    @property
    def device(self) -> torch.device:
        return self.distance_transform.device

    @property
    def latent_channels(self) -> int:
        return self.vae.latent_channels

    def set_normalizer(self, norm_dict: dict) -> "LatentDiffusionPredictor":
        """Replace the input / output scale factors (in place; returns self)."""
        for key in ("input", "output"):
            if norm_dict.get(key) is not None:
                self.normalizer[key] = MaxNormalizer(norm_dict[key]).to(self.device)
        return self

    # ----------------------------------------------------------- conditioning

    # Host values of the samplers. They are copied from the buffers when the
    # buffers are set (here and by ``load_state_dict``), so a sampler call
    # reads no device memory from the host: such a read would wait for every
    # kernel queued before it. The exported program (``utils/export.py``)
    # holds them as constants.

    def _read_host_values(self) -> None:
        self._host_values = {
            "distance_transform": bool(self.distance_transform.item()),
            "alphas_cumprod": self.scheduler.alphas_cumprod.detach().cpu().numpy()}

    def uses_distance_transform(self) -> bool:
        """The ``distance_transform`` flag, on the host."""
        return self._host_values["distance_transform"]

    def host_alphas_cumprod(self) -> np.ndarray:
        """The scheduler's alpha-bar table on the host (DPM-Solver++'s
        coefficients are computed from it there)."""
        return self._host_values["alphas_cumprod"]

    def pre_process(self, img_flat: torch.Tensor) -> torch.Tensor:
        """EDT (if enabled) + input normalization of (N, 1, H, W) masks."""
        if self.uses_distance_transform():
            img_flat = distance_transform_edt(img_flat[:, 0])[:, None]
        return self.normalizer["input"].normalize(img_flat, channel_axis=1)

    def samples_channels_last(self) -> bool:
        """Whether the samplers store their activations channels-last: on the
        card, where cuDNN's convs run NHWC / NDHWC and K1 reads that layout,
        unless a network's convs run in int8: K4 writes channels-first, so an
        int8 predictor stays channels-first throughout."""
        return self.device.type == "cuda" and not (self.vae_int8 or self.unet_int8)

    def prepare_conditioning(self, img: torch.Tensor, velocity_2d: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """img (B,S,1,H,W), velocity_2d (B,S,3,H,W) ->
        z_cond (B*ld, latent, lh, lw), m_cond (B*ld, 1, lh, lw), float32,
        with ld = S // vae_depth_factor; channels-first."""
        return self._conditioning(img, velocity_2d, channels_last=False)

    def _conditioning(self, img, velocity_2d, channels_last: bool):
        """:meth:`prepare_conditioning`, channels-last where ``channels_last``:
        E2D's input cast and laid out in one copy, z_cond the E2D output's view."""
        b, s = img.shape[0], velocity_2d.shape[1]
        h, w = img.shape[-2], img.shape[-1]
        lh, lw, ld = h // 4, w // 4, s // self.vae_depth_factor

        v2d = self.normalizer["output"].normalize(velocity_2d, channel_axis=2).transpose(1, 2)
        v2d = to_channels_last(v2d, self.compute_dtype) if channels_last \
            else v2d.to(self.compute_dtype)
        with self._int8(self.vae_int8):
            z_cond, _ = self.vae.encode_2d_deterministic(v2d)    # (B, C, ld, lh, lw)
        if z_cond.shape[2] != ld:
            raise ValueError(
                f"vae_depth_factor={self.vae_depth_factor} implies latent depth {ld}, but "
                f"encode_2d produced depth {z_cond.shape[2]}; the factor must match the "
                f"VAE's depth compression (the shipped Encoder preserves depth -> 1)")
        z_cond = z_cond.float().transpose(1, 2).reshape(b * ld, self.latent_channels, lh, lw)

        feats = self.pre_process(img.reshape(b * s, 1, h, w))
        feats = interpolate_bilinear(feats, lh, lw)            # (B*S, 1, lh, lw)
        if ld != s:
            feats = interpolate_trilinear(feats.reshape(b, s, 1, lh, lw).transpose(1, 2),
                                          ld, lh, lw)            # (B, 1, ld, lh, lw)
            feats = feats.transpose(1, 2).reshape(b * ld, 1, lh, lw)
        if channels_last:
            return to_channels_last(z_cond), to_channels_last(feats)
        return z_cond, feats

    def _unet_eps(self, x, z_cond, m_cond, t):
        cd = self.compute_dtype
        unet_in = torch.cat([x.to(cd), z_cond.to(cd), m_cond.to(cd)], dim=1)
        with self._int8(self.unet_int8):
            return self.model(unet_in, t).float()

    # ----------------------------------------------------------------- train

    def encode_target(self, velocity_3d: torch.Tensor) -> torch.Tensor:
        """(B,S,3,H,W) -> E3D mu latents (B,ld,latent,lh,lw), float32; the VAE
        runs in the compute dtype (reference predictor.py:1042-1085)."""
        v = self.normalizer["output"].normalize(velocity_3d.to(self.device, torch.float32),
                                                channel_axis=2)
        with self._int8(self.vae_int8):
            mu, _ = self.vae.encode_3d_deterministic(v.transpose(1, 2).to(self.compute_dtype))
        return mu.float().transpose(1, 2)

    def forward(self, img: torch.Tensor, velocity_2d: torch.Tensor, x_start: torch.Tensor, *,
                noise: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """The noise-prediction step: each latent slice draws its own
        timestep (reference predictor.py:736), ``q_sample``, one UNet
        evaluation.

        x_start: target latents (B, ld, latent, lh, lw) from ``encode_target``;
        ``noise`` follows the same contract (any shape of as many elements),
        ``t`` is (B*ld,) in [0, T). Whichever of the two is not given is drawn
        from ``generator`` (noise first, then t) on the generator's device.
        Returns (eps_pred, noise, t, x_t), eps_pred / noise / x_t as
        (B*ld, latent, lh, lw) float32. Not under ``inference_mode``: a
        caller that needs no gradients wraps it in ``torch.no_grad()``."""
        img = img.to(self.device, torch.float32)
        velocity_2d = velocity_2d.to(self.device, torch.float32)
        z_cond, m_cond = self.prepare_conditioning(img, velocity_2d)
        b, ld = img.shape[0], x_start.shape[1]
        x0 = x_start.to(self.device, torch.float32).reshape(
            b * ld, self.latent_channels, x_start.shape[-2], x_start.shape[-1])
        if (noise is None or t is None) and generator is None:
            raise ValueError("forward() needs a generator when noise or t is not given")
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=generator.device)
        if t is None:
            t = torch.randint(0, self.num_timesteps, (b * ld,), generator=generator,
                              device=generator.device)
        noise = noise.to(self.device, torch.float32).reshape(x0.shape)
        t = t.to(self.device, torch.int64)
        x_t = self.scheduler.q_sample(x0, t, noise)
        return self._unet_eps(x_t, z_cond, m_cond, t), noise, t, x_t

    # ------------------------------------------------------------- inference

    def _init_latent_noise(self, shape, noise: Optional[torch.Tensor],
                           generator: Optional[torch.Generator]) -> torch.Tensor:
        """``noise`` (if given): (B*ld, C, lh, lw) or (B, ld, C, lh, lw)."""
        if noise is not None:
            return noise.reshape(shape).to(self.device, torch.float32)
        if generator is None:
            raise ValueError("sampling needs a generator when noise is not given")
        return torch.randn(shape, generator=generator, device=generator.device).to(self.device)

    def _setup_sampling(self, img, velocity_2d, noise, generator):
        """Shared sampler preamble: conditioning and initial latents, in the
        samplers' layout (:meth:`samples_channels_last`)."""
        with span("sampler.prepare"):
            img = img.to(self.device, torch.float32)
            velocity_2d = velocity_2d.to(self.device, torch.float32)
            z_cond, m_cond = self._conditioning(img, velocity_2d, self.samples_channels_last())
            x = self._layout(self._init_latent_noise(z_cond.shape, noise, generator))
        return img, x, z_cond, m_cond

    def _layout(self, x: torch.Tensor) -> torch.Tensor:
        """x in the samplers' layout (fresh noise is drawn channels-first)."""
        return to_channels_last(x) if self.samples_channels_last() else x

    def _t(self, x: torch.Tensor, t: int) -> torch.Tensor:
        return torch.full((x.shape[0],), int(t), dtype=torch.int64, device=x.device)

    def _ddim_loop(self, x, z_cond, m_cond, num_steps: int, eta: float = 0.0,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ts = ddim_timesteps(self.num_timesteps, num_steps)
        ts_prev = list(ts[1:]) + [-1]
        for t, t_prev in zip(ts, ts_prev):
            with span("sampler.step"):
                t_batch = self._t(x, t)
                eps = self._unet_eps(x, z_cond, m_cond, t_batch)
                step_noise = None
                if eta > 0:
                    step_noise = self._layout(torch.randn(x.shape, generator=generator,
                                                          device=generator.device).to(x.device))
                x = self.scheduler.ddim_sample(eps, x, t_batch, int(t_prev), eta=eta,
                                               noise=step_noise, clip_range=CLIP)
        return x

    def _ddpm_loop(self, x, z_cond, m_cond, step_noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The T-step ancestral loop; step i (t = T-1-i) takes ``step_noise[i]``
        or, without a table, the i-th draw from ``generator``."""
        n_steps = self.num_timesteps
        if step_noise is not None:
            step_noise = step_noise.reshape((n_steps,) + tuple(x.shape)).to(x.device, torch.float32)
        for i, t in enumerate(range(n_steps - 1, -1, -1)):
            with span("sampler.step"):
                t_batch = self._t(x, t)
                eps = self._unet_eps(x, z_cond, m_cond, t_batch)
                if step_noise is not None:
                    z = self._layout(step_noise[i])
                else:
                    z = self._layout(torch.randn(x.shape, generator=generator,
                                                 device=generator.device).to(x.device))
                x = self.scheduler.p_sample(eps, x, t_batch, z, clip_denoised=True,
                                            clip_range=CLIP)
        return x

    def _one_step(self, x, z_cond, m_cond) -> torch.Tensor:
        """T = 1: x0 from the one UNet evaluation at t = 0 (reference
        predictor.py:823-838)."""
        with span("sampler.step"):
            eps = self._unet_eps(x, z_cond, m_cond, self._t(x, 0))
            alpha_bar = self.scheduler.alphas_cumprod[0]
            x = (x - torch.sqrt(1 - alpha_bar) * eps) / torch.sqrt(alpha_bar)
            return torch.clamp(x, *CLIP)

    def _dpm_loop(self, x, z_cond, m_cond, num_steps: int, order: int) -> torch.Tensor:
        # a repeated node (num_steps > T) would be a zero-width step: dedupe,
        # descending, which leaves the trajectory as it is
        ts = np.unique(ddim_timesteps(self.num_timesteps, num_steps))[::-1]
        c = dpm_solver_coefficients(self.host_alphas_cumprod(), ts, order=order)
        prev_x0 = torch.zeros_like(x)
        for i, t in enumerate(c["t"]):
            with span("sampler.step"):
                eps = self._unet_eps(x, z_cond, m_cond, self._t(x, t))
                x0 = (x - float(c["sigma_cur"][i]) * eps) / max(float(c["alpha_cur"][i]), 1e-8)
                x0 = torch.clamp(x0, *CLIP)
                d = x0 + float(c["c2"][i]) * (x0 - prev_x0)
                x = float(c["sigma_ratio"][i]) * x + float(c["x0_coef"][i]) * d
                prev_x0 = x0
        return x

    def _decode_and_finish(self, x, img):
        """Latents (B*ld, C, lh, lw) -> masked velocity (B, S, 3, H, W); on
        channels-last latents D3D's input is their view, and the output is
        made contiguous."""
        with span("sampler.decode"):
            b, s, h, w = img.shape[0], img.shape[1], img.shape[-2], img.shape[-1]
            ld = x.shape[0] // b
            z = x.reshape(b, ld, self.latent_channels, x.shape[-2], x.shape[-1]).transpose(1, 2)
            with self._int8(self.vae_int8):
                vel = self.vae.decode_3d(z.to(self.compute_dtype)).float()  # (B, 3, ld, H, W)
            vel = self.normalizer["output"].inverse(vel, channel_axis=1)
            if ld != s:
                vel = interpolate_trilinear(vel, s, h, w)
            out = vel.transpose(1, 2) * img                             # mask over C
            return out.contiguous() if self.samples_channels_last() else out

    @torch.inference_mode()
    def predict(self, img: torch.Tensor, velocity_2d: torch.Tensor, *,
                noise: Optional[torch.Tensor] = None,
                step_noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The full T-step DDPM ancestral loop, x0 clipped to +/-30 (reference
        predict(), predictor.py:754-896).

        ``step_noise``: an optional channels-first table (T, B*ld, C, lh, lw)
        of each step's noise, entry i for the i-th step taken (t = T-1-i).
        Without it each step draws its noise from ``generator`` in step order,
        the reference's ``torch.randn_like`` order (the JAX package folds its
        key by t instead, so the bits differ by design; the table holds the
        two to the same numbers)."""
        if generator is None and step_noise is None and self.num_timesteps > 1:
            raise ValueError("predict() needs a generator (or a step_noise table) for the "
                             "per-step ancestral noise")
        with span("sampler.call"):
            img, x, z_cond, m_cond = self._setup_sampling(img, velocity_2d, noise, generator)
            if self.num_timesteps == 1:
                x = self._one_step(x, z_cond, m_cond)
            else:
                x = self._ddpm_loop(x, z_cond, m_cond, step_noise, generator)
            return self._decode_and_finish(x, img)

    @torch.inference_mode()
    def predict_ddim(self, img: torch.Tensor, velocity_2d: torch.Tensor,
                     num_steps: int = 50, eta: float = 0.0, *,
                     noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """N-step DDIM sampling (reference predict_ddim); ``eta > 0`` draws
        step noise from ``generator``."""
        if eta > 0 and generator is None:
            raise ValueError("predict_ddim(eta>0) draws stochastic step noise; pass generator=")
        with span("sampler.call"):
            img, x, z_cond, m_cond = self._setup_sampling(img, velocity_2d, noise, generator)
            x = self._ddim_loop(x, z_cond, m_cond, num_steps, eta, generator)
            return self._decode_and_finish(x, img)

    @torch.inference_mode()
    def predict_dpm(self, img: torch.Tensor, velocity_2d: torch.Tensor,
                    num_steps: int = 10, *, order: int = 2,
                    noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Multistep DPM-Solver++ (deterministic; ``order`` 1 or 2) over the
        DDIM timestep spacing, one UNet evaluation a distinct timestep.
        ``order=1`` is DDIM(eta=0) while the x0 clip is inactive."""
        with span("sampler.call"):
            img, x, z_cond, m_cond = self._setup_sampling(img, velocity_2d, noise, generator)
            x = self._dpm_loop(x, z_cond, m_cond, num_steps, order)
            return self._decode_and_finish(x, img)
