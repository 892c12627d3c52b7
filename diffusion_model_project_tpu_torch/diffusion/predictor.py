"""LatentDiffusionPredictor: frozen dual-branch VAE + UNet + scheduler.

Counterpart of the JAX ``diffusion/predictor.py`` on the DDIM inference path:
  img (B,S,1,H,W), velocity_2d (B,S,3,H,W)
    -> EDT + normalize the mask, bilinear to the latent grid
    -> E2D encode (deterministic mu) of the normalized 2D velocity
    -> N DDIM steps of the UNet on B*S latent slices
    -> D3D decode, denormalize, mask -> (B,S,3,H,W).
The public contract is channels-first, as in the JAX package; inside, the
VAE sees (B, C, S, H, W) and the UNet (B*S, C, lh, lw). Module names follow
the reference predictor state dict (``model.*``, ``vae.*``, ``scheduler.*``,
``normalizer.{input,output}.scale_factors``, ``distance_transform``).
The DDPM, DPM-Solver and training entry points are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..models.unet import UNet
from ..models.vae import REFERENCE_FEATURES, DualBranchVAE
from ..ops.distance import distance_transform_edt
from ..ops.normalizer import MaxNormalizer
from ..ops.resize import interpolate_bilinear
from ..utils.device import resolve_device
from .scheduler import DiffusionScheduler, ddim_timesteps


class LatentDiffusionPredictor(nn.Module):
    def __init__(self, model_kwargs: dict, *, num_timesteps: int = 1000,
                 distance_transform: bool = True, latent_channels: Optional[int] = None,
                 vae_features: Optional[Sequence[int]] = None,
                 compute_dtype: torch.dtype = torch.float32, device="cuda"):
        """Modules with torch's default init on ``device`` (default 'cuda';
        raises without CUDA unless device='cpu'); ``create`` gives them the
        JAX package's initializers, ``load_state_dict`` given weights."""
        super().__init__()
        device = resolve_device(device)
        model_kwargs = dict(model_kwargs)
        model_kwargs.setdefault("time_embedding_dim", 64)
        self.model = UNet(**model_kwargs)
        latent_channels = latent_channels or model_kwargs.get("out_channels", 4)
        self.vae = DualBranchVAE(latent_channels=latent_channels,
                                 features=vae_features or REFERENCE_FEATURES)
        self.scheduler = DiffusionScheduler(num_timesteps)
        self.normalizer = nn.ModuleDict({"input": MaxNormalizer([1.0]),
                                         "output": MaxNormalizer([1.0] * 3)})
        self.register_buffer("distance_transform",
                             torch.tensor([1.0 if distance_transform else 0.0]))
        self.num_timesteps = num_timesteps
        # dtype of conv and matmul compute; scheduler math, normalization and
        # GroupNorm statistics stay float32
        self.compute_dtype = compute_dtype
        self.to(device)

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

    def pre_process(self, img_flat: torch.Tensor) -> torch.Tensor:
        """EDT (if enabled) + input normalization of (N, 1, H, W) masks."""
        if bool(self.distance_transform.item()):
            img_flat = distance_transform_edt(img_flat[:, 0])[:, None]
        return self.normalizer["input"].normalize(img_flat, channel_axis=1)

    def prepare_conditioning(self, img: torch.Tensor, velocity_2d: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """img (B,S,1,H,W), velocity_2d (B,S,3,H,W) ->
        z_cond (B*S, latent, lh, lw), m_cond (B*S, 1, lh, lw), float32.
        The VAE preserves depth, so the latent depth is S."""
        b, s = img.shape[0], velocity_2d.shape[1]
        h, w = img.shape[-2], img.shape[-1]
        lh, lw = h // 4, w // 4

        v2d = self.normalizer["output"].normalize(velocity_2d, channel_axis=2)
        z_cond, _ = self.vae.encode_2d_deterministic(
            v2d.transpose(1, 2).to(self.compute_dtype))        # (B, C, S, lh, lw)
        z_cond = z_cond.float().transpose(1, 2).reshape(b * s, self.latent_channels, lh, lw)

        feats = self.pre_process(img.reshape(b * s, 1, h, w))
        return z_cond, interpolate_bilinear(feats, lh, lw)     # (B*S, 1, lh, lw)

    def _unet_eps(self, x, z_cond, m_cond, t):
        cd = self.compute_dtype
        unet_in = torch.cat([x.to(cd), z_cond.to(cd), m_cond.to(cd)], dim=1)
        return self.model(unet_in, t).float()

    # ------------------------------------------------------------- inference

    def _init_latent_noise(self, shape, noise: Optional[torch.Tensor],
                           generator: Optional[torch.Generator]) -> torch.Tensor:
        """``noise`` (if given): (B*S, C, lh, lw) or (B, S, C, lh, lw)."""
        if noise is not None:
            return noise.reshape(shape).to(self.device, torch.float32)
        if generator is None:
            raise ValueError("sampling needs a generator when noise is not given")
        return torch.randn(shape, generator=generator, device=generator.device).to(self.device)

    def _setup_sampling(self, img, velocity_2d, noise, generator):
        """Shared sampler preamble: conditioning and initial latents."""
        img = img.to(self.device, torch.float32)
        velocity_2d = velocity_2d.to(self.device, torch.float32)
        b, s = img.shape[0], velocity_2d.shape[1]
        lh, lw = img.shape[-2] // 4, img.shape[-1] // 4
        z_cond, m_cond = self.prepare_conditioning(img, velocity_2d)
        x = self._init_latent_noise((b * s, self.latent_channels, lh, lw), noise, generator)
        return img, x, z_cond, m_cond

    def _ddim_loop(self, x, z_cond, m_cond, num_steps: int, eta: float = 0.0,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ts = ddim_timesteps(self.num_timesteps, num_steps)
        ts_prev = list(ts[1:]) + [-1]
        for t, t_prev in zip(ts, ts_prev):
            t_batch = torch.full((x.shape[0],), int(t), dtype=torch.int64, device=x.device)
            eps = self._unet_eps(x, z_cond, m_cond, t_batch)
            step_noise = None
            if eta > 0:
                step_noise = torch.randn(x.shape, generator=generator,
                                         device=generator.device).to(x.device)
            x = self.scheduler.ddim_sample(eps, x, t_batch, int(t_prev), eta=eta,
                                           noise=step_noise, clip_range=(-30.0, 30.0))
        return x

    def _decode_and_finish(self, x, img):
        """Latents (B*S, C, lh, lw) -> masked velocity (B, S, 3, H, W)."""
        b, s = img.shape[0], img.shape[1]
        z = x.reshape(b, s, self.latent_channels, x.shape[-2], x.shape[-1]).transpose(1, 2)
        vel = self.vae.decode_3d(z.to(self.compute_dtype)).float()   # (B, 3, S, H, W)
        vel = self.normalizer["output"].inverse(vel, channel_axis=1)
        return vel.transpose(1, 2) * img                            # mask over C

    @torch.inference_mode()
    def predict_ddim(self, img: torch.Tensor, velocity_2d: torch.Tensor,
                     num_steps: int = 50, eta: float = 0.0, *,
                     noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """N-step DDIM sampling (reference predict_ddim); ``eta > 0`` draws
        step noise from ``generator``."""
        if eta > 0 and generator is None:
            raise ValueError("predict_ddim(eta>0) draws stochastic step noise; pass generator=")
        img, x, z_cond, m_cond = self._setup_sampling(img, velocity_2d, noise, generator)
        x = self._ddim_loop(x, z_cond, m_cond, num_steps, eta, generator)
        return self._decode_and_finish(x, img)
