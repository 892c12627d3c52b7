"""Serving export: the whole sampling pipeline as one ``torch.export`` archive
(the port's counterpart of the JAX ``utils/export.py``).

``export_sampler`` traces ``predict_ddim`` or ``predict_dpm`` (EDT ->
conditioning encode -> the sampler's steps -> decode -> denormalize -> mask)
with ``torch.export.export`` at fixed shapes and returns the ``.pt2``
archive's bytes. The sampler's Python loop unrolls: a DDIM-N program holds N
UNet evaluations, and every scheduler coefficient, the timesteps and the
``distance_transform`` flag are constants of the program. The weights travel
in the archive as the program's state, once, whatever the step count (the
layout the JAX package calls weights-as-arguments); ``bake_weights=True``,
the JAX layout with weights as constants of the module, has no counterpart
and is refused.

K1 (GroupNorm + activation), K2 (self-attention) and K4 (the int8 conv of
an int8 predictor) reach their kernels through ``ctypes``, which
``torch.export`` cannot trace, so the wrappers trace as registered ops
(``torch.ops.dm_port.groupnorm_act``, ``torch.ops.dm_port.fused_attention``
and ``torch.ops.dm_port.int8_conv``) whose bodies are the wrappers: the
exported program launches the hand-written kernels on the card and takes
their plain versions on the CPU. A host that loads an archive therefore
needs torch and this package (importing this module registers the ops; the
kernels build on their first launch); it needs none of the model code's
configuration or checkpoint plumbing.

Shapes are static (batch baked at export time): a set of batch sizes is
exported as a set of archives. The program runs on the device it was traced
on, the predictor's.
"""
from __future__ import annotations

import io
import os
import tempfile
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

# importing the wrappers registers K1's, K2's and K4's ops, which load_sampler needs
from ..ops.cuda import attention as _k2  # noqa: F401
from ..ops.cuda import groupnorm_act as _k1  # noqa: F401
from ..ops.cuda import int8_conv as _k4  # noqa: F401

INPUT_NAMES = ("img", "velocity_2d", "noise")


class _SamplerProgram(nn.Module):
    """The traced function: one sampler call at fixed steps and options. The
    predictor enters its int8 contexts inside the samplers' bodies, so an
    int8 predictor's program traces K4's op with the quantize pass."""

    def __init__(self, pred, sampler: str, num_steps: int, eta: float):
        super().__init__()
        self.pred = pred
        self.sampler, self.num_steps, self.eta = sampler, num_steps, eta

    def forward(self, img, velocity_2d, noise):
        # the samplers' undecorated bodies: torch.export traces no
        # inference_mode region
        cls = type(self.pred)
        if self.sampler == "dpm":
            return cls.predict_dpm.__wrapped__(self.pred, img, velocity_2d,
                                               num_steps=self.num_steps, noise=noise)
        return cls.predict_ddim.__wrapped__(self.pred, img, velocity_2d,
                                            num_steps=self.num_steps, eta=self.eta,
                                            noise=noise)


def export_program(pred, *, batch: int, num_steps: int = 50, eta: float = 0.0,
                   sampler: str = "ddim", image_hw: Tuple[int, int] = (256, 256),
                   num_slices: int = 11):
    """The ``torch.export.ExportedProgram`` of one sampler call on ``pred``'s
    device: ``f(img (B,S,1,H,W), velocity_2d (B,S,3,H,W), noise (B*ld, C,
    H/4, W/4))`` -> the masked, denormalized (B, S, 3, H, W) velocity, all
    float32 and channels-first."""
    if sampler not in ("ddim", "dpm"):
        raise ValueError(f"unknown sampler {sampler!r} (ddim | dpm)")
    if eta != 0.0 and sampler == "ddim":
        raise ValueError("the exported program takes no generator: DDIM eta must be 0")
    h, w = image_hw
    s = num_slices
    ld = s // pred.vae_depth_factor
    dev = pred.device
    args = (torch.zeros((batch, s, 1, h, w), device=dev),
            torch.zeros((batch, s, 3, h, w), device=dev),
            torch.zeros((batch * ld, pred.latent_channels, h // 4, w // 4), device=dev))
    args[0][..., 0, 0] = 1.0  # one fluid voxel, as the server's warm-up input
    frozen = [p for p in pred.parameters() if p.requires_grad]
    try:
        for p in frozen:
            p.requires_grad_(False)
        return torch.export.export(_SamplerProgram(pred, sampler, int(num_steps), float(eta)),
                                   args, strict=False)
    finally:
        for p in frozen:
            p.requires_grad_(True)


def export_sampler(pred, *, batch: int, num_steps: int = 50, eta: float = 0.0,
                   sampler: str = "ddim", image_hw: Tuple[int, int] = (256, 256),
                   num_slices: int = 11, platforms: Optional[Sequence[str]] = None,
                   bake_weights: bool = False) -> bytes:
    """Serialize the sampling pipeline to a ``.pt2`` archive (``sampler``:
    "ddim" or "dpm", DPM-Solver++(2M)); see :func:`export_program` for the
    program's signature. ``platforms``: the device type(s) the program is
    for; a torch program runs on the device it is traced on, so it may name
    only the predictor's (default). ``bake_weights=True`` is refused: an
    archive always carries its weights as the program's state."""
    if bake_weights:
        raise ValueError(
            "bake_weights=True is not supported: a torch.export archive always carries "
            "the weights as the program's state, next to the graph (the JAX package's "
            "bake_weights=False layout); weights as graph constants have no counterpart")
    if platforms is not None and set(platforms) != {pred.device.type}:
        raise ValueError(
            f"platforms {tuple(platforms)}: a torch program runs on the device it is traced "
            f"on; move the predictor to the target device ({pred.device.type} now)")
    ep = export_program(pred, batch=batch, num_steps=num_steps, eta=eta, sampler=sampler,
                        image_hw=image_hw, num_slices=num_slices)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def input_shapes(ep) -> dict:
    """The exported program's input shapes, by name."""
    names = ep.graph_signature.user_inputs
    nodes = {n.name: n for n in ep.graph.nodes if n.op == "placeholder"}
    return {public: tuple(nodes[name].meta["val"].shape)
            for public, name in zip(INPUT_NAMES, names)}


def load_sampler(blob: bytes):
    """Deserialize an ``export_sampler`` archive into a ready callable
    ``f(img, velocity_2d, noise) -> velocity`` (float32 tensors on the
    device the program was traced on; run under ``inference_mode``). Wrong
    shapes raise ``ValueError``. ``f.program`` is the ``ExportedProgram``."""
    ep = torch.export.load(io.BytesIO(blob))
    shapes = input_shapes(ep)
    module = ep.module()

    def call(img, velocity_2d, noise):
        for name, x in zip(INPUT_NAMES, (img, velocity_2d, noise)):
            if tuple(x.shape) != shapes[name]:
                raise ValueError(f"{name}: shape {tuple(x.shape)} != the exported "
                                 f"program's {shapes[name]}")
        with torch.inference_mode():
            return module(img, velocity_2d, noise)

    call.program = ep  # the ExportedProgram, for inspection
    return call


def save_sampler(path: str, pred, **kwargs) -> None:
    """Export, then atomically replace ``path``. The export can fail (out of
    memory, a shape it refuses, an interrupt); truncating the output first
    would destroy the previous good archive and leave an empty file that
    load_sampler_file later fails on opaquely."""
    blob = export_sampler(pred, **kwargs)
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_sampler_file(path: str):
    with open(path, "rb") as f:
        return load_sampler(f.read())
