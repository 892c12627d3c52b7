"""Guards that keep the PyTorch port separate from the JAX package and keep
its kernels from falling back: no import of ``jax`` or of
``diffusion_model_project_tpu`` anywhere in the port or in ``chip_smoke.py``,
no CPU default for the entry points, and kernel modules that import without
``nvcc`` or CUDA."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "diffusion_model_project_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "diffusion_model_project_tpu"}


def _port_sources():
    # _build/ holds build outputs, not the port's sources
    return [f for f in sorted(PORT.rglob("*.py")) if "_build" not in f.relative_to(PORT).parts]


def _imported_top_levels(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_and_chip_smoke_import_no_jax():
    files = _port_sources() + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    offenders = {str(f.relative_to(REPO)): sorted(set(_imported_top_levels(f)) & FORBIDDEN)
                 for f in files}
    assert {k: v for k, v in offenders.items() if v} == {}


def test_port_calls_no_library_kernel_for_k1_or_k2():
    # GroupNorm and self-attention run in the hand-written kernels; library
    # versions may appear only as chip_smoke.py's timing yardstick
    calls = ("scaled_dot_product_attention", "F.group_norm", "torch.compile",
             "nn.GroupNorm(", "nn.MultiheadAttention(")
    found = {str(f.relative_to(REPO)): [c for c in calls if c in f.read_text()]
             for f in _port_sources()}
    assert {k: v for k, v in found.items() if v} == {}


def test_import_chain_leaves_jax_unloaded():
    code = ("import sys\n"
            "import diffusion_model_project_tpu_torch\n"
            "from diffusion_model_project_tpu_torch.diffusion.predictor import "
            "LatentDiffusionPredictor\n"
            "import diffusion_model_project_tpu_torch.ops.cuda.attention\n"
            "import diffusion_model_project_tpu_torch.ops.cuda.groupnorm_act\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'diffusion_model_project_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PATH="/usr/bin:/bin")  # no nvcc needed to import
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_point_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    from diffusion_model_project_tpu_torch.diffusion.predictor import LatentDiffusionPredictor
    from diffusion_model_project_tpu_torch.utils.config import PUBLISHED_UNET_KWARGS

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LatentDiffusionPredictor.create(dict(PUBLISHED_UNET_KWARGS))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LatentDiffusionPredictor(dict(PUBLISHED_UNET_KWARGS))
