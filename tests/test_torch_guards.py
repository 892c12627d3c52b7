"""Guards that keep the PyTorch port separate from the JAX package and keep
its kernels from falling back: no import of ``jax``, ``flax``, ``msgpack`` or
``diffusion_model_project_tpu`` anywhere in the port or in ``chip_smoke.py``,
no CPU default for the entry points (the serving, export and benchmark CLIs
too), and kernel modules that import without ``nvcc`` or CUDA."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from test_torch_train_step import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "diffusion_model_project_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "msgpack", "diffusion_model_project_tpu"}


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
    names = {str(f.relative_to(PORT)) for f in files[:-1]}
    assert {"inference.py", "data/dataset.py", "utils/checkpoint.py", "utils/flax_msgpack.py",
            "utils/torch_import.py", "evaluate.py", "inference_vae.py",
            "scripts/eval_testset_end2end.py", "losses/metrics.py", "losses/eval_metrics.py",
            "training/helper.py", "training/steps.py", "utils/vae_config.py",
            "train.py", "training/train_diffusion.py", "losses/physics.py",
            "utils/async_ckpt.py", "utils/preempt.py", "utils/tb.py", "utils/config.py",
            "train_3d_vae_only.py", "train_2d_with_cross.py", "training/accum.py",
            "training/train_vae_stage1.py", "training/train_vae_stage2.py", "data/split.py",
            "data/statistics.py", "scripts/generate_statistics.py",
            "scripts/data_split.py", "utils/serving.py", "utils/export.py",
            "utils/profiling.py", "utils/torch_export.py", "scripts/serve.py",
            "scripts/export_sampler.py", "scripts/perf_serving.py",
            "scripts/perf_serve_daemon.py", "scripts/perf_serve_latency.py",
            "scripts/export_torch.py", "scripts/plot_loss.py",
            "scripts/plot_physics_metrics.py", "scripts/plot_vae_loss.py"} <= names
    offenders = {str(f.relative_to(REPO)): sorted(set(_imported_top_levels(f)) & FORBIDDEN)
                 for f in files}
    assert {k: v for k, v in offenders.items() if v} == {}


def _uses_torch_compile(tree: ast.AST) -> bool:
    """Whether the module refers to ``torch.compile`` (called, passed or as a
    decorator, under any name torch or its ``compile`` is imported as);
    ``torch.compiler`` is another name."""
    torch_names, compile_names = {"torch"}, set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            torch_names |= {a.asname for a in node.names if a.name == "torch" and a.asname}
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            compile_names |= {a.asname or a.name for a in node.names if a.name == "compile"}
    return any((isinstance(node, ast.Attribute) and node.attr == "compile"
                and isinstance(node.value, ast.Name) and node.value.id in torch_names)
               or (isinstance(node, ast.Name) and node.id in compile_names)
               for node in ast.walk(tree))


def test_port_calls_no_library_kernel_for_k1_or_k2():
    # GroupNorm and self-attention run in the hand-written kernels; library
    # versions may appear only as chip_smoke.py's timing yardstick
    calls = ("scaled_dot_product_attention", "F.group_norm",
             "nn.GroupNorm(", "nn.MultiheadAttention(")
    found = {str(f.relative_to(REPO)): [c for c in calls if c in f.read_text()]
             + (["torch.compile"] if _uses_torch_compile(ast.parse(f.read_text())) else [])
             for f in _port_sources()}
    assert {k: v for k, v in found.items() if v} == {}
    # the rule itself: every way of reaching torch.compile, and not torch.compiler
    for text in ("import torch\nf = torch.compile(g)", "import torch as t\n@t.compile\ndef f(): pass",
                 "from torch import compile\ncompile(g)", "from torch import compile as c\nh = c"):
        assert _uses_torch_compile(ast.parse(text)), text
    for text in ("import torch\ntorch.compiler.is_compiling()", "import re\nre.compile('x')",
                 "from torch import compiler\ncompiler.is_compiling()"):
        assert not _uses_torch_compile(ast.parse(text)), text


def test_k3_wrapper_calls_no_library_conv():
    # the models' convolutions stay on cuDNN and the probe times it as its
    # yardstick; K3's wrapper and plain version compute without it
    text = (PORT / "ops" / "cuda" / "conv3x3.py").read_text()
    calls = ("conv2d", "_conv_forward", "F.conv", "torch.conv", "cudnn")
    assert [c for c in calls if c in text] == []


def test_k2_products_stay_hand_written():
    # the projections are part of the TPU kernel's body, so K2 computes them
    # in its own kernels: no library GEMM in the sources, no PyTorch product
    # in the wrapper (its CPU branch calls the plain version in ops/attention.py)
    csrc = sorted((PORT / "csrc").glob("*.cu")) + sorted((PORT / "csrc").glob("*.cuh"))
    assert any(f.suffix == ".cuh" for f in csrc)
    libraries = ("cublas", "cudnn", "cutlass/gemm", "cutlass/device", "cute/")
    includes = {f.name: [ln.lower() for ln in f.read_text().splitlines()
                         if ln.lstrip().startswith("#include")] for f in csrc}
    found = {k: [ln for ln in v if any(w in ln for w in libraries)] for k, v in includes.items()}
    assert {k: v for k, v in found.items() if v} == {}
    text = (PORT / "ops" / "cuda" / "attention.py").read_text()
    assert [c for c in ("F.linear", "torch.matmul", "torch.mm", "torch.bmm", "einsum")
            if c in text] == []
    tree = ast.parse(text)
    assert not [n for n in ast.walk(tree)
                if isinstance(n, (ast.BinOp, ast.AugAssign)) and isinstance(n.op, ast.MatMult)]


def test_import_chain_leaves_jax_unloaded():
    code = ("import sys\n"
            "import diffusion_model_project_tpu_torch\n"
            "from diffusion_model_project_tpu_torch.diffusion.predictor import "
            "LatentDiffusionPredictor\n"
            "import diffusion_model_project_tpu_torch.ops.cuda.attention\n"
            "import diffusion_model_project_tpu_torch.ops.cuda.groupnorm_act\n"
            "import diffusion_model_project_tpu_torch.ops.cuda.conv3x3\n"
            "import diffusion_model_project_tpu_torch.ops.cuda.int8_conv\n"
            "import diffusion_model_project_tpu_torch.ops.quant\n"
            "import diffusion_model_project_tpu_torch.scripts.perf_probe_conv\n"
            "import diffusion_model_project_tpu_torch.inference\n"
            "import diffusion_model_project_tpu_torch.data\n"
            "import diffusion_model_project_tpu_torch.utils.checkpoint\n"
            "import diffusion_model_project_tpu_torch.utils.flax_msgpack\n"
            "import diffusion_model_project_tpu_torch.evaluate\n"
            "import diffusion_model_project_tpu_torch.inference_vae\n"
            "import diffusion_model_project_tpu_torch.scripts.eval_testset_end2end\n"
            "import diffusion_model_project_tpu_torch.losses\n"
            "import diffusion_model_project_tpu_torch.training.steps\n"
            "import diffusion_model_project_tpu_torch.utils.vae_config\n"
            "import diffusion_model_project_tpu_torch.train\n"
            "import diffusion_model_project_tpu_torch.training.train_diffusion\n"
            "import diffusion_model_project_tpu_torch.utils.async_ckpt\n"
            "import diffusion_model_project_tpu_torch.train_3d_vae_only\n"
            "import diffusion_model_project_tpu_torch.train_2d_with_cross\n"
            "import diffusion_model_project_tpu_torch.scripts.generate_statistics\n"
            "import diffusion_model_project_tpu_torch.scripts.data_split\n"
            "import diffusion_model_project_tpu_torch.utils.serving\n"
            "import diffusion_model_project_tpu_torch.utils.export\n"
            "import diffusion_model_project_tpu_torch.utils.profiling\n"
            "import diffusion_model_project_tpu_torch.utils.torch_export\n"
            "import diffusion_model_project_tpu_torch.scripts.serve\n"
            "import diffusion_model_project_tpu_torch.scripts.export_sampler\n"
            "import diffusion_model_project_tpu_torch.scripts.perf_serving\n"
            "import diffusion_model_project_tpu_torch.scripts.perf_serve_daemon\n"
            "import diffusion_model_project_tpu_torch.scripts.perf_serve_latency\n"
            "import diffusion_model_project_tpu_torch.scripts.export_torch\n"
            "import diffusion_model_project_tpu_torch.scripts.plot_loss\n"
            "import diffusion_model_project_tpu_torch.scripts.plot_physics_metrics\n"
            "import diffusion_model_project_tpu_torch.scripts.plot_vae_loss\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'msgpack', 'diffusion_model_project_tpu'))\n"
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


def test_run_dir_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    import json

    from diffusion_model_project_tpu_torch import inference
    from diffusion_model_project_tpu_torch.utils.checkpoint import (
        build_predictor, predictor_from_directory)
    from diffusion_model_project_tpu_torch.utils.config import PUBLISHED_UNET_KWARGS

    predictor = {"model_name": "UNet", "model_kwargs": dict(PUBLISHED_UNET_KWARGS)}
    (tmp_path / "log.json").write_text(json.dumps({"params": {"training": {
        "predictor_type": "latent-diffusion", "predictor": predictor}}}))
    np_file = tmp_path / "sample.npz"
    import numpy as np

    np.savez(np_file, microstructure=np.ones((2, 1, 8, 8), np.float32),
             velocity_input=np.zeros((2, 3, 8, 8), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_predictor(predictor)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predictor_from_directory(str(tmp_path))
    assert inference.parse_args(["--model-dir", str(tmp_path)]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inference.run(["--model-dir", str(tmp_path), "--input-file", str(np_file)])


def test_vae_training_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    from diffusion_model_project_tpu_torch.training import train_vae_stage1, train_vae_stage2

    s1 = ["--dataset-dir", str(tmp_path)]
    s2 = [*s1, "--stage1-checkpoint", str(tmp_path)]
    assert train_vae_stage1.parse_args(s1).device == "cuda"
    assert train_vae_stage2.parse_args(s2).device == "cuda"
    for main, argv in ((train_vae_stage1.main, s1), (train_vae_stage2.main, s2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)


def test_serving_and_export_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    import json

    from diffusion_model_project_tpu_torch.scripts import (export_sampler, perf_serve_daemon,
                                                           perf_serve_latency, perf_serving,
                                                           serve)
    from diffusion_model_project_tpu_torch.utils.config import PUBLISHED_UNET_KWARGS

    predictor = {"model_name": "UNet", "model_kwargs": dict(PUBLISHED_UNET_KWARGS)}
    (tmp_path / "log.json").write_text(json.dumps({"params": {"training": {
        "predictor_type": "latent-diffusion", "predictor": predictor}}}))
    run = ["--model-dir", str(tmp_path)]
    clis = ((serve, run), (export_sampler, run + ["--out", str(tmp_path / "x.pt2")]),
            (perf_serving, []), (perf_serve_daemon, []), (perf_serve_latency, []))
    for cli, argv in clis:
        assert cli.parse_args(argv).device == "cuda", cli.__name__
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)
    assert not (tmp_path / "x.pt2").exists()
    # the run-dir converter touches no device: it reads msgpack and writes .pt
    text = (PORT / "scripts" / "export_torch.py").read_text() + \
        (PORT / "utils" / "torch_export.py").read_text()
    assert "cuda" not in text and "resolve_device" not in text
