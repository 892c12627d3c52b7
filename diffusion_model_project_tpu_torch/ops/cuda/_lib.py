"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Each ``.cu`` source is compiled by its own ``nvcc`` process (all started at
once) for ``sm_90a``, and the objects are linked into one ``libkernels.so``
with a plain C interface, loaded with ``ctypes``. The library lives in
``_build/<hash of the sources and headers>/``, so an edited source or
``.cuh`` header builds afresh and an unchanged tree is reused. The kernels
reach the driver's ``cuTensorMapEncodeTiled`` through the runtime's
``cudaGetDriverEntryPoint``, so the library links no ``-lcuda``. Nothing
here runs at import time: the first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry points: name -> argtypes (each returns cudaError_t as int)
_SIGNATURES = {
    "dm_groupnorm_act": [_P, _P, _P, _P, _P, _P, _F, _P],
    "dm_groupnorm_max_cluster": [_P],
    "dm_gemm_bias": [_I, _P, _P, _L, _L, _P, _P, _L, _L, _L, _I, _I, _I, _I, _P],
    "dm_attention_core": [_I, _P, _P, _L, _L, _I, _I, _F, _I, _I, _I, _P],
    "dm_conv3x3": [_I, _I, _P, _P, _P, _L, _L, _L, _L, _L, _I, _I, _P],
    "dm_int8_conv": [_I, _P, _P, _P, _P] + [_I] * 18 + [_P],
}

_lib = None
build_seconds = None  # wall time of the build in this process, None if cached


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources() -> list:
    """The sources ``nvcc`` compiles, one object each."""
    return sorted(SRC_DIR.glob("*.cu"))


def _digest() -> str:
    """Hash of every source and header under ``SRC_DIR`` and of the flags."""
    h = hashlib.sha256()
    for s in sources() + sorted(SRC_DIR.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link ``libkernels.so``; returns its path."""
    global build_seconds
    srcs = sources()
    out_dir = BUILD_DIR / _digest()
    so = out_dir / "libkernels.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in srcs:
        obj = out_dir / (src.stem + ".o")
        log = open(out_dir / (src.stem + ".log"), "w")
        procs.append((src, obj, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, obj, log, proc in procs:
        proc.wait()
        log.close()
        if proc.returncode != 0:
            failed.append((src.name, (out_dir / (src.stem + ".log")).read_text()))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(f"--- {n}\n{t}" for n, t in failed))
    tmp = out_dir / f"libkernels.{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         *[str(o) for _, o, _, _ in procs], "-o", str(tmp)],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    return so


def build_log() -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory, spills)."""
    out_dir = BUILD_DIR / _digest()
    return "\n".join(p.read_text() for p in sorted(out_dir.glob("*.log")))


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(t) -> int:
    """The handle of PyTorch's current CUDA stream on ``t``'s device. The raw
    handle (as Triton's launcher reads it) skips building a ``torch.cuda.Stream``,
    which costs host time on every launch of a host-bound loop."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)
