"""Build and load the hand-written CUDA kernels at first use.

Each `csrc/<name>.cu` is compiled by its own `nvcc` into
`build/haff_tpu_torch/<name>-<hash>.so` at the root of the checkout
(ignored by git), all sources at once in parallel, and loaded with
`ctypes`: a plain C interface taking device pointers as `c_void_p` and
the CUDA stream, returning the `cudaError_t` of the launch. Nothing is
compiled when the package is imported; the first wrapper call on a CUDA
tensor builds (or reuses, when the source hash matches) the library. A
failed build raises `KernelBuildError` with nvcc's output.

Also holds `LAUNCHES`, the launch counter every wrapper adds one to
where it launches its kernel (`count`), so a run can show which kernels
its path went through.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "haff_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Sources in csrc/ that are kernels (each one its own library).
SOURCES = ("sam_window_attn", "sam_global_attn", "flash_prefill", "flash_bwd",
           "decode_attn", "w8a8_matmul", "w4a16_matmul", "matmul_probe",
           "add_layer_norm", "moe_decode", "mla_decode_attn")

LAUNCHES: "collections.Counter[str]" = collections.Counter()

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time or 0.0 when reused, "ptxas": nvcc's -v text}
BUILD_INFO: Dict[str, dict] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (PATH or $CUDA_HOME/bin); the CUDA kernels of "
            "haff_tpu_torch build from source at first use")
    return nvcc


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all(names=SOURCES) -> Dict[str, dict]:
    """Compile every source not yet built, one nvcc per source, all
    started together; load each library. Returns BUILD_INFO."""
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        if not todo:
            return BUILD_INFO
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for name in todo:
            lib = BUILD_DIR / f"{name}-{_digest(name)}.so"
            if lib.exists():
                BUILD_INFO[name] = {"seconds": 0.0, "ptxas": "(reused)",
                                    "path": str(lib)}
                continue
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, lib)
        errors = []
        for name, (proc, tmp, lib) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                              f"{log}")
                continue
            os.replace(tmp, lib)
            BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                                "ptxas": log, "path": str(lib)}
        if errors:
            raise KernelBuildError("kernel build failed:\n" + "\n".join(errors))
        for name in todo:
            _LIBS[name] = ctypes.CDLL(BUILD_INFO[name]["path"])
        return BUILD_INFO


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = _LIBS[name]
    return lib


def count(name: str, q, path: int) -> None:
    """Add one launch of kernel `name` to LAUNCHES; a bf16 launch on path
    0, every kernel's scalar path, also counts under `<name>/scalar`."""
    LAUNCHES[name] += 1
    if q.dtype == torch.bfloat16 and path == 0:
        LAUNCHES[name + "/scalar"] += 1


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def check_operand(name: str, what: str, t, dtype, shape) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `shape`:
    a kernel reads its operands through raw pointers."""
    if not t.is_cuda:
        raise ValueError(f"{name}: {what} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def stream_handle(device) -> ctypes.c_void_p:
    """The current CUDA stream of `device` (a CUDA tensor's device, so its
    index is set) as the raw cudaStream_t the C entry points take. torch's
    raw accessor, not `torch.cuda.current_stream`, which builds a Stream
    object and costs several times a short kernel's host time."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(device.index))


def ptr(t) -> Optional[ctypes.c_void_p]:
    return None if t is None else ctypes.c_void_p(t.data_ptr())
