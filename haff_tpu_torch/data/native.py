"""ctypes bindings for the native host data path (port of
haff_tpu/data/native.py over the same runtime/haff_host.cpp).

Builds the shared library with g++ at first use into
build/haff_tpu_torch/ at the root of the checkout (git-ignored; the
source under runtime/ is only read), and falls back to the Python/cv2
implementations in data/transforms.py when no compiler is available: a
host-side fallback, not a device one. The native path exists for hosts
where per-frame Python preprocessing starves the card (SURVEY.md section
2.8 "hot transforms"); HAFF_NATIVE_PREPROCESS=1 selects it in
transforms.sam_preprocess / clip_preprocess."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from typing import Optional, Tuple

import numpy as np

_LIB = None
_TRIED = False


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


SOURCE = os.path.join(_repo_root(), "runtime", "haff_host.cpp")
BUILD_DIR = os.path.join(_repo_root(), "build", "haff_tpu_torch")


def library_path() -> str:
    """Where the library is built: build/haff_tpu_torch/, keyed by a hash
    of the source, so an edited source builds anew."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libhaffhost-{digest}.so")


def _compile(so: str, native_arch: bool) -> None:
    """g++ into a temporary file beside `so`, then renamed into place."""
    tmp = f"{so}.{os.getpid()}.tmp"
    flags = ["-O3"] + (["-march=native"] if native_arch else []) + [
        "-fPIC", "-shared"]
    subprocess.run(["g++", *flags, SOURCE, "-o", tmp], check=True,
                   capture_output=True)
    os.replace(tmp, so)


def _so_runs_here(so: str) -> bool:
    """Exercise the library once in a KILLABLE subprocess. A cached .so
    built with -march=native on a newer CPU dies with SIGILL — which
    would take the whole loader process down — so probe out-of-process
    before trusting it."""
    code = (
        "import ctypes, numpy as np\n"
        f"lib = ctypes.CDLL({so!r})\n"
        "lib.sam_preprocess_f32.restype = ctypes.c_int\n"
        "img = np.zeros((4, 4, 3), np.uint8)\n"
        "out = np.empty((8, 8, 3), np.float32)\n"
        "one = np.ones(3, np.float32)\n"
        "u8 = ctypes.POINTER(ctypes.c_uint8)\n"
        "f32 = ctypes.POINTER(ctypes.c_float)\n"
        "lib.sam_preprocess_f32(img.ctypes.data_as(u8), 4, 4, 8,\n"
        "    one.ctypes.data_as(f32), one.ctypes.data_as(f32),\n"
        "    out.ctypes.data_as(f32))\n")
    try:
        return subprocess.run(
            [sys.executable, "-c", code], capture_output=True,
            timeout=60).returncode == 0
    except subprocess.TimeoutExpired:
        return False


def load_library() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        so = library_path()
        os.makedirs(BUILD_DIR, exist_ok=True)
        if not os.path.exists(so) or not _so_runs_here(so):
            try:
                _compile(so, native_arch=True)
            except subprocess.CalledProcessError:
                _compile(so, native_arch=False)
            if not _so_runs_here(so):
                # -march=native binary illegal on this CPU: portable build
                _compile(so, native_arch=False)
                if not _so_runs_here(so):
                    raise RuntimeError("native library probe failed")
        lib = ctypes.CDLL(so)
        lib.sam_preprocess_f32.restype = ctypes.c_int
        _LIB = lib
    except Exception as e:  # no compiler / load failure -> Python path
        print(f"native: falling back to Python path ({e})")
        _LIB = None
    return _LIB


def available() -> bool:
    return load_library() is not None


def sam_preprocess_native(image: np.ndarray, image_size: int,
                          mean, std) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Fused resize-longest-side + normalize + pad (C++)."""
    lib = load_library()
    assert lib is not None
    img = np.ascontiguousarray(image, np.uint8)
    h, w = img.shape[:2]
    # np.empty: the C++ writes every byte (content + pad memsets)
    out = np.empty((image_size, image_size, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    packed = lib.sam_preprocess_f32(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int(h), ctypes.c_int(w), ctypes.c_int(image_size),
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out, (packed >> 16, packed & 0xFFFF)


def clip_preprocess_native(image: np.ndarray, image_size: int,
                           mean, std) -> np.ndarray:
    """Fused bicubic short-side resize + center crop + normalize (C++).

    PIL-exact resampling (antialias, window-clipped taps, separable
    passes with intermediate uint8 rounding) — matches the PIL parity
    path to 1 LSB of fixed-point rounding."""
    lib = load_library()
    assert lib is not None
    img = np.ascontiguousarray(image, np.uint8)
    h, w = img.shape[:2]
    out = np.empty((image_size, image_size, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    lib.clip_preprocess_f32(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int(h), ctypes.c_int(w), ctypes.c_int(image_size),
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def mask_to_canvas_native(mask: np.ndarray, resize_hw: Tuple[int, int],
                          image_size: int) -> np.ndarray:
    lib = load_library()
    assert lib is not None
    m = np.ascontiguousarray(mask, np.uint8)
    out = np.zeros((image_size, image_size), np.float32)
    lib.mask_to_canvas_f32(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int(m.shape[0]), ctypes.c_int(m.shape[1]),
        ctypes.c_int(resize_hw[0]), ctypes.c_int(resize_hw[1]),
        ctypes.c_int(image_size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def fill_polygon_native(points: np.ndarray, shape: Tuple[int, int]
                        ) -> np.ndarray:
    """Even-odd fill of one polygon (contour fallback when cv2 absent)."""
    lib = load_library()
    assert lib is not None
    pts = np.ascontiguousarray(points.reshape(-1, 2), np.int32)
    out = np.zeros(shape, np.uint8)
    lib.fill_polygon_u8(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int(pts.shape[0]), ctypes.c_int(shape[0]),
        ctypes.c_int(shape[1]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out
