"""ctypes bindings for the native host library ``native/hands_host.cpp``
(the port's own copy of ``hands_tpu/utils/native.py``): JPEG and PNG decode
through libjpeg and libpng, a bilinear affine warp with and without the
ImageNet normalisation, and the collation of images into one float array.

The source is compiled at first use with the flags of ``native/Makefile``
into ``hands_tpu_torch/csrc/_build/`` (keyed by a hash of the source and the
flags; nothing is written into ``native/``). Where it does not build (no
compiler, or no libjpeg/libpng headers), :func:`available` is False and the
callers take their other route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from functools import lru_cache
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "hands_host.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc" / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
LIBS = ("-ljpeg", "-lpng")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int)


def so_path() -> Path:
    cxx = os.environ.get("CXX", "g++")
    key = hashlib.sha256(SOURCE.read_bytes())
    key.update(" ".join((cxx,) + CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"hands_host_{key.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; raises with the compiler's
    message when it does not build."""
    so = so_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
         str(SOURCE), *LIBS], capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"the native host library does not build:\n"
                           f"{proc.stderr[-2000:]}")
    os.replace(tmp, so)  # a concurrent reader never sees half a file
    return so


@lru_cache(maxsize=1)
def _lib() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None

    lib.jpeg_probe.argtypes = [_u8p, ctypes.c_long, _i32p, _i32p, _i32p]
    lib.jpeg_probe.restype = ctypes.c_int
    lib.jpeg_decode_rgb.argtypes = [_u8p, ctypes.c_long, _u8p, ctypes.c_int,
                                    ctypes.c_int]
    lib.jpeg_decode_rgb.restype = ctypes.c_int
    lib.jpeg_decode_rgb_scaled.argtypes = [
        _u8p, ctypes.c_long, _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _i32p, _i32p]
    lib.jpeg_decode_rgb_scaled.restype = ctypes.c_int
    lib.png_probe.argtypes = [_u8p, ctypes.c_long, _i32p, _i32p]
    lib.png_probe.restype = ctypes.c_int
    lib.png_decode_rgb.argtypes = [_u8p, ctypes.c_long, _u8p, ctypes.c_int,
                                   ctypes.c_int]
    lib.png_decode_rgb.restype = ctypes.c_int
    lib.warp_affine_bilinear_u8.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _f32p, _u8p,
        ctypes.c_int, ctypes.c_int]
    lib.warp_affine_normalize_f32.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _f32p, _f32p,
        ctypes.c_int, ctypes.c_int, _f32p, _f32p]
    lib.stack_u8_to_f32.argtypes = [
        ctypes.POINTER(_u8p), ctypes.c_int, ctypes.c_long, _f32p,
        ctypes.c_float]
    return lib


def available() -> bool:
    return _lib() is not None


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(_u8p)


def decode_image(data: bytes, scale_denom: int = 1) -> Optional[np.ndarray]:
    """JPEG or PNG bytes -> (H, W, 3) uint8 RGB; None on failure.

    ``scale_denom`` in {1, 2, 4, 8} decodes a JPEG at 1/denom resolution
    through libjpeg's scaled iDCT (about denom^2 cheaper). PNGs ignore it.
    """
    lib = _lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if data[:3] == b"\xff\xd8\xff":
        if lib.jpeg_probe(_as_u8p(buf), len(data), ctypes.byref(h),
                          ctypes.byref(w), ctypes.byref(c)):
            return None
        if scale_denom > 1:
            cap_h = -(-h.value // scale_denom) + 8
            cap_w = -(-w.value // scale_denom) + 8
            out = np.empty((cap_h, cap_w, 3), np.uint8)
            oh, ow = ctypes.c_int(), ctypes.c_int()
            if lib.jpeg_decode_rgb_scaled(
                    _as_u8p(buf), len(data), _as_u8p(out), scale_denom,
                    cap_h, cap_w, ctypes.byref(oh), ctypes.byref(ow)):
                return None
            return np.ascontiguousarray(
                out.reshape(-1)[: oh.value * ow.value * 3]
                .reshape(oh.value, ow.value, 3))
        out = np.empty((h.value, w.value, 3), np.uint8)
        if lib.jpeg_decode_rgb(_as_u8p(buf), len(data), _as_u8p(out), h.value,
                               w.value):
            return None
        return out
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        if lib.png_probe(_as_u8p(buf), len(data), ctypes.byref(h),
                         ctypes.byref(w)):
            return None
        out = np.empty((h.value, w.value, 3), np.uint8)
        if lib.png_decode_rgb(_as_u8p(buf), len(data), _as_u8p(out), h.value,
                              w.value):
            return None
        return out
    return None


def read_image(path: str, scale_denom: int = 1) -> Optional[np.ndarray]:
    try:
        with open(path, "rb") as f:
            return decode_image(f.read(), scale_denom)
    except OSError:
        return None


def warp_affine(src: np.ndarray, M: np.ndarray, out_hw) -> np.ndarray:
    """Inverse-map bilinear warp (dst -> src ``M``, 2x3), zero border."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("the native host library is not available")
    src = np.ascontiguousarray(src, np.uint8)
    M = np.ascontiguousarray(M, np.float32)
    dh, dw = out_hw
    out = np.empty((dh, dw, src.shape[2]), np.uint8)
    lib.warp_affine_bilinear_u8(
        _as_u8p(src), src.shape[0], src.shape[1], src.shape[2],
        M.ctypes.data_as(_f32p), _as_u8p(out), dh, dw)
    return out


def warp_affine_normalize(src: np.ndarray, M: np.ndarray, out_hw, mean,
                          std) -> np.ndarray:
    """The warp fused with /255 and the per-channel normalisation -> f32
    HWC."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("the native host library is not available")
    src = np.ascontiguousarray(src, np.uint8)
    M = np.ascontiguousarray(M, np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    dh, dw = out_hw
    out = np.empty((dh, dw, src.shape[2]), np.float32)
    lib.warp_affine_normalize_f32(
        _as_u8p(src), src.shape[0], src.shape[1], src.shape[2],
        M.ctypes.data_as(_f32p), out.ctypes.data_as(_f32p), dh, dw,
        mean.ctypes.data_as(_f32p), std.ctypes.data_as(_f32p))
    return out


def stack_images(imgs) -> np.ndarray:
    """Same-shape HWC uint8 images -> (N, H, W, C) float32 in [0, 1]."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("the native host library is not available")
    imgs = [np.ascontiguousarray(im, np.uint8) for im in imgs]
    n = len(imgs)
    hwc = int(np.prod(imgs[0].shape))
    out = np.empty((n,) + imgs[0].shape, np.float32)
    ptrs = (_u8p * n)(*[_as_u8p(im) for im in imgs])
    lib.stack_u8_to_f32(ptrs, n, hwc, out.ctypes.data_as(_f32p),
                        np.float32(1.0 / 255.0))
    return out
