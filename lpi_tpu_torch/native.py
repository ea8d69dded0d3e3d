"""ctypes bindings for the host runtime `native/lpi_native.cpp` (counterpart
of `lpi_tpu/native.py`): bilinear resize + normalisation, centre crop, greedy
/ class-aware / soft NMS and a ROIAlign forward, all on numpy arrays.

The library is built at first use with `g++ -O3 -fPIC -shared -std=c++17`
into `build/lpi_tpu_torch/` beside the package, under a file lock, and
renamed into place, so concurrent processes build it once; its name carries
a hash of the source. A failed build raises with the compiler's output.
Unlike the JAX module, nothing falls back to numpy: the `*_plain` functions
are the numpy versions (the JAX module's fallbacks), which the tests hold
the library to and nothing else calls. `roi_align_cpu`'s plain version is
`ops/roi_align.py`.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "lpi_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "lpi_tpu_torch"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None


def compiler() -> Optional[str]:
    return os.environ.get("CXX") or shutil.which("g++")


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"liblpi_native.{digest}.so"


def build() -> Path:
    """Compile the library unless it is built; raises if that fails."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("the native library needs a C++ compiler (g++ on PATH, or $CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "liblpi_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"building {SOURCE.name} failed ({cxx} exited "
                                   f"{r.returncode}):\n{r.stdout}{r.stderr}")
            os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int)
        lib.resize_bilinear_normalize.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_int, f32p, f32p]
        lib.center_crop.argtypes = [f32p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int,
                                    ctypes.c_int]
        lib.nms.restype = ctypes.c_int
        lib.nms.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_float, i32p]
        lib.ml_nms.restype = ctypes.c_int
        lib.ml_nms.argtypes = [f32p, f32p, i32p, ctypes.c_int, ctypes.c_float, i32p]
        lib.soft_nms.restype = ctypes.c_int
        lib.soft_nms.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_float, ctypes.c_float]
        lib.roi_align_forward.argtypes = [f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p,
                                          ctypes.c_float, ctypes.c_int, ctypes.c_int, f32p]
        _lib = lib
    return _lib


def is_available() -> bool:
    """Whether the library is built or a compiler can build it."""
    return library_path().exists() or compiler() is not None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def resize_normalize(image_u8: np.ndarray, out_h: int, out_w: int, mean, std) -> np.ndarray:
    """uint8 [H, W, 3] -> normalised float32 [out_h, out_w, 3]."""
    lib = _load()
    image_u8 = np.ascontiguousarray(image_u8, np.uint8)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    out = np.empty((out_h, out_w, 3), np.float32)
    lib.resize_bilinear_normalize(image_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                  image_u8.shape[0], image_u8.shape[1], _fp(out), out_h, out_w,
                                  _fp(mean), _fp(std))
    return out


def center_crop(image_f32: np.ndarray, crop_h: int, crop_w: int) -> np.ndarray:
    lib = _load()
    image_f32 = np.ascontiguousarray(image_f32, np.float32)
    out = np.empty((crop_h, crop_w, 3), np.float32)
    lib.center_crop(_fp(image_f32), image_f32.shape[0], image_f32.shape[1], _fp(out),
                    crop_h, crop_w)
    return out


def nms_cpu(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float = 0.5) -> np.ndarray:
    """Greedy NMS -> kept indices, score-descending."""
    lib = _load()
    boxes = np.ascontiguousarray(boxes, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    out = np.empty(len(scores), np.int32)
    k = lib.nms(_fp(boxes), _fp(scores), len(scores), iou_threshold, _ip(out))
    return out[:k]


def ml_nms_cpu(boxes, scores, labels, iou_threshold: float = 0.5) -> np.ndarray:
    """Class-aware NMS -> kept indices, score-descending."""
    lib = _load()
    boxes = np.ascontiguousarray(boxes, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    labels = np.ascontiguousarray(labels, np.int32)
    out = np.empty(len(scores), np.int32)
    k = lib.ml_nms(_fp(boxes), _fp(scores), _ip(labels), len(scores), iou_threshold, _ip(out))
    return out[:k]


def soft_nms_cpu(boxes, scores, sigma: float = 0.5,
                 score_threshold: float = 0.001) -> Tuple[np.ndarray, int]:
    """Gaussian soft-NMS -> (the decayed scores, a copy; the number kept)."""
    lib = _load()
    boxes = np.ascontiguousarray(boxes, np.float32)
    scores = np.ascontiguousarray(scores, np.float32).copy()
    k = lib.soft_nms(_fp(boxes), _fp(scores), len(scores), sigma, score_threshold)
    return scores, int(k)


def roi_align_cpu(features: np.ndarray, roi: np.ndarray, spatial_scale: float = 1.0,
                  out_size: int = 7, sampling_ratio: int = 2) -> np.ndarray:
    """features [H, W, C], roi [4] (x1, y1, x2, y2) -> [out, out, C]."""
    lib = _load()
    features = np.ascontiguousarray(features, np.float32)
    roi = np.ascontiguousarray(roi, np.float32)
    h, w, c = features.shape
    out = np.zeros((out_size, out_size, c), np.float32)
    lib.roi_align_forward(_fp(features), h, w, c, _fp(roi), spatial_scale, out_size,
                          sampling_ratio, _fp(out))
    return out


# -- the plain versions (the JAX module's numpy fallbacks) ------------------

def _iou_np(a, b) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    union = (max(0, a[2] - a[0]) * max(0, a[3] - a[1])
             + max(0, b[2] - b[0]) * max(0, b[3] - b[1]) - inter)
    return inter / union if union > 0 else 0.0


def resize_normalize_plain(image_u8: np.ndarray, out_h: int, out_w: int,
                           mean, std) -> np.ndarray:
    from PIL import Image

    im = Image.fromarray(np.ascontiguousarray(image_u8, np.uint8)).resize(
        (out_w, out_h), Image.BILINEAR)
    arr = np.asarray(im, np.float32) / 255.0
    return ((arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)).astype(np.float32)


def center_crop_plain(image_f32: np.ndarray, crop_h: int, crop_w: int) -> np.ndarray:
    sh, sw = image_f32.shape[:2]
    oy, ox = (sh - crop_h) // 2, (sw - crop_w) // 2
    return np.asarray(image_f32, np.float32)[oy:oy + crop_h, ox:ox + crop_w].copy()


def nms_cpu_plain(boxes, scores, iou_threshold: float = 0.5) -> np.ndarray:
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    keep = []
    for i in np.argsort(-scores):
        if np.isfinite(scores[i]) and all(
                _iou_np(boxes[i], boxes[j]) <= iou_threshold for j in keep):
            keep.append(int(i))
    return np.asarray(keep, np.int32)


def ml_nms_cpu_plain(boxes, scores, labels, iou_threshold: float = 0.5) -> np.ndarray:
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    labels = np.asarray(labels, np.int32)
    keep = []
    for i in np.argsort(-scores):
        if np.isfinite(scores[i]) and all(
                labels[i] != labels[j] or _iou_np(boxes[i], boxes[j]) <= iou_threshold
                for j in keep):
            keep.append(int(i))
    return np.asarray(keep, np.int32)


def soft_nms_cpu_plain(boxes, scores, sigma: float = 0.5,
                       score_threshold: float = 0.001) -> Tuple[np.ndarray, int]:
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32).copy()
    done = np.zeros(len(scores), bool)
    kept = 0
    for _ in range(len(scores)):
        cand = np.where(~done & (scores > score_threshold))[0]
        if len(cand) == 0:
            break
        best = cand[np.argmax(scores[cand])]
        done[best] = True
        kept += 1
        for j in np.where(~done)[0]:
            v = _iou_np(boxes[best], boxes[j])
            scores[j] *= np.exp(-(v * v) / sigma)
    return scores, kept
