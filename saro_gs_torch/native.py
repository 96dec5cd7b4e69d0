"""ctypes binding of the native host library (counterpart of native.py).

The C++ sources under ``native/src`` (``colmap_bin.cpp``, ``knn.cpp``,
``image.cpp``; the C interface is ``saro_native.h``) give the host's hot
paths: COLMAP binary parsing, grid-hash nearest-neighbour distances, and
threaded PNG/JPEG decode with PIL-style Lanczos resizing.  This binding
builds two libraries of its own with ``g++`` at first use, with the flags
of ``native/Makefile``, into ``build/saro_gs_torch/native/``; it writes
nothing under ``native/``:

- the core library, ``libsaro_native.so``: ``knn.cpp`` and
  ``csrc/native_core.cpp``, which compiles ``colmap_bin.cpp`` with its
  track skips read through the stream's buffer (not one system call a
  point) and defines ``sn_free`` and ``sn_version``; linked without
  libpng, libjpeg or zlib, so that it builds on a host without their
  headers.  A failed build raises with the compiler's output, and a
  library that does not load raises too (``lib``).
- the image library, ``libsaro_native_image.so``: ``image.cpp`` with the
  Makefile's libraries.  Where it fails to build or load, the failure is
  kept with the compiler's first error line, printed once on stderr by the
  first caller that wanted a decode, and the decode callers take PIL
  (``image_lib``), as the JAX package's callers do when its library is
  missing.

Each library is rebuilt when it is older than its own sources.
``SARO_NATIVE=0`` selects the callers' pure-Python paths for both (every
function here then returns None).  A call the library refuses (a file it
cannot parse or decode) also returns None, and the caller takes its Python
path.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_ROOT, "native", "src")
# the core library's sources under SRC_DIR, and its own, which includes
# the first
SOURCES = ("colmap_bin.cpp", "knn.cpp")
CORE_SOURCE = os.path.join(_ROOT, "saro_gs_torch", "csrc", "native_core.cpp")
# the image library's sources under SRC_DIR
IMAGE_SOURCES = ("image.cpp",)
HEADERS = ("saro_native.h",)
BUILD_DIR = os.path.join(_ROOT, "build", "saro_gs_torch", "native")
SO_PATH = os.path.join(BUILD_DIR, "libsaro_native.so")
IMAGE_SO_PATH = os.path.join(BUILD_DIR, "libsaro_native_image.so")
# native/Makefile's CXXFLAGS and LDLIBS; the core library needs only
# threads
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-fopenmp",
            "-march=native")
LDLIBS = ("-lpng", "-ljpeg", "-lz", "-pthread")
CORE_LDLIBS = ("-pthread",)

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_IMAGE: Optional[ctypes.CDLL] = None
# why the image library is off (its build's or load's first error line),
# once it has failed
IMAGE_ERROR: Optional[str] = None

_c_double_p = ctypes.POINTER(ctypes.c_double)
_c_float_p = ctypes.POINTER(ctypes.c_float)
_c_uint8_p = ctypes.POINTER(ctypes.c_uint8)
_c_uint32_p = ctypes.POINTER(ctypes.c_uint32)
_c_int32_p = ctypes.POINTER(ctypes.c_int32)
_c_uint64_p = ctypes.POINTER(ctypes.c_uint64)
_c_int64_p = ctypes.POINTER(ctypes.c_int64)

_i32, _i64 = ctypes.c_int32, ctypes.c_int64
CORE_SIGNATURES = {
    "sn_read_points3d_bin": [
        ctypes.c_char_p, ctypes.POINTER(_c_double_p),
        ctypes.POINTER(_c_uint8_p), ctypes.POINTER(_c_double_p), _c_int64_p],
    "sn_read_images_bin": [
        ctypes.c_char_p, _c_int64_p, ctypes.POINTER(_c_uint32_p),
        ctypes.POINTER(_c_double_p), ctypes.POINTER(_c_double_p),
        ctypes.POINTER(_c_uint32_p), ctypes.POINTER(ctypes.c_char_p),
        _c_int64_p],
    "sn_read_cameras_bin": [
        ctypes.c_char_p, _c_int64_p, ctypes.POINTER(_c_uint32_p),
        ctypes.POINTER(_c_int32_p), ctypes.POINTER(_c_uint64_p),
        ctypes.POINTER(_c_double_p), ctypes.POINTER(_c_int64_p)],
    "sn_nn_distance": [_c_float_p, _i64, _c_float_p, ctypes.c_int],
    "sn_knn_mean_sq_dist": [_c_float_p, _i64, ctypes.c_int, _c_float_p,
                            ctypes.c_int],
}
IMAGE_SIGNATURES = {
    "sn_load_image": [ctypes.c_char_p, _i32, _i32, _c_float_p, _c_float_p],
    "sn_load_images": [ctypes.POINTER(ctypes.c_char_p), _i32, _i32, _i32,
                       _c_float_p, _c_float_p, _i32, _c_int32_p],
}


def _bind(so: ctypes.CDLL, sigs: dict) -> ctypes.CDLL:
    for name, argtypes in sigs.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    so.sn_free.argtypes = [ctypes.c_void_p]
    so.sn_free.restype = None
    so.sn_version.argtypes = []
    so.sn_version.restype = ctypes.c_char_p
    return so


def core_sources() -> List[str]:
    """What g++ compiles into the core library (colmap_bin.cpp comes in
    through CORE_SOURCE)."""
    return [os.path.join(SRC_DIR, SOURCES[1]), CORE_SOURCE]


def image_sources() -> List[str]:
    return [os.path.join(SRC_DIR, f) for f in IMAGE_SOURCES]


def command(so_path: str, sources: Sequence[str],
            ldlibs: Sequence[str]) -> List[str]:
    """The g++ line that compiles and links ``sources`` into ``so_path``."""
    return ["g++", *CXXFLAGS, "-I", SRC_DIR, "-shared", "-o", so_path,
            *sources, *ldlibs]


def _stale(so_path: str, deps: Sequence[str]) -> bool:
    if not os.path.exists(so_path):
        return True
    built = os.path.getmtime(so_path)
    return any(os.path.getmtime(f) > built for f in list(deps) + [
        os.path.join(SRC_DIR, h) for h in HEADERS])


def _build(so_path: str, sources: Sequence[str], ldlibs: Sequence[str],
           included: Sequence[str] = ()) -> float:
    """Compile ``sources`` into ``so_path`` where it is missing or older
    than them, the headers or the ``included`` sources."""
    if not _stale(so_path, list(sources) + list(included)):
        return 0.0
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = command(tmp, sources, ldlibs)
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building {so_path} failed: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"building {so_path} failed (g++ rc "
                           f"{res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stderr}")
    os.replace(tmp, so_path)
    return time.perf_counter() - t0


def build() -> float:
    """Compile the core library if it is missing or older than its
    sources; returns the seconds the compile took (0 when there was
    nothing to do).  Raises RuntimeError with the compiler's output on
    failure."""
    return _build(SO_PATH, core_sources(), CORE_LDLIBS,
                  included=[os.path.join(SRC_DIR, SOURCES[0])])


def build_image() -> float:
    """``build`` for the image library."""
    return _build(IMAGE_SO_PATH, image_sources(), LDLIBS)


def _disabled() -> bool:
    return os.environ.get("SARO_NATIVE", "1") == "0"


def lib() -> Optional[ctypes.CDLL]:
    """The loaded core library, built at first use; None under
    SARO_NATIVE=0."""
    global _LIB
    if _disabled():
        return None
    with _LOCK:
        if _LIB is None:
            build()
            try:
                _LIB = _bind(ctypes.CDLL(SO_PATH), CORE_SIGNATURES)
            except OSError as e:
                raise RuntimeError(f"loading {SO_PATH} failed: {e}") from e
        return _LIB


def available() -> bool:
    return lib() is not None


def _first_error(msg: str) -> str:
    lines = msg.splitlines()
    return next((ln.strip() for ln in lines if "error" in ln),
                lines[0] if lines else msg)


def image_lib() -> Optional[ctypes.CDLL]:
    """The loaded image library, built at first use; None under
    SARO_NATIVE=0 or where it failed to build or load.  The first failure
    is kept in IMAGE_ERROR and printed once on stderr; the library is not
    built again in this process."""
    global _IMAGE, IMAGE_ERROR
    if _disabled():
        return None
    with _LOCK:
        if _IMAGE is None and IMAGE_ERROR is None:
            try:
                build_image()
                _IMAGE = _bind(ctypes.CDLL(IMAGE_SO_PATH), IMAGE_SIGNATURES)
            except (RuntimeError, OSError) as e:
                IMAGE_ERROR = _first_error(str(e))
                print(f"saro_gs_torch.native: the image decoders are off "
                      f"({IMAGE_ERROR}); images decode through PIL",
                      file=sys.stderr, flush=True)
        return _IMAGE


def image_available() -> bool:
    return image_lib() is not None


def _take(ptr, shape, dtype, so):
    """Copy a library-owned buffer into numpy and free it."""
    n = int(np.prod(shape))
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True) \
        if n else np.empty(0, dtype)
    so.sn_free(ctypes.cast(ptr, ctypes.c_void_p))
    return arr.reshape(shape)


# ---------------------------------------------------------------- colmap

def read_points3d_bin(path: str):
    """-> (xyz [N,3] f64, rgb [N,3] u8, err [N] f64) or None."""
    so = lib()
    if so is None:
        return None
    xyz, rgb, err = _c_double_p(), _c_uint8_p(), _c_double_p()
    n = ctypes.c_int64()
    if so.sn_read_points3d_bin(str(path).encode(), ctypes.byref(xyz),
                               ctypes.byref(rgb), ctypes.byref(err),
                               ctypes.byref(n)) != 0:
        return None
    n = n.value
    return (_take(xyz, (n, 3), np.float64, so),
            _take(rgb, (n, 3), np.uint8, so),
            _take(err, (n,), np.float64, so))


def read_images_bin(path: str):
    """-> list of (image_id, qvec [4], tvec [3], camera_id, name) or
    None."""
    so = lib()
    if so is None:
        return None
    n = ctypes.c_int64()
    ids, cams = _c_uint32_p(), _c_uint32_p()
    q, t = _c_double_p(), _c_double_p()
    names = ctypes.c_char_p()
    nlen = ctypes.c_int64()
    if so.sn_read_images_bin(str(path).encode(), ctypes.byref(n),
                             ctypes.byref(ids), ctypes.byref(q),
                             ctypes.byref(t), ctypes.byref(cams),
                             ctypes.byref(names), ctypes.byref(nlen)) != 0:
        return None
    num = n.value
    blob = ctypes.string_at(names, nlen.value)
    so.sn_free(ctypes.cast(names, ctypes.c_void_p))
    return list(zip(
        _take(ids, (num,), np.uint32, so).tolist(),
        _take(q, (num, 4), np.float64, so),
        _take(t, (num, 3), np.float64, so),
        _take(cams, (num,), np.uint32, so).tolist(),
        blob.decode("utf-8").split("\0")[:num]))


def read_cameras_bin(path: str):
    """-> list of (camera_id, model_id, width, height, params) or None."""
    so = lib()
    if so is None:
        return None
    n = ctypes.c_int64()
    ids, models = _c_uint32_p(), _c_int32_p()
    wh = _c_uint64_p()
    params, offs = _c_double_p(), _c_int64_p()
    if so.sn_read_cameras_bin(str(path).encode(), ctypes.byref(n),
                              ctypes.byref(ids), ctypes.byref(models),
                              ctypes.byref(wh), ctypes.byref(params),
                              ctypes.byref(offs)) != 0:
        return None
    num = n.value
    off = _take(offs, (num + 1,), np.int64, so)
    par = _take(params, (int(off[-1]),), np.float64, so)
    whv = _take(wh, (num, 2), np.uint64, so)
    return [(cid, mid, int(whv[i, 0]), int(whv[i, 1]),
             par[off[i]:off[i + 1]])
            for i, (cid, mid) in enumerate(zip(
                _take(ids, (num,), np.uint32, so).tolist(),
                _take(models, (num,), np.int32, so).tolist()))]


# ------------------------------------------------------------------- knn

def nn_distance(points: np.ndarray, nthreads: int = 0):
    """[N] float32 distance to the nearest other point, or None."""
    so = lib()
    if so is None:
        return None
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    out = np.empty(pts.shape[0], np.float32)
    rc = so.sn_nn_distance(pts.ctypes.data_as(_c_float_p), pts.shape[0],
                           out.ctypes.data_as(_c_float_p), nthreads)
    return out if rc == 0 else None


def knn_mean_sq_dist(points: np.ndarray, k: int = 3, nthreads: int = 0):
    """[N] mean squared distance to the k nearest neighbours (the
    reference's distCUDA2), or None."""
    so = lib()
    if so is None:
        return None
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    out = np.empty(pts.shape[0], np.float32)
    rc = so.sn_knn_mean_sq_dist(pts.ctypes.data_as(_c_float_p),
                                pts.shape[0], k,
                                out.ctypes.data_as(_c_float_p), nthreads)
    return out if rc == 0 else None


# ---------------------------------------------------------------- images

def load_image(path: str, width: int, height: int,
               bg: Tuple[float, float, float] = (0.0, 0.0, 0.0)):
    """Decode and resize one image -> [3, H, W] float32 in [0, 1], alpha
    composited over ``bg``; or None."""
    so = image_lib()
    if so is None:
        return None
    out = np.empty((3, height, width), np.float32)
    bgv = np.asarray(bg, np.float32)
    rc = so.sn_load_image(str(path).encode(), width, height,
                          bgv.ctypes.data_as(_c_float_p),
                          out.ctypes.data_as(_c_float_p))
    return out if rc == 0 else None


def load_images(paths: List[str], width: int, height: int,
                bg: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                nthreads: int = 0):
    """Decode a batch on the library's thread pool -> [B, 3, H, W]
    float32; or None."""
    so = image_lib()
    if so is None or not paths:
        return None
    n = len(paths)
    out = np.empty((n, 3, height, width), np.float32)
    status = np.zeros(n, np.int32)
    bgv = np.asarray(bg, np.float32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = so.sn_load_images(arr, n, width, height,
                           bgv.ctypes.data_as(_c_float_p),
                           out.ctypes.data_as(_c_float_p), nthreads,
                           status.ctypes.data_as(_c_int32_p))
    return out if rc == 0 else None
