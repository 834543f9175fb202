"""DSM registration: multiscale NaN-aware NCC alignment of a predicted DSM to the
lidar ground truth, then an affine z-mapping.

`spnerf_tpu/evaluation/registration.py`, after the reference SP-NeRF's
numba kernels (`modules/dsmr.py:7-213`), with its two backends:

  * numpy: the pyramid downsample and the NCC search are array ops;
  * C++ (`spnerf_torch/native/dsmr.cpp`, the same algorithm), built with g++
    at first use into `spnerf_torch/_build/` and loaded with ctypes.
    `use_native=True` (the default) takes it; where it cannot be built or
    loaded, the numpy path runs, as in the JAX package. Both give the same
    shifts; `backend()` names the one that runs.

Algorithm (reference semantics):
  1. build a NaN-aware 2x average pyramid while min(h, w) > 100;
  2. coarse-to-fine: at each level search the (2*dx_prev +- irange) window for the
     integer shift maximizing NCC over finite overlapping pixels (irange=5);
  3. z-mapping: a = sig_ref/sig_sec if scaling else 1, b = mu_ref - a * mu_sec;
  4. apply: out[j, i] = a * v[j + dy, i + dx] + b (NaN outside).
"""

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess

import numpy as np

from ..ops._build import BUILD, PKG

_NATIVE_SRC = PKG / "native" / "dsmr.cpp"
_GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_native = {}
_DOUBLE_P = ctypes.POINTER(ctypes.c_double)
_INT_P = ctypes.POINTER(ctypes.c_int)


def _compiler():
    """g++'s version, or "none" where there is no g++."""
    if shutil.which("g++") is None:
        return "none"
    try:
        return subprocess.run(["g++", "-dumpfullversion"], check=True,
                              capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "none"


def native_library_path():
    """The library's path, named by the source, the flags, the host's
    architecture and the compiler, so that a library built on one host is
    never loaded on another."""
    key = " ".join([*_GXX_FLAGS, platform.machine(), _compiler()])
    tag = hashlib.sha256(_NATIVE_SRC.read_bytes() + key.encode()).hexdigest()
    return BUILD / f"libdsmr-{tag[:12]}.so"


def _build_native(lib_path):
    """Compile dsmr.cpp (one g++ command, ~1 s) into a pid-suffixed file and
    rename it into place, so that concurrent processes never load a partly
    written library. True if the library exists afterwards."""
    if shutil.which("g++") is None:
        return False
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_GXX_FLAGS, "-o", str(tmp), str(_NATIVE_SRC)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, lib_path)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        # another process may have built it meanwhile
    return lib_path.exists()


def load_native():
    """The loaded C++ library, built first if needed; None where it cannot
    be built or loaded."""
    if "lib" in _native:
        return _native["lib"]
    lib_path = native_library_path()
    lib = None
    if lib_path.exists() or _build_native(lib_path):
        try:
            lib = ctypes.CDLL(str(lib_path))
            lib.dsmr_compute_shift.argtypes = [
                _DOUBLE_P, _DOUBLE_P, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, _INT_P, _INT_P, _DOUBLE_P,
                _DOUBLE_P]
            lib.dsmr_compute_shift.restype = None
            lib.dsmr_apply_shift.argtypes = [
                _DOUBLE_P, _DOUBLE_P, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double]
            lib.dsmr_apply_shift.restype = None
        except (OSError, AttributeError):
            lib = None
    _native["lib"] = lib
    return lib


def backend():
    """"native" where the C++ library loads, else "numpy": the backend that
    `compute_shift` and `apply_shift` take by default."""
    return "native" if load_native() is not None else "numpy"


def downsample2x(u):
    """NaN-aware 2x downsample: mean of the finite values in each 2x2 block
    (reference dsmr.downsample2x, modules/dsmr.py:17-47). u: (H, W)."""
    h, w = u.shape
    ph, pw = (h + 1) // 2 * 2, (w + 1) // 2 * 2
    pad = np.full((ph, pw), np.nan)
    pad[:h, :w] = u
    blocks = pad.reshape(ph // 2, 2, pw // 2, 2).transpose(0, 2, 1, 3)
    blocks = blocks.reshape(ph // 2, pw // 2, 4)
    cnt = np.isfinite(blocks).sum(axis=-1)
    s = np.nansum(blocks, axis=-1)
    with np.errstate(invalid="ignore"):
        out = np.where(cnt > 0, s / np.maximum(cnt, 1), np.nan)
    return out


def _shifted_view(v, dx, dy):
    """v sampled at (i+dx, j+dy), NaN-padded, same shape as v."""
    h, w = v.shape
    out = np.full((h, w), np.nan)
    src_y0, src_y1 = max(0, dy), min(h, h + dy)
    src_x0, src_x1 = max(0, dx), min(w, w + dx)
    dst_y0, dst_y1 = max(0, -dy), max(0, -dy) + (src_y1 - src_y0)
    dst_x0, dst_x1 = max(0, -dx), max(0, -dx) + (src_x1 - src_x0)
    if src_y1 > src_y0 and src_x1 > src_x0:
        out[dst_y0:dst_y1, dst_x0:dst_x1] = v[src_y0:src_y1, src_x0:src_x1]
    return out


def _moments(u, v, dx, dy):
    """(mu_u, mu_v, sig_u, sig_v, xcorr) over finite overlapping pixels of u and
    v shifted by (dx, dy) — reference mean_std (modules/dsmr.py:50-89)."""
    vv = _shifted_view(v, dx, dy)
    ok = np.isfinite(u) & np.isfinite(vv)
    n = ok.sum()
    if n == 0:
        return 0.0, 0.0, 0.0, 0.0, 0.0
    a = u[ok]
    b = vv[ok]
    muu, muv = a.mean(), b.mean()
    da, db = a - muu, b - muv
    return muu, muv, np.sqrt((da * da).mean()), np.sqrt((db * db).mean()), (da * db).mean()


def ncc(u, v, dx=0, dy=0):
    muu, muv, sigu, sigv, xc = _moments(u, v, dx, dy)
    return xc / (sigu * sigv) if sigu > 0 and sigv > 0 else -np.inf


def _search_ncc(u, v, irange, dx0, dy0):
    best = (-np.inf, dx0, dy0)
    for dy in range(dy0 - irange, dy0 + irange + 1):
        for dx in range(dx0 - irange, dx0 + irange + 1):
            c = ncc(u, v, dx, dy)
            if c > best[0]:
                best = (c, dx, dy)
    return best[1], best[2]


def _recursive_ncc(u, v, irange=5, dx=0, dy=0):
    if min(u.shape) > 100:
        dx, dy = _recursive_ncc(downsample2x(u), downsample2x(v), irange,
                                dx // 2, dy // 2)
        dx, dy = dx * 2, dy * 2
    return _search_ncc(u, v, irange, dx, dy)


def compute_shift(ref, sec, scaling=False, irange=5, use_native=True):
    """Shift (dx, dy) + affine (a, b) registering `sec` onto `ref`.

    ref, sec: (H, W) float arrays (NaN = nodata). Reference:
    dsmr.compute_shift (modules/dsmr.py:161-188), called with scaling=False by
    the eval pipeline (modules/utils.py:205).
    """
    ref = np.ascontiguousarray(ref, np.float64)
    sec = np.ascontiguousarray(sec, np.float64)
    if ref.shape != sec.shape or ref.ndim != 2:
        raise ValueError(f"compute_shift: shapes {ref.shape} and {sec.shape}")
    lib = load_native() if use_native else None
    if lib is not None:
        dx, dy = ctypes.c_int(0), ctypes.c_int(0)
        a, b = ctypes.c_double(1.0), ctypes.c_double(0.0)
        lib.dsmr_compute_shift(
            ref.ctypes.data_as(_DOUBLE_P), sec.ctypes.data_as(_DOUBLE_P),
            ref.shape[0], ref.shape[1], int(irange), int(scaling),
            ctypes.byref(dx), ctypes.byref(dy), ctypes.byref(a),
            ctypes.byref(b))
        return dx.value, dy.value, a.value, b.value
    dx, dy = _recursive_ncc(ref, sec, irange)
    muu, muv, sigu, sigv, _ = _moments(ref, sec, dx, dy)
    a = sigu / sigv if scaling and sigv > 0 else 1.0
    b = muu - muv * a
    return dx, dy, a, b


def apply_shift(v, dx=0, dy=0, a=1.0, b=0.0, use_native=True):
    """Resample v by the integer shift and apply z -> a*z + b
    (reference dsmr.apply_shift_, modules/dsmr.py:139-150).

    The reference signature also takes planar-ramp terms c, d, which its
    numba kernel never applies (its channel loop variable shadows `c`) and
    every caller passes as 0; they are dropped here, as in the JAX package."""
    v = np.ascontiguousarray(v, np.float64)
    lib = load_native() if use_native and v.ndim == 2 else None
    if lib is not None:
        out = np.empty_like(v)
        lib.dsmr_apply_shift(
            v.ctypes.data_as(_DOUBLE_P), out.ctypes.data_as(_DOUBLE_P),
            v.shape[0], v.shape[1], int(dx), int(dy), float(a), float(b))
        return out
    return a * _shifted_view(v, dx, dy) + b
