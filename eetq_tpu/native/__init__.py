"""Native host-side quantizer/packer (C++ + OpenMP, ctypes ABI).

The counterpart of the reference's CPU preprocessing library
(`csrc/cutlass_kernels/cutlass_preprocessors.cc` + the build in `setup.py`):
the O(K*N) per-column absmax/round/clip loops run multithreaded native code
on host numpy weights during checkpoint conversion, keeping the dense fp16
weight off the device. Built lazily with g++ on first use (no build step;
JIT-compile-and-cache like the kernels themselves); every entry has a numpy
fallback so the package works without a toolchain.

Bit-exactness with the JAX quantizer is tested (tests/test_native.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

from eetq_tpu.utils.logging import get_logger

log = get_logger(__name__)

_SRC = os.path.join(os.path.dirname(__file__), "quantizer.cc")
_LIB_ENV = "EETQ_NATIVE_LIB"
_DISABLE_ENV = "EETQ_DISABLE_NATIVE"

_lib = None
_lib_tried = False


def _build_lib() -> str | None:
    """Compile quantizer.cc to a shared library in a cache dir."""
    cache = os.environ.get(
        "EETQ_CACHE_DIR", os.path.join(tempfile.gettempdir(), "eetq_tpu_cache")
    )
    os.makedirs(cache, exist_ok=True)
    import hashlib

    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    lib_path = os.path.join(cache, f"libeetq_host_{tag}.so")
    if os.path.exists(lib_path):
        return lib_path
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp",
        "-march=native", _SRC, "-o", lib_path + ".tmp",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("native quantizer build failed (%s); using numpy fallback", e)
        return None
    os.replace(lib_path + ".tmp", lib_path)
    log.info("built native quantizer: %s", lib_path)
    return lib_path


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if os.environ.get(_DISABLE_ENV):
        return None
    path = os.environ.get(_LIB_ENV) or _build_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        log.warning("native quantizer load failed (%s); using numpy fallback", e)
        return None
    i8p = ctypes.POINTER(ctypes.c_int8)
    f32p = ctypes.POINTER(ctypes.c_float)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i64 = ctypes.c_int64
    for name, argtypes in {
        "eetq_quantize_f32": [f32p, i64, i64, i64, ctypes.c_int, i64, i8p, f32p],
        "eetq_quantize_f16": [u16p, i64, i64, i64, ctypes.c_int, i64, i8p, f32p],
        "eetq_quantize_bf16": [u16p, i64, i64, i64, ctypes.c_int, i64, i8p, f32p],
        "eetq_pack_int4": [i8p, i64, i64, i8p],
        "eetq_transpose_i8": [i8p, i64, i64, i8p],
    }.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    lib.eetq_native_version.restype = ctypes.c_int
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def _numpy_quantize(w: np.ndarray, bits: int, group_size: int | None):
    qrange = float(1 << (bits - 1))
    e, k, n = w.shape
    g = group_size or k
    wg = w.reshape(e, k // g, g, n).astype(np.float32)
    absmax = np.abs(wg).max(axis=2)
    scales = absmax / qrange
    safe = np.where(scales == 0.0, 1.0, scales)
    x = wg / safe[:, :, None, :]
    q = np.trunc(x + np.copysign(np.float32(0.5), x))
    q = np.clip(q, -qrange, qrange - 1).astype(np.int8).reshape(e, k, n)
    return q, scales.astype(np.float32)


def host_symmetric_quantize(
    w: np.ndarray, bits: int = 8, group_size: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Quantize a host numpy weight [K, N] or [E, K, N]; returns (int8 q,
    f32 scales [N]/[G,N] with expert leading dims). Same semantics (and
    bits) as eetq_tpu.quant.symmetric_quantize, on CPU, multithreaded."""
    squeeze = w.ndim == 2
    w3 = w[None] if squeeze else w
    if w3.ndim != 3:
        raise ValueError(f"weight must be 2-D or 3-D, got {w.shape}")
    e, k, n = w3.shape
    if group_size is not None and k % group_size:
        raise ValueError(f"group_size {group_size} must divide K {k}")
    groups = k // group_size if group_size else 1

    lib = _load()
    if lib is None:
        q, s = _numpy_quantize(w3, bits, group_size)
    else:
        q = np.empty((e, k, n), np.int8)
        s = np.empty((e, groups, n), np.float32)
        gs = group_size or 0
        if w3.dtype == np.float32:
            arr = np.ascontiguousarray(w3)
            lib.eetq_quantize_f32(
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                e, k, n, bits, gs,
                q.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
        elif w3.dtype == np.float16:
            arr = np.ascontiguousarray(w3).view(np.uint16)
            lib.eetq_quantize_f16(
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                e, k, n, bits, gs,
                q.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
        elif w3.dtype.str in ("<V2", "|V2") or w3.dtype.name == "bfloat16":
            arr = np.ascontiguousarray(w3).view(np.uint16)
            lib.eetq_quantize_bf16(
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                e, k, n, bits, gs,
                q.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
        else:
            q, s = _numpy_quantize(w3.astype(np.float32), bits, group_size)
    if group_size is None:
        s = s[:, 0]  # [E, N]
    if squeeze:
        q, s = q[0], s[0]
    return q, s


def host_pack_int4(q: np.ndarray) -> np.ndarray:
    """Split-half nibble packing [Kp, N] -> [Kp/2, N] (Kp even), matching
    eetq_tpu.layout.pack_weights(bits=4)."""
    if q.dtype != np.int8 or q.ndim != 2 or q.shape[0] % 2:
        raise ValueError(f"need int8 [even K, N], got {q.dtype} {q.shape}")
    lib = _load()
    kp, n = q.shape
    if lib is None:
        half = kp // 2
        lo = q[:half].view(np.uint8) & 0x0F
        hi = q[half:].view(np.uint8) << 4
        return (lo | hi).view(np.int8)
    out = np.empty((kp // 2, n), np.int8)
    qc = np.ascontiguousarray(q)
    lib.eetq_pack_int4(
        qc.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), kp, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
    )
    return out


def host_transpose_i8(a: np.ndarray) -> np.ndarray:
    """Cache-tiled int8 transpose (checkpoint [out, in] -> kernel [in, out])."""
    if a.dtype != np.int8 or a.ndim != 2:
        raise ValueError(f"need int8 2-D, got {a.dtype} {a.shape}")
    lib = _load()
    if lib is None:
        return np.ascontiguousarray(a.T)
    rows, cols = a.shape
    out = np.empty((cols, rows), np.int8)
    ac = np.ascontiguousarray(a)
    lib.eetq_transpose_i8(
        ac.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), rows, cols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
    )
    return out


__all__ = [
    "native_available",
    "host_symmetric_quantize",
    "host_pack_int4",
    "host_transpose_i8",
]
