"""ctypes bindings for the native host codec (runtime/native/dietcpu.cpp).

Provides the framework's host-side compress/decompress path — the
counterpart of the reference's C++ host layer — producing archives
byte-identical to the device codec and the NumPy oracle. Builds the shared
library on first use if it is missing (plain g++, no external deps).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

from ..core.constants import FloatType

_DIR = os.path.join(os.path.dirname(__file__), "native")
_SO = os.path.join(_DIR, "libdietcpu.so")

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO):
        subprocess.run(["make", "-C", _DIR], check=True, capture_output=True)
    lib = ctypes.CDLL(_SO)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32 = ctypes.c_uint32
    i32 = ctypes.c_int32

    lib.dgt_max_compressed_size.restype = u32
    lib.dgt_max_compressed_size.argtypes = [u32]
    lib.dgt_max_float_compressed_size.restype = u32
    lib.dgt_max_float_compressed_size.argtypes = [u32, u32]
    lib.dgt_ans_encode.restype = u32
    lib.dgt_ans_encode.argtypes = [u8p, u32, i32, i32, u8p, i32]
    lib.dgt_ans_decode.restype = i32
    lib.dgt_ans_decode.argtypes = [u8p, u8p, u32, u32p, i32]
    lib.dgt_float_compress.restype = u32
    lib.dgt_float_compress.argtypes = [u8p, u32, u32, i32, i32, u8p, i32]
    lib.dgt_float_decompress.restype = i32
    lib.dgt_float_decompress.argtypes = [u8p, u8p, u32, u32p, u32p, i32]
    lib.dgt_float_compress_batch.restype = None
    lib.dgt_float_compress_batch.argtypes = [
        u8p, u32, u32p, u32, u32, i32, i32, u8p, u32, u32p, i32,
    ]
    lib.dgt_float_decompress_batch.restype = None
    lib.dgt_float_decompress_batch.argtypes = [
        u8p, u32, u32, u8p, u32, u32, i32p, u32p, i32,
    ]
    _lib = lib
    return lib


def _p8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def default_threads() -> int:
    return min(os.cpu_count() or 1, 16)


def ans_encode(data: np.ndarray, prob_bits: int = 10,
               use_checksum: bool = False,
               nthreads: Optional[int] = None) -> np.ndarray:
    lib = _load()
    data = np.ascontiguousarray(data, np.uint8).ravel()
    out = np.zeros(lib.dgt_max_compressed_size(data.size), np.uint8)
    n = lib.dgt_ans_encode(
        _p8(data), data.size, prob_bits, int(use_checksum), _p8(out),
        nthreads or default_threads(),
    )
    return out[:n]


def ans_decode(archive: np.ndarray,
               nthreads: Optional[int] = None) -> np.ndarray:
    lib = _load()
    archive = np.ascontiguousarray(archive, np.uint8).ravel()
    n = int(archive[8:12].view(np.uint32)[0]) if archive.size >= 12 else 0
    out = np.zeros(max(n, 1), np.uint8)
    size = ctypes.c_uint32(0)
    rc = lib.dgt_ans_decode(
        _p8(archive), _p8(out), out.size, ctypes.byref(size),
        nthreads or default_threads(),
    )
    if rc != 0:
        raise RuntimeError(f"native ans_decode failed: {rc}")
    return out[: size.value]


def float_compress(words: np.ndarray, float_type: FloatType,
                   prob_bits: int = 10, use_checksum: bool = False,
                   nthreads: Optional[int] = None) -> np.ndarray:
    lib = _load()
    ft = FloatType(float_type)
    raw = np.ascontiguousarray(words).view(np.uint8).ravel()
    ws = {1: 2, 2: 2, 3: 4, 4: 8}[int(ft)]
    n = raw.size // ws
    out = np.zeros(lib.dgt_max_float_compressed_size(int(ft), n), np.uint8)
    sz = lib.dgt_float_compress(
        _p8(raw), n, int(ft), prob_bits, int(use_checksum), _p8(out),
        nthreads or default_threads(),
    )
    return out[:sz]


def float_decompress(archive: np.ndarray,
                     nthreads: Optional[int] = None
                     ) -> Tuple[np.ndarray, FloatType]:
    lib = _load()
    archive = np.ascontiguousarray(archive, np.uint8).ravel()
    n = int(archive[4:8].view(np.uint32)[0])
    ft = FloatType(int(archive[8:12].view(np.uint32)[0]) & 0xF)
    ws = {1: 2, 2: 2, 3: 4, 4: 8}[int(ft)]
    out = np.zeros(max(n, 1) * ws, np.uint8)
    nn = ctypes.c_uint32(0)
    fto = ctypes.c_uint32(0)
    rc = lib.dgt_float_decompress(
        _p8(archive), _p8(out), n, ctypes.byref(nn), ctypes.byref(fto),
        nthreads or default_threads(),
    )
    if rc != 0:
        raise RuntimeError(f"native float_decompress failed: {rc}")
    dt = {1: np.uint16, 2: np.uint16, 3: np.uint32, 4: np.uint64}[int(ft)]
    return out[: n * ws].view(dt), ft


def float_compress_batch(data: np.ndarray, sizes: np.ndarray,
                         float_type: FloatType, prob_bits: int = 10,
                         use_checksum: bool = False,
                         nthreads: Optional[int] = None):
    """data: uint8[B, rowBytes] padded rows; sizes: float counts.
    Returns (out uint8[B, maxComp], out_sizes uint32[B])."""
    lib = _load()
    ft = FloatType(float_type)
    data = np.ascontiguousarray(data, np.uint8)
    B, row_bytes = data.shape
    sizes = np.ascontiguousarray(sizes, np.uint32)
    max_n = int(sizes.max()) if B else 0
    out_row = int(lib.dgt_max_float_compressed_size(int(ft), max_n))
    out = np.zeros((B, out_row), np.uint8)
    out_sizes = np.zeros(B, np.uint32)
    lib.dgt_float_compress_batch(
        _p8(data), row_bytes,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), B, int(ft),
        prob_bits, int(use_checksum), _p8(out), out_row,
        out_sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        nthreads or default_threads(),
    )
    return out, out_sizes


def float_decompress_batch(comp: np.ndarray, cap_floats: int,
                           float_type: FloatType,
                           nthreads: Optional[int] = None):
    lib = _load()
    ft = FloatType(float_type)
    comp = np.ascontiguousarray(comp, np.uint8)
    B, crow = comp.shape
    ws = {1: 2, 2: 2, 3: 4, 4: 8}[int(ft)]
    out = np.zeros((B, cap_floats * ws), np.uint8)
    status = np.zeros(B, np.int32)
    nout = np.zeros(B, np.uint32)
    lib.dgt_float_decompress_batch(
        _p8(comp), crow, B, _p8(out), cap_floats * ws, cap_floats,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nout.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        nthreads or default_threads(),
    )
    return out, status, nout
