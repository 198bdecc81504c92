"""Native (C) host-side kernels, loaded via ctypes.

The genuinely host-bound loops in the framework live here (the reference
used the ``galois`` package and three ad-hoc ``.so``s via ctypes;
SURVEY.md native-component summary).  The device compute path needs no
native code -- JAX/XLA covers it -- so this library ships only:

  * gf2.c: bit-packed GF(2) Gauss-Jordan / rank, and the batched ML
    (optimal) decoder built on them -- inherently pivot-sequential;
  * peeling.c: the sequential R-process peeling decoder (one random
    degree-1 peel at a time) with O(E) incremental degree tracking and
    residual-degree-histogram sampling -- inherently sequential per
    trial.

Build: ``python -m iib_project_ldpc_codes_tpu.native.build`` (or import;
it auto-builds with the system C compiler on first use).  All callers fall
back to a pure-numpy implementation when the library is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(__file__)
_SO_PATH = os.path.join(_HERE, "libgf2.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def build(force: bool = False) -> str:
    """Compile the C kernels into libgf2.so with the system compiler."""
    srcs = [os.path.join(_HERE, f) for f in ("gf2.c", "peeling.c")]
    stale = (force or not os.path.exists(_SO_PATH) or
             any(os.path.getmtime(_SO_PATH) < os.path.getmtime(s)
                 for s in srcs))
    if stale:
        cc = os.environ.get("CC", "cc")
        cmd = [cc, "-O3", "-march=native", "-shared", "-fPIC", *srcs,
               "-o", _SO_PATH]
        subprocess.run(cmd, check=True, capture_output=True)
    return _SO_PATH


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None on failure."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        build()
        lib = ctypes.CDLL(_SO_PATH)
        lib.gf2_row_reduce.restype = ctypes.c_int
        lib.gf2_row_reduce.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.gf2_rank.restype = ctypes.c_int
        lib.gf2_rank.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.peel_decode_trials.restype = ctypes.c_int
        lib.peel_decode_trials.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        lib.ml_decode_trials.restype = ctypes.c_int
        lib.ml_decode_trials.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8)]
        lib.peel_decode_trials_hist.restype = ctypes.c_int
        lib.peel_decode_trials_hist.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def gf2_row_reduce_native(aug: np.ndarray, num_cols: int
                          ) -> Optional[Tuple[np.ndarray, list]]:
    """Native Gauss-Jordan on uint64[rows, words]; None if lib unavailable.

    Mutates ``aug`` in place (like ops.ml.gf2_row_reduce) and returns
    (aug, pivot_columns).
    """
    lib = load()
    if lib is None:
        return None
    aug = np.ascontiguousarray(aug, dtype=np.uint64)
    rows, words = aug.shape
    pivots = np.zeros(min(rows, num_cols) + 1, dtype=np.int32)
    rank = lib.gf2_row_reduce(
        aug.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        rows, words, num_cols,
        pivots.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return aug, pivots[:rank].tolist()


def gf2_rank_native(mat: np.ndarray, num_cols: int) -> Optional[int]:
    lib = load()
    if lib is None:
        return None
    mat = np.ascontiguousarray(mat, dtype=np.uint64)
    rows, words = mat.shape
    return lib.gf2_rank(
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        rows, words, num_cols)


def peel_decode_trials_native(chk_to_var: np.ndarray,
                              var_to_chk: np.ndarray,
                              erased: np.ndarray, seed: int
                              ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray, np.ndarray]]:
    """Sequential R-process peeling over a batch of erasure patterns.

    Args:
      chk_to_var: int32[m, dc], var_to_chk: int32[n, dv],
      erased: bool/uint8[trials, n], seed: PRNG seed (reproducible).

    Returns ``(unresolved[trials, n] bool, evolution[trials, n+1] int32,
    steps[trials] int32, num_erasures[trials] int32)`` with the exact
    bookkeeping of ops.peeling.peel_decode (counts before each peel,
    final 0 appended on success, -1 padding), or None if the native
    library is unavailable.
    """
    lib = load()
    if lib is None:
        return None
    chk_to_var = np.ascontiguousarray(chk_to_var, np.int32)
    var_to_chk = np.ascontiguousarray(var_to_chk, np.int32)
    erased = np.ascontiguousarray(erased, np.uint8)
    trials, n = erased.shape
    m, dc = chk_to_var.shape
    dv = var_to_chk.shape[1]
    max_evo = n + 1
    unresolved = np.zeros((trials, n), np.uint8)
    evolution = np.zeros((trials, max_evo), np.int32)
    steps = np.zeros(trials, np.int32)
    erasures = np.zeros(trials, np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.peel_decode_trials(
        chk_to_var.ctypes.data_as(i32p), var_to_chk.ctypes.data_as(i32p),
        n, m, dv, dc, erased.ctypes.data_as(u8p), trials,
        ctypes.c_uint64(seed), unresolved.ctypes.data_as(u8p),
        evolution.ctypes.data_as(i32p), max_evo,
        steps.ctypes.data_as(i32p), erasures.ctypes.data_as(i32p))
    if rc != 0:
        return None
    return unresolved.astype(bool), evolution, steps, erasures


def peel_decode_trials_hist_native(chk_to_var: np.ndarray,
                                   var_to_chk: np.ndarray,
                                   erased: np.ndarray, seed: int,
                                   sample_u: np.ndarray
                                   ) -> Optional[Tuple[np.ndarray,
                                                       np.ndarray,
                                                       np.ndarray]]:
    """Peel a batch recording residual check-degree histograms.

    ``sample_u`` is a strictly-descending int32 vector of
    unresolved-variable counts at which to snapshot the histogram
    (u = n(1-t) in the theory time units of
    utils.theory.degree_distribution_at_time).

    Returns ``(hist[trials, len(sample_u), dc+1] int32 (-1 rows =
    snapshot never reached), unresolved[trials, n] bool,
    num_erasures[trials] int32)`` or None if the library is unavailable.
    The peel order matches :func:`peel_decode_trials_native` exactly for
    equal (seed, trial).
    """
    lib = load()
    if lib is None:
        return None
    chk_to_var = np.ascontiguousarray(chk_to_var, np.int32)
    var_to_chk = np.ascontiguousarray(var_to_chk, np.int32)
    erased = np.ascontiguousarray(erased, np.uint8)
    sample_u = np.ascontiguousarray(sample_u, np.int32)
    trials, n = erased.shape
    m, dc = chk_to_var.shape
    dv = var_to_chk.shape[1]
    ns = len(sample_u)
    hist = np.zeros((trials, ns, dc + 1), np.int32)
    unresolved = np.zeros((trials, n), np.uint8)
    steps = np.zeros(trials, np.int32)
    erasures = np.zeros(trials, np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.peel_decode_trials_hist(
        chk_to_var.ctypes.data_as(i32p), var_to_chk.ctypes.data_as(i32p),
        n, m, dv, dc, erased.ctypes.data_as(u8p), trials,
        ctypes.c_uint64(seed), sample_u.ctypes.data_as(i32p), ns,
        hist.ctypes.data_as(i32p), unresolved.ctypes.data_as(u8p),
        steps.ctypes.data_as(i32p), erasures.ctypes.data_as(i32p))
    if rc != 0:
        return None
    return hist, unresolved.astype(bool), erasures


def ml_decode_trials_native(chk_to_var: np.ndarray, n: int, rx: np.ndarray
                            ) -> Optional[np.ndarray]:
    """Batched ML BEC decode (native) from the edge-list code form.

    ``chk_to_var``: int32 [m, dc] (fixed code) or [trials, m, dc]
    (per-trial codes); ``rx``: uint8 [trials, n] in the {0,1,2} wire
    format.  Returns decoded uint8 [trials, n] ({0,1,2}, 2 =
    undetermined) or None if the library is unavailable.  Bit-exact vs
    ops.ml.ml_decode (dense-boolean-H semantics, duplicate edges count
    once).
    """
    lib = load()
    if lib is None:
        return None
    rx = np.ascontiguousarray(rx, np.uint8)
    trials, rn = rx.shape
    if rn != n:
        return None
    chk = np.ascontiguousarray(chk_to_var, np.int32)
    if chk.ndim == 2:
        c_count, (m, dc) = 1, chk.shape
    else:
        c_count, m, dc = chk.shape
        if c_count != trials:
            return None
    out = np.zeros((trials, n), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = lib.ml_decode_trials(
        chk.ctypes.data_as(i32p), c_count, m, dc, n,
        rx.ctypes.data_as(u8p), trials, out.ctypes.data_as(u8p))
    if rc != 0:
        return None
    return out
