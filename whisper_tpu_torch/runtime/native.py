"""ctypes bindings for the port's host C++ runtime (csrc/runtime.cpp).

Counterpart of whisper_tpu/runtime/native.py: block dequantization, the
DTW dynamic program, the signal-energy envelope and the GBNF grammar
engine's vocab scan and token accept, in threaded C++ on the host. The
library builds with g++ at first use through ops/build.py into
`_build/libruntime-<hash>.so`; the port never loads the JAX package's.

Every entry point returns None when the library cannot be built or
loaded, and its consumer (checkpoint/quant.py, decoding/dtw.py,
decoding/timestamps.py, decoding/grammar.py) then takes its Python path,
which computes the same values. The first failure logs one warning with
the compiler's output; `available()` says whether the library loaded.
"""

from __future__ import annotations

import ctypes
import logging
import os
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

_lib: Optional[ctypes.CDLL] = None
_tried = False


def get_lib() -> Optional[ctypes.CDLL]:
    """The runtime library, built and loaded on first use; None if that
    failed (once: later calls do not retry)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    from whisper_tpu_torch.ops import build
    try:
        lib = build.load("runtime")
    except (OSError, RuntimeError) as e:
        log.warning("the host runtime (csrc/runtime.cpp) did not build or load; "
                    "its consumers take their Python paths:\n%s", e)
        return None
    lib.wtpu_dequantize.restype = ctypes.c_int
    lib.wtpu_dequantize.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
    lib.wtpu_dtw.restype = ctypes.c_int
    lib.wtpu_dtw.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.wtpu_signal_energy.restype = None
    lib.wtpu_signal_energy.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.wtpu_version.restype = ctypes.c_int
    lib.wtpu_grammar_rejects.restype = ctypes.c_int64
    lib.wtpu_grammar_rejects.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
    lib.wtpu_grammar_accept.restype = ctypes.c_int32
    lib.wtpu_grammar_accept.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def dequantize(ttype: int, raw, nelems: int, n_threads: int = 0) -> Optional[np.ndarray]:
    """Block dequantization of a raw ggml payload to float32; None if the
    library is unavailable, the type unsupported or the buffer short (the
    C side trusts nelems)."""
    lib = get_lib()
    if lib is None:
        return None
    from whisper_tpu_torch.checkpoint import quant
    buf = np.frombuffer(raw, np.uint8) if isinstance(raw, (bytes, bytearray)) else raw
    try:
        need = quant.row_nbytes(ttype, nelems)
    except (KeyError, AssertionError):
        need = None
    if need is not None and buf.nbytes < need:
        return None
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    buf = np.ascontiguousarray(buf)
    out = np.empty(nelems, np.float32)
    rc = lib.wtpu_dequantize(ttype, _ptr(buf), _ptr(out), nelems, n_threads)
    return out if rc == 0 else None


def dtw(x: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The DTW path (text indices, time indices) through cost matrix x; None
    if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    n, m = x.shape
    ti = np.empty(n + m, np.int32)
    tj = np.empty(n + m, np.int32)
    ln = lib.wtpu_dtw(_ptr(x), n, m, _ptr(ti), _ptr(tj))
    if ln < 0:
        return None
    return ti[:ln].copy(), tj[:ln].copy()


def signal_energy(x: np.ndarray, hw: int) -> Optional[np.ndarray]:
    """Moving average of |x| over 2*hw+1 samples; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(len(x), np.float32)
    lib.wtpu_signal_energy(_ptr(x), len(x), hw, _ptr(out))
    return out


# ---------------------------------------------------------------------------
# GBNF grammar engine (the native twin of decoding/grammar.py's machine)
# ---------------------------------------------------------------------------

def flatten_rules(rules) -> Tuple[np.ndarray, np.ndarray]:
    """rules: list of [(type, value), ...] -> (elems (N, 2) i32, offs i32)."""
    offs = np.zeros(len(rules) + 1, np.int32)
    offs[1:] = np.cumsum([len(r) for r in rules])
    elems = np.array([e for r in rules for e in r], np.int32).reshape(-1, 2)
    return elems, offs


def flatten_stacks(stacks) -> Tuple[np.ndarray, np.ndarray]:
    """stacks: list of ((rule, index), ...) -> (pairs (N, 2) i32, offs i32)."""
    offs = np.zeros(len(stacks) + 1, np.int32)
    offs[1:] = np.cumsum([len(s) for s in stacks])
    flat = np.array([p for s in stacks for p in s], np.int32).reshape(-1, 2)
    return flat, offs


def flatten_vocab(tokens) -> Tuple[np.ndarray, np.ndarray]:
    """tokens: list of bytes -> (concatenated u8, offsets i64)."""
    offs = np.zeros(len(tokens) + 1, np.int64)
    offs[1:] = np.cumsum([len(t) for t in tokens])
    buf = np.frombuffer(b"".join(tokens), np.uint8).copy() if offs[-1] else \
        np.zeros(0, np.uint8)
    return buf, offs


def grammar_rejects(rules_flat, stacks, vocab_flat, partial_value: int,
                    partial_remain: int) -> Optional[np.ndarray]:
    """The rejected-token mask (n_tokens uint8) at these stacks; None if
    the library is unavailable. rules_flat / vocab_flat: flatten_rules /
    flatten_vocab."""
    lib = get_lib()
    if lib is None:
        return None
    elems, roffs = rules_flat
    vbuf, voffs = vocab_flat
    sflat, soffs = flatten_stacks(stacks)
    n_tokens = len(voffs) - 1
    mask = np.zeros(n_tokens, np.uint8)
    rc = lib.wtpu_grammar_rejects(
        _ptr(elems), _ptr(roffs), len(roffs) - 1, _ptr(sflat), _ptr(soffs), len(soffs) - 1,
        _ptr(vbuf), _ptr(voffs), n_tokens, partial_value, partial_remain, _ptr(mask))
    return mask if rc >= 0 else None


def grammar_accept(rules_flat, stacks, token: bytes, partial_value: int,
                   partial_remain: int):
    """The stacks advanced through one token's code points: (stacks,
    partial value, partial remain), or None if the library is unavailable
    or the result overflows the fixed output buffers."""
    lib = get_lib()
    if lib is None:
        return None
    elems, roffs = rules_flat
    sflat, soffs = flatten_stacks(stacks)
    tok = np.frombuffer(bytes(token), np.uint8).copy()
    partial = np.array([partial_value, partial_remain], np.int32)
    max_stacks, max_pairs = 4096, 65536
    out_flat = np.zeros((max_pairs, 2), np.int32)
    out_offs = np.zeros(max_stacks + 1, np.int32)
    n = lib.wtpu_grammar_accept(
        _ptr(elems), _ptr(roffs), len(roffs) - 1, _ptr(sflat), _ptr(soffs), len(soffs) - 1,
        _ptr(tok), len(tok), _ptr(partial), _ptr(out_flat), _ptr(out_offs), max_pairs,
        max_stacks)
    if n < 0:
        return None
    pairs = out_flat[: out_offs[n]].tolist()
    stacks_out = [tuple(map(tuple, pairs[out_offs[s]: out_offs[s + 1]])) for s in range(n)]
    return stacks_out, int(partial[0]), int(partial[1])
