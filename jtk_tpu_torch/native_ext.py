"""ctypes bindings for the native host-runtime pieces (``native/*.cc``).

The TPU build keeps FLOP-heavy work on the device; the host runtime around
it (IO, seeding/voting scans, scheduling) is native C++ where the reference
used Rust/C (SURVEY.md §2.4).  Libraries build lazily on first use with the
image's g++ and fall back to the pure-numpy implementations when a
toolchain is absent — every native entry point has a Python twin with
identical semantics.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           os.pardir, "native")
# built libraries go to the package's (git-ignored) build directory; the
# tracked native/lib*.so files of the JAX package are never rewritten
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_build", "native")
_cache: dict[str, object] = {}


def _build(name: str) -> str | None:
    src = os.path.join(_NATIVE_DIR, f"{name}.cc")
    lib = os.path.join(_BUILD_DIR, f"lib{name}.so")
    if not os.path.exists(src):
        return None
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return lib
    try:
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
             "-o", tmp, src],
            check=True, capture_output=True, timeout=300)
        os.replace(tmp, lib)
        return lib
    except Exception as e:  # noqa: BLE001
        print(f"native build of {name} failed: {e}", file=sys.stderr)
        return None


def load(name: str):
    """Load (building if needed) lib<name>.so; returns None on failure
    (callers then use their pure-numpy twins)."""
    if name in _cache:
        return _cache[name]
    lib_path = _build(name)
    handle = None
    if lib_path is not None:
        try:
            handle = ctypes.CDLL(lib_path)
        except OSError as e:
            print(f"native load of {name} failed: {e}", file=sys.stderr)
    _cache[name] = handle
    return handle


_I8P = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_U16P = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_U64P = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")


def kmer_vote_native(blob, lane_starts, lane_lens, lane_phases,
                     idx_kmers, idx_cids, idx_poss,
                     k: int, stride: int, max_occ: int, min_hits: int,
                     bin_: int, n_threads: int | None = None):
    """Native candidate voting; returns (lane, cid, dmed, c2) int32 arrays
    or None when the native library is unavailable."""
    lib = load("kmer_vote")
    if lib is None:
        return None
    fn = lib.kmer_vote
    if not getattr(fn, "_configured", False):
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            _I8P, _I64P, _I64P, _I64P, ctypes.c_int32,
            _U64P, _I32P, _I32P, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            _I32P, _I32P, _I32P, _I32P, ctypes.c_int64,
        ]
        fn._configured = True
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    blob = np.ascontiguousarray(blob, np.int8)
    lane_starts = np.ascontiguousarray(lane_starts, np.int64)
    lane_lens = np.ascontiguousarray(lane_lens, np.int64)
    lane_phases = np.ascontiguousarray(lane_phases, np.int64)
    idx_kmers = np.ascontiguousarray(idx_kmers, np.uint64)
    idx_cids = np.ascontiguousarray(idx_cids, np.int32)
    idx_poss = np.ascontiguousarray(idx_poss, np.int32)
    cap = max(1024, 16 * len(lane_starts))
    for _ in range(3):
        out = [np.empty(cap, np.int32) for _ in range(4)]
        n = fn(blob, lane_starts, lane_lens, lane_phases,
               np.int32(len(lane_starts)),
               idx_kmers, idx_cids, idx_poss, np.int64(len(idx_kmers)),
               np.int32(k), np.int32(stride), np.int32(max_occ),
               np.int32(min_hits), np.int32(bin_), np.int32(n_threads),
               out[0], out[1], out[2], out[3], np.int64(cap))
        if n >= 0:
            return tuple(o[:n] for o in out)
        cap = -n
    return None


def gotoh_skel_native(ch, cl, dr, offs, pairs, min_match: int,
                      score_thr: int, n_threads: int | None = None):
    """Threaded chunk-space Gotoh over skeleton pairs (deletion fill).

    ch/cl (int32) and dr (uint8) are concatenated per-read skeletons with
    offs (int64, n_reads+1); pairs is (P, 3) int32 rows (ri, qi, fwd).
    Returns (pass uint8 (P,), kinds uint8, lens int32, starts int64 (P,),
    counts int32 (P,)) — merged RLE ops per passing pair — or None when
    the native library is unavailable."""
    lib = load("gotoh_skel")
    if lib is None:
        return None
    fn = lib.gotoh_skel
    if not getattr(fn, "_configured", False):
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            _I32P, _I32P, _U8P, _I64P, ctypes.c_int32,
            _I32P, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _U8P, _U8P, _I32P, _I64P, _I32P, ctypes.c_int64,
        ]
        fn._configured = True
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    ch = np.ascontiguousarray(ch, np.int32)
    cl = np.ascontiguousarray(cl, np.int32)
    dr = np.ascontiguousarray(dr, np.uint8)
    offs = np.ascontiguousarray(offs, np.int64)
    pairs = np.ascontiguousarray(pairs, np.int32)
    P = len(pairs)
    passed = np.empty(P, np.uint8)
    starts = np.empty(P, np.int64)
    counts = np.empty(P, np.int32)
    cap = max(1024, 12 * P)
    for _ in range(3):
        kinds = np.empty(cap, np.uint8)
        lens = np.empty(cap, np.int32)
        n = fn(ch, cl, dr, offs, np.int32(len(offs) - 1),
               pairs, np.int64(P), np.int32(min_match), np.int32(score_thr),
               np.int32(n_threads), passed, kinds, lens, starts, counts,
               np.int64(cap))
        if n >= 0:
            return passed, kinds[:n], lens[:n], starts, counts
        cap = -n
    return None


def cigar_expand_native(bits, del_vals, del_idx, q_lens, lead_d):
    """Batched RLE cigar construction from packed traceback streams.

    bits (B, bytes) uint8 little-endian is-insertion plane; del_vals/del_idx
    (B, K) uint16; q_lens/lead_d (B,) int32.  Returns (kinds uint8, lens
    int32, row_off int64 (B+1,)) or None when the library is unavailable."""
    lib = load("cigar_expand")
    if lib is None:
        return None
    fn = lib.cigar_expand
    if not getattr(fn, "_configured", False):
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            _U8P, ctypes.c_int64, _U16P, _U16P, ctypes.c_int32,
            _I32P, _I32P, ctypes.c_int32,
            _U8P, _I32P, ctypes.c_int64, _I64P,
        ]
        fn._configured = True
    bits = np.ascontiguousarray(bits, np.uint8)
    del_vals = np.ascontiguousarray(del_vals, np.uint16)
    del_idx = np.ascontiguousarray(del_idx, np.uint16)
    q_lens = np.ascontiguousarray(q_lens, np.int32)
    lead_d = np.ascontiguousarray(lead_d, np.int32)
    B = len(q_lens)
    row_off = np.empty(B + 1, np.int64)
    cap = max(1024, int(q_lens.sum()) // 8)
    for _ in range(3):
        kinds = np.empty(cap, np.uint8)
        lens = np.empty(cap, np.int32)
        n = fn(bits, np.int64(bits.shape[1]), del_vals, del_idx,
               np.int32(del_vals.shape[1]), q_lens, lead_d, np.int32(B),
               kinds, lens, np.int64(cap), row_off)
        if n >= 0:
            return kinds[:n], lens[:n], row_off
        cap = -n
    return None
