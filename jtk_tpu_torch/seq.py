"""DNA sequence utilities (host side, NumPy).

Reference counterpart: ``haplotyper/src/seq.rs`` (revcomp table + DNA iterator)
and the 2-bit encoding convention A->0, C->1, G->2, T->3 used by the HMM
emission tables (``definitions/src/lib.rs:121-125``).

Encoding used throughout this package:
  A=0 C=1 G=2 T=3, N/pad=4.  Lowercase (repeat-masked) bases carry a separate
  mask bit; device arrays only ever see the 0..4 codes.
"""

from __future__ import annotations

import numpy as np

# ASCII -> code lookup (uppercase & lowercase both map to the base code).
_LUT = np.full(256, 4, dtype=np.int8)
for i, b in enumerate(b"ACGT"):
    _LUT[b] = i
for i, b in enumerate(b"acgt"):
    _LUT[b] = i

# lowercase detector (mask bit)
_IS_LOWER = np.zeros(256, dtype=bool)
for b in b"acgt":
    _IS_LOWER[b] = True

_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)
_DECODE_LOWER = np.frombuffer(b"acgtn", dtype=np.uint8)

# complement in code space: A<->T, C<->G, N->N
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.int8)


def encode(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII DNA -> int8 codes (0..4)."""
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(bytes(seq), dtype=np.uint8)
    return _LUT[arr]


def mask_bits(seq: bytes | str) -> np.ndarray:
    """Boolean array: True where the base is lowercase (repeat-masked)."""
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(bytes(seq), dtype=np.uint8)
    return _IS_LOWER[arr]


def decode(codes: np.ndarray, lower: np.ndarray | None = None) -> bytes:
    """int8 codes -> ASCII DNA; positions where ``lower`` is True emit lowercase."""
    codes = np.asarray(codes)
    up = _DECODE[codes]
    if lower is not None:
        lo = _DECODE_LOWER[codes]
        up = np.where(lower, lo, up)
    return up.tobytes()


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space."""
    return _COMP[np.asarray(codes)[::-1]]


def revcomp_ascii(seq: bytes) -> bytes:
    return decode(revcomp(encode(seq)))
