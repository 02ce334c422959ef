"""K1 — banded pair-HMM forward/backward (3-state Match/Ins/Del).

Counterpart of ``jtk_tpu/ops/phmm.py``: conditional pair-HMM over
(template = chunk, query = read), banded around the guide diagonal, in
probability space with per-row rescaling.  Tables come from the table
kernels of :mod:`jtk_tpu_torch.ops.phmm_tables`; log-likelihoods alone from
the forward kernel of :mod:`jtk_tpu_torch.ops.phmm_lk` (hand-written CUDA on
the card, plain PyTorch on the CPU).

Parameter layout mirrors the reference: transitions 3x3 ``[from, to]``,
``mat_emit[ref, query]`` (4, 4), ``ins_emit[prev_query_or_start, query]``
(5, 4).  :class:`PHMMParams` holds float32 tensors; the tiny tables move to
an op's device when it runs.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

import numpy as np
import torch

from .phmm_lk import lk_inputs, phmm_lk, tables8
from .phmm_tables import EPS, prep_tables_inputs, tables_batch


class PHMMParams(NamedTuple):
    trans: torch.Tensor     # (3,3) f32 [from, to]; states M=0, I=1, D=2
    mat_emit: torch.Tensor  # (4,4) f32 [ref, query]
    ins_emit: torch.Tensor  # (5,4) f32 [prev query base (4=start), query]

    @classmethod
    def from_hmmparam(cls, hp, device=None) -> "PHMMParams":
        t = np.array(
            [[hp.mat_mat, hp.mat_ins, hp.mat_del],
             [hp.ins_mat, hp.ins_ins, hp.ins_del],
             [hp.del_mat, hp.del_ins, hp.del_del]], dtype=np.float32)
        me = np.array(hp.mat_emit, dtype=np.float32).reshape(4, 4)
        ie = np.array(hp.ins_emit, dtype=np.float32).reshape(5, 4)
        return params_from_numpy(t, me, ie, device)

    @classmethod
    def default(cls, device=None) -> "PHMMParams":
        from ..datamodel import HMMParam
        return cls.from_hmmparam(HMMParam(), device)


def params_from_numpy(trans, mat_emit, ins_emit, device=None) -> PHMMParams:
    """PHMMParams from numpy tables — e.g. the fields of a ``jtk_tpu``
    ``PHMMParams`` passed through ``np.asarray`` — on ``device`` (default:
    the runtime device)."""
    from ..runtime import resolve
    dev = resolve(device)

    def t(x, shape):
        a = torch.as_tensor(np.array(x, np.float32), device=dev)
        if tuple(a.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(a.shape)}")
        return a

    return PHMMParams(t(trans, (3, 3)), t(mat_emit, (4, 4)),
                      t(ins_emit, (5, 4)))


def _batched(q, r, offsets, q_len, t_len):
    q = np.asarray(q)
    if q.ndim == 1:
        return (q[None], np.asarray(r), np.asarray(offsets)[None],
                np.array([q_len]), int(t_len), True)
    return q, np.asarray(r), np.asarray(offsets), np.asarray(q_len), \
        np.asarray(t_len) if np.ndim(t_len) else int(t_len), False


def forward_banded(q, r, offsets, q_len, t_len, params: PHMMParams, W: int,
                   device=None):
    """Banded forward pass of one pair (q (Q,), r (T,)) or a batch
    (q (B, Q), r (T,) or (B, T)).  offsets must have unit increments.
    Returns (lk, (Ms, Is, Ds), fcum, rcs) with tables (…, Q+1, W) row-scaled,
    ``fcum`` cumulative log scales (true f(i,j) = table[i, j-off[i]] *
    exp(fcum[i])) and ``rcs[i, k]`` = r[off[i]+k-1] (code 4 out of range)."""
    q, r, offs, ql, tl, single = _batched(q, r, offsets, q_len, t_len)
    prep = prep_tables_inputs(q, r, offs, ql, tl, params, W, device=device)
    lk, tabs, fcum, rcs, _b, _bc, _o = tables_batch(prep, W, backward=False)
    if single:
        return lk[0], tuple(x[0] for x in tabs), fcum[0], rcs[0]
    return lk, tabs, fcum, rcs


def backward_banded(q, r, offsets, q_len, t_len, params: PHMMParams, W: int,
                    device=None):
    """Banded backward pass with the same band offsets as forward.
    Returns ((bM, bI, bD), bcum): true b(i,j) = table[i, j-off[i]] *
    exp(bcum[i])."""
    q, r, offs, ql, tl, single = _batched(q, r, offsets, q_len, t_len)
    prep = prep_tables_inputs(q, r, offs, ql, tl, params, W, device=device)
    _lk, _f, _fc, _r, tabs, bcum, _o = tables_batch(prep, W)
    if single:
        return tuple(x[0] for x in tabs), bcum[0]
    return tabs, bcum


def likelihood(q, r, offsets, q_len, t_len, params: PHMMParams, W: int):
    lk, _, _, _ = forward_banded(q, r, offsets, q_len, t_len, params, W)
    return lk


def likelihood_pairs(qs, rs, offs, q_lens, t_lens, params, W: int,
                     max_batch: int = 256):
    """Log-likelihoods of independent (query, template) pairs through the
    forward log-likelihood kernel (K1l, :mod:`.phmm_lk`), which writes no
    tables.  Returns numpy (B,)."""
    from ..runtime import device
    dev = device()
    qs = np.asarray(qs)
    rs, offs = np.asarray(rs), np.asarray(offs)
    q_lens = np.asarray(q_lens)
    t_lens = np.broadcast_to(np.asarray(t_lens), (len(qs),))
    tabs = tables8(params, dev)
    out = np.zeros(len(qs), np.float32)
    for s in range(0, len(qs), max_batch):
        sl = slice(s, s + max_batch)
        args = lk_inputs(qs[sl], rs if rs.ndim == 1 else rs[sl], offs[sl],
                         q_lens[sl], t_lens[sl], W, device=dev)
        out[sl] = phmm_lk(*args, *tabs).cpu().numpy()
    return out


def likelihood_pileup(qs, template, offs, q_lens, t_len, params, W: int):
    """Log-likelihoods of many queries against one template."""
    return likelihood_pairs(qs, np.asarray(template), offs, q_lens, t_len,
                            params, W)


def _cdf_rows(m) -> list:
    """Per-row float64 CDFs, normalised as ``Generator.choice`` does."""
    out = []
    for row in np.asarray(m):
        c = np.asarray(row, np.float64).cumsum()
        c /= c[-1]
        out.append(c.tolist())
    return out


def hmm_generate(rng: np.random.Generator, template: np.ndarray,
                 params: PHMMParams) -> np.ndarray:
    """Sample a read from the pair-HMM: walk M/I/D by the transition matrix,
    emit query bases from the emission tables.  Host-side; used by the
    gain-calibration simulators.

    Each draw is ``bisect(cdf, rng.random())`` — exactly what
    ``rng.choice(n, p=row)`` computes, one uniform per draw — so the reads
    and the generator's stream equal the JAX package's ``hmm_generate``."""
    t = _np(params.trans)
    me = _np(params.mat_emit)
    me = me / np.maximum(me.sum(1, keepdims=True), 1e-9)
    ie = _np(params.ins_emit)
    ie = ie / np.maximum(ie.sum(1, keepdims=True), 1e-9)
    c_me, c_ie = _cdf_rows(me), _cdf_rows(ie)
    c_t = _cdf_rows(t / t.sum(1, keepdims=True))
    rnd = rng.random
    out = []
    state = 0
    i = 0
    prev = 4
    tpl = np.asarray(template).tolist()
    T = len(tpl)
    while i < T:
        if state == 0:   # M: consume template, emit
            b = bisect.bisect_right(c_me[tpl[i]], rnd())
            out.append(b)
            prev = b
            i += 1
        elif state == 1:  # I: emit only
            b = bisect.bisect_right(c_ie[prev], rnd())
            out.append(b)
            prev = b
        else:            # D: consume template silently
            i += 1
        state = bisect.bisect_right(c_t[state], rnd())
    return np.array(out, np.int8)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


__all__ = ["EPS", "PHMMParams", "params_from_numpy", "forward_banded",
           "backward_banded", "likelihood", "likelihood_pairs",
           "likelihood_pileup", "hmm_generate"]
