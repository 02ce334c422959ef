"""K1l — banded pair-HMM forward log-likelihood, without tables.

Counterpart of the K1l half of ``jtk_tpu/ops/pallas_phmm.py``
(``_phmm_fwd_kernel``, launched by ``_pallas_fwd`` and wrapped by
``pallas_likelihood_pileup``).  :func:`phmm_lk` is the kernel wrapper: on
CUDA tensors it launches the hand-written kernel of ``csrc/phmm_lk.cu`` (the
K1 forward-tables kernel's row wavefront and launch geometry, without the
tables); on CPU tensors it runs :func:`phmm_lk_plain`, the same function in
plain PyTorch.  :func:`lk_inputs` builds its arguments on the device.

The recursion is ``jtk_tpu/ops/phmm.py::forward_banded``'s: M/I/D update,
the in-row Del chain ``D[k] = c[k] + tdd * D[k-1]``, each row rescaled by
its sum (+ EPS), rows past ``q_len`` frozen, and
``lk = log(fin + EPS) + sum(log scales)`` with ``fin`` the M + I + D mass
at column ``t_len`` of the last row.  Codes are raw: an N (code 4) in the
read or template emits with probability 0, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_build import Launches, check, launch
from .phmm_tables import EPS, _linrec, _shl, _shr, scratch, tables_geometry

LAUNCHES = Launches("phmm_lk")


def tables8(params, device):
    """PHMMParams -> padded (8, 8) trans, mat_emit, ins_emit tensors on
    ``device`` (rows/columns past the real table are 0, so code 4 emits
    with probability 0 and ins row 4 is the start row).  Differentiable."""
    pad = torch.nn.functional.pad

    def p8(x, rows, cols):
        x = x.to(device=device, dtype=torch.float32)
        return pad(x, (0, 8 - cols, 0, 8 - rows)).contiguous()

    return (p8(params.trans, 3, 3), p8(params.mat_emit, 4, 4),
            p8(params.ins_emit, 5, 4))


def lk_inputs(qs, templates, offsets, q_lens, t_lens, W: int, device=None):
    """Arguments of :func:`phmm_lk` for a batch of pairs, built on the
    device: (qs, shifts, inc, rc0, j0, qlen, tlen).

    ``qs`` (B, Q) read codes, ``templates`` one (T,) template or per-pair
    (B, T) rows, ``offsets`` (B, Q+1) unit-increment band starts,
    ``q_lens`` (B,), ``t_lens`` (B,) or a scalar.  Codes past a length
    become 4; ``inc[r]`` is the template char entering lane W-1 when row
    r+1's band shifts; ``rc0[k]`` = template[off[0] + k - 1]."""
    from ..runtime import resolve
    dev = resolve(device)
    qs = np.asarray(qs)
    B, Q = qs.shape
    q_lens = np.asarray(q_lens, np.int64).reshape(B)
    tpl = np.asarray(templates)
    if tpl.ndim == 1:
        tpl = np.broadcast_to(tpl, (B, len(tpl)))
    t_lens = np.broadcast_to(np.asarray(t_lens, np.int64), (B,))
    T = tpl.shape[1]
    qc = np.where(np.arange(Q) < q_lens[:, None], np.clip(qs, 0, 4), 4)
    rc = np.where(np.arange(T) < t_lens[:, None], np.clip(tpl, 0, 4), 4)

    def t(x, dt=torch.int32):
        return torch.as_tensor(np.array(x), dtype=dt, device=dev)

    offs = t(offsets, torch.int64)
    i32 = torch.int32
    r_pad = torch.cat([torch.full((B, 1), 4, dtype=i32, device=dev), t(rc),
                       torch.full((B, W + Q + 2), 4, dtype=i32, device=dev)],
                      1)
    ks = torch.arange(W, dtype=torch.int64, device=dev)
    j0 = offs[:, :1] + ks[None]
    return (t(qc), (offs[:, 1:] - offs[:, :-1]).to(i32).contiguous(),
            torch.gather(r_pad, 1, offs[:, 1:] + W - 1).contiguous(),
            torch.gather(r_pad, 1, j0).contiguous(), j0.to(i32).contiguous(),
            t(q_lens), t(t_lens))


def phmm_lk_plain(qs, shifts, inc, rc0, j0, qlen, tlen, trans, me, ie):
    """Plain PyTorch version of the K1l kernel: (B,) f32 log-likelihoods."""
    B = rc0.shape[0]
    dev = rc0.device
    tmm, tmi, tmd = trans[0, 0], trans[0, 1], trans[0, 2]
    tim, tii, tid = trans[1, 0], trans[1, 1], trans[1, 2]
    tdm, tdi, tdd = trans[2, 0], trans[2, 1], trans[2, 2]
    me_f, ie_f = me.reshape(-1), ie.reshape(-1)
    tl = tlen[:, None].to(torch.int64)
    ql = qlen.to(torch.int64)
    j = j0.to(torch.int64)
    rc = rc0.to(torch.int64)
    M = (j == 0).to(torch.float32)
    I = torch.zeros_like(M)
    D = _linrec(tmd * _shr(M), tdd)
    D = torch.where((j >= 1) & (j <= tl), D, 0.0)
    s0 = (M + I + D).sum(1, keepdim=True) + EPS
    M, I, D = M / s0, I / s0, D / s0
    logs = torch.log(s0[:, 0])
    qprev = torch.full((B,), 4, dtype=torch.int64, device=dev)
    Qe = int(ql.max()) if B else 0
    for r in range(min(Qe, qs.shape[1])):
        qc = qs[:, r].to(torch.int64)
        sv = shifts[:, r:r + 1].to(torch.int64)
        one = sv == 1
        Md = torch.where(one, M, _shr(M))
        Id = torch.where(one, I, _shr(I))
        Dd = torch.where(one, D, _shr(D))
        Mu = torch.where(one, _shl(M), M)
        Iu = torch.where(one, _shl(I), I)
        Du = torch.where(one, _shl(D), D)
        rc_sh = torch.cat([rc[:, 1:], inc[:, r:r + 1].to(torch.int64)], 1)
        rc = torch.where(one, rc_sh, rc)
        jn = j + sv
        ok = (jn >= 1) & (jn <= tl)
        em = torch.where(ok, me_f[rc * 8 + qc[:, None]], 0.0)
        ei = ie_f[qprev * 8 + qc][:, None]
        Mrow = em * (tmm * Md + tim * Id + tdm * Dd)
        Irow = torch.where(jn <= tl, ei * (tmi * Mu + tii * Iu + tdi * Du),
                           0.0)
        Drow = torch.where(ok, _linrec(_shr(tmd * Mrow + tid * Irow), tdd),
                           0.0)
        sc = (Mrow + Irow + Drow).sum(1, keepdim=True) + EPS
        live = (r + 1 <= ql)[:, None]
        M = torch.where(live, Mrow / sc, M)
        I = torch.where(live, Irow / sc, I)
        D = torch.where(live, Drow / sc, D)
        logs = logs + torch.where(live[:, 0], torch.log(sc[:, 0]), 0.0)
        j = torch.where(live, jn, j)
        qprev = qc
    fin = torch.where(j == tl, M + I + D, 0.0).sum(1)
    return torch.log(fin + EPS) + logs


def phmm_lk(qs, shifts, inc, rc0, j0, qlen, tlen, trans, me, ie):
    """Forward log-likelihoods of a batch of pairs.

    qs, shifts, inc (B, Q) int32; rc0, j0 (B, W) int32; qlen, tlen (B,)
    int32; trans, me, ie (8, 8) f32 padded tables (:func:`tables8`).
    Any W >= 1 (the launch geometry of the K1 table kernels,
    :func:`~.phmm_tables.tables_geometry`).  Returns (B,) f32."""
    if rc0.device.type == "cpu":
        return phmm_lk_plain(qs, shifts, inc, rc0, j0, qlen, tlen, trans, me,
                             ie)
    B, W = rc0.shape
    Q = qs.shape[1]
    geometry = tables_geometry(W, "phmm_lk")
    f32, i32 = torch.float32, torch.int32
    for t, name, dt, shape in (
            (qs, "qs", i32, (B, Q)), (shifts, "shifts", i32, (B, Q)),
            (inc, "inc", i32, (B, Q)), (rc0, "rc0", i32, (B, W)),
            (j0, "j0", i32, (B, W)), (qlen, "qlen", i32, (B,)),
            (tlen, "tlen", i32, (B,)), (trans, "trans", f32, (8, 8)),
            (me, "me", f32, (8, 8)), (ie, "ie", f32, (8, 8))):
        check(t, dt, shape, f"phmm_lk {name}", device=rc0.device)
    out = torch.empty(B, dtype=f32, device=rc0.device)
    emis = torch.empty((B, 5, Q), dtype=f32, device=rc0.device)
    launch("phmm_lk", "phmm_lk_launch", qs, shifts, inc, rc0, j0, qlen, tlen,
           trans, me, ie, emis, out, B, Q, W, *geometry,
           scratch(B, W, f32, rc0.device))
    LAUNCHES.add((B, Q, W))
    return out
