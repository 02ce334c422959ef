"""Plain pair-HMM forward log-likelihoods, and the template edits of the
modification table, for the correctness check.

The model is the one the configuration file states: three states M, I, D,
start in M at (0, 0), end in any state at (Q, T); M emits ``mat_emit[ref,
query]``, I emits ``ins_emit[previous query base or 4 at the start,
query]``, D emits nothing (``jtk_tpu``'s oracle, unbanded).  One query row
at a time over a batch in plain PyTorch, in probability space with each
row scaled by its largest cell: M and I come from the row above, the D
chain along the row is a linear recurrence solved by doubling.  Imports
nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

# the modification table's columns: 4 substitutions, 4 insertions,
# copies of 1..3 bases, deletions of 1..3 bases
NUM_EDIT, COPY1, DEL1 = 14, 8, 11
# copies of 2 and 3 bases are approximate in the closed form (it drops the
# insertion states between copied columns): not held to the forward
EXACT_EDITS = tuple(e for e in range(NUM_EDIT) if e not in (COPY1 + 1,
                                                             COPY1 + 2))


def apply_edit(template: np.ndarray, e: int, pos: int) -> np.ndarray:
    """Template with column ``e``'s edit at ``pos``."""
    t = np.asarray(template, np.int8)
    if e < 4:
        out = t.copy()
        out[pos] = e
        return out
    if e < 8:
        return np.concatenate([t[:pos], [e - 4], t[pos:]]).astype(np.int8)
    if e < DEL1:
        c = e - COPY1 + 1
        return np.concatenate([t[:pos + c], t[pos:pos + c], t[pos + c:]])
    d = e - DEL1 + 1
    return np.concatenate([t[:pos], t[pos + d:]])


def _params(hmm: dict, dtype, device):
    tr = torch.tensor([[hmm["mat_mat"], hmm["mat_ins"], hmm["mat_del"]],
                       [hmm["ins_mat"], hmm["ins_ins"], hmm["ins_del"]],
                       [hmm["del_mat"], hmm["del_ins"], hmm["del_del"]]],
                      dtype=torch.float64)
    me = torch.tensor(hmm["mat_emit"], dtype=torch.float64).reshape(4, 4)
    ie = torch.tensor(hmm["ins_emit"], dtype=torch.float64).reshape(5, 4)
    return (tr.to(device=device, dtype=dtype), me.to(device=device,
                                                     dtype=dtype),
            ie.to(device=device, dtype=dtype))


def forward_lk(queries, templates, strands, hmms, device,
               dtype=torch.float64):
    """Log-likelihood of each query given its template, under
    ``hmms[0]`` for a forward-strand pair and ``hmms[1]`` otherwise.
    Computed in ``dtype`` throughout (a lower type is the control).
    Returns numpy float64 (B,)."""
    B = len(queries)
    if B == 0:
        return np.zeros(0)
    Q = max(len(q) for q in queries)
    T = max(len(t) for t in templates)
    qa = np.full((B, Q), 0, np.int64)
    ta = np.full((B, T), 0, np.int64)
    for b, (q, t) in enumerate(zip(queries, templates)):
        qa[b, :len(q)] = q
        ta[b, :len(t)] = t
    qa = torch.as_tensor(qa, device=device)
    ta = torch.as_tensor(ta, device=device)
    ql = torch.as_tensor([len(q) for q in queries], device=device)
    tl = torch.as_tensor([len(t) for t in templates], device=device)
    st = torch.as_tensor(np.asarray(strands, bool), device=device)
    pf, pr = (_params(h, dtype, device) for h in hmms)
    sel = st[:, None, None]
    tr = torch.where(sel, pf[0][None], pr[0][None])          # (B, 3, 3)
    me = torch.where(sel, pf[1][None], pr[1][None])          # (B, 4, 4)
    ie = torch.where(sel, pf[2][None], pr[2][None])          # (B, 5, 4)
    # a template column past the pair's end takes no part
    live = torch.arange(T, device=device)[None] < tl[:, None]

    def t_(a, b):
        return tr[:, a, b][:, None]

    tdd = tr[:, 2, 2][:, None]
    steps = []
    s = 1
    while s < T + 1:
        steps.append(s)
        s *= 2

    def d_chain(c):
        """D[j] = c[j] + tDD * D[j - 1] over the row (D[0] = c[0])."""
        d = c
        pw = tdd
        for s in steps:
            d = d + pw * torch.nn.functional.pad(d, (s, 0))[:, :T + 1]
            pw = pw * pw
        return d

    zero = torch.zeros((B, T + 1), dtype=dtype, device=device)
    M = zero.clone()
    M[:, 0] = 1
    I = zero.clone()
    c0 = torch.nn.functional.pad(t_(0, 2) * M[:, :-1], (1, 0))
    D = d_chain(c0)
    logscale = torch.zeros(B, dtype=torch.float64, device=device)
    prev_q = torch.full((B,), 4, dtype=torch.int64, device=device)
    bidx = torch.arange(B, device=device)
    for i in range(1, Q + 1):
        qi = qa[:, i - 1]
        em = me[bidx[:, None], ta, qi[:, None]]               # (B, T)
        em = torch.where(live, em, torch.zeros((), dtype=dtype,
                                                device=device))
        ei = ie[bidx, prev_q, qi][:, None]
        Mn = torch.nn.functional.pad(em * (
            t_(0, 0) * M[:, :-1] + t_(1, 0) * I[:, :-1]
            + t_(2, 0) * D[:, :-1]), (1, 0))
        In = ei * (t_(0, 1) * M + t_(1, 1) * I + t_(2, 1) * D)
        c = torch.nn.functional.pad(t_(0, 2) * Mn[:, :-1]
                                    + t_(1, 2) * In[:, :-1], (1, 0))
        Dn = d_chain(c)
        scale = torch.maximum(torch.maximum(Mn.amax(1), In.amax(1)),
                              Dn.amax(1))
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        on = (i <= ql)
        inv = (1 / scale)[:, None]
        M = torch.where(on[:, None], Mn * inv, M)
        I = torch.where(on[:, None], In * inv, I)
        D = torch.where(on[:, None], Dn * inv, D)
        logscale = logscale + torch.where(
            on, torch.log(scale).to(torch.float64),
            torch.zeros((), dtype=torch.float64, device=device))
        # accumulate in the computing type, as a control in it would
        logscale = logscale.to(dtype).to(torch.float64)
        prev_q = torch.where(on, qi, prev_q)
    end = (M + I + D).gather(1, tl[:, None].long())[:, 0]
    return (torch.log(end.to(torch.float64)) + logscale).cpu().numpy()
