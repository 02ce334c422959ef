"""A float64 pair-HMM oracle that imports no JAX, for the card tests.

The same functions as ``jtk_tpu.ops.oracle.phmm_forward`` and
``apply_edit`` (tests/test_torch_modtable_oracle.py holds them equal): an
unbanded global forward from M at (0, 0), in probability space with each
row rescaled by its sum, so it needs no log-sum-exp a cell.
"""

import math

import numpy as np


def phmm_forward(q, r, par, mode: str = "global"):
    """Unbanded pair-HMM forward log-likelihood of read ``q`` against
    template ``r`` (codes 0..3); ``par`` holds the nine transitions by
    name, ``mat_emit`` (4, 4) [ref, query] and ``ins_emit`` (5, 4)
    [previous query base or 4 = start, query]."""
    if mode != "global":
        raise ValueError(mode)
    Q, T = len(q), len(r)
    me = np.asarray(par["mat_emit"], np.float64).reshape(4, 4)
    ie = np.asarray(par["ins_emit"], np.float64).reshape(5, 4)
    tmm, tmi, tmd = par["mat_mat"], par["mat_ins"], par["mat_del"]
    tim, tii, tid = par["ins_mat"], par["ins_ins"], par["ins_del"]
    tdm, tdi, tdd = par["del_mat"], par["del_ins"], par["del_del"]
    M = [0.0] * (T + 1)
    I = [0.0] * (T + 1)
    D = [0.0] * (T + 1)
    M[0] = 1.0
    for j in range(1, T + 1):
        D[j] = tmd * M[j - 1] + tdd * D[j - 1]
    log_scale = 0.0
    for i in range(1, Q + 1):
        qi = int(q[i - 1])
        e_ins = ie[int(q[i - 2]) if i >= 2 else 4, qi]
        Mn = [0.0] * (T + 1)
        In = [0.0] * (T + 1)
        Dn = [0.0] * (T + 1)
        for j in range(T + 1):
            if j > 0:
                Mn[j] = me[int(r[j - 1]), qi] * (
                    tmm * M[j - 1] + tim * I[j - 1] + tdm * D[j - 1])
                Dn[j] = tmd * Mn[j - 1] + tid * In[j - 1] + tdd * Dn[j - 1]
            In[j] = e_ins * (tmi * M[j] + tii * I[j] + tdi * D[j])
        s = sum(Mn) + sum(In) + sum(Dn)
        M = [x / s for x in Mn]
        I = [x / s for x in In]
        D = [x / s for x in Dn]
        log_scale += math.log(s)
    return math.log(M[T] + I[T] + D[T]) + log_scale


def apply_edit(template, op: str, pos: int, base: int = 0):
    """A single template edit: 'S' substitute, 'I' insert-before, 'D'
    delete ``base`` chars (default 1), 'C' tandem-copy ``base`` chars."""
    t = list(template)
    if op == "S":
        t[pos] = base
    elif op == "I":
        t.insert(pos, base)
    elif op == "D":
        del t[pos:pos + max(base, 1)]
    elif op == "C":
        c = max(base, 1)
        t = t[:pos + c] + t[pos:pos + c] + t[pos + c:]
    return np.array(t, dtype=np.asarray(template).dtype)
