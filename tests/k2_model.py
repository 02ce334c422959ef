"""K2's column walk, modelled in plain PyTorch, and the inputs of its tests.

``csrc/modtable_assembly.cu`` gives each template column of a pair one
thread, which walks the band rows that cover the column in increasing row
order, carries the previous row's values of its column (and of the column
to its left) in registers, and keeps the 16 column sums in float64.
:func:`k2_model` runs the same recurrence for every column at once, row by
row, on the CPU: the kernel's arithmetic can be held to the plain assembly
(``modtable.modification_table_from_tables_plain``) without a card.

Imports only the port (no JAX): the card tests use it too.
"""

import numpy as np
import torch

from jtk_tpu_torch.io import sim
from jtk_tpu_torch.ops import modtable as pmod
from jtk_tpu_torch.ops import phmm as pphmm
from jtk_tpu_torch.ops.banded_align import linear_offsets
from jtk_tpu_torch.ops.phmm import EPS
from jtk_tpu_torch.ops.phmm_tables import prep_tables_inputs, tables_batch


def k2_model(q, offsets, q_len, t_len, trans, mat_emit, W, Tpad, lk,
             f_tabs, fcum, tpl, b_tabs, bcum):
    """The kernel's recurrence: ``modification_table_from_tables``'s
    arguments with the template codes ``tpl`` (B, T) in place of ``rcs``.
    Returns the (B, Tpad+1, NUM_EDIT) log table."""
    B, Q = q.shape
    dev = q.device
    f32, f64 = torch.float32, torch.float64
    fM, fI, fD = f_tabs
    bM, _bI, bD = b_tabs
    T = tpl.shape[1]
    NC = Tpad + 1 + pmod.COPY_SIZE
    jc = torch.arange(NC, device=dev)[None].expand(B, NC)
    ql = q_len.to(torch.int64)[:, None]
    tl = t_len.to(torch.int64)[:, None]
    tpl64 = tpl.to(torch.int64)

    def code_at(x):                      # the band's template code at x
        inb = (x >= 1) & (x <= T)
        return torch.where(inb, torch.gather(tpl64, 1, (x - 1).clamp(0, T - 1)),
                           4)

    pc = {d: code_at(jc + d) for d in range(-2, 4)}
    valid = jc <= torch.minimum(tl, torch.full_like(tl, Tpad))
    me5 = torch.zeros((B, 4, 5), dtype=f32, device=dev)
    me5[:, :, :4] = mat_emit
    t = {n: trans[:, a, b][:, None] for n, (a, b) in dict(
        mm=(0, 0), im=(1, 0), dm=(2, 0), md=(0, 2), id=(1, 2),
        dd=(2, 2)).items()}
    z = torch.zeros((B, NC), dtype=f32, device=dev)
    fl = [z, z, z]           # row i-1 at column jc-1
    fc = [z, z, z]           # row i-1 at column jc
    cM12 = cM13 = cMb2 = cMb1 = cD = z
    sums = {n: torch.zeros((B, NC), dtype=f64, device=dev) for n in
            ["s0", "s1", "s2", "s3", "sb", "d1", "d2", "d3", "i0", "i1",
             "i2", "i3", "ib", "c1", "c2", "c3"]}
    ninf = torch.full((B,), -np.inf, dtype=f32, device=dev)
    lkc = lk[:, None]
    for i in range(Q + 1):
        k = jc - offsets[:, i:i + 1].to(torch.int64)
        live = valid & (i <= ql)
        band = live & (k >= 0) & (k <= W)
        full = live & (k >= 0) & (k < W)

        def ld(tab, lane, ok):
            v = torch.gather(tab[:, i], 1, lane.clamp(0, W - 1))
            return torch.where(ok, v, 0.0)

        fl_n = [ld(x, k - 1, band & (k >= 1)) for x in (fM, fI, fD)]
        fc_n = [ld(x, k, full) for x in (fM, fI, fD)]
        bMd = [ld(bM, k + d, full & (k + d < W)) for d in range(4)]
        bDd = [ld(bD, k + d, full & (k + d < W)) for d in range(4)]
        if i >= 1:
            qp = q[:, i - 1].to(torch.int64)
            emq = [me5[torch.arange(B, device=dev), v, qp][:, None]
                   for v in range(4)]
        else:
            emq = [torch.zeros((B, 1), dtype=f32, device=dev)] * 4

        def em(d):
            code = torch.where((k + d >= 0) & (k + d < W), pc[d], 4)
            out = torch.zeros((B, NC), dtype=f32, device=dev)
            for v in range(4):
                out = torch.where(code == v, emq[v].expand(B, NC), out)
            return out

        def cs(u):
            fp = fcum[:, i - u] if i - u >= 0 else ninf
            return torch.exp(torch.clamp(fp[:, None] + bcum[:, i:i + 1] - lkc,
                                         -80.0, 80.0))

        cB, cA, cU2, cU3 = cs(0), cs(1), cs(2), cs(3)
        A = t["mm"] * fl[0] + t["im"] * fl[1] + t["dm"] * fl[2]
        An = t["mm"] * fc[0] + t["im"] * fc[1] + t["dm"] * fc[2]
        Dnew = t["md"] * fl_n[0] + t["id"] * fl_n[1] + t["dd"] * fl_n[2]
        Dn = t["md"] * fc_n[0] + t["id"] * fc_n[1] + t["dd"] * fc_n[2]
        AbM = A * bMd[0] * cA
        AnbM = An * bMd[0] * cA
        terms = {f"s{v}": emq[v] * AbM for v in range(4)}
        terms["sb"] = fc_n[2] * bDd[0] * cB
        for d in range(1, 4):
            terms[f"d{d}"] = em(d) * A * bMd[d] * cA + Dnew * bDd[d] * cB
        terms.update({f"i{v}": emq[v] * AnbM for v in range(4)})
        terms["ib"] = Dn * bDd[0] * cB
        M11 = em(0) * An
        terms["c1"] = M11 * bMd[0] * cA + Dn * bDd[0] * cB
        e2 = em(0)
        M12 = em(-1) * An
        terms["c2"] = (e2 * (t["mm"] * cM12) * bMd[0] * cU2
                       + e2 * (t["dm"] * cD) * bMd[0] * cA
                       + t["dd"] * Dn * bDd[0] * cB
                       + t["md"] * M12 * bDd[0] * cA)
        M13 = em(-2) * An
        e = em(-1)
        Mb2, Mb1 = e * (t["mm"] * cM13), e * (t["dm"] * cD)
        terms["c3"] = (e2 * (t["mm"] * cMb2) * bMd[0] * cU3
                       + e2 * (t["mm"] * cMb1 + t["dm"] * (t["md"] * cM13))
                       * bMd[0] * cU2
                       + e2 * (t["dm"] * (t["dd"] * cD)) * bMd[0] * cA
                       + t["dd"] * (t["dd"] * Dn) * bDd[0] * cB
                       + (t["md"] * Mb1 + t["dd"] * (t["md"] * M13))
                       * bDd[0] * cA
                       + t["md"] * Mb2 * bDd[0] * cU2)
        for n, x in terms.items():
            sums[n] += torch.where(full, x.to(f64), 0.0)
        fl = [torch.where(band, x, y) for x, y in zip(fl_n, fl)]
        fc = [torch.where(full, x, y) for x, y in zip(fc_n, fc)]
        cM12 = torch.where(full, M12, cM12)
        cM13 = torch.where(full, M13, cM13)
        cMb2 = torch.where(full, Mb2, cMb2)
        cMb1 = torch.where(full, Mb1, cMb1)
        cD = torch.where(full, Dn, cD)
    s = {n: v.to(f32) for n, v in sums.items()}
    T1 = Tpad + 1
    pos = torch.arange(T1, device=dev)[None]
    out = torch.empty((B, T1, pmod.NUM_EDIT), dtype=f32, device=dev)

    def put(col, vals, shift, live_rows):
        v = torch.log(torch.clamp(vals[:, shift:shift + T1], min=EPS)) + lkc
        out[:, :, col] = torch.where(live_rows, v, -1e30)

    for v in range(4):
        put(v, s[f"s{v}"] + s["sb"], 1, pos < tl)
        put(4 + v, s[f"i{v}"] + s["ib"], 0, pos <= tl)
    for c in range(1, 4):
        put(8 + c - 1, s[f"c{c}"], c, pos + c <= tl)
    bidx = torch.arange(B, device=dev)
    off_q = offsets[bidx, q_len.to(torch.int64)].to(torch.int64)
    for d in range(1, 4):
        put(11 + d - 1, s[f"d{d}"], 1, pos + d <= tl)
        kl = (t_len.to(torch.int64) - d - off_q).clamp(0, W - 1)
        qi = q_len.to(torch.int64)
        f_last = fM[bidx, qi, kl] + fI[bidx, qi, kl] + fD[bidx, qi, kl]
        last = torch.log(f_last + EPS) + fcum[bidx, qi]
        col = out[:, :, 11 + d - 1]
        out[:, :, 11 + d - 1] = torch.where(pos == tl - d, last[:, None], col)
    return out


def plain_error_bound(want, lk):
    """Per entry, nats: 1e-3 plus the plain assembly's own float64 error
    bound, 4 * 2^-52 * S / v for an entry of linear value v (over lk),
    where S is the pair's total of that edit over its live positions.  The
    plain version's column sums are differences of running row sums in
    float64, whose rounding grows with S; an entry far below S (a read
    whose lk is floored, a deep edit) can be off there by more than 1e-3,
    where K2's row-ordered sums, without differences, are not."""
    live = want > -1e29
    v = torch.exp((want - lk[:, None, None]).double()).where(live, 0.0)
    S = v.sum(1, keepdim=True)
    return 1e-3 + 4 * 2.0 ** -52 * S / v.clamp(min=1e-300)


def k2_case(seed, B, W, per_pair=True, T=300, ragged=True, device="cpu"):
    """B reads of ~5 % error and both strands, against one template or
    per-pair templates of different lengths; with ``ragged`` some reads end
    early or start late (a prefix or suffix of their template, still under
    the band's reach).  Returns (assembly args, template codes, Tpad) on
    ``device``: ``args`` are :func:`modtable.modification_table_from_tables`'s
    arguments but the last, the template codes."""
    rng = np.random.default_rng(seed)
    Tpad = T
    if per_pair:
        t_lens = np.array([T - int(rng.integers(0, 40)) for _ in range(B)])
        tpl = np.full((B, T), 4, np.int8)
        for b in range(B):
            tpl[b, :t_lens[b]] = sim.random_genome(rng, int(t_lens[b]))
    else:
        t_lens = np.full(B, T)
        tpl = sim.random_genome(rng, T)
    reads = []
    for b in range(B):
        t = tpl[b, :t_lens[b]] if per_pair else tpl
        lo, hi = 0, len(t)
        cut = min(W // 3, 60)
        if ragged and b % 4 == 1:
            hi -= int(rng.integers(1, cut))       # ends early
        elif ragged and b % 4 == 2:
            lo += int(rng.integers(1, cut))       # starts late
        reads.append(sim.noisy_read(rng, t[lo:hi], 0.05))
    q_lens = np.array([len(r) for r in reads], np.int64)
    Q = ((int(q_lens.max()) + 63) // 64) * 64
    qs = np.full((B, Q), 4, np.int8)
    for b, r in enumerate(reads):
        qs[b, :len(r)] = r
    offs = np.stack([linear_offsets(int(n), int(tl), Q, W)
                     for n, tl in zip(q_lens, t_lens)])
    strands = rng.random(B) < 0.5
    pf = pphmm.PHMMParams.default("cpu")
    pr = pphmm.params_from_numpy(*(x.numpy() * 0.9 + 0.1 / x.shape[1]
                                   for x in pf), "cpu")
    t_len = t_lens if per_pair else int(T)
    prep = prep_tables_inputs(qs, tpl, offs, q_lens, t_len,
                              pmod._host_params(pf), W, strands=strands,
                              params_rev=pmod._host_params(pr), device=device)
    lk, f_tabs, fcum, rcs, b_tabs, bcum, offs_t = tables_batch(prep, W)
    trans_b, me_b = pmod.strand_params(prep)
    args = (prep["qs"], offs_t, prep["q_lens"], prep["t_lens"], trans_b,
            me_b, W, Tpad, lk, f_tabs, fcum, rcs, b_tabs, bcum)
    return args, prep["r"], Tpad
