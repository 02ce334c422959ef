"""Local clustering — per-chunk phasing of read pileups (the algorithmic heart).

Reference: ``haplotyper/src/local_clustering/{mod.rs,pseudo_mcmc.rs}``
(SURVEY.md §2.3, §3.3).  Per chunk: polish the consensus with the pair-HMM
(K1/K2), derive per-read variant-gain profiles from the modification table,
filter variant columns (small-gain compression pseudo_mcmc.rs:141-165,
end-mask + homopolymer filter :425-505, binomial-tail p-values, strand-bias
chi^2 :314-339, greedy diversity pick :516-575), then cluster reads with the
device MCMC (ops/cluster.py) and pick k by the expected-gain acceptance rule
(:213-274).

Counterpart of ``jtk_tpu/stages/local_clustering.py`` (production engine):
polish and variant statistics ride the K1 table kernels; phase B batches the
MCMC across ALL chunks per candidate k as parallel lanes of one chain.
"""

from __future__ import annotations

import logging
import time

import numpy as np

from .. import seq as seqmod
from ..datamodel import DataSet, ReadType
from ..ops.banded_align import linear_offsets
from ..ops.cluster import POS_THR, mcmc_cluster_batch, poisson_size_table, used_columns_and_gains
from ..ops.modtable import NUM_EDIT
from ..ops.phmm import PHMMParams
from ..ops.polish import polish_until_converge
from .likelihood_gains import Gains, estimate_gains
from .util import homopolymer_length, logsumexp, update_coverage

logger = logging.getLogger(__name__)

MASK_LENGTH = 7
MAX_HOMOP_LENGTH = 2
EXPT_GAIN_FACTOR = 0.8
PVALUE = 0.05
ROUND = 3


def _difftype_of_edit(e: int) -> str:
    """pos_to_bp_and_difftype (pseudo_mcmc.rs:167-177): copies count as
    insertions."""
    from ..ops.modtable import COPY_SIZE
    if e < 4:
        return "sub"
    if e < 8 + COPY_SIZE:
        return "ins"
    return "del"


def gather_pileups(ds: DataSet):
    """chunk_id -> list of (read_pos_in_ds, node_idx)."""
    pileups: dict[int, list] = {c.id: [] for c in ds.selected_chunks}
    for ri, er in enumerate(ds.encoded_reads):
        for ni, n in enumerate(er.nodes):
            if n.chunk in pileups:
                pileups[n.chunk].append((ri, ni))
    return pileups


def _refresh_cigars(reads, template, W, max_batch=256):
    """Banded global alignment of each pileup read against the (polished)
    template; returns new cigars."""
    from ..ops.banded_align import align_with_cigar_batch
    from ..ops.polish import effective_band
    t_len = len(template)
    q_lens = np.array([len(r) for r in reads], np.int32)
    W = effective_band(W, q_lens, t_len)
    Qpad = ((int(q_lens.max()) + 63) // 64) * 64
    qs = np.full((len(reads), Qpad), 4, np.int8)
    for i, r in enumerate(reads):
        qs[i, :len(r)] = r
    tpl = np.asarray(template, np.int8)
    rs = np.tile(tpl, (len(reads), 1))
    offs = np.stack([linear_offsets(int(l), t_len, Qpad, W) for l in q_lens])
    cigars = []
    for s in range(0, len(reads), max_batch):
        e = min(len(reads), s + max_batch)
        res = align_with_cigar_batch(qs[s:e], rs[s:e], offs[s:e],
                                     q_lens[s:e], np.full(e - s, t_len,
                                                          np.int32),
                                     W, "global")
        cigars.extend(res["cigar"])
    return cigars


def _pileup_tables(reads, strands, template, params_f, params_r, W, Tpad):
    """Per-read modification tables with strand-specific HMMs.
    Returns (lks (R,), profiles (R, (Tpad+1)*NUM_EDIT))."""
    t_len = len(template)
    tpl = np.full(Tpad, 4, np.int8)
    tpl[:t_len] = template
    R = len(reads)
    Qpad = ((max(len(r) for r in reads) + 63) // 64) * 64
    qs = np.full((R, Qpad), 4, np.int8)
    for i, r in enumerate(reads):
        qs[i, :len(r)] = r
    q_lens = np.array([len(r) for r in reads], np.int32)
    from ..ops.polish import effective_band
    W = effective_band(W, q_lens, t_len)
    offs = np.stack([linear_offsets(int(l), t_len, Qpad, W) for l in q_lens])
    lks = np.zeros(R)
    profs = np.zeros((R, (Tpad + 1) * NUM_EDIT), np.float32)
    strands = np.asarray(strands, bool)
    from ..ops.modtable import modification_table_pileup_pallas
    lk, tab = modification_table_pileup_pallas(
        qs, tpl, offs, q_lens, np.int32(t_len), params_f, W, Tpad,
        strands=strands, params_rev=params_r)
    lks[:] = lk
    g = tab - lk[:, None, None]
    g = np.where(tab < -1e29, 0.0, g)
    profs[:] = g.reshape(R, -1)
    return lks, profs


def _expected_of_cols(template, cols, gains):
    """Homopolymer-conditioned expected gain per selected profile column."""
    homop = homopolymer_length(template)
    out = []
    for c in cols:
        bp = min(int(c) // NUM_EDIT, len(template) - 1)
        hp = int(homop[bp]) if len(homop) else 1
        out.append(gains.expected(hp, _difftype_of_edit(int(c) % NUM_EDIT)))
    return np.array(out)


def variant_exp_mat(template: np.ndarray, gains: Gains, Trows: int):
    """(Trows, NUM_EDIT) homopolymer-conditioned expected-gain matrix — the
    compression threshold grid (compress_small_gains, pseudo_mcmc.rs:141-165),
    shared by the host filter and the on-device stats reduction."""
    homop = homopolymer_length(template)
    hp = np.zeros(Trows, np.int32)
    hp[:len(template)] = homop
    hp_idx = np.clip(hp, 1, 3)
    exp_mat = np.zeros((Trows, NUM_EDIT), np.float32)
    for e in range(NUM_EDIT):
        dt = _difftype_of_edit(e)
        for L in (1, 2, 3):
            exp_mat[hp_idx == L, e] = gains.expected(L, dt)
    return exp_mat, hp, hp_idx


def _variant_candidates(template: np.ndarray, R: int, counts, tot_gain, obs,
                        both_strands: bool, gains: Gains, coverage: float,
                        copy_num: int, exp_mat, hp, hp_idx):
    """Candidate flat columns + scores from per-template VARIANT STATS:
    counts/tot_gain (Trows, NUM_EDIT) over compressed profiles, and obs
    (Trows, NUM_EDIT, 2, 2) strand/sign contingency tables.  Works from the
    on-device reduction or from host profiles — no per-read data needed."""
    t_len = len(template)
    Trows = counts.shape[0]
    from ..ops.modtable import COPY_SIZE, DEL_SIZE

    pos_mask = np.zeros((Trows, NUM_EDIT), bool)
    valid_j = np.arange(Trows)
    in_range = (valid_j >= MASK_LENGTH) & (valid_j <= t_len - MASK_LENGTH)
    pos_mask[:, :] = in_range[:, None]
    # homopolymer constraints for ins/del
    for d in range(DEL_SIZE):
        pos_mask[:, 8 + COPY_SIZE + d] &= hp <= MAX_HOMOP_LENGTH
    for b in range(4):
        jj = np.arange(Trows)
        prev_idx = np.clip(jj - 1, 0, t_len - 1)
        nxt_idx = np.clip(jj, 0, t_len - 1)
        tb = np.full(Trows, -1, np.int32)
        tb[:t_len] = template
        prev_run = np.where((jj >= 1) & (tb[prev_idx] == b), hp[prev_idx] + 1, 1)
        nxt_run = np.where(tb[nxt_idx] == b, hp[nxt_idx] + 1, 1)
        pos_mask[:, 4 + b] &= (prev_run <= MAX_HOMOP_LENGTH + 1) & \
                              (nxt_run <= MAX_HOMOP_LENGTH + 1)

    # binomial-tail p-values per (difftype, homopolymer length)
    pval_tab = {}
    for dt in ("sub", "del", "ins"):
        for L in (1, 2, 3):
            pval_tab[(dt, L)] = np.array(
                [gains.pvalue(dt, c, R, homop_len=L) for c in range(R + 1)])
    pvals = np.ones_like(tot_gain)
    for e in range(NUM_EDIT):
        dt = _difftype_of_edit(e)
        cc = np.clip(counts[:, e].astype(np.int64), 0, R)
        for L in (1, 2, 3):
            m = hp_idx == L
            pvals[m, e] = pval_tab[(dt, L)][cc[m]]
    exp_col = exp_mat * EXPT_GAIN_FACTOR
    keep = pos_mask & (counts * exp_col < tot_gain) & \
        (pvals < PVALUE / max(t_len, 1))

    # strand-bias chi^2 (pseudo_mcmc.rs:314-339), vectorized over columns
    if both_strands:
        nz_tot = obs.sum(axis=(-2, -1))                  # (Trows, NUM_EDIT)
        strand_count = obs.sum(-1)                       # (.., 2)
        sign_count = obs.sum(-2)
        with np.errstate(divide="ignore", invalid="ignore"):
            expd = strand_count[..., :, None] * sign_count[..., None, :] \
                / np.maximum(nz_tot, 1e-9)[..., None, None]
            chi = np.where(expd > 0, (obs - expd) ** 2 / expd, 0.0) \
                .sum(axis=(-2, -1))
        keep &= (nz_tot > 0) & (chi < 10.0)

    cand = np.nonzero(keep.reshape(-1))[0]
    if len(cand) == 0:
        return cand, np.zeros(0)
    # score candidates: max-Poisson count LK + total gain (filter_profiles)
    from .util import max_poisson_lk
    cflat = counts.reshape(-1)
    gflat = tot_gain.reshape(-1)
    scores = np.array([max_poisson_lk(int(cflat[ci]), coverage, 1,
                                      max(copy_num, 1)) + gflat[ci]
                       for ci in cand])
    ok = scores > 0
    return cand[ok], scores[ok]


def _diversity_pick(cand, scores, comp_cols, copy_num: int):
    """Greedy diversity pick over candidate columns; ``comp_cols`` is the
    (R, n_cand) compressed profile block at the candidates
    (pick_filtered_profiles :516-575).  Returns indices INTO cand."""
    sel_state = np.zeros(len(cand), np.int8)  # 0 open, 1 picked, 2 ban, 3 susp
    for _ in range(ROUND):
        sel_state[sel_state == 3] = 0
        for _ in range(max(copy_num, 2)):
            open_idx = np.nonzero(sel_state == 0)[0]
            if len(open_idx) == 0:
                break
            pick = open_idx[np.argmax(scores[open_idx])]
            sel_state[pick] = 1
            pj = cand[pick] // NUM_EDIT
            pcol = comp_cols[:, pick]
            for oi in np.nonzero((sel_state == 0) | (sel_state == 3))[0]:
                oj = cand[oi] // NUM_EDIT
                if abs(int(oj) - int(pj)) < MASK_LENGTH:
                    sel_state[oi] = 2
                    continue
                ocol = comp_cols[:, oi]
                nz = (np.abs(pcol) > POS_THR) & (np.abs(ocol) > POS_THR)
                if nz.sum() == 0:
                    continue
                a, b = pcol[nz], ocol[nz]
                cos = abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9)
                agree = (a * b > 0).mean()
                sok = max(agree, 1 - agree)
                if sok > 0.8 or cos > 0.8:
                    sel_state[oi] = 3
    return np.nonzero(sel_state == 1)[0]


def _host_variant_stats(prof_comp, strands):
    """counts/tot_gain/obs from host-resident compressed profiles (the scan
    engine path) — same quantities the device reduction produces."""
    pos = prof_comp > POS_THR
    counts = pos.sum(axis=0).astype(np.float64)
    tot_gain = np.where(pos, prof_comp, 0.0).sum(axis=0)
    nz = np.abs(prof_comp) > 1e-4
    sgn = prof_comp > 0
    obs = np.zeros(counts.shape + (2, 2))
    for s in (0, 1):
        srow = (strands.astype(int) == s)[:, None, None]
        for p in (0, 1):
            obs[..., s, p] = (nz & srow & (sgn == bool(p))).sum(axis=0)
    return counts, tot_gain, obs


def filter_variants(template: np.ndarray, profiles: np.ndarray,
                    strands: np.ndarray, gains: Gains, coverage: float,
                    copy_num: int):
    """Column filtering; returns selected column indices (into profiles)."""
    R = profiles.shape[0]
    prof = profiles.reshape(R, -1, NUM_EDIT)
    Trows = prof.shape[1]
    exp_mat, hp, hp_idx = variant_exp_mat(template, gains, Trows)
    prof = np.where(np.abs(prof) < 0.5 * exp_mat[None, :, :], 0.0, prof)
    counts, tot_gain, obs = _host_variant_stats(prof, strands)
    both = bool(strands.any() and (~strands).any())
    cand, scores = _variant_candidates(template, R, counts, tot_gain, obs,
                                       both, gains, coverage, copy_num,
                                       exp_mat, hp, hp_idx)
    if len(cand) == 0:
        return np.zeros(0, np.int64)
    picked = _diversity_pick(cand, scores, prof.reshape(R, -1)[:, cand],
                             copy_num)
    return cand[picked]


def _k_range(copy_num: int, n_variants: int):
    """pseudo_mcmc.rs:236-241."""
    end = min(copy_num, 1 + 2 * n_variants)
    start = max(end, 5) - 3
    return list(range(max(start, 2), end + 1))


def cluster_chunks_mcmc(features: dict, coverage: float, seed: int,
                        restarts: int = 20, flips_per_read: int = 2000,
                        max_steps: int = 100_000):
    """Phase B: batch the MCMC across chunks per k.

    features: chunk_id -> dict(X (R,V), copy_num, local_cov).
    Returns chunk_id -> (assign, posterior (R,k), score, k).
    """
    import torch

    from ..runtime import device
    dev = device()
    # k selection state per chunk
    state = {cid: dict(assign=np.zeros(f["X"].shape[0], np.int64),
                       max=0.0, max_k=1,
                       read_gain=np.zeros(f["X"].shape[0]),
                       used=np.zeros(f["X"].shape[1], bool),
                       alive=True)
             for cid, f in features.items()}
    kranges = {cid: _k_range(f["copy_num"], f["X"].shape[1])
               for cid, f in features.items()}
    max_k = max((kr[-1] for kr in kranges.values() if kr), default=1)
    for ki, k in enumerate(range(2, max_k + 1)):
        todo = [cid for cid, kr in kranges.items()
                if k in kr and state[cid]["alive"]]
        todo = [cid for cid in todo
                if features[cid]["X"].shape[0] > features[cid]["copy_num"]]
        if not todo:
            continue
        Rmax = max(features[cid]["X"].shape[0] for cid in todo)
        Vmax = max(features[cid]["X"].shape[1] for cid in todo)
        Rmax = ((Rmax + 7) // 8) * 8
        Vmax = max(((Vmax + 7) // 8) * 8, 8)
        B = len(todo)
        X = np.zeros((B, Rmax, Vmax), np.float32)
        Rs = np.zeros(B, np.int32)
        size_lk = np.zeros((B, Rmax + 1), np.float32)
        for b, cid in enumerate(todo):
            f = features[cid]
            r, v = f["X"].shape
            X[b, :r, :v] = f["X"]
            Rs[b] = r
            size_lk[b] = poisson_size_table(Rmax, coverage, k)
        steps = int(min(flips_per_read * Rmax, max_steps))
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 977 * k)
        assign, score = mcmc_cluster_batch(X, Rs, size_lk, k, steps,
                                           restarts, generator=gen,
                                           device=dev)
        for b, cid in enumerate(todo):
            f = features[cid]
            st = state[cid]
            r = f["X"].shape[0]
            asn = assign[b, :r].astype(np.int64)
            sc = float(score[b])
            if k == 2:
                # also try the single-best-column split (use_highest_gain)
                hg_asn, hg_sc = _use_highest_gain(f["X"])
                if hg_sc > sc:
                    asn, sc = hg_asn, hg_sc
            used, lk_gain = used_columns_and_gains(f["X"], asn, k)
            # expected-gain acceptance (pseudo_mcmc.rs:275-301)
            newly = used & ~st["used"]
            no_new = bool((used == st["used"]).all())
            exp_gain = 0.0
            if no_new:
                exp_gain = max((features[cid]["expected"][v]
                                for v in np.nonzero(used)[0]), default=0.0)
            elif newly.any():
                exp_gain = max(features[cid]["expected"][v]
                               for v in np.nonzero(newly)[0])
            thr = max(EXPT_GAIN_FACTOR * exp_gain, 0.1) * f["local_cov"] + 0.1
            if sc - st["max"] > thr:
                st.update(assign=asn, max=sc, max_k=k, used=used)
            else:
                st["alive"] = False
    results = {}
    for cid, st in state.items():
        f = features[cid]
        k = st["max_k"]
        _, lk_gain = used_columns_and_gains(f["X"], st["assign"], k)
        # post-tune: move reads to their argmax cluster (pseudo_mcmc.rs:98-104)
        asn = st["assign"].copy()
        am = lk_gain.argmax(1)
        better = lk_gain[np.arange(len(asn)), am] > \
            lk_gain[np.arange(len(asn)), asn] + 0.001
        asn[better] = am[better]
        post = lk_gain - logsumexp(lk_gain, axis=1)[:, None]
        results[cid] = (asn, post, st["max"], k)
    return results


UPPER_COPY_NUM = 8  # local_clustering/mod.rs:85
BRANCH_NUM = 4


def _estim_copy_num(asn, k, copy_num, coverage):
    """Distribute ``copy_num`` copies over k clusters by coverage residual
    (local_clustering/mod.rs:223-243)."""
    counts = np.bincount(asn, minlength=k).astype(float)
    cps = np.ones(k, np.int64)
    for _ in range(k, copy_num):
        resid = (counts - coverage * cps) ** 2
        cps[int(np.argmax(resid))] += 1
    return cps


def _phase_chunk(reads, strands, template, params_f, params_r, band, gains,
                 coverage, copy_num, local_cov, seed):
    """Profiles + variant filter + MCMC for one pileup against ``template``.
    Returns (asn, post, score, k)."""
    R = len(reads)
    if copy_num < 2 or R <= copy_num:
        return (np.zeros(R, np.int64), np.zeros((R, 1)), 0.0, 1)
    Tpad = ((len(template) + 127) // 128) * 128
    _lks, profs = _pileup_tables(reads, strands, template, params_f,
                                 params_r, band, Tpad)
    cols = filter_variants(template, profs, strands, gains, coverage,
                           copy_num)
    if len(cols) == 0:
        return (np.zeros(R, np.int64), np.zeros((R, 1)), 0.0, 1)
    X = profs[:, cols].astype(np.float32)
    expected = _expected_of_cols(template, cols, gains)
    feats = {0: dict(X=X, copy_num=copy_num, local_cov=local_cov,
                     expected=expected)}
    res = cluster_chunks_mcmc(feats, coverage, seed)
    return res[0]


def cluster_recursive(reads, strands, template, params_f, params_r, band,
                      gains, coverage, copy_num, local_cov, seed,
                      polish_cap: int = 60, depth: int = 0):
    """Recursive 4-way split for copy_num >= 8
    (clustering_recursive, local_clustering/mod.rs:126-190): cluster at
    branch factor 4, re-polish each sub-pileup's consensus, recurse with the
    residual copy numbers, and merge assignments/posteriors."""
    if copy_num < UPPER_COPY_NUM or depth > 4:
        return _phase_chunk(reads, strands, template, params_f, params_r,
                            band, gains, coverage, copy_num, local_cov, seed)
    asn, post, score, k = _phase_chunk(
        reads, strands, template, params_f, params_r, band, gains, coverage,
        BRANCH_NUM, local_cov, seed)
    if k <= 1:
        return asn, post, score, k
    copy_numbers = _estim_copy_num(asn, k, copy_num, coverage)
    rng = np.random.default_rng(seed + depth)
    subs = []
    for b in range(k):
        idx = np.nonzero(asn == b)[0]
        sub_reads = [reads[i] for i in idx]
        sub_strands = strands[idx]
        if len(sub_reads) >= 4:
            sel = rng.permutation(len(sub_reads))[:polish_cap]
            sub_tpl, _ = polish_until_converge(
                template, [sub_reads[i] for i in sel], params_f, W=band)
        else:
            sub_tpl = template
        subs.append(cluster_recursive(
            sub_reads, sub_strands, sub_tpl, params_f, params_r, band,
            gains, coverage, int(copy_numbers[b]),
            max(len(sub_reads) / max(copy_numbers[b], 1), 1.0),
            seed + 31 * (b + 1), polish_cap, depth + 1))
    cluster_nums = [s[3] for s in subs]
    offsets = np.concatenate([[0], np.cumsum(cluster_nums)])[:-1]
    total_k = int(sum(cluster_nums))
    total_score = float(score + sum(s[2] for s in subs))
    pointers = [0] * k
    merged_asn = np.zeros(len(reads), np.int64)
    merged_post = np.full((len(reads), total_k), -30.0)
    for i, (a, ps) in enumerate(zip(asn, post)):
        sub_asn, sub_post = subs[a][0], subs[a][1]
        j = pointers[a]
        pointers[a] += 1
        merged_asn[i] = offsets[a] + sub_asn[j]
        # spread top-level posterior over each branch's clusters, then
        # refine within the assigned branch (mod.rs:171-186)
        row = np.empty(total_k)
        for b in range(k):
            p_b = ps[b] if b < len(ps) else -30.0
            row[offsets[b]:offsets[b] + cluster_nums[b]] = \
                p_b - np.log(max(cluster_nums[b], 1))
        row[offsets[a]:offsets[a] + cluster_nums[a]] += \
            sub_post[j][:cluster_nums[a]] + np.log(max(cluster_nums[a], 1))
        row -= logsumexp(row)
        merged_post[i] = row
    return merged_asn, merged_post, total_score, total_k


def _use_highest_gain(X: np.ndarray):
    """pseudo_mcmc.rs:673-693: split on the single best column."""
    gains = np.where(X > 0, X, 0.0).sum(0)
    if gains.max() <= 0:
        return np.zeros(X.shape[0], np.int64), 0.0
    c = int(np.argmax(gains))
    asn = (X[:, c] > 0).astype(np.int64)
    _, lk_gain = used_columns_and_gains(X, asn, 2)
    sc = float(lk_gain[np.arange(len(asn)), asn].sum())
    return asn, sc


def _variant_features_device(per_chunk, params_f, params_r, band, Tpad,
                             gains, coverage, copy_nums):
    """From pileups to clustering features without fetching per-read
    modtables: per slice the variant stats reduce on the device; candidate
    selection runs on the host from the stats; only the candidate COLUMNS of
    the (still device-resident) tables are fetched.
    Returns {cid: (cols, X (R, n_cols))}.

    The resident tables are O(total_pairs * Tpad * NUM_EDIT) in device
    memory, so the chunk set is processed in pair-bounded groups — each
    group's gather completes (freeing its tables) before the next group's
    stats run."""
    from ..ops.modtable import modtable_pileup_stats_pallas
    from ..ops.banded_align import linear_offsets
    # ~1.5 GB of resident f32 tables per group
    group_pairs = max(1536, int(1.5e9) // ((int(Tpad) + 1) * NUM_EDIT * 4))
    total_pairs = sum(len(v[0]) for v in per_chunk.values())
    if total_pairs > group_pairs:
        out = {}
        group: dict = {}
        n = 0
        for cid, v in per_chunk.items():
            if n and n + len(v[0]) > group_pairs:
                out.update(_variant_features_device(
                    group, params_f, params_r, band, Tpad, gains, coverage,
                    copy_nums))
                group, n = {}, 0
            group[cid] = v
            n += len(v[0])
        if group:
            out.update(_variant_features_device(
                group, params_f, params_r, band, Tpad, gains, coverage,
                copy_nums))
        return out
    order = list(per_chunk)
    pair_cid, pair_reads, pair_strand, pair_tpl, seg_ids = [], [], [], [], []
    for pos_c, cid in enumerate(order):
        reads, strands, template = per_chunk[cid]
        for r, s in zip(reads, strands):
            pair_cid.append(cid)
            pair_reads.append(r)
            pair_strand.append(bool(s))
            pair_tpl.append(template)
            seg_ids.append(pos_c)
    if not pair_reads:
        return {}
    from ..ops.polish import band_buckets, pad_bucket
    q_lens = np.array([len(r) for r in pair_reads], np.int32)
    t_lens = np.array([len(t) for t in pair_tpl], np.int32)
    Bp = len(pair_reads)
    pair_strand = np.asarray(pair_strand, bool)
    seg_ids = np.asarray(seg_ids)
    exp_info = {cid: variant_exp_mat(per_chunk[cid][2], gains, Tpad + 1)
                for cid in order}
    exp_mats = np.stack([exp_info[cid][0] for cid in order])
    _t0 = time.time()
    buckets, _dropped = band_buckets(q_lens, t_lens, band)
    stats = None
    bucket_gathers = []  # (bidx, gather)
    for Wb, bidx in buckets:
        qlb, tlb = q_lens[bidx], t_lens[bidx]
        Qpad = pad_bucket(int(qlb.max()))
        nb = len(bidx)
        qs = np.full((nb, Qpad), 4, np.int8)
        tpl_mat = np.full((nb, Tpad), 4, np.int8)
        for p, b in enumerate(bidx):
            qs[p, :len(pair_reads[b])] = pair_reads[b]
            tpl_mat[p, :len(pair_tpl[b])] = pair_tpl[b]
        offs = np.stack([linear_offsets(int(ql), int(tl), Qpad, Wb)
                         for ql, tl in zip(qlb, tlb)])
        _lks, st, g = modtable_pileup_stats_pallas(
            qs, tpl_mat, offs, qlb, tlb, params_f, Wb, Tpad,
            pair_strand[bidx], params_r, seg_ids[bidx],
            len(order), exp_mats)
        stats = st if stats is None else stats + st
        bucket_gathers.append((bidx, g))

    def gather(cols):
        raw = np.zeros((Bp, len(cols)), np.float32)
        comp = np.zeros((Bp, len(cols)), np.float32)
        for bidx, g in bucket_gathers:
            r, c = g(cols)
            raw[bidx], comp[bidx] = r, c
        return raw, comp

    _t1 = time.time()
    cands = {}
    for pos_c, cid in enumerate(order):
        reads, strands, template = per_chunk[cid]
        st = stats[pos_c]
        counts, tot_gain = st[..., 0], st[..., 1]
        obs = st[..., 2:6].reshape(st.shape[0], NUM_EDIT, 2, 2)
        strands = np.asarray(strands, bool)
        both = bool(strands.any() and (~strands).any())
        exp_mat, hp, hp_idx = exp_info[cid]
        cand, scores = _variant_candidates(
            template, len(reads), counts, tot_gain, obs, both, gains,
            coverage, copy_nums[cid], exp_mat, hp, hp_idx)
        cands[cid] = (cand, scores)
    union = sorted({int(c) for cand, _s in cands.values() for c in cand})
    _t2 = time.time()
    out = {}
    if not union:
        return {cid: (np.zeros(0, np.int64), None) for cid in order}
    raw, comp = gather(np.array(union, np.int64))
    logger.info("variant features: stats %.1fs, candidates %.1fs, "
                "gather %.1fs (%d chunks, %d cols)",
                _t1 - _t0, _t2 - _t1, time.time() - _t2, len(order),
                len(union))
    colpos = {c: i for i, c in enumerate(union)}
    pair_cid = np.asarray(pair_cid)
    for cid in order:
        cand, scores = cands[cid]
        rows = np.nonzero(pair_cid == cid)[0]
        if len(cand) == 0:
            out[cid] = (np.zeros(0, np.int64), None)
            continue
        upos = np.array([colpos[int(c)] for c in cand])
        picked = _diversity_pick(cand, scores, comp[rows][:, upos],
                                 copy_nums[cid])
        cols = cand[picked]
        X = raw[rows][:, upos[picked]].astype(np.float32)
        out[cid] = (cols, X)
    return out


def _batched_refresh_cigars(per_chunk, band, max_batch=512):
    """Banded global alignments of every (read, its-chunk-template) pair in
    one sweep: {cid: [cigar]}.  All batches are dispatched before any is
    collected."""
    from ..ops.banded_align import (collect_align_cigar,
                                    dispatch_align_cigar, linear_offsets)
    pair_cid, pair_reads, pair_tpl = [], [], []
    for cid, (reads, _strands, template) in per_chunk.items():
        for r in reads:
            pair_cid.append(cid)
            pair_reads.append(r)
            pair_tpl.append(template)
    if not pair_reads:
        return {}
    from ..ops.polish import band_buckets, pad_bucket
    q_lens = np.array([len(r) for r in pair_reads], np.int32)
    t_lens = np.array([len(t) for t in pair_tpl], np.int32)
    buckets, dropped = band_buckets(q_lens, t_lens, band)
    cigars = [None] * len(pair_reads)  # dropped pairs keep their old cigar
    dispatched = []
    for Wb, bidx in buckets:
        Qpad = pad_bucket(int(q_lens[bidx].max()))
        Tmax = ((int(t_lens[bidx].max()) + 63) // 64) * 64
        for s in range(0, len(bidx), max_batch):
            grp = bidx[s:s + max_batch]
            B = len(grp)
            qs = np.full((B, Qpad), 4, np.int8)
            rs = np.full((B, Tmax), 4, np.int8)
            offs = np.zeros((B, Qpad + 1), np.int32)
            for b, gi in enumerate(grp):
                qs[b, :q_lens[gi]] = pair_reads[gi]
                rs[b, :t_lens[gi]] = pair_tpl[gi]
                offs[b] = linear_offsets(int(q_lens[gi]), int(t_lens[gi]),
                                         Qpad, Wb)
            dispatched.append((grp, dispatch_align_cigar(
                qs, rs, offs, q_lens[grp], t_lens[grp], Wb, "global")))
    for grp, d in dispatched:
        for gi, cg in zip(grp, collect_align_cigar(d)["cigar"]):
            cigars[gi] = cg
    out = {}
    pair_cid = np.asarray(pair_cid)
    pos = 0
    for cid, (reads, _s, _t) in per_chunk.items():
        out[cid] = cigars[pos:pos + len(reads)]
        pos += len(reads)
    return out


def local_clustering(ds: DataSet, seed: int = 42, W: int | None = None,
                     polish_cap: int = 60, restarts: int = 20,
                     flips_per_read: int = 2000,
                     selection: set | None = None) -> DataSet:
    """Per-chunk phasing with CROSS-CHUNK device batching: one polish round,
    one cigar-refresh sweep and one profile pass per strand cover every
    chunk's pileup simultaneously (the reference's rayon-per-chunk loop,
    local_clustering/mod.rs:56-121, recast as flat device batches)."""
    from ..ops.polish import polish_many
    coverage = update_coverage(ds)
    params_f = PHMMParams.from_hmmparam(ds.model_param.forward)
    params_r = PHMMParams.from_hmmparam(ds.model_param.reverse)
    gains = estimate_gains(params_f, ds.error_rate, seed=seed)
    pileups = gather_pileups(ds)
    chunks = {c.id: c for c in ds.selected_chunks}
    features = {}
    rng = np.random.default_rng(seed)
    # gather all pileups up front
    work = {}
    for cid, members in pileups.items():
        if selection is not None and cid not in selection:
            continue
        chunk = chunks[cid]
        if not members:
            chunk.cluster_num = 1
            continue
        reads = [seqmod.encode(ds.encoded_reads[ri].nodes[ni].seq)
                 for ri, ni in members]
        strands = np.array([ds.encoded_reads[ri].nodes[ni].is_forward
                            for ri, ni in members])
        work[cid] = (members, reads, strands)
    if not work:
        ds.push_stage("LocalClustering", [f"seed={seed}"])
        return ds
    band = W or max(max(ReadType.band_width(ds.read_type,
                                            len(chunks[cid].seq))
                        for cid in work), 64)
    band = ((band + 127) // 128) * 128
    # 1. batched polish of every chunk consensus (coverage-capped)
    t0 = time.time()
    order = sorted(work)
    polish_sets = []
    strand_sets = []
    for cid in order:
        _m, reads, strands = work[cid]
        sel = rng.permutation(len(reads))[:polish_cap]
        polish_sets.append([reads[i] for i in sel])
        strand_sets.append(strands[sel])
    tpls, _ = polish_many([chunks[cid].codes() for cid in order],
                          polish_sets, params_f, W=band,
                          strands=strand_sets, params_rev=params_r)
    templates = {}
    for cid, tpl in zip(order, tpls):
        chunks[cid].seq = seqmod.decode(np.asarray(tpl, np.int8)).decode()
        templates[cid] = np.asarray(tpl, np.int8)
    t_polish = time.time() - t0
    logger.info("local_clustering: polish %.1fs (%d chunks)", t_polish,
                len(order))
    t0b = time.time()
    # 2. batched cigar refresh so node CIGARs (and every downstream error
    # model) stay in sync (reference: update_by_clusterings, mod.rs:244)
    per_chunk = {cid: (work[cid][1], work[cid][2], templates[cid])
                 for cid in order}
    refreshed = _batched_refresh_cigars(per_chunk, band)
    logger.info("local_clustering: cigar refresh %.1fs", time.time() - t0b)
    for cid in order:
        for (ri, ni), cg in zip(work[cid][0], refreshed[cid]):
            if cg is not None:
                ds.encoded_reads[ri].nodes[ni].cigar = cg
    # high-copy repeats take the recursive path (rare; per-chunk calls)
    recursive_cids = [cid for cid in order
                      if chunks[cid].copy_num >= UPPER_COPY_NUM
                      and len(work[cid][1]) > chunks[cid].copy_num]
    for cid in recursive_cids:
        members, reads, strands = work[cid]
        chunk = chunks[cid]
        asn, post, score, k = cluster_recursive(
            reads, strands, templates[cid], params_f, params_r, band, gains,
            coverage, chunk.copy_num,
            len(reads) / max(chunk.copy_num, 1), seed + cid,
            polish_cap=polish_cap)
        chunk.cluster_num = int(max(k, 1))
        chunk.score = float(score)
        for (ri, ni), a, p in zip(members, asn, post):
            node = ds.encoded_reads[ri].nodes[ni]
            node.cluster = int(a)
            node.posterior = [float(x) for x in p]
        del per_chunk[cid]
    # 3. per-read profiles -> variant columns for every remaining chunk:
    # stats reduce on the device and only candidate columns are fetched
    Tpad = ((max((len(t) for t in templates.values()), default=1) + 127)
            // 128) * 128
    t0c = time.time()
    colx = _variant_features_device(
        per_chunk, params_f, params_r, band, Tpad, gains, coverage,
        {cid: chunks[cid].copy_num for cid in per_chunk})
    for cid in order:
        if cid not in per_chunk:
            continue
        chunk = chunks[cid]
        members, reads, strands = work[cid]
        template = templates[cid]
        # 4. variant columns
        cols, X = colx[cid]
        if chunk.copy_num < 2 or len(cols) == 0 or \
                len(reads) <= chunk.copy_num:
            chunk.cluster_num = 1
            chunk.score = 0.0
            for (ri, ni) in members:
                node = ds.encoded_reads[ri].nodes[ni]
                node.cluster = 0
                node.posterior = [0.0]
            continue
        expected_per_col = _expected_of_cols(template, cols, gains)
        features[cid] = dict(X=X, copy_num=chunk.copy_num,
                             local_cov=len(reads) / max(chunk.copy_num, 1),
                             expected=expected_per_col, members=members)
        logger.debug("RECORD\t%d\t%.0f\t%.0f\t%d\t%d\t%d", cid,
                     (time.time() - t0) * 1e3, t_polish * 1e3,
                     len(template), len(cols), len(reads))
    logger.info("local_clustering: profiles+variants %.1fs",
                time.time() - t0c)
    t0d = time.time()
    results = cluster_chunks_mcmc(features, coverage, seed,
                                  restarts=restarts,
                                  flips_per_read=flips_per_read)
    for cid, (asn, post, score, k) in results.items():
        chunk = chunks[cid]
        chunk.cluster_num = int(max(k, 1))
        chunk.score = float(score)
        for (ri, ni), a, p in zip(features[cid]["members"], asn, post):
            node = ds.encoded_reads[ri].nodes[ni]
            node.cluster = int(a)
            node.posterior = [float(x) for x in p]
    logger.info("local_clustering: mcmc %.1fs", time.time() - t0d)
    ds.push_stage("LocalClustering", [f"seed={seed}"])
    return ds
