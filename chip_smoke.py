#!/usr/bin/env python3
"""Smoke run of jtk_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels of ``jtk_tpu_torch/csrc`` (one nvcc per source,
   started together);
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (the K1 tables at polish's B 192 / W 128 and W 512
   and model tuning's B 40 / W 128 and W 256), and times both with CUDA
   events, each beside its bound: K3 bit-exact
   (stream, last row, decoded CIGARs); the K1 tables within rtol 2e-3 /
   atol 1e-5 (tables) and rtol 1e-4 / atol 2e-2 (cumulative log scales);
   K1l's lk within rtol 1e-4 / atol 2e-2 of its plain version and of K1f's
   lk; the counts kernel within rtol 1e-3 / atol 1e-4; the
   PairHMMLikelihood gradient within rtol 1e-3 / atol 1e-4 (per bp) of
   torch.autograd through the plain forward;
4. path (a): the stage-by-stage slice reads -> GFA (entry, mask_repeats,
   select_chunks, pick_top_n_component, estimate/purge multiplicity,
   local_clustering, assemble with contig polishing) on a simulated 60 kb
   diploid region at 60x ONT-like coverage with the pipeline's defaults;
5. path (b), the main path: ``jtk pipeline -p profile.toml`` through the
   port's CLI on a fresh 60 kb / 60x region (region_size 60k, chunk 2000,
   margin 500, seed 42), then a resume rerun from its checkpoints;
6. counts every kernel's launches on each path (set to 0 just before it,
   read just after; path (a) by stage, path (b) by launch shape (B, Q, W),
   the five most frequent of each kernel), checks the truth bars of
   tests/test_e2e.py on both
   (mean ARI > 0.6, mean contig error < 0.05, total length > 2/3 of the
   region for (a) and of both haplotypes for (b)), the five checkpoints and
   the resumed GFA;
7. prints the kernels line, the card line, then {"ok": true, "device": ...}
   as the last line.  Any failure exits non-zero without the last line.

``--kernels-only`` stops after step 3 (a quick build-and-check run).  The
script runs the ``jtk_tpu_torch`` beside it, so a copy of it placed in an
unpacked ``git archive`` of an earlier commit checks and times that
commit's kernels at the same shapes: a kernel redesign is timed against
its parent in one call.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REGION = 60_000          # the only cut: production chunk/band/coverage
COVERAGE = 60
SEED = 42
HBM_BYTES_PER_S = 3.35e12     # H100 SXM memory rate
FP32_OPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
OUT_DIR = os.path.join(HERE, "chiprun_out", "chip_smoke")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_time(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# kernel checks at the main path's shapes
# ---------------------------------------------------------------------------


def check_k3(rng, dev):
    """K3 at B = 2048 candidates, Q = 2048 chunk rows, W = 256 (the
    mapper's production shapes), infix mode as in encode."""
    import numpy as np
    import torch

    from jtk_tpu_torch.io import sim
    from jtk_tpu_torch.ops import edit_dp as k3
    from jtk_tpu_torch.ops.banded_align import decode_indexed

    B, Q, W, margin = 2048, 2048, 256, 500
    clen = 2000
    Tpad = ((clen + 2 * margin + 64 + 511) // 512) * 512
    chunks = [sim.random_genome(rng, clen) for _ in range(64)]
    blob = np.full((len(chunks), Q), 4, np.int8)
    for i, c in enumerate(chunks):
        blob[i, :clen] = c
    cand = rng.integers(0, len(chunks), B)
    rs = np.zeros((B, Tpad), np.int8)
    t_lens = np.zeros(B, np.int64)
    for b in range(B):
        read = sim.noisy_read(rng, chunks[cand[b]], 0.05)
        win = np.concatenate([sim.random_genome(rng, margin), read,
                              sim.random_genome(rng, margin)])[:Tpad]
        rs[b, :len(win)] = win
        t_lens[b] = len(win)
    ws = np.zeros(B, np.int64)
    astart = np.zeros(B, np.int64)
    q = torch.as_tensor(blob[cand], dtype=torch.int32, device=dev)
    q_lens = torch.full((B,), clen, dtype=torch.int64, device=dev)
    tl = torch.as_tensor(t_lens, device=dev)
    r = torch.as_tensor(rs, dtype=torch.int32, device=dev)
    diag0 = torch.as_tensor(ws + margin - astart, device=dev)
    ii = torch.arange(Q + 1, device=dev)
    hi = (tl - W + 1).clamp(min=0)
    off = torch.minimum((diag0[:, None] + ii[None] - W // 2).clamp(min=0),
                        hi[:, None])
    off_q = torch.minimum((diag0 + q_lens - W // 2).clamp(min=0), hi)
    off = torch.where(ii[None] <= q_lens[:, None], off, off_q[:, None])
    args = k3.k3_inputs(q, r, off, tl, W, "infix")
    ql32 = q_lens.to(torch.int32)
    tl32 = tl.to(torch.int32)
    kargs = args + (ql32, tl32)
    torch.cuda.synchronize()
    packed_k, last_k = k3.edit_dp(*kargs)
    torch.cuda.synchronize()
    packed_p, last_p = k3.edit_dp_plain(*kargs)
    torch.cuda.synchronize()
    if not torch.equal(packed_k, packed_p) or not torch.equal(last_k, last_p):
        raise AssertionError("K3: kernel stream/last row differ from plain")

    def decode(packed, last):
        score, end = k3.select_end(last, off, q_lens, tl, W, "infix")
        dels, ops, start = k3.traceback_packed(packed, off, q_lens, end, W)
        valid = tl >= q_lens // 2
        meta = k3.to_host(*k3.pack_results(
            score, end, start, dels, ops, valid,
            torch.as_tensor(astart, device=dev)))
        return decode_indexed(*meta, [clen] * B)

    dk, dp = decode(packed_k, last_k), decode(packed_p, last_p)
    if dk != dp:
        raise AssertionError("K3: decoded CIGARs differ")
    n_valid = sum(1 for d in dk if d[4])
    max_err = float((last_k - last_p).abs().max())
    ms = cuda_time(lambda: k3.edit_dp(*kargs), reps=5)
    plain_ms = cuda_time(lambda: k3.edit_dp_plain(*kargs), reps=1, warmup=0)
    moved = nbytes(*kargs) + nbytes(packed_k, last_k)
    ops = 20.0 * B * Q * W   # ~20 integer ops per DP cell
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    log(f"K3 edit_dp B={B} Q={Q} W={W}: bit-exact stream+last+cigars "
        f"({n_valid} valid alignments), kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, bound {max(t_bytes, t_ops):.3f} ms")
    return dict(name="edit_dp (K3)", route="cuda",
                source="jtk_tpu_torch/csrc/edit_dp.cu",
                replaces="jtk_tpu/ops/pallas_k3.py:33", max_abs_err=max_err,
                ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


TABLE_SHAPES = (("polish", 192, 128), ("polish_W512", 192, 512),
                ("model_tune", 40, 128), ("model_tune_W256", 40, 256))


def check_tables(rng, dev):
    """K1 forward/backward at Q = 2048 read rows against ~2 kb templates:
    B = 192 pairs at W = 128 (ONT band 0.03 * 2000 rounded up) and 512
    (polish), and model tuning's B = 40 at W = 128 and 256 (a pileup whose
    shortest read widens the band, ``effective_band``)."""
    import numpy as np
    import torch

    from jtk_tpu_torch.io import sim
    from jtk_tpu_torch.ops import phmm_tables as pt
    from jtk_tpu_torch.ops.banded_align import linear_offsets
    from jtk_tpu_torch.ops.phmm import PHMMParams

    Q = 2048
    params_f = PHMMParams.default(dev)
    # reverse-strand set: a perturbed copy, so the strand select matters
    params_r = PHMMParams(params_f.trans * 0.98 + 0.0066,
                          params_f.mat_emit, params_f.ins_emit)
    out = {"fwd": [], "bwd": []}
    for label, B, W in TABLE_SHAPES:
        tpl = np.full((B, Q + 64), 4, np.int8)
        qs = np.full((B, Q), 4, np.int8)
        q_lens = np.zeros(B, np.int64)
        t_lens = np.zeros(B, np.int64)
        offs = np.zeros((B, Q + 1), np.int64)
        for b in range(B):
            t = sim.random_genome(rng, 2000 - int(rng.integers(0, 40)))
            read = sim.noisy_read(rng, t, 0.05)[:Q]
            tpl[b, :len(t)] = t
            qs[b, :len(read)] = read
            q_lens[b], t_lens[b] = len(read), len(t)
            offs[b] = linear_offsets(len(read), len(t), Q, W)
        strands = rng.random(B) < 0.5
        prep = pt.prep_tables_inputs(qs, tpl, offs, q_lens, t_lens, params_f,
                                     W, strands=strands, params_rev=params_r,
                                     device=dev)
        fwd_args, bwd_args, _aux = pt.kernel_inputs(prep, W)
        for kind, args, kern, plain in (
                ("fwd", fwd_args, pt.fwd_tables, pt.fwd_tables_plain),
                ("bwd", bwd_args, pt.bwd_tables, pt.bwd_tables_plain)):
            torch.cuda.synchronize()
            got = kern(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err = 0.0
            for g, w in zip(got[:3], want[:3]):
                if not torch.allclose(g, w, rtol=2e-3, atol=1e-5):
                    raise AssertionError(f"K1 {kind} {label}: tables differ "
                                         f"(max {float((g - w).abs().max())})")
                err = max(err, float((g - w).abs().max()))
            cg, cw = torch.cumsum(got[3], 1), torch.cumsum(want[3], 1)
            if not torch.allclose(cg, cw, rtol=1e-4, atol=2e-2):
                raise AssertionError(f"K1 {kind} {label}: log scales differ "
                                     f"(max {float((cg - cw).abs().max())})")
            err = max(err, float((cg - cw).abs().max()))
            ms = cuda_time(lambda: kern(*args), reps=5)
            plain_ms = cuda_time(lambda: plain(*args), reps=1, warmup=0)
            moved = nbytes(*args) + nbytes(*got)
            flops = 40.0 * B * Q * W
            t_bytes = moved / HBM_BYTES_PER_S * 1e3
            t_ops = flops / FP32_OPS_PER_S * 1e3
            log(f"K1 {kind}_tables {label} B={B} Q={Q} W={W}: max abs err "
                f"{err:.3g}, kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
                f"bound {max(t_bytes, t_ops):.3f} ms")
            out[kind].append(dict(label=label, B=B, Q=Q, W=W, err=err, ms=ms,
                                  plain_ms=plain_ms,
                                  bound_ms=max(t_bytes, t_ops),
                                  bound_by="bytes" if t_bytes >= t_ops
                                  else "operations"))
            del got, want
            torch.cuda.empty_cache()
    rows = []
    for kind, line in (("fwd", 197), ("bwd", 337)):
        first, *others = out[kind]
        row = dict(
            name=f"{kind}_tables (K1{kind[0]})", route="cuda",
            source="jtk_tpu_torch/csrc/phmm_tables.cu",
            replaces=f"jtk_tpu/ops/pallas_phmm.py:{line}",
            max_abs_err=max(o["err"] for o in out[kind]), ms=first["ms"],
            plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
            bound_by=first["bound_by"], library_ms=None,
            shape=dict(B=first["B"], Q=Q, W=first["W"]))
        for o in others:
            row[f"at_{o['label']}"] = {k: o[k] for k in (
                "B", "Q", "W", "ms", "plain_ms", "bound_ms")}
        rows.append(row)
    return rows


def _pileup_pairs(rng, B, tlen, Qmult, W, err=0.05, jitter=40):
    """B noisy reads against one random template (the model-tune and
    gain-calibration layout): qs (B, Q) padded to ``Qmult``, offsets,
    lengths and the effective band."""
    import numpy as np

    from jtk_tpu_torch.io import sim
    from jtk_tpu_torch.ops.banded_align import linear_offsets
    from jtk_tpu_torch.ops.polish import effective_band

    tpl = sim.random_genome(rng, tlen)
    reads = [sim.noisy_read(rng, tpl, err)[:tlen + jitter] for _ in range(B)]
    q_lens = np.array([len(r) for r in reads], np.int64)
    W = effective_band(W, q_lens, tlen)
    Q = ((int(q_lens.max()) + Qmult - 1) // Qmult) * Qmult
    qs = np.full((B, Q), 4, np.int8)
    for b, r in enumerate(reads):
        qs[b, :len(r)] = r
    offs = np.stack([linear_offsets(int(n), tlen, Q, W) for n in q_lens])
    return tpl, qs, offs, q_lens, W


def check_lk(rng, dev):
    """K1l at model tune's shape (B = 40 reads of one strand against a
    ~2 kb chunk, Q = longest read rounded up to 64, W = 128) and at the
    gain calibration's (B = 256 pairs of 100 bp, Q rounded up to 32,
    W = 64), against its plain version and against K1f's lk."""
    import numpy as np
    import torch

    from jtk_tpu_torch.ops import phmm_lk as k1l
    from jtk_tpu_torch.ops import phmm_tables as pt
    from jtk_tpu_torch.ops.phmm import PHMMParams

    params = PHMMParams.default(dev)
    tabs = k1l.tables8(params, dev)
    res = []
    for label, B, tlen, Qmult, W0 in (("model_tune", 40, 2000, 64, 128),
                                      ("gain_calibration", 256, 100, 32, 64)):
        tpl, qs, offs, q_lens, W = _pileup_pairs(rng, B, tlen, Qmult, W0)
        tlen, B = len(tpl), len(qs)
        args = k1l.lk_inputs(qs, tpl, offs, q_lens, tlen, W, device=dev)
        torch.cuda.synchronize()
        got = k1l.phmm_lk(*args, *tabs)
        want = k1l.phmm_lk_plain(*args, *tabs)
        prep = pt.prep_tables_inputs(qs, tpl, offs, q_lens, tlen, params, W,
                                     device=dev)
        lk_f = pt.tables_batch(prep, W, backward=False)[0]
        torch.cuda.synchronize()
        for other, what in ((want, "plain"), (lk_f, "K1f's lk")):
            if not torch.allclose(got, other, rtol=1e-4, atol=2e-2):
                raise AssertionError(
                    f"K1l {label}: lk differs from {what} (max "
                    f"{float((got - other).abs().max())})")
        err = float((got - want).abs().max())
        err_f = float((got - lk_f).abs().max())
        ms = cuda_time(lambda: k1l.phmm_lk(*args, *tabs), reps=5)
        plain_ms = cuda_time(lambda: k1l.phmm_lk_plain(*args, *tabs),
                             reps=1, warmup=0)
        moved = nbytes(*args, *tabs) + got.numel() * 4
        # the loop stops at each pair's q_len: count the rows this data needs
        flops = 40.0 * W * float(q_lens.sum())
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_OPS_PER_S * 1e3
        Q = qs.shape[1]
        log(f"K1l phmm_lk {label} B={B} Q={Q} W={W}: max abs err {err:.3g} "
            f"(vs K1f lk {err_f:.3g}), kernel {ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms, bound {max(t_bytes, t_ops):.4f} ms")
        res.append(dict(label=label, B=B, Q=Q, W=W, err=max(err, err_f),
                        ms=ms, plain_ms=plain_ms,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops
                        else "operations"))
    r0, r1 = res
    return dict(name="phmm_lk (K1l)", route="cuda",
                source="jtk_tpu_torch/csrc/phmm_lk.cu",
                replaces="jtk_tpu/ops/pallas_phmm.py:55",
                max_abs_err=max(r0["err"], r1["err"]), ms=r0["ms"],
                plain_ms=r0["plain_ms"], bound_ms=r0["bound_ms"],
                bound_by=r0["bound_by"], library_ms=None,
                shape=dict(B=r0["B"], Q=r0["Q"], W=r0["W"]),
                at_gain_calibration={k: r1[k] for k in (
                    "B", "Q", "W", "ms", "plain_ms", "bound_ms")})


def check_counts(rng, dev):
    """The counts kernel at model tune's shape (B = 40, Q ~ 2.1 k, W = 128)
    against its plain version (rtol 1e-3 / atol 1e-4), and the whole
    PairHMMLikelihood gradient against torch.autograd through the plain
    forward at B = 8, Q = 256."""
    import numpy as np
    import torch

    from jtk_tpu_torch.ops import phmm_grad as pg
    from jtk_tpu_torch.ops import phmm_lk as k1l
    from jtk_tpu_torch.ops.phmm import PHMMParams
    from jtk_tpu_torch.parallel import params_to_theta, theta_to_params

    params = PHMMParams.default(dev)
    tpl, qs, offs, q_lens, W = _pileup_pairs(rng, 40, 2000, 64, 128)
    batch = pg.PairBatch(qs, tpl, offs, q_lens, len(tpl), W, device=dev)
    args = pg.counts_args(pg.counts_prep(params, batch), W)
    torch.cuda.synchronize()
    got = pg.phmm_counts(*args)
    want = pg.phmm_counts_plain(*args)
    torch.cuda.synchronize()
    if not torch.allclose(got, want, rtol=1e-3, atol=1e-4):
        raise AssertionError(f"counts: kernel differs from plain (max "
                             f"{float((got - want).abs().max())})")
    # each query base is emitted by exactly one M or I state
    emitted = got[:, 9:].sum(1)
    if not torch.allclose(emitted, batch.q_lens.to(torch.float32),
                          rtol=1e-3):
        raise AssertionError("counts: M + I emissions do not sum to q_len")
    err = float((got - want).abs().max())
    ms = cuda_time(lambda: pg.phmm_counts(*args), reps=5)
    plain_ms = cuda_time(lambda: pg.phmm_counts_plain(*args), reps=1,
                         warmup=0)
    moved = nbytes(*args) + got.numel() * 4
    flops = 60.0 * W * float((q_lens + 1).sum())
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_OPS_PER_S * 1e3
    Qc = qs.shape[1]
    log(f"counts B=40 Q={Qc} W={W}: max abs err {err:.3g}, kernel "
        f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
        f"{max(t_bytes, t_ops):.3f} ms")
    del args, got, want, batch
    torch.cuda.empty_cache()

    # the gradient: counts kernel path vs autograd through the plain forward
    tpl, qs, offs, q_lens, Wg = _pileup_pairs(rng, 8, 240, 256, 64,
                                              jitter=16)
    batch = pg.PairBatch(qs, tpl, offs, q_lens, len(tpl), Wg, device=dev)
    theta = params_to_theta(params)
    grads = []
    for use_kernel in (True, False):
        th = {k: v.clone().requires_grad_(True) for k, v in theta.items()}
        p = theta_to_params(th)
        if use_kernel:
            lk = pg.pair_likelihood(p, batch)
        else:
            lk = k1l.phmm_lk_plain(*batch.lk_args, *k1l.tables8(p, dev))
        (-lk.sum()).backward()
        grads.append([th[k].grad / float(q_lens.sum()) for k in th])
    g_err = 0.0
    for a, b in zip(*grads):
        if not torch.allclose(a, b, rtol=1e-3, atol=1e-4):
            raise AssertionError(f"gradient: counts path differs from "
                                 f"autograd (max {float((a - b).abs().max())})")
        g_err = max(g_err, float((a - b).abs().max()))
    log(f"PairHMMLikelihood gradient B=8 Q={qs.shape[1]} W={Wg}: per-bp max "
        f"abs err vs autograd {g_err:.3g}")
    return dict(name="phmm_counts (lk gradient)", route="cuda",
                source="jtk_tpu_torch/csrc/phmm_counts.cu",
                replaces="jtk_tpu/parallel/__init__.py:120 (jax.value_and_grad "
                         "of the K1 forward; no Pallas kernel)",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None, grad_max_abs_err_per_bp=g_err,
                shape=dict(B=40, Q=Qc, W=W))


# ---------------------------------------------------------------------------
# the slice: reads -> GFA
# ---------------------------------------------------------------------------


def launch_counters():
    """The launch counters of the five kernel wrappers, in the order of the
    kernels line."""
    from jtk_tpu_torch.ops import (edit_dp, phmm_grad, phmm_lk,
                                   phmm_tables)
    return [edit_dp.LAUNCHES, phmm_tables.FWD_LAUNCHES,
            phmm_tables.BWD_LAUNCHES, phmm_lk.LAUNCHES, phmm_grad.LAUNCHES]


class _LaunchCounts(logging.Filter):
    """Stamps each log record with the launch counts so far, so that two
    runs' logs show where their launches part."""

    def __init__(self, counters):
        super().__init__()
        self.counters = counters

    def filter(self, record):
        record.launches = "/".join(str(c.count) for c in self.counters)
        return True


def run_slice(rng, counters):
    """Path (a).  ``counters`` (see :func:`launch_counters`) are read at
    each stage's end and on every line of ``stages.log``; the polish
    rounds' DEBUG lines go there too."""
    import numpy as np

    from jtk_tpu_torch import seq as seqmod
    from jtk_tpu_torch.io import sim
    from jtk_tpu_torch.io.eval import assembly_metrics
    from jtk_tpu_torch.stages.assemble import assemble
    from jtk_tpu_torch.stages.determine_chunks import select_chunks
    from jtk_tpu_torch.stages.entry import entry
    from jtk_tpu_torch.stages.local_clustering import local_clustering
    from jtk_tpu_torch.stages.multiplicity import (estimate_multiplicity,
                                                   purge_multiplicity)
    from jtk_tpu_torch.stages.pick_component import pick_top_n_component
    from jtk_tpu_torch.stages.repeat_masking import mask_repeats
    from jtk_tpu_torch.stages.util import adjusted_rand_index

    hap1, hap2 = sim.diploid(rng, REGION, het=0.004)
    reads = sim.simulate_reads(rng, [hap1, hap2], coverage=COVERAGE,
                               mean_len=15_000, error=0.05, clip_ends=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    # the stages' own timing lines (polish, cigar refresh, variant stats,
    # mcmc, consensus rounds) go to a log beside the outputs, each with the
    # launch counts K3/K1f/K1b/K1l/counts so far
    handler = logging.FileHandler(os.path.join(OUT_DIR, "stages.log"), "w")
    handler.addFilter(_LaunchCounts(counters))
    handler.setFormatter(logging.Formatter(
        "%(asctime)s [%(launches)s] %(name)s: %(message)s"))
    root = logging.getLogger()
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    polish_log = logging.getLogger("jtk_tpu_torch.ops.polish")
    polish_log.setLevel(logging.DEBUG)
    fa = os.path.join(OUT_DIR, "reads.fa")
    with open(fa, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">sim_{i}\n{seqmod.decode(r['codes']).decode()}\n")
    chunk_len, margin = 2000, 500
    take_num = int(3 * REGION / chunk_len / 2)
    stage_s, stage_launches = {}, {}
    t = time.time()
    seen = [c.count for c in counters]

    def mark(name):
        nonlocal t, seen
        now = time.time()
        stage_s[name] = now - t
        counts = [c.count for c in counters]
        stage_launches[name] = [a - b for a, b in zip(counts, seen)]
        log(f"stage {name}: {stage_s[name]:.1f} s, launches "
            + ", ".join(f"{c.name}={n}" for c, n in
                        zip(counters, stage_launches[name])))
        t, seen = now, counts

    ds = entry(fa, "ONT")
    mark("entry")
    mask_repeats(ds, 12, 0.001, 10)
    mark("mask_repeats")
    select_chunks(ds, chunk_len, take_num, margin, SEED, 10)
    mark("select_chunks")
    pick_top_n_component(ds, 1)
    estimate_multiplicity(ds)
    purge_multiplicity(ds, 10)
    mark("component+multiplicity")
    local_clustering(ds, seed=SEED)
    mark("local_clustering")
    gfa = assemble(ds, to_polish=True, window_size=2000, seed=SEED)
    mark("assemble")
    with open(os.path.join(OUT_DIR, "slice.gfa"), "w") as f:
        f.write(gfa)
    aris = []
    for c in ds.selected_chunks:
        if c.cluster_num < 2:
            continue
        asn, truth = [], []
        for er in ds.encoded_reads:
            for n in er.nodes:
                if n.chunk == c.id:
                    asn.append(n.cluster)
                    truth.append(reads[er.id]["hap"])
        aris.append(adjusted_rand_index(truth, asn))
    m = assembly_metrics(gfa, [hap1, hap2])
    mark("evaluation")
    root.removeHandler(handler)
    handler.close()
    polish_log.setLevel(logging.NOTSET)
    with open(os.path.join(OUT_DIR, "stages.log")) as f:
        for line in f:
            if "local_clustering:" in line or "select_chunks:" in line:
                log("  " + line.split(" ", 2)[2].rstrip())
    return dict(n_reads=len(reads), chunks=len(ds.selected_chunks),
                phased_chunks=len(aris),
                mean_ari=float(np.mean(aris)) if aris else float("nan"),
                contigs=len(m["contigs"]), total_len=int(m["total_len"]),
                mean_error=float(m["mean_error"]), stage_s=stage_s,
                stage_launches=stage_launches)


def run_pipeline_path(rng):
    """Path (b): the user's entry point, ``jtk pipeline -p profile.toml``
    through the port's CLI, on a fresh simulated region; then a resume
    rerun from the checkpoints."""
    # the checkpoints (tens of MB each) stay in a temporary directory; the
    # GFA, the timings and the log are copied beside the other outputs
    with tempfile.TemporaryDirectory(prefix="jtk_pipe_") as out:
        res = _pipeline_in(rng, out)
        keep = os.path.join(OUT_DIR, "pipeline")
        os.makedirs(keep, exist_ok=True)
        for fn in ("pipe.gfa", "pipe.timings.tsv", "pipeline.log",
                   "profile.toml"):
            if os.path.exists(os.path.join(out, fn)):
                shutil.copy(os.path.join(out, fn), keep)
    return res


def _pipeline_in(rng, out):
    import numpy as np

    from jtk_tpu_torch import cli
    from jtk_tpu_torch import seq as seqmod
    from jtk_tpu_torch.datamodel import DataSet
    from jtk_tpu_torch.io import sim
    from jtk_tpu_torch.io.eval import assembly_metrics
    from jtk_tpu_torch.stages.util import adjusted_rand_index

    hap1, hap2 = sim.diploid(rng, REGION, het=0.004)
    reads = sim.simulate_reads(rng, [hap1, hap2], coverage=COVERAGE,
                               mean_len=15_000, error=0.05, clip_ends=True)
    fa = os.path.join(out, "reads.fa")
    with open(fa, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">sim_{i}\n{seqmod.decode(r['codes']).decode()}\n")
    profile = os.path.join(out, "profile.toml")

    def write_profile(resume: bool):
        with open(profile, "w") as f:
            f.write(f'input_file = "{fa}"\nread_type = "ONT"\n'
                    f'out_dir = "{out}"\nprefix = "pipe"\n'
                    f'region_size = "{REGION // 1000}k"\nchunk_len = 2000\n'
                    f'margin = 500\nseed = {SEED}\n'
                    f'resume = {"true" if resume else "false"}\n')

    handler = logging.FileHandler(os.path.join(out, "pipeline.log"), "w")
    handler.setFormatter(logging.Formatter("%(asctime)s %(name)s: %(message)s"))
    root = logging.getLogger()
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    stem = os.path.join(out, "pipe")
    write_profile(False)
    t0 = time.time()
    cli.main(["pipeline", "-p", profile])
    wall = time.time() - t0
    log(f"path (b) cli pipeline: {wall:.1f} s")
    missing = [e for e in ("entry.json", "encoded.json", "clustered.json",
                           "de.json", "json", "gfa")
               if not os.path.exists(f"{stem}.{e}")]
    with open(f"{stem}.gfa") as f:
        gfa = f.read()
    phases = {}
    with open(f"{stem}.timings.tsv") as f:
        for line in f.read().splitlines()[1:]:
            name, sec = line.split("\t")
            phases[name] = float(sec)
    ds = DataSet.load(f"{stem}.json")
    aris = []
    for c in ds.selected_chunks:
        if c.cluster_num < 2:
            continue
        asn, truth = [], []
        for er in ds.encoded_reads:
            for n in er.nodes:
                if n.chunk == c.id:
                    asn.append(n.cluster)
                    truth.append(reads[er.id]["hap"])
        aris.append(adjusted_rand_index(truth, asn))
    m = assembly_metrics(gfa, [hap1, hap2])
    hmm = {}
    for strand in ("forward", "reverse"):
        hp = getattr(ds.model_param, strand)
        hmm[strand] = dict(
            trans=[[hp.mat_mat, hp.mat_ins, hp.mat_del],
                   [hp.ins_mat, hp.ins_ins, hp.ins_del],
                   [hp.del_mat, hp.del_ins, hp.del_del]],
            mat_emit_diag=[hp.mat_emit[5 * i] for i in range(4)])
    root.removeHandler(handler)
    handler.close()
    # resume: every phase checkpoint exists, so only assemble runs again
    os.remove(f"{stem}.gfa")
    write_profile(True)
    t0 = time.time()
    cli.main(["pipeline", "-p", profile])
    resume_s = time.time() - t0
    return dict(n_reads=len(reads), wall_s=wall, phases_s=phases,
                chunks=len(ds.selected_chunks), phased_chunks=len(aris),
                mean_ari=float(np.mean(aris)) if aris else float("nan"),
                contigs=len(m["contigs"]), total_len=int(m["total_len"]),
                mean_error=float(m["mean_error"]), missing=missing,
                resumed=os.path.exists(f"{stem}.gfa"), resume_s=resume_s,
                hmm=hmm)


def truth_failures(name, res, min_len):
    out = []
    if not res["mean_ari"] > 0.6:
        out.append(f"{name}: mean ARI {res['mean_ari']} <= 0.6")
    if not res["mean_error"] < 0.05:
        out.append(f"{name}: mean contig error {res['mean_error']} >= 0.05")
    if not res["total_len"] > min_len:
        out.append(f"{name}: total length {res['total_len']} <= {min_len}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels, drive no path")
    opts = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "jtk_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(jtk_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from jtk_tpu_torch.ops import cuda_build
    from jtk_tpu_torch.runtime import set_device

    # selecting cuda turns TF32 off: full fp32 in the one-hot segment sums
    set_device("cuda")
    dev = torch.device("cuda")
    t_all = time.time()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; jtk_tpu_torch from {HERE}")

    t0 = time.time()
    cuda_build.build(["edit_dp", "phmm_tables", "phmm_lk", "phmm_counts"])
    log(f"build: {time.time() - t0:.1f} s")
    # the table kernels keep a thread's band lanes in registers at every
    # geometry (ops/phmm_tables.py::tables_geometry): a spill breaks that
    spills = []
    for name, text in cuda_build.BUILD_LOG.items():
        fn = ""
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:   # _Z17fwd_tables_kernelILi4ELi1EEv... -> fwd_tables_kernel<4,1>
                fn = re.sub(r"^_Z\d+(\w+?)ILi(\d+)ELi(\d+)E.*$", r"\1<\2,\3>",
                            m.group(1))
            elif "registers" in line or "spill" in line:
                log(f"ptxas {name} {fn}: {line.strip()}")
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if name == "phmm_tables" and m and (int(m.group(1))
                                                    or int(m.group(2))):
                    spills.append(f"{fn} spills ({line.strip()})")

    rng = np.random.default_rng(SEED)
    rows = [check_k3(rng, dev)]
    torch.cuda.empty_cache()
    rows += check_tables(rng, dev)
    torch.cuda.empty_cache()
    rows.append(check_lk(rng, dev))
    torch.cuda.empty_cache()
    rows.append(check_counts(rng, dev))
    torch.cuda.empty_cache()
    log(f"kernel checks done at {time.time() - t_all:.1f} s")
    if opts.kernels_only:
        print(json.dumps({"kernels": rows}))
        if spills:
            print("chip_smoke FAILED: " + "; ".join(spills), file=sys.stderr)
            return 1
        return 0

    counters = launch_counters()
    # path (a): the stage-by-stage slice
    for c in counters:
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    res_a = run_slice(np.random.default_rng(SEED + 1), counters)
    launches_a = [c.count for c in counters]
    log("path (a) slice: " + json.dumps(res_a))
    log(f"path (a) peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.empty_cache()
    # path (b): the CLI pipeline, the main path
    for c in counters:
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    res_b = run_pipeline_path(np.random.default_rng(SEED + 2))
    launches_b = [c.count for c in counters]
    log("path (b) pipeline: " + json.dumps(res_b))
    log(f"path (b) peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for phase, sec in res_b["phases_s"].items():
        log(f"phase {phase}: {sec:.1f} s")
    # where each kernel's launches on the main path go, by (B, Q, W): the
    # launches x time of a kernel at the shapes the pipeline uses
    res_b["launch_shapes_top5"] = {}
    for c in counters:
        top = c.shapes.most_common(5)
        log(f"path (b) {c.name} launches by shape (B, Q, W), top 5 of "
            f"{len(c.shapes)}: " + ", ".join(f"{s}={n}" for s, n in top))
        res_b["launch_shapes_top5"][c.name] = [[list(s), n] for s, n in top]
    for strand, h in res_b["hmm"].items():
        log(f"fitted {strand} HMM: trans {h['trans']}, mat_emit diagonal "
            f"{h['mat_emit_diag']}")
    for row, na, nb in zip(rows, launches_a, launches_b):
        row["launches"] = nb
        row["launches_slice"] = na
    log("kernel launches, path (a) slice / path (b) pipeline: "
        + ", ".join(f"{r['name']}={r['launches_slice']}/{r['launches']}"
                    for r in rows))
    failures = [f"{r['name']} never launched on the pipeline" for r in rows
                if r["launches"] == 0]
    # the slice has no model tuning, so no gradient
    failures += [f"{r['name']} never launched on the slice" for r in rows[:4]
                 if r["launches_slice"] == 0]
    failures += spills
    failures += truth_failures("path (a)", res_a, 2 * REGION / 3)
    failures += truth_failures("path (b)", res_b, 2 * 2 * REGION / 3)
    if res_b["missing"]:
        failures.append(f"path (b): missing outputs {res_b['missing']}")
    if not res_b["resumed"]:
        failures.append("path (b): the resume rerun wrote no GFA")
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    log(f"total wall {time.time() - t_all:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: r[k] for k in keys} for r in rows]
    with open(os.path.join(OUT_DIR, "result.json"), "w") as f:
        json.dump(dict(card=card, kernels=rows, slice=res_a,
                       pipeline=res_b, total_s=time.time() - t_all), f,
                  indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
