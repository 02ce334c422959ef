#!/usr/bin/env python3
"""Smoke run of jtk_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels of ``jtk_tpu_torch/csrc`` (one nvcc per source,
   started together), fails on a ptxas spill of K3 (its DP and walk), the
   K1 family, counts or the MCMC chain, and prints the SASS row-loop
   statistics of K3's warp-form DP, of its walk and of the MCMC chain's
   step loop (``tools/sass_loop_stats``), failing on a block-wide barrier
   in any of them;
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (K3 at the mapper's B 2048 and at path (b)'s own K3
   shapes; the K1 tables at polish's B 192 / W 128 and W 512 and model
   tuning's B 40 / W 128 and W 256; K1l also at the gain calibration's B
   256 / W 64 and with an N; the gradient's float64 tables at model
   tuning's B 40 / W 128 and 256; counts, from float64 tables, also with
   reads that start 22 and 40 bases late; the MCMC chain at path (b)'s
   B 27 x 20 restarts / K 2 / V 8, at K 4 / V 12, at K 8 / V 40 and at a
   1 Mb run's 414 chunks x 20 / K 2 / V 8) and then, in a last step, at
   the band widths above 1024 that the pipeline can reach (K3 to 16 384,
   int32 cells above 8192; the K1 family, tables in both types, K1l and
   counts, to 8192, the scratch form above 4096), and times both with
   CUDA events, each beside its bound: K3's DP
   bit-exact
   on each pair's stream rows below its q_len and the last row, its walk
   bit-exact against the plain walk, and the decoded CIGARs; the K1 tables
   within rtol 2e-3 / atol 1e-5 (tables) and rtol 1e-4 / atol 2e-2
   (cumulative log scales); K1l's lk within rtol 1e-4 / atol 2e-2 of its
   plain version and of K1f's lk; the counts kernel within rtol 1e-3 /
   atol 1e-4 and bitwise equal in two calls; the PairHMMLikelihood
   gradient within rtol 1e-3 / atol 1e-4 (per bp) of torch.autograd
   through the plain forward; the MCMC chain bit-exact against its plain
   version over four draw blocks (every state tensor), timed per
   1024-step launch (the register form also against the general form at
   path (b)'s shape) and per clustering call of 100 000 steps;
4. path (a): the stage-by-stage slice reads -> GFA (entry, mask_repeats,
   select_chunks, pick_top_n_component, estimate/purge multiplicity,
   local_clustering, assemble with contig polishing) on a simulated 60 kb
   diploid region at 60x ONT-like coverage with the pipeline's defaults;
5. path (b), the main path: ``jtk pipeline -p profile.toml --devices
   cuda`` through the port's CLI, on one device, on a fresh 60 kb / 60x
   region (region_size 60k, chunk 2000, margin 500, seed 42), then a
   resume rerun from its checkpoints, and one
   more ``dump_sam`` on the rerun's contigs, split into K3's DP, its walk
   and the host by synchronised timers (outside the timed path; its
   launches are not counted); model tuning's counts are checked for pairs
   whose M + I emissions miss their q_len by more than 1 %, each listed
   with how late its read starts in its chunk;
6. path (c): path (b)'s run (same profile and seed, no resume rerun) with
   the device set of the data-parallel paths (``--devices``) the card
   listed four times, so every split, per-shard launch and merge runs on
   one card, and where the host has several cards, over every card once;
   each must give path (b)'s GFA byte for byte, its fitted HMMs bit for
   bit, its per-chunk ARI and contig error; launches per kernel and per
   entry of the set, peak device memory per card and the modtable engine's
   calls by their number of slices are logged;
7. the multidevice phase (the twin of ``__graft_entry__.py``'s
   ``dryrun_multichip``): the train step, the sharded pileup lk, the k-mer
   histogram, a modtable engine call of three slices and a candidate batch
   of ``extend_candidates``, each on the card alone and on the card listed
   four times, compared bit for bit;
8. counts every kernel's launches on each path (set to 0 just before it,
   read just after; path (a) by stage, path (b) by launch shape (B, Q, W),
   the five most frequent of each kernel), times each kernel at path
   (b)'s three most-launched shapes and K3's DP and walk at every shape
   they were launched at (launches x time, and x (time - bound)), checks
   the truth bars of tests/test_e2e.py on both (mean ARI > 0.6, mean
   contig error < 0.05, total length > 2/3 of the region for (a) and of
   both haplotypes for (b)), the five checkpoints and the resumed GFA;
9. prints the kernels line, the card line, then {"ok": true, "device": ...}
   as the last line.  Any failure exits non-zero without the last line.

``--kernels-only`` stops after step 3 (a quick build-and-check run).  The
script runs the ``jtk_tpu_torch`` beside it, so a copy of it placed in an
unpacked ``git archive`` of an earlier commit checks and times that
commit's kernels at the same shapes (a tree without K3's walk kernel
walks with its plain loop): a kernel redesign is timed against its parent
in one call.  The checks stop at the first failure, after printing every
line before it, and the widths above 1024 come last: a parent whose
kernels refuse them has timed every main-path shape first.
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
# libraries whose kernels must not spill (the script fails on a spill)
NO_SPILL = ("edit_dp", "phmm_tables", "phmm_lk", "phmm_counts", "mcmc_chain")
LIBRARIES = NO_SPILL


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


def device_ms(fn, reps: int = 5):
    """Mean milliseconds the card spends in kernels per ``fn()`` call, from
    torch.profiler's CUDA activity (without the host time between the
    launches that ``cuda_time`` also counts); None if the trace has no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    return us / 1e3 / reps if us > 0 else None


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# kernel checks at the main path's shapes
# ---------------------------------------------------------------------------


# path (b)'s K3 shapes (B, Q, W): its two most-launched, with 12 launches
# each, and its longest Q (dump_sam's whole reads), 8 launches each
K3_PATH_SHAPES = ((29, 256, 128), (26, 2048, 768), (748, 2240, 640),
                  (1, 59200, 512))
# latency of a shared-memory load on Hopper (cycles, public
# microbenchmarks): the walk's chain is two dependent loads a step
SMEM_LOAD_CYCLES = 30
# latencies (cycles, public microbenchmarks) of a warp shuffle and of a
# dependent fp32 add: the MCMC chain's step is a chain of such operations
SHFL_CYCLES = 24
FP32_CYCLES = 4


def roofline(bytes_, ops):
    """(least ms, what bounds it): ``bytes_`` over the memory rate against
    ``ops`` over the fp32 rate."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k3_bounds(B, Q, W, rows):
    """The DP's and the walk's bounds (roofline) for B pairs whose q_lens
    sum to ``rows`` (both stop at each pair's q_len).  The DP reads its
    (B, W) rows once and its row streams up to q_len, writes the stream up
    to q_len (2-byte cells, 4 above 8192 lanes) and the last row; ~20
    integer operations a cell.  The walk reads at most two stream cells and
    one band offset a step, q_len and end_j a pair, and writes dels and ops
    of every step and start_j; ~15 integer operations a step."""
    cell = 2 if W <= 8192 else 4
    dp = roofline(4 * (3 * B * W + 3 * rows + 2 * B) + cell * W * rows
                  + 4 * B * W, 20.0 * W * rows)
    tb = roofline((2 * cell + 8) * rows + 5 * B * Q + 20 * B, 15.0 * rows)
    return dp, tb


def timed_once(fn):
    """(milliseconds, result) of one call of ``fn``, CUDA events."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), out


def _rows_below(stream, qlen):
    """``stream`` with each pair's rows from its q_len on set to 0: the
    kernel writes no others, and nothing reads them."""
    import torch
    rows = (torch.arange(stream.shape[0], device=stream.device)[:, None, None]
            < qlen[None, :, None])
    return torch.where(rows, stream, 0)


def _k3_case(label, dev, kargs, off, mode, reps=5, decode=None):
    """K3 on one batch: the DP kernel against edit_dp_plain (the stream on
    each pair's rows below q_len, and the last row) and the walk kernel
    against traceback_packed_plain on the kernel's stream, all bit-exact,
    and ``decode(walk outputs)`` of both walks equal; the four times (the
    plain versions one run each, whose outputs are the ones compared) and
    the bounds."""
    import torch

    from jtk_tpu_torch.ops import edit_dp as k3

    qlen, tl = kargs[6], kargs[7]
    B, Q = kargs[1].shape
    W = kargs[0].shape[1]
    torch.cuda.synchronize()
    packed, last = k3.edit_dp(*kargs)
    plain_ms, (packed_p, last_p) = timed_once(lambda: k3.edit_dp_plain(*kargs))
    if not (torch.equal(_rows_below(packed, qlen), _rows_below(packed_p, qlen))
            and torch.equal(last, last_p)):
        raise AssertionError(f"K3 {label}: kernel stream/last row differ "
                             f"from plain")
    del packed_p
    score, end = k3.select_end(last, off, qlen.long(), tl.long(), W, mode)
    # a parent tree without the walk kernel walks with the plain loop
    plain_walk = getattr(k3, "traceback_packed_plain", None)
    walk_fn = plain_walk or k3.traceback_packed
    tb_plain_ms, walk_p = timed_once(
        lambda: walk_fn(packed, off, qlen, end, W))
    walk = walk_p if plain_walk is None else k3.traceback_packed(
        packed, off, qlen, end, W)
    for g, w, what in zip(walk, walk_p, ("dels", "ops", "start_j")):
        if not torch.equal(g, w):
            raise AssertionError(f"K3 walk {label}: {what} differ from plain")
    cigars = None
    if decode is not None:
        cigars = decode(score, end, *walk)
        if cigars != decode(score, end, *walk_p):
            raise AssertionError(f"K3 {label}: decoded CIGARs differ")
    ms = cuda_time(lambda: k3.edit_dp(*kargs), reps=reps)
    tb_ms = tb_plain_ms if plain_walk is None else cuda_time(
        lambda: k3.traceback_packed(packed, off, qlen, end, W), reps=reps)
    rows = int(qlen.sum())
    (dp_b, dp_by), (tb_b, tb_by) = k3_bounds(B, Q, W, rows)
    log(f"K3 {label} B={B} Q={Q} W={W}: bit-exact stream (rows < q_len), "
        f"last row, walk{' and cigars' if cigars is not None else ''}; DP "
        f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {dp_b:.4f} ms; "
        f"walk kernel {tb_ms:.3f} ms, plain {tb_plain_ms:.1f} ms, bound "
        f"{tb_b:.4f} ms")
    del packed, walk, walk_p
    torch.cuda.empty_cache()
    return (dict(B=B, Q=Q, W=W, ms=ms, plain_ms=plain_ms, bound_ms=dp_b,
                 bound_by=dp_by),
            dict(B=B, Q=Q, W=W, ms=tb_ms, plain_ms=tb_plain_ms, bound_ms=tb_b,
                 bound_by=tb_by, steps=rows), cigars)


def _k3_random(rng, dev, B, Q, W):
    """K3's kernel arguments and band offsets at launch shape (B, Q, W):
    random codes, a diagonal band, every pair Q rows (infix)."""
    import torch

    from jtk_tpu_torch.ops import edit_dp as k3

    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    T = Q + W
    q = torch.randint(0, 4, (B, Q), generator=g, device=dev)
    r = torch.randint(0, 4, (B, T), generator=g, device=dev)
    ii = torch.arange(Q + 1, device=dev)
    off = (ii - W // 4).clamp(0, T - W + 1)[None].expand(B, Q + 1) \
        .contiguous()
    tl = torch.full((B,), T, dtype=torch.int64, device=dev)
    kargs = k3.k3_inputs(q, r, off, tl, W, "infix") + (
        torch.full((B,), Q, dtype=torch.int32, device=dev),
        tl.to(torch.int32))
    return kargs, off


def check_k3(rng, dev, sm_ghz):
    """K3 at B = 2048 candidates, Q = 2048 chunk rows, W = 256 (the
    mapper's production shapes), infix mode as in encode, bit-exact with
    the decoded CIGARs (:func:`_k3_case`); then at each of K3_PATH_SHAPES.
    Returns the rows of the DP kernel and of the walk."""
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
    kargs = k3.k3_inputs(q, r, off, tl, W, "infix") + (
        q_lens.to(torch.int32), tl.to(torch.int32))

    def decode(score, end, dels, ops, start):
        valid = tl >= q_lens // 2
        meta = k3.to_host(*k3.pack_results(
            score, end, start, dels, ops, valid,
            torch.as_tensor(astart, device=dev)))
        return decode_indexed(*meta, [clen] * B)

    dp, tb, cigars = _k3_case("mapper", dev, kargs, off, "infix",
                              decode=decode)
    n_valid = sum(1 for d in cigars if d[4])
    log(f"K3 mapper: {n_valid} valid alignments")
    del kargs, cigars
    torch.cuda.empty_cache()
    dp_row = dict(name="edit_dp (K3)", route="cuda",
                  source="jtk_tpu_torch/csrc/edit_dp.cu",
                  replaces="jtk_tpu/ops/pallas_k3.py:33", max_abs_err=0.0,
                  ms=dp["ms"], plain_ms=dp["plain_ms"],
                  bound_ms=dp["bound_ms"], bound_by=dp["bound_by"],
                  library_ms=None, shape=dict(B=B, Q=Q, W=W), at_path=[])
    tb_row = dict(name="edit_tb (K3 walk)", route="cuda",
                  source="jtk_tpu_torch/csrc/edit_dp.cu",
                  replaces="jtk_tpu/ops/pallas_k3.py:148 (_traceback_packed, "
                           "a lax.scan beside the Pallas call)",
                  max_abs_err=0.0, ms=tb["ms"], plain_ms=tb["plain_ms"],
                  bound_ms=tb["bound_ms"], bound_by=tb["bound_by"],
                  library_ms=None, shape=dict(B=B, Q=Q, W=W), at_path=[])
    for shape in K3_PATH_SHAPES:
        kargs, off = _k3_random(rng, dev, *shape)
        dp, tb, _ = _k3_case(f"at path (b)'s {shape}", dev, kargs, off,
                             "infix")
        if shape[0] == 1:   # one pair: the walk's chain alone
            tb["chain_ms"] = tb["steps"] * 2 * SMEM_LOAD_CYCLES / sm_ghz / 1e6
            log(f"K3 walk {shape}: one pair, {tb['steps']} steps; its chain "
                f"of two dependent shared-memory loads a step allows "
                f"{tb['chain_ms']:.3f} ms at {sm_ghz:.3f} GHz")
        dp_row["at_path"].append(dp)
        tb_row["at_path"].append(tb)
        del kargs, off
        torch.cuda.empty_cache()
    return dp_row, tb_row


def _k3_wide(rng, dev, Wd):
    """K3 at band width ``Wd`` > 1024 (consensus tiles of more than ~7 kb;
    the warp form's 9-16 warps a pair, the block form above 2048, the
    scratch form with int32 cells above 8192, at B 2 there: a stream of
    W 16 384 takes 2.2 GB at B 2), bit-exact with its walk
    (:func:`_k3_case`); its times and bounds."""
    kargs, off = _k3_wide_inputs(rng, dev, W=Wd, B=8 if Wd <= 8192 else 2)
    dp, tb, _ = _k3_case(f"W{Wd}", dev, kargs, off, "infix")
    return dp, tb


def _k3_wide_inputs(rng, dev, W, B=8, margin=600):
    """K3's kernel arguments and band offsets for B chunks of ~W rows placed
    (infix) in read windows 2 * margin longer, band W (a consensus tile's
    layout)."""
    import numpy as np
    import torch

    from jtk_tpu_torch.io import sim
    from jtk_tpu_torch.ops import edit_dp as k3
    from jtk_tpu_torch.ops.banded_align import diagonal_offsets

    Q = W + 256
    T = Q + 2 * margin + 64
    qs = np.full((B, Q), 4, np.int8)
    rs = np.full((B, T), 4, np.int8)
    q_lens = np.zeros(B, np.int64)
    t_lens = np.zeros(B, np.int64)
    offs = np.zeros((B, Q + 1), np.int64)
    for b in range(B):
        L = Q - int(rng.integers(0, 64))
        c = sim.random_genome(rng, L)
        win = np.concatenate([sim.random_genome(rng, margin),
                              sim.noisy_read(rng, c, 0.06),
                              sim.random_genome(rng, margin)])[:T]
        qs[b, :L], rs[b, :len(win)] = c, win
        q_lens[b], t_lens[b] = L, len(win)
        offs[b] = diagonal_offsets(L, margin, len(win), Q, W)

    def t(x, dt):
        return torch.as_tensor(x, dtype=dt, device=dev)

    tl = t(t_lens, torch.int64)
    off = t(offs, torch.int64)
    args = k3.k3_inputs(t(qs, torch.int32), t(rs, torch.int32), off, tl, W,
                        "infix")
    return args + (t(q_lens, torch.int32), tl.to(torch.int32)), off


# (label, B, W, type): polish's B 192 at W 128 and 512, model tuning's B 40
# at W 128 and 256 (the modtable's float32 tables), and the gradient's
# float64 tables at model tuning's shapes
TABLE_SHAPES = (("polish", 192, 128, "f32"), ("polish_W512", 192, 512, "f32"),
                ("model_tune", 40, 128, "f32"),
                ("model_tune_W256", 40, 256, "f32"),
                ("model_tune_f64", 40, 128, "f64"),
                ("model_tune_W256_f64", 40, 256, "f64"))
# in the last step: the register form's widest band (2048), then above it
# the wide form, both types
TABLE_WIDE_SHAPES = (("W2048", 8, 2048, "f32"), ("W2176", 8, 2176, "f32"),
                     ("W4096", 4, 4096, "f32"),
                     ("W2176_f64", 8, 2176, "f64"),
                     ("W4096_f64", 4, 4096, "f64"))


def _table_type(name):
    import torch
    return torch.float64 if name == "f64" else torch.float32


def _tables_case(rng, dev, label, B, W, type_name):
    """K1 forward and backward on B reads against ~2 kb templates (Q 2048;
    past W 2048, templates ~W + 150 long), a random strand each, against
    the plain versions in the same type: tables within rtol 2e-3 / atol
    1e-5, cumulative log scales rtol 1e-4 / atol 2e-2."""
    import numpy as np
    import torch

    from jtk_tpu_torch.io import sim
    from jtk_tpu_torch.ops import phmm_tables as pt
    from jtk_tpu_torch.ops.banded_align import linear_offsets
    from jtk_tpu_torch.ops.phmm import PHMMParams

    tlen = 2000 if W <= 2048 else W + 150
    Q = 2048 if W <= 2048 else ((tlen + 40 + 127) // 128) * 128
    dtype = _table_type(type_name)
    params_f = PHMMParams.default(dev)
    # reverse-strand set: a perturbed copy, so the strand select matters
    params_r = PHMMParams(params_f.trans * 0.98 + 0.0066,
                          params_f.mat_emit, params_f.ins_emit)
    tpl = np.full((B, Q + 64), 4, np.int8)
    qs = np.full((B, Q), 4, np.int8)
    q_lens = np.zeros(B, np.int64)
    t_lens = np.zeros(B, np.int64)
    offs = np.zeros((B, Q + 1), np.int64)
    for b in range(B):
        t = sim.random_genome(rng, tlen - int(rng.integers(0, 40)))
        read = sim.noisy_read(rng, t, 0.05)[:Q]
        tpl[b, :len(t)] = t
        qs[b, :len(read)] = read
        q_lens[b], t_lens[b] = len(read), len(t)
        offs[b] = linear_offsets(len(read), len(t), Q, W)
    strands = rng.random(B) < 0.5
    prep = pt.prep_tables_inputs(qs, tpl, offs, q_lens, t_lens, params_f,
                                 W, strands=strands, params_rev=params_r,
                                 device=dev)
    fwd_args, bwd_args, _aux = pt.kernel_inputs(prep, W, dtype)
    out = {}
    for kind, args, kern, plain in (
            ("fwd", fwd_args, pt.fwd_tables, pt.fwd_tables_plain),
            ("bwd", bwd_args, pt.bwd_tables, pt.bwd_tables_plain)):
        torch.cuda.synchronize()
        got = kern(*args)
        plain_ms, want = timed_once(lambda: plain(*args))
        err = 0.0
        for g, w in zip(got[:3], want[:3]):
            if g.dtype != dtype or not torch.allclose(g, w, rtol=2e-3,
                                                      atol=1e-5):
                raise AssertionError(f"K1 {kind} {label}: tables differ "
                                     f"(max {float((g - w).abs().max())})")
            err = max(err, float((g - w).abs().max()))
        cg, cw = torch.cumsum(got[3], 1), torch.cumsum(want[3], 1)
        if not torch.allclose(cg, cw, rtol=1e-4, atol=2e-2):
            raise AssertionError(f"K1 {kind} {label}: log scales differ "
                                 f"(max {float((cg - cw).abs().max())})")
        err = max(err, float((cg - cw).abs().max()))
        ms = cuda_time(lambda: kern(*args), reps=5)
        moved = nbytes(*args) + nbytes(*got)
        bound_ms, bound_by = roofline(moved, 40.0 * B * Q * W)
        log(f"K1 {kind}_tables {label} B={B} Q={Q} W={W} {type_name}: max "
            f"abs err {err:.3g}, kernel {ms:.3f} ms, plain {plain_ms:.1f} "
            f"ms, bound {bound_ms:.3f} ms")
        out[kind] = dict(label=label, B=B, Q=Q, W=W, type=type_name, err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
        del got, want
        torch.cuda.empty_cache()
    return out


def check_tables(rng, dev):
    """K1 forward/backward at TABLE_SHAPES (see :func:`_tables_case`)."""
    out = {"fwd": [], "bwd": []}
    for shape in TABLE_SHAPES:
        res = _tables_case(rng, dev, *shape)
        for kind in out:
            out[kind].append(res[kind])
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
            shape=dict(B=first["B"], Q=first["Q"], W=first["W"]))
        for o in others:
            row[f"at_{o['label']}"] = _at_table(o)
        rows.append(row)
    return rows


def _at_table(o):
    return {k: o[k] for k in ("B", "Q", "W", "type", "ms", "plain_ms",
                              "bound_ms")}


def _pileup_pairs(rng, B, tlen, Qmult, W, err=0.05, jitter=40, short=0):
    """B noisy reads against one random template (the model-tune layout):
    qs (B, Q) padded to ``Qmult``, offsets, lengths and the effective band.
    One read starts ``short`` bases into the template, which widens the
    band (``effective_band``) as a short read in a pileup does.  (A read
    that ends early instead ends in a run of deletions: past ~20 of them
    its end cell holds less than EPS of its last row's mass, and the
    reference's lk, log(fin + EPS) + scales, is floored there; PERF.md §7.)"""
    import numpy as np

    from jtk_tpu_torch.io import sim
    from jtk_tpu_torch.ops.banded_align import linear_offsets
    from jtk_tpu_torch.ops.polish import effective_band

    tpl = sim.random_genome(rng, tlen)
    reads = [sim.noisy_read(rng, tpl, err)[:tlen + jitter] for _ in range(B)]
    if short:
        reads[0] = reads[0][short:]
    q_lens = np.array([len(r) for r in reads], np.int64)
    W = effective_band(W, q_lens, tlen)
    Q = ((int(q_lens.max()) + Qmult - 1) // Qmult) * Qmult
    qs = np.full((B, Q), 4, np.int8)
    for b, r in enumerate(reads):
        qs[b, :len(r)] = r
    offs = np.stack([linear_offsets(int(n), tlen, Q, W) for n in q_lens])
    return tpl, qs, offs, q_lens, W


def _calibration_pairs(rng, B=256, seq_len=100, W=64):
    """The gain calibration's layout (stages/likelihood_gains.py
    ``_batched_lks``): B reads of ~100 bp, each against its own template,
    Q and T rounded up to 32, band W 64."""
    import numpy as np

    from jtk_tpu_torch.io import sim
    from jtk_tpu_torch.ops.banded_align import linear_offsets

    tpls = [sim.random_genome(rng, seq_len + int(rng.integers(2, 10)))
            for _ in range(B)]
    reads = [sim.noisy_read(rng, t, 0.05) for t in tpls]
    Q = ((max(len(r) for r in reads) + 31) // 32) * 32
    T = ((max(len(t) for t in tpls) + 31) // 32) * 32
    qs = np.full((B, Q), 4, np.int8)
    rs = np.full((B, T), 4, np.int8)
    for b, (r, t) in enumerate(zip(reads, tpls)):
        qs[b, :len(r)], rs[b, :len(t)] = r, t
    q_lens = np.array([len(r) for r in reads], np.int64)
    t_lens = np.array([len(t) for t in tpls], np.int64)
    offs = np.stack([linear_offsets(int(q), int(t), Q, W)
                     for q, t in zip(q_lens, t_lens)])
    return rs, qs, offs, q_lens, t_lens, W


# K1l's shapes: model tuning's pileups (B 40 reads against a ~2 kb chunk;
# a short read widens the band to 256), a read with an N, and the gain
# calibration (B 256, Q 128, W 64); above 1024 (the last step), a short
# read's band of 1152 and 2048, and past 2048 (the wide form) 2176 on a
# 2.3 kb chunk and 4096 on a 4.2 kb one
LK_SHAPES = (("model_tune", 0, False), ("model_tune_W256", 150, False),
             ("model_tune_N", 0, True), ("gain_calibration", 0, False))
LK_WIDE_SHAPES = (("model_tune_W1152", 1000, False),
                  ("model_tune_W2048", 1900, False),
                  ("model_tune_W2176", 2050, False, 2300),
                  ("model_tune_W4096", 3970, False, 4200))


def check_lk(rng, dev):
    """K1l at the shapes of LK_SHAPES (see :func:`_lk_case`)."""
    res = [_lk_case(rng, dev, *shape) for shape in LK_SHAPES]
    r0 = res[0]
    row = dict(name="phmm_lk (K1l)", route="cuda",
               source="jtk_tpu_torch/csrc/phmm_lk.cu",
               replaces="jtk_tpu/ops/pallas_phmm.py:55",
               max_abs_err=max(r["err"] for r in res), ms=r0["ms"],
               plain_ms=r0["plain_ms"], bound_ms=r0["bound_ms"],
               bound_by=r0["bound_by"], library_ms=None,
               shape=dict(B=r0["B"], Q=r0["Q"], W=r0["W"]))
    for r in res[1:]:
        row[f"at_{r['label']}"] = _at(r)
    return row


def _at(r):
    return {k: r[k] for k in ("B", "Q", "W", "ms", "device_ms", "plain_ms",
                              "bound_ms") if k in r}


def _lk_case(rng, dev, label, short, with_n, tlen=2000):
    """K1l on one layout against its plain version and, on reads without
    N, against K1f's lk; both within rtol 1e-4 / atol 2e-2."""
    import torch

    from jtk_tpu_torch.ops import phmm_lk as k1l
    from jtk_tpu_torch.ops import phmm_tables as pt
    from jtk_tpu_torch.ops.phmm import PHMMParams

    params = PHMMParams.default(dev)
    tabs = k1l.tables8(params, dev)
    if label == "gain_calibration":
        tpl, qs, offs, q_lens, tlen, W = _calibration_pairs(rng)
    else:
        tpl, qs, offs, q_lens, W = _pileup_pairs(rng, 40, tlen, 64, 128,
                                                 short=short)
        tlen = len(tpl)
    if with_n:   # in-length N: emits with probability 0
        qs[1, 30] = 4
    B, Q = qs.shape
    args = k1l.lk_inputs(qs, tpl, offs, q_lens, tlen, W, device=dev)
    torch.cuda.synchronize()
    got = k1l.phmm_lk(*args, *tabs)
    plain_ms, want = timed_once(lambda: k1l.phmm_lk_plain(*args, *tabs))
    others = [(want, "plain")]
    if not with_n:   # the tables prep scores an N as A
        prep = pt.prep_tables_inputs(qs, tpl, offs, q_lens, tlen, params, W,
                                     device=dev)
        others.append((pt.tables_batch(prep, W, backward=False)[0],
                       "K1f's lk"))
    torch.cuda.synchronize()
    err = 0.0
    for other, what in others:
        if not torch.allclose(got, other, rtol=1e-4, atol=2e-2):
            raise AssertionError(
                f"K1l {label}: lk differs from {what} (max "
                f"{float((got - other).abs().max())})")
        err = max(err, float((got - other).abs().max()))
    if with_n and not float(got[1]) < float(got[0]) - 1000:
        raise AssertionError("K1l: a read with an N is not improbable")
    ms = cuda_time(lambda: k1l.phmm_lk(*args, *tabs), reps=5)
    dev_ms = device_ms(lambda: k1l.phmm_lk(*args, *tabs))
    dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.3f} ms"
    moved = nbytes(*args, *tabs) + got.numel() * 4
    # the loop stops at each pair's q_len: count the rows this data needs
    flops = 40.0 * W * float(q_lens.sum())
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_OPS_PER_S * 1e3
    log(f"K1l phmm_lk {label} B={B} Q={Q} W={W}: max abs err {err:.3g} "
        f"(vs {', '.join(w for _o, w in others)}), kernel {ms:.3f} ms "
        f"(device {dev_txt}), plain {plain_ms:.1f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms")
    return dict(label=label, B=B, Q=Q, W=W, err=err, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# the counts kernel's shapes (from float64 tables): model tuning's
# pileups at W 128, with a read that starts 22 bases late (row 0's cell
# weights pass float32's range there; whole, they made its counts NaN)
# and 40 late (its opening deletion run is under float32's range), and
# with a short read that widens the band to 256; above 1024 (the last
# step), 1152, and past 2048 2176 and 4096 (B cut to 8 and 4: the float64
# tables of B 40 at W 4096 would take 33 GB)
COUNTS_SHAPES = (("model_tune", 0), ("model_tune_late22", 22),
                 ("model_tune_late40", 40), ("model_tune_W256", 150))
COUNTS_WIDE_SHAPES = (("model_tune_W1152", 1000),
                      ("model_tune_W2176", 2050, 2300, 8),
                      ("model_tune_W4096", 3970, 4200, 4))


def check_counts(rng, dev):
    """The counts kernel at COUNTS_SHAPES (see :func:`_counts_case`); and
    the whole PairHMMLikelihood gradient against torch.autograd through
    the plain forward at B = 8, Q = 256."""
    import torch

    from jtk_tpu_torch.ops import phmm_grad as pg
    from jtk_tpu_torch.ops import phmm_lk as k1l
    from jtk_tpu_torch.ops.phmm import PHMMParams
    from jtk_tpu_torch.parallel import params_to_theta, theta_to_params

    res = [_counts_case(rng, dev, *shape) for shape in COUNTS_SHAPES]
    params = PHMMParams.default(dev)
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
    r0 = res[0]
    row = dict(name="phmm_counts (lk gradient)", route="cuda",
               source="jtk_tpu_torch/csrc/phmm_counts.cu",
               replaces="jtk_tpu/parallel/__init__.py:120 (jax.value_and_grad "
                        "of the K1 forward; no Pallas kernel)",
               max_abs_err=max(r["err"] for r in res), ms=r0["ms"],
               plain_ms=r0["plain_ms"], bound_ms=r0["bound_ms"],
               bound_by=r0["bound_by"], library_ms=None,
               grad_max_abs_err_per_bp=g_err,
               shape=dict(B=r0["B"], Q=r0["Q"], W=r0["W"]))
    for r in res[1:]:
        row[f"at_{r['label']}"] = _at(r)
    return row


def _counts_case(rng, dev, label, short, tlen=2000, B=40):
    """The counts kernel on a model-tune pileup (B ~ 40, Q ~ 2.1 k) whose
    first read starts ``short`` bases late, against its plain version
    (rtol 1e-3 / atol 1e-4), bitwise equal in two calls, its M + I
    emissions summing to each read's length."""
    import torch

    from jtk_tpu_torch.ops import phmm_grad as pg
    from jtk_tpu_torch.ops import phmm_lk as k1l
    from jtk_tpu_torch.ops.phmm import PHMMParams

    params = PHMMParams.default(dev)
    tpl, qs, offs, q_lens, W = _pileup_pairs(rng, B, tlen, 64, 128,
                                             short=short)
    # model tuning's outlier filter (stages/model_tune.py): the band is
    # sized from every read, the gradient taken on reads whose lk per base
    # is above -2 (a read that starts 150 or more bases late is not: its
    # paths open with a row-0 mass under float32's range)
    lk = k1l.phmm_lk(*k1l.lk_inputs(qs, tpl, offs, q_lens, len(tpl), W,
                                    device=dev), *k1l.tables8(params, dev))
    keep = lk.cpu().numpy() / q_lens > -2.0
    if 0 < short < 150 and not keep[0]:
        raise AssertionError(f"counts {label}: the late read was filtered")
    qs, offs, q_lens = qs[keep], offs[keep], q_lens[keep]
    batch = pg.PairBatch(qs, tpl, offs, q_lens, len(tpl), W, device=dev)
    args = pg.counts_args(pg.counts_prep(params, batch), W)
    torch.cuda.synchronize()
    got = pg.phmm_counts(*args)
    again = pg.phmm_counts(*args)
    plain_ms, want = timed_once(lambda: pg.phmm_counts_plain(*args))
    if not torch.allclose(got, want, rtol=1e-3, atol=1e-4):
        raise AssertionError(f"counts {label}: kernel differs from plain "
                             f"(max {float((got - want).abs().max())})")
    if not torch.equal(got, again):
        raise AssertionError(f"counts {label}: two calls differ")
    # each query base is emitted by exactly one M or I state
    emitted = got[:, 9:].sum(1)
    if not torch.allclose(emitted, batch.q_lens.to(torch.float32),
                          rtol=1e-3):
        raise AssertionError(f"counts {label}: M + I emissions do not sum "
                             f"to q_len")
    err = float((got - want).abs().max())
    ms = cuda_time(lambda: pg.phmm_counts(*args), reps=5)
    moved = nbytes(*args) + got.numel() * 4
    flops = 60.0 * W * float((q_lens + 1).sum())
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_OPS_PER_S * 1e3
    Qc = qs.shape[1]
    log(f"counts {label} B={len(qs)} Q={Qc} W={W}: max abs err {err:.3g}, "
        f"bitwise equal in two calls, kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, bound {max(t_bytes, t_ops):.3f} ms")
    del args, got, again, want, batch
    torch.cuda.empty_cache()
    return dict(label=label, B=len(qs), Q=Qc, W=W, err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def check_wide(rng, dev, rows):
    """The last step: the band widths above 1024 that the pipeline can
    reach, K3 and its walk at W 1152, 2048, 4096, 8192, and past the old
    limit at 8320 and 16 384 (int32 cells), the K1 tables at
    TABLE_WIDE_SHAPES, K1l at LK_WIDE_SHAPES and counts at
    COUNTS_WIDE_SHAPES, each held to its check at the main shapes, and
    past the K1 family's old limit, 4096, the four kernels at K1_BEYOND;
    their times go into ``rows`` (the K3, walk, K1f, K1b, K1l and counts
    rows of the kernels line, by name)."""
    import torch

    by_name = {r["name"]: r for r in rows}
    for shape in TABLE_WIDE_SHAPES:
        res = _tables_case(rng, dev, *shape)
        for kind, name in (("fwd", "fwd_tables (K1f)"),
                           ("bwd", "bwd_tables (K1b)")):
            row = by_name[name]
            row[f"at_{shape[0]}"] = _at_table(res[kind])
            row["max_abs_err"] = max(row["max_abs_err"], res[kind]["err"])
        torch.cuda.empty_cache()
    for Wd in (1152, 2048, 4096, 8192, 8320, 16384):
        dp, tb = _k3_wide(rng, dev, Wd)
        by_name["edit_dp (K3)"][f"at_W{Wd}"] = dp
        by_name["edit_tb (K3 walk)"][f"at_W{Wd}"] = tb
        torch.cuda.empty_cache()
    lk_row = by_name["phmm_lk (K1l)"]
    for shape in LK_WIDE_SHAPES:
        r = _lk_case(rng, dev, *shape)
        lk_row[f"at_{r['label']}"] = _at(r)
        lk_row["max_abs_err"] = max(lk_row["max_abs_err"], r["err"])
    counts_row = by_name["phmm_counts (lk gradient)"]
    for shape in COUNTS_WIDE_SHAPES:
        r = _counts_case(rng, dev, *shape)
        counts_row[f"at_{r['label']}"] = _at(r)
        counts_row["max_abs_err"] = max(counts_row["max_abs_err"], r["err"])
    for W in K1_BEYOND:
        accept_k1_beyond_limit(rng, dev, W, by_name)
        torch.cuda.empty_cache()


# past the K1 family's old limit, 4096 (the scratch form): a short read
# against a long template widens the band there (``effective_band``)
K1_BEYOND = (4224, 8192)


def _beyond_pairs(rng, W, B=2, qlen=300):
    """B reads of ~``qlen`` bases from the two ends of a template W + 200
    long, in a band of W (what ``effective_band`` gives a pileup with such
    a read): the pair layout past the K1 family's old limit, at a size
    whose plain versions take seconds on the card."""
    import numpy as np

    from jtk_tpu_torch.io import sim
    from jtk_tpu_torch.ops.banded_align import linear_offsets

    tlen = W + 200
    tpl = sim.random_genome(rng, tlen)
    reads = [sim.noisy_read(rng, tpl[s:s + qlen], 0.05)
             for s in ((0, tlen - qlen) * B)[:B]]
    q_lens = np.array([len(r) for r in reads], np.int64)
    Q = ((int(q_lens.max()) + 63) // 64) * 64
    qs = np.full((B, Q), 4, np.int8)
    for b, r in enumerate(reads):
        qs[b, :len(r)] = r
    offs = np.stack([linear_offsets(int(n), tlen, Q, W) for n in q_lens])
    return tpl, qs, offs, q_lens


def accept_k1_beyond_limit(rng, dev, W, by_name):
    """K1f and K1b (float32 and float64), K1l and counts at band width W
    past the old limit of 4096 (the scratch form), against their plain
    versions at the main shapes' tolerances: tables rtol 2e-3 / atol 1e-5,
    cumulative log scales and lk rtol 1e-4 / atol 2e-2, counts rtol 1e-3 /
    atol 1e-4 and bitwise equal in two calls.  Times go into the rows of
    ``by_name`` as ``at_W{W}`` (``_f64`` for the float64 tables)."""
    import torch

    from jtk_tpu_torch.ops import phmm_grad as pg
    from jtk_tpu_torch.ops import phmm_lk as k1l
    from jtk_tpu_torch.ops import phmm_tables as pt
    from jtk_tpu_torch.ops.phmm import PHMMParams

    tpl, qs, offs, q_lens = _beyond_pairs(rng, W)
    B, Q = qs.shape
    tlen = len(tpl)
    rows = float(q_lens.sum())
    params = PHMMParams.default(dev)
    prep = pt.prep_tables_inputs(qs, tpl, offs, q_lens, tlen, params, W,
                                 device=dev)
    for type_name in ("f32", "f64"):
        dtype = _table_type(type_name)
        fwd_args, bwd_args, _aux = pt.kernel_inputs(prep, W, dtype)
        for kind, args, kern, plain, name in (
                ("fwd", fwd_args, pt.fwd_tables, pt.fwd_tables_plain,
                 "fwd_tables (K1f)"),
                ("bwd", bwd_args, pt.bwd_tables, pt.bwd_tables_plain,
                 "bwd_tables (K1b)")):
            got = kern(*args)
            plain_ms, want = timed_once(lambda: plain(*args))
            err = 0.0
            for g, w in zip(got[:3], want[:3]):
                if g.dtype != dtype or not torch.allclose(g, w, rtol=2e-3,
                                                          atol=1e-5):
                    raise AssertionError(
                        f"K1 {kind} W{W} {type_name}: tables differ (max "
                        f"{float((g - w).abs().max())})")
                err = max(err, float((g - w).abs().max()))
            cg, cw = torch.cumsum(got[3], 1), torch.cumsum(want[3], 1)
            if not torch.allclose(cg, cw, rtol=1e-4, atol=2e-2):
                raise AssertionError(
                    f"K1 {kind} W{W} {type_name}: log scales differ (max "
                    f"{float((cg - cw).abs().max())})")
            err = max(err, float((cg - cw).abs().max()))
            ms = cuda_time(lambda: kern(*args), reps=3)
            bound_ms, bound_by = roofline(nbytes(*args) + nbytes(*got),
                                          40.0 * W * rows)
            log(f"K1 {kind}_tables W{W} {type_name} B={B} Q={Q} (scratch "
                f"form, past the old limit 4096): max abs err {err:.3g}, "
                f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
                f"{bound_ms:.4f} ms")
            row = by_name[name]
            suffix = "" if type_name == "f32" else "_f64"
            row[f"at_W{W}{suffix}"] = dict(B=B, Q=Q, W=W, type=type_name,
                                           ms=ms, plain_ms=plain_ms,
                                           bound_ms=bound_ms)
            row["max_abs_err"] = max(row["max_abs_err"], err)
            del got, want
    tabs = k1l.tables8(params, dev)
    args = k1l.lk_inputs(qs, tpl, offs, q_lens, tlen, W, device=dev)
    got = k1l.phmm_lk(*args, *tabs)
    plain_ms, want = timed_once(lambda: k1l.phmm_lk_plain(*args, *tabs))
    if not torch.allclose(got, want, rtol=1e-4, atol=2e-2):
        raise AssertionError(f"K1l W{W}: lk differs from plain (max "
                             f"{float((got - want).abs().max())})")
    err = float((got - want).abs().max())
    ms = cuda_time(lambda: k1l.phmm_lk(*args, *tabs), reps=3)
    bound_ms, _by = roofline(nbytes(*args, *tabs) + 4 * B, 40.0 * W * rows)
    log(f"K1l phmm_lk W{W} B={B} Q={Q} (scratch form): max abs err "
        f"{err:.3g}, kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
        f"{bound_ms:.4f} ms")
    row = by_name["phmm_lk (K1l)"]
    row[f"at_W{W}"] = dict(B=B, Q=Q, W=W, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms)
    row["max_abs_err"] = max(row["max_abs_err"], err)
    batch = pg.PairBatch(qs, tpl, offs, q_lens, tlen, W, device=dev)
    cargs = pg.counts_args(pg.counts_prep(params, batch), W)
    got = pg.phmm_counts(*cargs)
    again = pg.phmm_counts(*cargs)
    plain_ms, want = timed_once(lambda: pg.phmm_counts_plain(*cargs))
    if not torch.allclose(got, want, rtol=1e-3, atol=1e-4):
        raise AssertionError(f"counts W{W}: kernel differs from plain (max "
                             f"{float((got - want).abs().max())})")
    if not torch.equal(got, again):
        raise AssertionError(f"counts W{W}: two calls differ")
    err = float((got - want).abs().max())
    ms = cuda_time(lambda: pg.phmm_counts(*cargs), reps=3)
    bound_ms, _by = roofline(nbytes(*cargs) + got.numel() * 4,
                             60.0 * W * (rows + B))
    log(f"counts W{W} B={B} Q={Q} (float64 tables of the scratch form): max "
        f"abs err {err:.3g}, bitwise equal in two calls, kernel {ms:.3f} "
        f"ms, plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms")
    row = by_name["phmm_counts (lk gradient)"]
    row[f"at_W{W}"] = dict(B=B, Q=Q, W=W, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms)
    row["max_abs_err"] = max(row["max_abs_err"], err)


# ---------------------------------------------------------------------------
# the MCMC chain
# ---------------------------------------------------------------------------


# (B chunks, S restarts, K, V, Rmax): path (b)'s clustered phase (27
# chunks, K 2, V 8 after padding), the recursive path's K 4 on one chunk,
# K 8 / V 40 (two column groups of 32, a run-time K: the general form),
# and a 1 Mb run's 414 chunks (VALIDATE_r05.json) at path (b)'s K and V
CHAIN_SHAPES = ((27, 20, 2, 8, 128), (1, 20, 4, 12, 64), (3, 4, 8, 40, 96),
                (414, 20, 2, 8, 128))
CHAIN_K_STEPS = 100_000   # a clustering call's steps: min(2000 Rmax, 1e5)


def _chain_case(rng, dev, B, S, K, V, Rmax):
    """Planted clusters for B chunks (reads Rmax - 0..7 each), the chain's
    start on the card (k-means++ and Lloyd from a seeded generator), its
    inputs and the generator for its draws."""
    import numpy as np
    import torch

    from jtk_tpu_torch.ops import cluster as pcl

    X = np.zeros((B, Rmax, V), np.float32)
    Rs = np.zeros(B, np.int64)
    for b in range(B):
        R = Rmax - int(rng.integers(0, 8))
        truth = rng.integers(0, K, R)
        x = rng.normal(0, 0.6, (R, V))
        for c in range(K):
            cols = np.arange(V) % K == c
            x[np.ix_(truth == c, cols)] += 2.0
            x[np.ix_(truth != c, cols)] -= 1.0
        X[b, :R] = x
        Rs[b] = R
    size_lk = np.stack([pcl.poisson_size_table(Rmax, Rmax / K, K)] * B)
    Xt = torch.tensor(X, device=dev)
    Rt = torch.tensor(Rs, device=dev)
    slt = torch.tensor(size_lk, device=dev)
    w = (torch.arange(Rmax, device=dev)[None] < Rt[:, None]).float()
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 30)))
    g0 = pcl._gumbel((B, S, K, Rmax), gen, dev)
    st = pcl.chain_start(Xt, w, slt, K, g0)
    return dict(X=Xt, R=Rt, size_lk=slt, st=st, gen=gen, Xnp=X, Rnp=Rs,
                size_np=size_lk)


def chain_bound(B, S, K, V, Rmax, T):
    """A draw block's bound (ms, and what bounds it), roofline: the draws,
    X, the size tables and the chain state read once, the state written
    once; ~20 K V operations a step and lane."""
    lanes = B * S
    state = lanes * (2 * Rmax + 3 * K * V + K + 2) * 4
    moved = (3 * T * lanes + B * Rmax * V + B * (Rmax + 1)) * 4 + 2 * state
    return roofline(moved, 20.0 * K * V * T * lanes)


def chain_latency(K, T, sm_ghz):
    """The chain's own bound (ms, and cycles a step): T steps of one step's
    dependent chain at the highest SM clock, the load of assign[i], the
    K-cluster column sum, the 5-step shuffle tree and its broadcast, the K
    size terms and the accept test."""
    cycles = (SMEM_LOAD_CYCLES + K * FP32_CYCLES + 5 * (SHFL_CYCLES +
              FP32_CYCLES) + SHFL_CYCLES + K * FP32_CYCLES + 2 * FP32_CYCLES)
    return T * cycles / sm_ghz / 1e6, cycles


def check_chain(rng, dev, sm_ghz):
    """The MCMC chain kernel against mcmc_chain_plain at CHAIN_SHAPES, from
    the same start and the same draws, over four draw blocks: every state
    tensor bit-exact after each block.  Timed per 1024-step launch (CUDA
    events) beside the plain block, and per clustering call of
    CHAIN_K_STEPS steps at path (b)'s shape (host clock, synchronised)."""
    import numpy as np
    import torch

    from jtk_tpu_torch.ops import cluster as pcl

    res = []
    for B, S, K, V, Rmax in CHAIN_SHAPES:
        case = _chain_case(rng, dev, B, S, K, V, Rmax)
        st, X, size_lk = case["st"], case["X"], case["size_lk"]
        plain = {k: v.clone() for k, v in st.items()}
        for blk in range(4):
            draws = pcl.block_draws(*pcl.generator_block(
                case["gen"], (pcl.DRAW_BLOCK, B, S), K, dev), case["R"],
                Rmax)
            pcl.mcmc_chain(st, X, size_lk, *draws)
            pcl.mcmc_chain_plain(plain, X, size_lk, *draws)
            torch.cuda.synchronize()
            for name, v in plain.items():
                if not torch.equal(st[name], v):
                    raise AssertionError(
                        f"mcmc_chain B={B} S={S} K={K} V={V}: {name} differs "
                        f"from the plain chain after block {blk}")
        ms = cuda_time(lambda: pcl.mcmc_chain(st, X, size_lk, *draws),
                       reps=5)
        form = getattr(pcl, "chain_form", lambda *a: "general")(K, V, Rmax)
        general_ms = None
        if form != "general":   # the general form on the same state
            general_ms = cuda_time(lambda: pcl.mcmc_chain(
                st, X, size_lk, *draws, general=True), reps=5)
        plain_ms = cuda_time(lambda: pcl.mcmc_chain_plain(
            plain, X, size_lk, *draws), reps=1, warmup=0)
        bound_ms, bound_by = chain_bound(B, S, K, V, Rmax, pcl.DRAW_BLOCK)
        chain_ms, cycles = chain_latency(K, pcl.DRAW_BLOCK, sm_ghz)
        log(f"mcmc_chain B={B} S={S} K={K} V={V} Rmax={Rmax}: bit-exact "
            f"over 4 blocks, kernel ({form} form) {ms:.3f} ms a "
            f"{pcl.DRAW_BLOCK}-step launch"
            + ("" if general_ms is None else
               f" (general form {general_ms:.3f} ms)")
            + f", plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), its chain {chain_ms:.3f} ms ({cycles} cycles a "
            f"step at {sm_ghz:.3f} GHz)")
        res.append(dict(B=B, S=S, K=K, V=V, Rmax=Rmax, ms=ms, form=form,
                        general_ms=general_ms,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, chain_ms=chain_ms,
                        chain_cycles_per_step=cycles))
        del case, st, plain
        torch.cuda.empty_cache()
    # one clustering call at path (b)'s shape: the seeding, the aggregates,
    # CHAIN_K_STEPS steps in blocks and the pick of the best restart
    B, S, K, V, Rmax = CHAIN_SHAPES[0]
    case = _chain_case(rng, dev, B, S, K, V, Rmax)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    assign, score = pcl.mcmc_cluster_batch(
        case["Xnp"], case["Rnp"], case["size_np"], K, CHAIN_K_STEPS, S,
        generator=gen, device=dev)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    if not np.isfinite(score).all():
        raise AssertionError("mcmc_cluster_batch: a score is not finite")
    blocks = -(-CHAIN_K_STEPS // pcl.DRAW_BLOCK)
    log(f"mcmc_cluster_batch B={B} S={S} K={K} V={V} Rmax={Rmax}, "
        f"{CHAIN_K_STEPS} steps ({blocks} launches): {call_s * 1e3:.1f} ms "
        f"a call (the chain's bound {res[0]['chain_ms'] * blocks:.1f} ms)")
    r0 = res[0]
    row = dict(name="mcmc_chain (MCMC chain)", route="cuda",
               source="jtk_tpu_torch/csrc/mcmc_chain.cu",
               replaces="jtk_tpu/ops/cluster.py:184 (the lax.scan of "
                        "mcmc_cluster_batch; no Pallas kernel)",
               max_abs_err=0.0, ms=r0["ms"], plain_ms=r0["plain_ms"],
               bound_ms=r0["bound_ms"], bound_by=r0["bound_by"],
               library_ms=None, chain_ms=r0["chain_ms"],
               general_form_ms=r0["general_ms"],
               k_call_ms=call_s * 1e3, k_call_steps=CHAIN_K_STEPS,
               shape=dict(B=B, S=S, K=K, V=V, Rmax=Rmax))
    for r in res[1:]:
        row[f"at_B{r['B']}_S{r['S']}_K{r['K']}_V{r['V']}"] = {
            k: r[k] for k in ("ms", "form", "general_ms", "plain_ms",
                              "bound_ms", "chain_ms")}
    return row


# ---------------------------------------------------------------------------
# the slice: reads -> GFA
# ---------------------------------------------------------------------------


def launch_counters():
    """The launch counters of the seven kernel wrappers (K3's DP and walk,
    K1f, K1b, K1l, counts, the MCMC chain), in the order of the kernels
    line."""
    from jtk_tpu_torch.ops import (cluster, edit_dp, phmm_grad, phmm_lk,
                                   phmm_tables)
    return [edit_dp.LAUNCHES, edit_dp.TB_LAUNCHES, phmm_tables.FWD_LAUNCHES,
            phmm_tables.BWD_LAUNCHES, phmm_lk.LAUNCHES, phmm_grad.LAUNCHES,
            cluster.CHAIN_LAUNCHES]


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
    # launch counts K3/walk/K1f/K1b/K1l/counts/chain so far
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


def run_pipeline_path(rng, keep="pipeline", resume=True, devices=None):
    """Path (b): the user's entry point, ``jtk pipeline -p profile.toml``
    through the port's CLI, on a fresh simulated region; then (``resume``)
    a resume rerun from the checkpoints.  Path (c) is the same run without
    the rerun, on the device set ``devices`` (the CLI's ``--devices``)."""
    # the checkpoints (tens of MB each) stay in a temporary directory; the
    # GFA, the timings and the log are copied beside the other outputs
    with tempfile.TemporaryDirectory(prefix="jtk_pipe_") as out:
        res = _pipeline_in(rng, out, resume, devices)
        keep = os.path.join(OUT_DIR, keep)
        os.makedirs(keep, exist_ok=True)
        for fn in ("pipe.gfa", "pipe.timings.tsv", "pipeline.log",
                   "profile.toml"):
            if os.path.exists(os.path.join(out, fn)):
                shutil.copy(os.path.join(out, fn), keep)
    return res


def _pipeline_in(rng, out, resume=True, devices=None):
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
    argv = ["pipeline", "-p", profile]
    if devices:
        argv += ["--devices", ",".join(devices)]
    t0 = time.time()
    with EmissionCheck() as emissions:   # model tuning's counts
        cli.main(argv)
    wall = time.time() - t0
    name = "path (c)" if devices and len(devices) > 1 else "path (b)"
    log(f"{name} cli pipeline: {wall:.1f} s")
    emis = emissions.result()
    log(f"{name} model tuning: {emis['pairs_off']} of {emis['pairs']} "
        f"pairs (over {emis['calls']} counts launches, "
        f"{emis['calls_with_off']} with any) emit M + I more than 1 % off "
        f"their q_len; worst relative difference {emis['worst_rel']}; "
        f"{emis['off_within_150']} of them start at most 150 bases late; "
        f"(bases late at the start, bases early at the end) of each: "
        f"{sorted(set(emis['off_start_late_end_early']))}")
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
    res = dict(n_reads=len(reads), wall_s=wall, phases_s=phases,
               chunks=len(ds.selected_chunks), phased_chunks=len(aris),
               aris=aris,
               mean_ari=float(np.mean(aris)) if aris else float("nan"),
               contigs=len(m["contigs"]), total_len=int(m["total_len"]),
               mean_error=float(m["mean_error"]), missing=missing, hmm=hmm,
               model_param=ds.model_param.to_json(), gfa=gfa,
               emissions=emis)
    if not resume:
        return res
    # resume: every phase checkpoint exists, so only assemble runs again
    os.remove(f"{stem}.gfa")
    write_profile(True)
    from jtk_tpu_torch.stages import consensus
    dump_sam, seen = consensus.dump_sam, []

    def keep_args(ds_, contigs, path, **kw):   # what the rerun dumps
        seen.append((ds_, contigs))
        return dump_sam(ds_, contigs, path, **kw)

    consensus.dump_sam = keep_args
    try:
        t0 = time.time()
        cli.main(argv)
        resume_s = time.time() - t0
    finally:
        consensus.dump_sam = dump_sam
    split = dump_sam_split(*seen[-1], out) if seen else None
    return dict(res, resumed=os.path.exists(f"{stem}.gfa"),
                resume_s=resume_s, dump_sam_split=split)


# ---------------------------------------------------------------------------
# the device set: path (c) and the multidevice phase
# ---------------------------------------------------------------------------


def _extend_batch(rng, n_reads=256, per_read=8, clen=2000, margin=200):
    """The mapper's candidate batch (B 2048 at its production chunk length
    and band): reads of a noisy chunk copy between random flanks, on
    either strand, each with a candidate for its chunk and ``per_read`` - 1
    for other chunks."""
    import numpy as np

    from jtk_tpu_torch import seq as seqmod
    from jtk_tpu_torch.io import sim
    from jtk_tpu_torch.mapper import Candidate

    chunks = {c: sim.random_genome(rng, clen) for c in range(32)}
    reads, cands = [], []
    for i in range(n_reads):
        c, fwd = i % 32, bool(i % 3)
        left = int(rng.integers(200, 400))
        body = sim.noisy_read(rng, chunks[c], 0.05)
        read = np.concatenate([sim.random_genome(rng, left), body,
                               sim.random_genome(rng, 300)]).astype(np.int8)
        start = left if fwd else len(read) - left - len(body)
        reads.append(read if fwd else seqmod.revcomp(read))
        cands.append(Candidate(i, c, fwd, start - margin, clen + 2 * margin,
                               40))
        for j in range(1, per_read):
            cands.append(Candidate(i, (c + j) % 32, fwd, start - margin,
                                   clen + 2 * margin, 3))
    return cands, reads, chunks, margin


def multidevice_phase(rng, n=4, dev="cuda"):
    """The twin of ``__graft_entry__.py::dryrun_multichip`` at the main
    path's shapes: the train step (10 steps, model tuning's B 40 / W 128),
    the sharded pileup lk, the k-mer histogram (path (b)'s ~3.6 M k-mers,
    k 12), one modtable engine call of 3 slices (polish's B 192 / W 128
    slices, gains reduced on the device) and one ``extend_candidates``
    batch (B 2048, W 256), each on the card alone and on the card listed
    ``n`` times (``dev``), compared bit for bit.  Returns (failures,
    record)."""
    import numpy as np
    import torch

    from jtk_tpu_torch import parallel as par
    from jtk_tpu_torch.mapper import extend_candidates
    from jtk_tpu_torch.ops import modtable as mt
    from jtk_tpu_torch.ops import phmm_grad as pg
    from jtk_tpu_torch.ops.phmm import PHMMParams
    from jtk_tpu_torch.runtime import use_devices

    tpl, qs, offs, q_lens, W = _pileup_pairs(rng, 40, 2000, 64, 128)
    wts = np.ones(len(qs), np.float32)
    kmers = rng.integers(0, 4 ** 12, 3_600_000)
    mtpl, mqs, moffs, mql, mW = _pileup_pairs(rng, 400, 2000, 64, 128)
    ext = _extend_batch(rng)

    def train():
        batch = pg.PairBatch(qs, tpl, offs, q_lens, len(tpl), W)
        theta = par.params_to_theta(PHMMParams.default())
        theta, losses = par.make_train_steps(W)(
            theta, batch, torch.as_tensor(wts, device=dev))
        return [theta[k] for k in par.KEYS] + [losses]

    def modtable():
        return list(mt.modification_table_pileup_pallas(
            mqs, mtpl, moffs, mql, np.int32(len(mtpl)), PHMMParams.default(),
            mW, len(mtpl), seg_ids=np.zeros(len(mqs), np.int32), n_seg=1,
            finish=False))

    def extend():
        cands, reads, chunks, margin = ext
        res = extend_candidates(cands, reads, chunks, W=256, margin=margin)
        return [[r["dist"], r["ops"], r["span_start"], r["span_end"]]
                for r in res]

    calls = {
        "train_steps": train,
        "pileup_lk": lambda: par.make_sharded_pileup_lk(W)(
            qs, tpl, offs, q_lens, len(tpl)),
        "kmer_hist": lambda: par.make_sharded_kmer_hist(4 ** 12)(kmers),
        "modtable_3_slices": modtable,
        "extend_candidates": extend,
    }
    counters = launch_counters()
    multi = sum(v for k, v in mt.SLICE_CALLS.items() if k >= 3)
    out, record = {}, {}
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    for devs in ([dev], [dev] * n):
        for name, fn in calls.items():
            for c in counters:
                c.reset()
            with use_devices(devs):
                sync()
                t0 = time.perf_counter()
                got = fn()
                sync()
                sec = time.perf_counter() - t0
            out[name, len(devs)] = got
            record[f"{name} x{len(devs)}"] = dict(
                s=sec, launches_by_entry={
                    c.name: dict(c.entries) for c in counters if c.count})
    failures = []

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return a.dtype == b.dtype and torch.equal(a, b.to(a.device))
        if isinstance(a, np.ndarray):
            return a.dtype == b.dtype and np.array_equal(a, b)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        return a == b

    for name in calls:
        ok = same(out[name, 1], out[name, n])
        record[f"{name} x{n}"]["bit_identical"] = ok
        log(f"multidevice {name}: card x1 {record[f'{name} x1']['s']:.3f} s,"
            f" card x{n} {record[f'{name} x{n}']['s']:.3f} s, launches by "
            f"entry {record[f'{name} x{n}']['launches_by_entry']}; "
            f"{'bit-identical' if ok else 'DIFFERENT'}")
        if not ok:
            failures.append(f"multidevice {name}: card x{n} differs from "
                            "card x1")
    hist = out["kmer_hist", 1].cpu().numpy()
    if not np.array_equal(hist, np.bincount(kmers, minlength=4 ** 12)):
        failures.append("multidevice kmer_hist differs from np.bincount")
    if sum(v for k, v in mt.SLICE_CALLS.items() if k >= 3) - multi < 2:
        failures.append("multidevice modtable call did not cut 3 slices")
    return failures, record


def compare_paths(b, c, name):
    """Failures where path ``name`` differs from path (b): the GFA byte for
    byte, the fitted HMMs of both strands bit for bit, the per-chunk ARI
    and the contig error (``gfa`` is the GFA's text)."""
    out = []
    if c["gfa"] != b["gfa"]:
        out.append(f"{name}: GFA differs from path (b)'s")
    if c["model_param"] != b["model_param"]:
        out.append(f"{name}: fitted HMMs differ from path (b)'s")
    for key in ("aris", "mean_error", "contigs", "total_len", "chunks"):
        if c[key] != b[key]:
            out.append(f"{name}: {key} {c[key]} != path (b)'s {b[key]}")
    return out


def cross_card_paths():
    """On a host with several cards: path (b) on ``cuda:0`` and path (c)
    over every card, in turns b, c, c, b, each (c) held against the first
    (b); prints the comparisons and one JSON line of walls, phases,
    launches by entry and peak memory by card.  Run it as ``python3 -c
    "import chip_smoke; chip_smoke.cross_card_paths()"``."""
    import numpy as np
    import torch

    from jtk_tpu_torch.runtime import set_device
    from jtk_tpu_torch.stages import likelihood_gains
    set_device("cuda")
    torch.cuda.init()   # the peak-memory resets need the allocator
    cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    res, out = {}, []
    for name, devs in (("b", ["cuda:0"]), ("c", cards), ("c2", cards),
                       ("b2", ["cuda:0"])):
        likelihood_gains._GAINS_CACHE.clear()
        counters = launch_counters()
        for x in counters:
            x.reset()
        for i in range(len(cards)):
            torch.cuda.reset_peak_memory_stats(i)
        r = run_pipeline_path(np.random.default_rng(SEED + 2), "x4_" + name,
                              False, devs)
        r["launches_by_entry"] = {x.name: dict(x.entries) for x in counters}
        r["peak_gib"] = peak_memory_by_device(cards)
        res[name] = r
        out.append(dict(name=name, devices=devs, wall_s=r["wall_s"],
                        phases_s=r["phases_s"],
                        launches_by_entry=r["launches_by_entry"],
                        peak_gib=r["peak_gib"]))
    for n in ("c", "c2", "b2"):
        print(n, "against b:", compare_paths(res["b"], res[n], n)
              or "identical")
    print(json.dumps(out))


def peak_memory_by_device(devs) -> dict:
    """Peak device memory (GiB) of each card in ``devs``."""
    import torch
    idx = sorted({torch.device(d).index or 0 for d in devs})
    return {f"cuda:{i}": torch.cuda.max_memory_allocated(i) / 2 ** 30
            for i in idx}


# ---------------------------------------------------------------------------
# each kernel at the main path's own launch shapes
# ---------------------------------------------------------------------------


def _random_pairs(rng, B, Q, W):
    """B reads of up to Q bases against their own random templates, each
    reachable in a band of W (q_len within W/4 of t_len): qs (B, Q),
    templates (B, T), offsets, q_lens, t_lens."""
    import numpy as np

    from jtk_tpu_torch.io import sim
    from jtk_tpu_torch.ops.banded_align import linear_offsets

    T = Q + 32
    qs = np.full((B, Q), 4, np.int8)
    rs = np.full((B, T), 4, np.int8)
    q_lens = np.zeros(B, np.int64)
    t_lens = np.zeros(B, np.int64)
    offs = np.zeros((B, Q + 1), np.int64)
    for b in range(B):
        t = sim.random_genome(rng, Q - int(rng.integers(0, max(1, min(
            W // 4, Q // 8)))))
        r = sim.noisy_read(rng, t, 0.05)[:Q]
        if len(t) - len(r) >= W - 2:   # keep the end reachable
            r = np.concatenate([r, t[len(r):]])[:Q]
        qs[b, :len(r)], rs[b, :len(t)] = r, t
        q_lens[b], t_lens[b] = len(r), len(t)
        offs[b] = linear_offsets(len(r), len(t), Q, W)
    return qs, rs, offs, q_lens, t_lens


def _shape_call(kind, rng, dev, B, Q, W, *rest):
    """A call of kernel ``kind`` (a launch counter's name) at launch shape
    (B, Q, W) (the tables' also with their type; the chain's is (B, S, K,
    V, Rmax)) on synthetic pairs of that shape, and its bound (ms): the
    inputs read and outputs written once over the memory rate, or the
    operations of the rows these pairs need over the fp32 rate."""
    import torch

    from jtk_tpu_torch.ops import edit_dp as k3
    from jtk_tpu_torch.ops import phmm_grad as pg
    from jtk_tpu_torch.ops import phmm_lk as k1l
    from jtk_tpu_torch.ops import phmm_tables as pt
    from jtk_tpu_torch.ops.phmm import PHMMParams

    def bound(args, out_bytes, ops):
        return roofline(nbytes(*args) + out_bytes, ops)[0]

    params = PHMMParams.default(dev)
    if kind == "mcmc_chain":
        from jtk_tpu_torch.ops import cluster as pcl
        S, K, V, Rmax = Q, W, *rest
        case = _chain_case(rng, dev, B, S, K, V, Rmax)
        draws = pcl.block_draws(*pcl.generator_block(
            case["gen"], (pcl.DRAW_BLOCK, B, S), K, dev), case["R"], Rmax)
        return (lambda: pcl.mcmc_chain(case["st"], case["X"],
                                       case["size_lk"], *draws),
                chain_bound(B, S, K, V, Rmax, pcl.DRAW_BLOCK)[0])
    if kind in ("edit_dp", "edit_tb"):
        # K3 and its walk run every one of the Q rows of every pair
        args, off = _k3_random(rng, dev, B, Q, W)
        dp, tb = k3_bounds(B, Q, W, B * Q)
        if kind == "edit_dp":
            return lambda: k3.edit_dp(*args), dp[0]
        packed, last = k3.edit_dp(*args)
        qlen, tl = args[6], args[7]
        _s, end = k3.select_end(last, off, qlen.long(), tl.long(), W,
                                "infix")
        return (lambda: k3.traceback_packed(packed, off, qlen, end, W),
                tb[0])
    qs, rs, offs, q_lens, t_lens = _random_pairs(rng, B, Q, W)
    rows = float(q_lens.sum())
    if kind == "phmm_lk":
        args = k1l.lk_inputs(qs, rs, offs, q_lens, t_lens, W, device=dev)
        tabs = k1l.tables8(params, dev)
        return (lambda: k1l.phmm_lk(*args, *tabs),
                bound(args + tabs, 4 * B, 40.0 * W * rows))
    prep = pt.prep_tables_inputs(qs, rs, offs, q_lens, t_lens, params, W,
                                 device=dev)
    if kind == "phmm_counts":
        args = pg.counts_args(prep, W)
        return (lambda: pg.phmm_counts(*args),
                bound(args, 4 * B * pg.N_COUNTS, 60.0 * W * (rows + B)))
    dtype = _table_type(rest[0] if rest else "f32")
    fwd_args, bwd_args, _aux = pt.kernel_inputs(prep, W, dtype)
    args = fwd_args if kind == "fwd_tables" else bwd_args
    kern = pt.fwd_tables if kind == "fwd_tables" else pt.bwd_tables
    size = 8 if dtype == torch.float64 else 4
    return (lambda: kern(*args),
            bound(args, size * B * Q * (3 * W + 1), 40.0 * W * rows))


def time_path_shapes(rng, dev, path_shapes, top=3):
    """Time each kernel once at the main path's most-launched shapes (the
    ``top`` of each kernel's launches by shape, ``path_shapes``: {kernel:
    Counter of (B, Q, W)}, taken from the counters after the path), and K3
    and its walk at every shape they were launched at, beside each shape's
    bound, and print launches x time and launches x (time - bound).
    Returns {kernel: [[B, Q, W], launches, ms, bound_ms]}."""
    import torch

    out = {}
    for name, shapes in path_shapes.items():
        count = sum(shapes.values())
        if name in ("edit_dp", "edit_tb"):
            picked = sorted(shapes)
        else:
            picked = [s for s, _n in shapes.most_common(top)]
        rows = []
        for shape in picked:
            fn, bound_ms = _shape_call(name, rng, dev, *shape)
            rows.append([list(shape), shapes[shape], cuda_time(fn, reps=3),
                         bound_ms])
            del fn
            torch.cuda.empty_cache()
        total = sum(n * ms for _s, n, ms, _b in rows)
        gap = sum(n * (ms - b) for _s, n, ms, b in rows)
        covered = sum(n for _s, n, _ms, _b in rows)
        log(f"path (b) {name} at its shapes: " + ", ".join(
            f"{tuple(s)} {n} x {ms:.3f} ms (bound {b:.4f})"
            for s, n, ms, b in rows)
            + f"; launches x time {total:.1f} ms, x (time - bound) "
            f"{gap:.1f} ms, over {covered} of {count} launches")
        out[name] = rows
    return out


def sm_clock_ghz() -> float:
    """The card's highest SM clock (GHz), from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return float(out[0]) / 1e3


def sass_report(lib: str, kernels) -> list[str]:
    """``cuobjdump -sass`` of built library ``lib``, saved under OUT_DIR;
    for each function whose name holds one of ``kernels`` (name, anchor of
    its row loop), print the loop's instructions, static stall cycles and
    scoreboard waits (tools/sass_loop_stats) and its barriers.  Returns the
    failures: a barrier on barrier 0 (the whole block) in such a loop."""
    from jtk_tpu_torch.ops import cuda_build
    from jtk_tpu_torch.tools import sass_loop_stats as sls

    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", cuda_build.lib_path(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"{lib}.sass"), "w") as f:
        f.write(text)
    failures = []
    for name, body in sls.functions(text):
        for kernel, anchor in kernels:
            if kernel not in name:
                continue
            loop = sls.loop_body(body, anchor)
            if loop is None:
                failures.append(f"{name}: no row loop found at {anchor}")
                continue
            n, stalls, waits = sls.loop_stats(body, anchor)
            bars = [t for t, _c in loop if t.startswith("BAR.")]
            block = [t for t in bars if re.search(r"BAR\.SYNC\S*\s+0x0\b", t)]
            log(f"sass {name[:64]}: row loop {n} instructions, {stalls} "
                f"stall cycles, {waits} scoreboard waits; barriers "
                f"{bars or 'none'}")
            if block:
                failures.append(f"{name}: a block-wide barrier in its row "
                                f"loop ({block})")
    return failures


class EmissionCheck:
    """Wraps the counts kernel's wrapper for the length of a run and counts,
    on the card, the pairs whose M + I emission counts differ from their
    q_len by more than 1 % (each query base is emitted once): the late-start
    fault of the counts (PERF.md §7).  Each such pair is kept with how late
    its read starts, the column of the backward table's largest cell at row
    0 (a linear band starts at column 0), and how early it ends, the
    template's end less the column of the forward table's largest cell at
    the read's last row (where an end that falls under the EPS floor of
    log(fin + EPS) shows).  Adds no host synchronisation."""

    def __enter__(self):
        import torch

        from jtk_tpu_torch.ops import phmm_grad as pg
        self.pg, self.orig = pg, pg.phmm_counts
        self.calls, self.off, self.pairs = 0, [], 0
        self.worst, self.where = [], []

        def wrapped(*a):
            out = self.orig(*a)
            fM, fI, fD, bM, bI, bD = a[:6]
            rcs, shifts, ql = a[8], a[10], a[11]
            qlen = ql.to(torch.float32)
            rel = (out[:, 9:].sum(1) - qlen).abs() / qlen.clamp(min=1)
            bad = rel > 0.01
            self.off.append(bad.sum())
            self.worst.append(rel.max())
            q = ql.to(torch.int64)
            b = torch.arange(len(q), device=q.device)
            off = torch.cat([torch.zeros_like(shifts[:, :1]),
                             torch.cumsum(shifts, 1)], 1)[b, q]
            ks = torch.arange(rcs.shape[2], device=q.device)
            t_len = off + torch.where(rcs[b, q] != 4, ks, -1).max(1).values
            start = (bM[:, 0] + bI[:, 0] + bD[:, 0]).argmax(1)
            end = off + (fM[b, q] + fI[b, q] + fD[b, q]).argmax(1)
            self.where.append(torch.where(
                bad[:, None], torch.stack([start, t_len - end], 1), -1))
            self.calls += 1
            self.pairs += len(qlen)
            return out

        pg.phmm_counts = wrapped
        return self

    def __exit__(self, *exc):
        self.pg.phmm_counts = self.orig

    def result(self):
        import torch
        if not self.calls:
            return dict(calls=0, pairs=0, pairs_off=0, calls_with_off=0,
                        worst_rel=None, off_start_late_end_early=[],
                        off_within_150=0)
        # the launches may have run on several cards
        off = torch.stack([x.cpu() for x in self.off])
        where = torch.cat([x.cpu() for x in self.where])
        where = sorted(tuple(int(x) for x in w) for w in where
                       if int(w[0]) >= 0)
        return dict(calls=self.calls, pairs=self.pairs,
                    pairs_off=int(off.sum()),
                    calls_with_off=int((off > 0).sum()),
                    worst_rel=max(float(x) for x in self.worst),
                    off_start_late_end_early=where,
                    off_within_150=sum(s <= 150 for s, _e in where))


def dump_sam_split(ds, contigs, out):
    """One more ``dump_sam`` call on the path's final dataset and contigs,
    outside the timed path: the seconds in K3's DP (edit_dp), in its walk
    (traceback_packed) and the rest (host), each from synchronised timers.
    Its launches are not counted (the counters are restored)."""
    import torch

    from jtk_tpu_torch.ops import edit_dp as k3
    from jtk_tpu_torch.stages import consensus

    spent = {"edit_dp": 0.0, "traceback_packed": 0.0}
    orig = {n: getattr(k3, n) for n in spent}

    def timed(name):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = orig[name](*a, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t
            return r
        return call

    snap = [(c.count, c.shapes.copy(), c.entries.copy())
            for c in launch_counters()]
    for n in spent:
        setattr(k3, n, timed(n))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        consensus.dump_sam(ds, contigs, os.path.join(out, "split.sam"))
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for n, f in orig.items():
            setattr(k3, n, f)
        for c, (n, shapes, entries) in zip(launch_counters(), snap):
            c.count, c.shapes, c.entries = n, shapes, entries
    res = dict(total_s=total, k3_dp_s=spent["edit_dp"],
               walk_s=spent["traceback_packed"],
               host_s=total - sum(spent.values()))
    log(f"dump_sam split: {total:.2f} s, K3 DP {res['k3_dp_s']:.3f} s, walk "
        f"{res['walk_s']:.3f} s, host {res['host_s']:.2f} s")
    return res


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
    from jtk_tpu_torch.tools import sass_loop_stats as sls

    # selecting cuda turns TF32 off: full fp32 in the one-hot segment sums
    set_device("cuda")
    dev = torch.device("cuda")
    t_all = time.time()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; jtk_tpu_torch from {HERE}")

    t0 = time.time()
    cuda_build.build(LIBRARIES)
    log(f"build: {time.time() - t0:.1f} s")
    # the row-wavefront kernels keep a thread's band lanes in registers at
    # every geometry (ops/phmm_tables.py::tables_geometry,
    # ops/edit_dp.py::edit_dp_geometry; the K1 family's wide form its
    # row's temporaries), the counts kernel its 45 accumulators and the
    # chain its step: a spill of any of them breaks that
    spills = []
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as f:
        for name, text in cuda_build.BUILD_LOG.items():
            f.write(f"== {name}\n{text}\n")
    for name, text in cuda_build.BUILD_LOG.items():
        fn = ""
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:   # _Z17fwd_tables_kernelIfLi4ELi1EEv... -> ...<f,4,1>
                fn = m.group(1)
                mm = re.match(r"_Z\d+([A-Za-z_]\w*?)I([fd]?)((?:L[ib]\d+E)+)E",
                              fn)
                if mm:
                    fn = (mm.group(1) + "<" + ",".join(
                        ([mm.group(2)] if mm.group(2) else [])
                        + re.findall(r"L[ib](\d+)E", mm.group(3))) + ">")
            elif "registers" in line or "spill" in line:
                log(f"ptxas {name} {fn}: {line.strip()}")
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if name in NO_SPILL and m and (int(m.group(1))
                                               or int(m.group(2))):
                    spills.append(f"{fn} spills ({line.strip()})")

    # K3's row loops (the warp form, at W <= 2048) and the walk's step loop
    # hold no block-wide barrier (a tree without the tool's helpers skips)
    if hasattr(sls, "functions"):
        spills += sass_report("edit_dp", (("edit_dp_warp", "SHFL.UP"),
                                          ("edit_tb_kernel", "SHFL.IDX")))
        spills += sass_report("mcmc_chain", (("mcmc_chain", "SHFL.DOWN"),))
    sm_ghz = sm_clock_ghz()
    log(f"highest SM clock {sm_ghz:.3f} GHz")
    rng = np.random.default_rng(SEED)
    rows = list(check_k3(rng, dev, sm_ghz))
    torch.cuda.empty_cache()
    rows += check_tables(rng, dev)
    torch.cuda.empty_cache()
    rows.append(check_lk(rng, dev))
    torch.cuda.empty_cache()
    rows.append(check_counts(rng, dev))
    torch.cuda.empty_cache()
    rows.append(check_chain(rng, dev, sm_ghz))
    torch.cuda.empty_cache()
    check_wide(rng, dev, rows)
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
    # one device (``--devices cuda``, also on a host with several cards):
    # the reference path (c) is held against
    res_b = run_pipeline_path(np.random.default_rng(SEED + 2),
                              devices=["cuda"])
    launches_b = [c.count for c in counters]
    shapes_b = {c.name: c.shapes.copy() for c in counters}
    gfa_b = res_b.pop("gfa")
    log("path (b) pipeline: " + json.dumps(res_b))
    log(f"path (b) peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for phase, sec in res_b["phases_s"].items():
        log(f"phase {phase}: {sec:.1f} s")
    # where each kernel's launches on the main path go, by (B, Q, W): the
    # launches x time of a kernel at the shapes the pipeline uses
    res_b["launch_shapes_top5"] = {}
    for name, shapes in shapes_b.items():
        top = shapes.most_common(5)
        log(f"path (b) {name} launches by shape (B, Q, W), top 5 of "
            f"{len(shapes)}: " + ", ".join(f"{s}={n}" for s, n in top))
        res_b["launch_shapes_top5"][name] = [[list(s), n] for s, n in top]
    res_b["shape_times"] = time_path_shapes(np.random.default_rng(SEED + 3),
                                            dev, shapes_b)
    for strand, h in res_b["hmm"].items():
        log(f"fitted {strand} HMM: trans {h['trans']}, mat_emit diagonal "
            f"{h['mat_emit_diag']}")
    torch.cuda.empty_cache()
    # path (c): path (b)'s run on the card listed four times (every split,
    # per-shard launch and merge of the sharded paths, on one card), and
    # over every card where there are several; no resume rerun
    from jtk_tpu_torch.ops import modtable as mt
    sets = [["cuda"] * 4]
    if torch.cuda.device_count() > 1:
        sets.append([f"cuda:{i}" for i in range(torch.cuda.device_count())])
    res_c, path_failures = [], []
    from jtk_tpu_torch.stages import likelihood_gains
    for devs in sets:
        name = f"path (c) {'+'.join(devs)}"
        # the gain calibration is cached in the process: path (c) redoes
        # path (b)'s
        likelihood_gains._GAINS_CACHE.clear()
        for c in counters:
            c.reset()
        mt.SLICE_CALLS.clear()
        for i in range(torch.cuda.device_count()):
            torch.cuda.reset_peak_memory_stats(i)
        r = run_pipeline_path(np.random.default_rng(SEED + 2),
                              keep=f"pipeline_c{len(res_c)}", resume=False,
                              devices=devs)
        r.update(devices=devs, launches={c.name: c.count for c in counters},
                 launches_by_entry={c.name: dict(sorted(c.entries.items()))
                                    for c in counters},
                 peak_gib_by_device=peak_memory_by_device(devs),
                 modtable_calls_by_slices=dict(sorted(mt.SLICE_CALLS.items())))
        path_failures += compare_paths(dict(res_b, gfa=gfa_b), r, name)
        path_failures += [f"{name}: {k} never launched"
                          for k, v in r["launches"].items() if v == 0]
        r["gfa_identical"] = r.pop("gfa") == gfa_b
        log(f"{name}: " + json.dumps(r))
        log(f"{name} launches (path (b)'s in brackets): " + ", ".join(
            f"{c.name}={r['launches'][c.name]} ({n})"
            for c, n in zip(counters, launches_b)))
        log(f"{name} launches by entry of the device set: "
            + json.dumps(r["launches_by_entry"]))
        log(f"{name} peak device memory by card (GiB): "
            + json.dumps(r["peak_gib_by_device"]))
        log(f"{name} modtable engine calls by their number of slices: "
            + json.dumps(r["modtable_calls_by_slices"]))
        res_c.append(r)
        torch.cuda.empty_cache()
    md_failures, res_md = multidevice_phase(np.random.default_rng(SEED + 4))
    path_failures += md_failures
    for row, na, nb in zip(rows, launches_a, launches_b):
        row["launches"] = nb
        row["launches_slice"] = na
    log("kernel launches, path (a) slice / path (b) pipeline: "
        + ", ".join(f"{r['name']}={r['launches_slice']}/{r['launches']}"
                    for r in rows))
    failures = [f"{r['name']} never launched on the pipeline" for r in rows
                if r["launches"] == 0]
    # the slice has no model tuning, so no gradient
    failures += [f"{r['name']} never launched on the slice" for r in rows
                 if r["launches_slice"] == 0
                 and r["name"] != "phmm_counts (lk gradient)"]
    failures += spills
    failures += path_failures
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
                       pipeline=res_b, path_c=res_c, multidevice=res_md,
                       total_s=time.time() - t_all), f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
