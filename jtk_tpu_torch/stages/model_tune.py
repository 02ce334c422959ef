"""HMM fitting: strand-specific pair-HMM parameters by gradient EM.

Reference: ``haplotyper/src/model_tune.rs:94-156`` — picks <=5 median-coverage
chunk pileups, then iterates (polish -> Baum-Welch fit) with kiley's
``fit_antidiagonal_par_multiple``.

Counterpart of ``jtk_tpu/stages/model_tune.py``: gradient ascent on the sum
of read log-likelihoods over log-domain (softmax) parameters, whose
gradient is the expected-count Baum-Welch statistic.  The port's step
(:mod:`jtk_tpu_torch.parallel`) takes lk from the K1l kernel and its
gradient from the K1 tables and the counts kernel, the reads sharded over
the device set (:func:`jtk_tpu_torch.runtime.devices`), as ``jtk_tpu``
shards them over its mesh; the fit is the same bits at any device count.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .. import seq as seqmod
from .. import trace
from ..datamodel import DataSet, HMMParam, ReadType
from ..ops.banded_align import linear_offsets
from ..ops.phmm import PHMMParams, _np, likelihood_pileup
from ..ops.polish import effective_band, polish_until_converge

logger = logging.getLogger(__name__)


PAD_MULTIPLE = 8  # fixed batch padding, as in the reference
N_INNER = 10      # steps between convergence checks


def _fit_strand(reads: list[np.ndarray], template: np.ndarray,
                init: PHMMParams, W: int, steps: int = 60,
                lr: float = 0.05, clip: float = 1.0):
    """Fit one strand's HMM with the gradient-EM train step."""
    from ..ops.phmm_grad import PairBatch
    from ..parallel import (make_train_steps, params_to_theta, shard_batch,
                            theta_to_params)
    from ..runtime import devices

    if not reads:
        return init
    devs = devices()
    dev = devs[0]
    t_len = len(template)
    Qpad = ((max(len(r) for r in reads) + 63) // 64) * 64
    qs = np.full((len(reads), Qpad), 4, np.int8)
    for i, r in enumerate(reads):
        qs[i, :len(r)] = r
    q_lens = np.array([len(r) for r in reads], np.int32)
    W = effective_band(W, q_lens, t_len)
    offs = np.stack([linear_offsets(int(l), t_len, Qpad, W) for l in q_lens])

    # drop outlier reads that barely fit the template (their underflowed
    # forward rows produce non-finite gradients)
    lks = likelihood_pileup(qs, template, offs, q_lens, t_len, init, W)
    keep = lks / np.maximum(q_lens, 1) > -2.0
    if keep.sum() < 2:
        return init
    qs, offs, q_lens = qs[keep], offs[keep], q_lens[keep]

    # pad the batch to a fixed multiple with weight-0 stub reads
    n = len(qs)
    N = ((n + PAD_MULTIPLE - 1) // PAD_MULTIPLE) * PAD_MULTIPLE
    wts = np.zeros(N, np.float32)
    wts[:n] = 1.0
    if N > n:
        # weight-0 duplicates of the first read keep every row's band valid
        qs = np.concatenate([qs, np.tile(qs[:1], (N - n, 1))])
        offs = np.concatenate([offs, np.tile(offs[:1], (N - n, 1))])
        q_lens = np.concatenate(
            [q_lens, np.full(N - n, q_lens[0], np.int32)])

    # prepared once on the primary, cut once over the device set
    batch = shard_batch(PairBatch(qs, np.asarray(template, np.int8), offs,
                                  q_lens, t_len, W, device=dev), devs)
    wts_d = torch.as_tensor(wts, device=dev)
    steps_fn = make_train_steps(W, lr=lr, clip=clip, n_inner=N_INNER,
                                devices=devs)
    theta = params_to_theta(init, device=dev)
    prev = None
    best = theta
    for it in range(0, steps, N_INNER):
        with trace.span("model_tune.steps", device=True):
            theta, losses = steps_fn(theta, batch, wts_d)
        losses = losses.cpu().numpy().astype(np.float64)
        if not np.all(np.isfinite(losses)) or any(
                not bool(torch.isfinite(x).all()) for x in theta.values()):
            logger.warning("model fit diverged in steps %d..%d; keeping "
                           "previous", it, it + N_INNER)
            theta = best
            break
        best = theta
        seq = ([prev] if prev is not None else []) + losses.tolist()
        if any(abs(b - a) < 1e-4 for a, b in zip(seq, seq[1:])):
            break
        prev = losses[-1]
    out = theta_to_params(theta)
    if any(not bool(torch.isfinite(x).all()) for x in out):
        return init
    return out


def _params_to_hmmparam(p: PHMMParams) -> HMMParam:
    t = _np(p.trans).astype(np.float64)
    return HMMParam(
        mat_mat=float(t[0, 0]), mat_ins=float(t[0, 1]), mat_del=float(t[0, 2]),
        ins_mat=float(t[1, 0]), ins_ins=float(t[1, 1]), ins_del=float(t[1, 2]),
        del_mat=float(t[2, 0]), del_ins=float(t[2, 1]), del_del=float(t[2, 2]),
        mat_emit=_np(p.mat_emit).astype(np.float64).reshape(-1).tolist(),
        ins_emit=_np(p.ins_emit).astype(np.float64).reshape(-1).tolist(),
    )


def update_models_on_both_strands(ds: DataSet, n_chunks: int = 3,
                                  cap: int = 40, seed: int = 42,
                                  polish_rounds: int = 2) -> DataSet:
    """Fit forward/reverse HMMs on median-coverage chunk pileups."""
    pileups: dict[int, list] = {}
    for er in ds.encoded_reads:
        for n in er.nodes:
            pileups.setdefault(n.chunk, []).append(
                (seqmod.encode(n.seq), n.is_forward))
    if not pileups:
        return ds
    sizes = sorted(pileups.items(), key=lambda kv: len(kv[1]))
    mid = len(sizes) // 2
    chosen = sizes[max(0, mid - n_chunks // 2): mid + (n_chunks + 1) // 2]
    chunks = {c.id: c for c in ds.selected_chunks}
    params_f = PHMMParams.from_hmmparam(ds.model_param.forward)
    params_r = PHMMParams.from_hmmparam(ds.model_param.reverse)
    rng = np.random.default_rng(seed)
    for _ in range(polish_rounds):
        for cid, pu in chosen:
            chunk = chunks[cid]
            reads = [s for s, _ in pu]
            strands = [f for _, f in pu]
            band = max(ReadType.band_width(ds.read_type, len(chunk.seq)), 64)
            band = ((band + 63) // 64) * 64
            sel = rng.permutation(len(reads))[:cap]
            template, _ = polish_until_converge(
                chunk.codes(), [reads[i] for i in sel], params_f, W=band,
                max_rounds=4)
            chunk.seq = seqmod.decode(template).decode()
            fwd = [r for r, s in zip(reads, strands) if s][:cap]
            rev = [r for r, s in zip(reads, strands) if not s][:cap]
            params_f = _fit_strand(fwd, template, params_f, band)
            params_r = _fit_strand(rev, template, params_r, band)
    ds.model_param.forward = _params_to_hmmparam(params_f)
    ds.model_param.reverse = _params_to_hmmparam(params_r)
    logger.info("model_tune: fitted on %d pileups", len(chosen))
    ds.push_stage("ModelFit", [])
    return ds
