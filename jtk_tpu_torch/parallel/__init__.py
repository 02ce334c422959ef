"""Gradient EM for the pair-HMM, and data parallelism over a device set.

Counterpart of ``jtk_tpu/parallel/__init__.py``.  ``jtk_tpu`` shards over a
1-D ``data`` mesh of every local device, in one process; the port shards
over :func:`jtk_tpu_torch.runtime.devices`, in one process too and with no
process group.  A shard is a contiguous run of rows (:func:`shard_leading`)
whose kernels run on its own entry of the set; the merges are plain tensor
moves to the primary (the set's first entry): an all-gather is a
``torch.cat`` of the shards in order (:func:`gather`), a psum of integers a
sum in shard order, and a float sum over reads runs once, on the primary,
over the gathered tensor of the same shape as on one device.  So every
sharded path gives the same bits at any device count.  Each shard's work
is queued before any result is read back (no host sync inside a shard
loop), so the cards of a set overlap.

* the log-domain parameterisation (``params_to_theta`` /
  ``theta_to_params``);
* the train step (``make_train_step`` / ``make_train_steps``): reads
  sharded, each shard's lk from the K1l kernel and its per-read counts from
  the float64 K1 tables and the counts kernel
  (:func:`~..ops.phmm_grad.pair_lk`, :func:`~..ops.phmm_grad.pair_counts`),
  both gathered in read order, and the gradient's one sum over the reads
  on the primary, through the autograd softmax;
* ``make_sharded_pileup_lk`` (K1l per shard, gathered) and
  ``make_sharded_kmer_hist`` (a bincount per shard, summed).

The step keeps the reference's semantics: per-read losses ``-lk * w``
summed in a fixed-shape sum (weight-0 stub reads pad the batch), then in
this order: non-finite gradient entries zeroed, division by
``max(total_bp, 1)``, a global-norm clip, the step.  The loss returned is
the one before the update.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops import cuda_build
from ..ops.phmm import PHMMParams
from ..ops.phmm_grad import PairBatch, pair_counts, pair_lk, param_grads
from ..ops.phmm_lk import lk_inputs, phmm_lk, tables8
from ..runtime import resolve_set

KEYS = ("trans", "mat_emit", "ins_emit")


def shard_bounds(n: int, k: int) -> list[tuple[int, int]]:
    """(start, stop) of ``k`` contiguous shards of ``n`` rows, in order:
    the first ``n % k`` hold one row more, and shards past ``n`` rows are
    empty."""
    q, r = divmod(n, k)
    out, a = [], 0
    for i in range(k):
        b = a + q + (i < r)
        out.append((a, b))
        a = b
    return out


@contextlib.contextmanager
def on_entry(i: int):
    """Count the enclosed launches for entry ``i`` of the device set
    (:class:`~..ops.cuda_build.Launches`' ``entries``)."""
    token = cuda_build.ENTRY.set(i)
    try:
        yield
    finally:
        cuda_build.ENTRY.reset(token)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) \
        else torch.as_tensor(np.ascontiguousarray(x))


def shard_leading(devs, *tensors):
    """Each tensor (or numpy array) cut on its leading axis into one
    contiguous shard per entry of ``devs`` (default: the current set), in
    order, shard i on ``devs[i]``: a list of shards per tensor
    (:func:`shard_bounds`: uneven or empty shards are fine)."""
    devs = resolve_set(devs)
    out = []
    for t in tensors:
        t = _tensor(t)
        out.append([t[a:b].to(d) for (a, b), d in
                    zip(shard_bounds(len(t), len(devs)), devs)])
    return out


def replicate(devs, *tensors):
    """Each tensor (or numpy array) on every entry of ``devs`` (default:
    the current set): a list of copies per tensor, one copy a distinct
    device (entries on one device share it, as do entries on the tensor's
    own device)."""
    devs = resolve_set(devs)
    out = []
    for t in tensors:
        t = _tensor(t)
        copies = {d: t.to(d) for d in dict.fromkeys(devs)}
        out.append([copies[d] for d in devs])
    return out


def gather(shards, dev) -> torch.Tensor:
    """The shards concatenated in order on ``dev`` (the all-gather)."""
    shards = [s.to(dev) for s in shards]
    return shards[0] if len(shards) == 1 else torch.cat(shards)


def shard_batch(batch: PairBatch, devices=None) -> list[PairBatch]:
    """``batch`` cut into contiguous shards of pairs, one per entry of the
    device set (default: the current set) that gets any pair."""
    devs = resolve_set(devices)
    if len(devs) == 1 and devs[0] == batch.device:
        return [batch]
    B = batch.q_lens.shape[0]
    return [batch.rows(a, b, d) for (a, b), d in
            zip(shard_bounds(B, len(devs)), devs) if b > a]


# ---------------------------------------------------------------------------
# HMM parameterization for gradient EM
# ---------------------------------------------------------------------------


def params_to_theta(params, device=None) -> dict:
    """Probability tables -> unconstrained log-domain parameters.
    ``params`` is a PHMMParams of tensors or of numpy-convertible arrays
    (e.g. a ``jtk_tpu`` PHMMParams), so a JAX-side fit carries over."""
    from ..runtime import resolve
    out = {}
    for key, x in zip(KEYS, params):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.array(x, np.float32),
                                device=resolve(device))
        out[key] = torch.log(x.to(torch.float32) + 1e-9)
    return out


def theta_to_params(theta) -> PHMMParams:
    """Softmax rows back to stochastic matrices (differentiable)."""
    return PHMMParams(*(torch.softmax(theta[k], dim=-1) for k in KEYS))


def _per_shard(fn, tables, shards):
    """``fn(params, shard)`` for each shard in order, the three tables
    copied to the shard's device."""
    out = []
    for i, b in enumerate(shards):
        with on_entry(i):
            out.append(fn(PHMMParams(*(t.to(b.device) for t in tables)), b))
    return out


class _ShardedLikelihood(torch.autograd.Function):
    """lk (N,) of the shards' pairs, in order, on the tables' device (the
    primary), differentiable in the three tables: the backward gathers
    each shard's per-pair counts and sums them once there."""

    @staticmethod
    def forward(ctx, trans, mat_emit, ins_emit, shards):
        ctx.save_for_backward(trans, mat_emit, ins_emit)
        ctx.shards = shards
        return gather(_per_shard(pair_lk, (trans, mat_emit, ins_emit),
                                 shards), trans.device)

    @staticmethod
    def backward(ctx, grad_lk):
        tables = ctx.saved_tensors
        counts = gather(_per_shard(pair_counts, tables, ctx.shards),
                        grad_lk.device)
        return (*param_grads(grad_lk, counts, *tables), None)


def _train_step(theta, shards, wts, lr: float, clip: float):
    th = {k: v.detach().requires_grad_(True) for k, v in theta.items()}
    with torch.enable_grad():
        p = theta_to_params(th)
        lk = _ShardedLikelihood.apply(p.trans, p.mat_emit, p.ins_emit,
                                      shards)
        losses = -lk * wts
        grads = torch.autograd.grad(losses.sum(), [th[k] for k in KEYS])
    q_lens = gather([b.q_lens for b in shards], wts.device)
    total_bp = torch.clamp((q_lens.to(torch.float32) * wts).sum(), min=1.0)
    g = [torch.where(torch.isfinite(x), x, 0.0) / total_bp for x in grads]
    gnorm = torch.sqrt(sum((x ** 2).sum() for x in g))
    scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
    new_theta = {k: theta[k].detach() - lr * scale * x
                 for k, x in zip(KEYS, g)}
    loss = losses.detach().sum() / torch.clamp(wts.sum(), min=1.0)
    return new_theta, loss


def make_train_step(W: int, lr: float = 0.05, clip: float = 1.0,
                    devices=None):
    """One data-parallel gradient-EM step: ``step(theta, batch, wts) ->
    (theta, loss)`` with ``batch`` a :class:`PairBatch` at band ``W``
    (cut over ``devices``, default the current set, at each call) or the
    list of its shards (:func:`shard_batch`), and ``wts`` (N,) f32 read
    weights on the primary (0 masks a padding read).  theta lives on the
    primary."""

    def step(theta, batch, wts):
        shards = batch if isinstance(batch, list) \
            else shard_batch(batch, devices)
        for b in shards:
            if b.W != W:
                raise ValueError(f"batch band {b.W} != step band {W}")
        return _train_step(theta, shards, wts, lr, clip)

    return step


def make_train_steps(W: int, lr: float = 0.05, clip: float = 1.0,
                     n_inner: int = 10, devices=None):
    """``n_inner`` steps per call: ``many(theta, batch, wts) -> (theta,
    losses (n_inner,))``, ``batch`` cut once a call where it is not cut
    already; the caller checks convergence between calls."""
    step = make_train_step(W, lr=lr, clip=clip, devices=devices)

    def many(theta, batch, wts):
        shards = batch if isinstance(batch, list) \
            else shard_batch(batch, devices)
        losses = []
        for _ in range(n_inner):
            theta, loss = step(theta, shards, wts)
            losses.append(loss)
        return theta, torch.stack(losses)

    return many


def make_sharded_pileup_lk(W: int, devices=None):
    """Sharded per-read likelihood under the default parameters:
    ``fn(qs, template, offsets, q_lens, t_len) -> lk (B,)`` on the primary,
    reads cut over ``devices`` (default the current set), K1l per shard,
    gathered in read order."""

    def fn(qs, template, offsets, q_lens, t_len):
        devs = resolve_set(devices)
        qs, offsets = np.asarray(qs), np.asarray(offsets)
        q_lens = np.asarray(q_lens)
        outs = []
        for i, ((a, b), dev) in enumerate(
                zip(shard_bounds(len(qs), len(devs)), devs)):
            if a == b:
                continue
            with on_entry(i):
                args = lk_inputs(qs[a:b], template, offsets[a:b],
                                 q_lens[a:b], t_len, W, device=dev)
                outs.append(phmm_lk(*args, *tables8(PHMMParams.default(dev),
                                                    dev)))
        if not outs:
            return torch.zeros(0, dtype=torch.float32, device=devs[0])
        return gather(outs, devs[0])

    return fn


def make_sharded_kmer_hist(n_bins: int, devices=None):
    """Sharded k-mer histogram: ``fn(kmers) -> (n_bins,) int64`` on the
    primary, the k-mers (non-negative integers) cut over ``devices``
    (default the current set), a bincount of ``kmers % n_bins`` per shard,
    summed in shard order (the repeat-masking counting pattern,
    repeat_masking.rs:162-194)."""

    def fn(kmers):
        devs = resolve_set(devices)
        if not isinstance(kmers, torch.Tensor):
            kmers = np.asarray(kmers).astype(np.int64)
        shards, = shard_leading(devs, kmers)
        hist = None
        for i, s in enumerate(shards):
            with on_entry(i):
                h = torch.bincount(s.to(torch.int64) % n_bins,
                                   minlength=n_bins).to(devs[0])
            hist = h if hist is None else hist + h
        return hist

    return fn


__all__ = ["KEYS", "shard_bounds", "shard_leading", "replicate", "gather",
           "shard_batch", "on_entry", "params_to_theta", "theta_to_params",
           "make_train_step", "make_train_steps", "make_sharded_pileup_lk",
           "make_sharded_kmer_hist"]
