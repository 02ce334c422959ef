"""Gradient EM for the pair-HMM on one device.

Counterpart of the single-device half of ``jtk_tpu/parallel/__init__.py``:
the log-domain parameterisation (``params_to_theta`` / ``theta_to_params``)
and the train step (``make_train_step`` / ``make_train_steps``).  The
gradient of -sum(lk) comes from :class:`~..ops.phmm_grad.PairHMMLikelihood`
(the K1l kernel forward, K1 tables + counts kernel backward) through the
autograd softmax.  The mesh paths (``shard_map``, sharded pileup
likelihoods, k-mer histograms) wait for more than one GPU.

The step keeps the reference's semantics: per-read losses ``-lk * w``
summed in a fixed-shape sum (weight-0 stub reads pad the batch), then in
this order: non-finite gradient entries zeroed, division by
``max(total_bp, 1)``, a global-norm clip, the step.  The loss returned is
the one before the update.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.phmm import PHMMParams
from ..ops.phmm_grad import PairBatch, pair_likelihood

KEYS = ("trans", "mat_emit", "ins_emit")


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


def _train_step(theta, batch: PairBatch, wts, lr: float, clip: float):
    th = {k: v.detach().requires_grad_(True) for k, v in theta.items()}
    with torch.enable_grad():
        losses = -pair_likelihood(theta_to_params(th), batch) * wts
        grads = torch.autograd.grad(losses.sum(), [th[k] for k in KEYS])
    total_bp = torch.clamp((batch.q_lens.to(torch.float32) * wts).sum(),
                           min=1.0)
    g = [torch.where(torch.isfinite(x), x, 0.0) / total_bp for x in grads]
    gnorm = torch.sqrt(sum((x ** 2).sum() for x in g))
    scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
    new_theta = {k: theta[k].detach() - lr * scale * x
                 for k, x in zip(KEYS, g)}
    loss = losses.detach().sum() / torch.clamp(wts.sum(), min=1.0)
    return new_theta, loss


def make_train_step(W: int, lr: float = 0.05, clip: float = 1.0):
    """One gradient-EM step: ``step(theta, batch, wts) -> (theta, loss)``
    with ``batch`` a :class:`PairBatch` at band ``W`` and ``wts`` (B,) f32
    read weights on its device (0 masks a padding read)."""

    def step(theta, batch: PairBatch, wts):
        if batch.W != W:
            raise ValueError(f"batch band {batch.W} != step band {W}")
        return _train_step(theta, batch, wts, lr, clip)

    return step


def make_train_steps(W: int, lr: float = 0.05, clip: float = 1.0,
                     n_inner: int = 10):
    """``n_inner`` steps per call: ``many(theta, batch, wts) -> (theta,
    losses (n_inner,))``; the caller checks convergence between calls."""
    step = make_train_step(W, lr=lr, clip=clip)

    def many(theta, batch: PairBatch, wts):
        losses = []
        for _ in range(n_inner):
            theta, loss = step(theta, batch, wts)
            losses.append(loss)
        return theta, torch.stack(losses)

    return many


__all__ = ["KEYS", "params_to_theta", "theta_to_params", "make_train_step",
           "make_train_steps"]
