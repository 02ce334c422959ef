"""Faults planted in the timed path, to see ``correct`` come out false.

Each fault replaces one program function through :func:`tracing.patch`
(the benchmark's one way of replacing a program function).  A job kind
lists the faults its cells can have:

- ``unchanged``: the job's entry returns its state as it came;
- ``half``: half of each batch of reads, or of each group of chunks,
  left out;
- ``altered``: an answer altered where it is produced (a node's CIGAR; a
  chain's assignment);
- ``polish_unchanged``: the polish returns its templates as it got them;
- ``chain_unmoved``: the chain stays at a random start (no k-means
  seeding, no step).  Left at its own k-means++ start the chain already
  finds the truth partition on these cells' chunks, so a chain that only
  skips its steps gives right answers and is not a fault to catch.

No one-card cell has an exchange between chips, so none leaves one out.

Used by ``control.py`` (on the card, at a cell's own size) and by the
CPU tests (at a tiny size).
"""

from __future__ import annotations

import contextlib

import numpy as np

from tracing import patch, undo

ENC = "jtk_tpu_torch.stages.encode"
LC = "jtk_tpu_torch.stages.local_clustering"
CL = "jtk_tpu_torch.ops.cluster"


def _returns_its_state(orig):
    return lambda ds, **kw: ds


def _half_reads(orig):
    def half(ds, **kw):
        reads = ds.raw_reads
        ds.raw_reads = reads[: len(reads) // 2]
        try:
            return orig(ds, **kw)
        finally:
            ds.raw_reads = reads
    return half


def _altered_node(orig):
    def altered(*args):
        n = orig(*args)
        if n is not None and n["cigar"]:
            k, m = n["cigar"][0]
            n["cigar"] = [("I", 1), ("D", 1), (k, m - 1)] + n["cigar"][1:]
        return n
    return altered


def _half_chunks(orig):
    def half(ds, seed=42, selection=None, **kw):
        sel = sorted(selection)[: len(selection) // 2]
        return orig(ds, seed=seed, selection=set(sel), **kw)
    return half


def _altered_assignment(orig):
    def altered(*args, **kwargs):
        assign, score = orig(*args, **kwargs)
        assign = np.array(assign)
        assign[:, 0] = (assign[:, 0] + 1) % args[3]
        return assign, score
    return altered


def _polish_returns_its_input(orig):
    def unchanged(templates, pileups, *args, **kwargs):
        return ([np.asarray(t, np.int8) for t in templates],
                [np.zeros(len(p)) for p in pileups])
    return unchanged


def _no_chain_steps(orig):
    return lambda *args, **kwargs: None


def _random_start(orig):
    def start(X, w, gumbel, K, **kwargs):
        import torch
        return torch.where(w[:, None] > 0, gumbel.argmax(2), 0)
    return start


FAULTS = {
    "encode": {
        "unchanged": [(f"{ENC}:encode", _returns_its_state)],
        "half": [(f"{ENC}:encode", _half_reads)],
        "altered": [(f"{ENC}:_node_from_result", _altered_node)],
    },
    "phase": {
        "unchanged": [(f"{LC}:local_clustering", _returns_its_state)],
        "half": [(f"{LC}:local_clustering", _half_chunks)],
        "altered": [(f"{LC}:mcmc_cluster_batch", _altered_assignment)],
        "polish_unchanged": [("jtk_tpu_torch.ops.polish:polish_many",
                              _polish_returns_its_input)],
        "chain_unmoved": [(f"{CL}:_kmeanspp_init", _random_start),
                          (f"{CL}:mcmc_chain", _no_chain_steps)],
    },
}


@contextlib.contextmanager
def planted(kind: str, name: str):
    """The fault ``name`` of job kind ``kind`` in place while inside."""
    done = []
    for spec, make in FAULTS[kind][name]:
        done += patch(spec, make)
    try:
        yield
    finally:
        undo(done)
