"""Whether a row's sum on the card keeps its bits however many rows share
the call, for PyTorch's ``sum`` and for the fixed pairwise tree the float64
gradient tables' row 0 uses (``ops/phmm_tables._tree_row_sum``), and
whether the sharded train step is bit-identical at card x 1 and x 4 with
``sum`` in the tree's place::

    python3 -m jtk_tpu_torch.tools.row_sum_order

Prints one JSON line a case: ``rows`` cases count, for float64 rows of
width W, the rows of a call over B rows whose sum differs in any bit from
the same row's in a call over 40; ``train`` cases say whether ten train
steps at B reads and band W give the same theta and losses on the card
alone and on the card listed four times (shards of B / 4 reads).
"""

from __future__ import annotations

import json
import sys


def _rows_case(W: int, B: int, dev) -> dict:
    import torch

    from ..ops import phmm_tables as pt
    g = torch.Generator(device=dev).manual_seed(W * 100 + B)
    # positive values over ~20 orders of magnitude, as row 0's M and D
    x = torch.exp(torch.randn((40, W), generator=g, device=dev,
                              dtype=torch.float64) * 8.0)
    out = {"case": "rows", "W": W, "B": B}
    for name, fn in (("sum", lambda t: t.sum(1, keepdim=True)),
                     ("tree", pt._tree_row_sum)):
        ref = fn(x)[:B]
        got = fn(x[:B].clone())
        out[f"{name}_rows_differ"] = int((got != ref).sum())
    return out


def _train_case(W: int, B: int, tlen: int, with_sum: bool,
                dev="cuda") -> dict:
    import numpy as np
    import torch

    from .. import parallel as par
    from ..io import sim
    from ..ops import phmm_grad as pg
    from ..ops import phmm_tables as pt
    from ..ops.banded_align import linear_offsets
    from ..ops.phmm import PHMMParams
    from ..runtime import use_devices

    rng = np.random.default_rng(W + B)
    tpl = sim.random_genome(rng, tlen).astype(np.int8)
    reads = [sim.noisy_read(rng, tpl, 0.05) for _ in range(B)]
    q_lens = np.array([len(r) for r in reads], np.int32)
    Q = ((int(q_lens.max()) + 63) // 64) * 64
    qs = np.full((B, Q), 4, np.int8)
    for i, r in enumerate(reads):
        qs[i, :len(r)] = r
    offs = np.stack([linear_offsets(int(q), tlen, Q, W) for q in q_lens])
    wts = np.ones(B, np.float32)
    tree = pt._tree_row_sum
    if with_sum:
        pt._tree_row_sum = lambda t: t.sum(1, keepdim=True)
    try:
        out = []
        for n in (1, 4):
            with use_devices([dev] * n):
                batch = pg.PairBatch(qs, tpl, offs, q_lens, tlen, W)
                theta = par.params_to_theta(PHMMParams.default())
                theta, losses = par.make_train_steps(W)(
                    theta, batch, torch.as_tensor(wts, device=dev))
            out.append([theta[k] for k in par.KEYS] + [losses])
    finally:
        pt._tree_row_sum = tree
    same = all(torch.equal(a, b) for a, b in zip(*out))
    return {"case": "train", "W": W, "B": B, "row_sum": "sum" if with_sum
            else "tree", "bit_identical_x1_x4": same}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("row_sum_order: no CUDA device", file=sys.stderr)
        return 2
    from ..runtime import set_device
    set_device("cuda")
    dev = torch.device("cuda")
    for W in (128, 256, 1152, 2048, 4096, 8192):
        for B in (1, 2, 3, 4, 10, 13):
            print(json.dumps(_rows_case(W, B, dev)), flush=True)
    for W, B, tlen in ((128, 40, 2000), (256, 40, 2000), (2048, 4, 2000)):
        for with_sum in (True, False):
            print(json.dumps(_train_case(W, B, tlen, with_sum)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
