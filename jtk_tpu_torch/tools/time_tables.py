"""Time the float32 K1 table kernels (forward and backward) at the
modification table's shapes, on the card, with CUDA events.

    python3 -m jtk_tpu_torch.tools.time_tables [--reps N]

Prints one JSON line per (shape, pass): the median milliseconds of N
launches after a warm-up.  It uses only the table API that every tree of
the port since its redesign of the K1 kernels has (``prep_tables_inputs``,
``kernel_inputs(prep, W)``, ``fwd_tables``, ``bwd_tables``), so a copy run
from an unpacked earlier commit times that commit's kernels on the same
inputs: run both trees in turns in one call (parent, change, change,
parent) to compare them on one card.
"""

from __future__ import annotations

import argparse
import json

# (label, B, W): polish's B 192 at W 128 and 512, model tuning's B 40 at
# W 128 and 256 (Q 2048 read rows against ~2 kb templates)
SHAPES = (("polish", 192, 128), ("polish_W512", 192, 512),
          ("model_tune", 40, 128), ("model_tune_W256", 40, 256))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=21)
    opts = ap.parse_args()

    import numpy as np
    import torch

    from jtk_tpu_torch.io import sim
    from jtk_tpu_torch.ops import phmm_tables as pt
    from jtk_tpu_torch.ops.banded_align import linear_offsets
    from jtk_tpu_torch.ops.phmm import PHMMParams

    if not torch.cuda.is_available():
        raise SystemExit("time_tables: no CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(42)
    Q = 2048
    params = PHMMParams.default(dev)
    for label, B, W in SHAPES:
        tpl = np.full((B, Q + 64), 4, np.int8)
        qs = np.full((B, Q), 4, np.int8)
        q_lens = np.zeros(B, np.int64)
        t_lens = np.zeros(B, np.int64)
        offs = np.zeros((B, Q + 1), np.int64)
        for b in range(B):
            t = sim.random_genome(rng, 2000 - int(rng.integers(0, 40)))
            r = sim.noisy_read(rng, t, 0.05)[:Q]
            tpl[b, :len(t)], qs[b, :len(r)] = t, r
            q_lens[b], t_lens[b] = len(r), len(t)
            offs[b] = linear_offsets(len(r), len(t), Q, W)
        prep = pt.prep_tables_inputs(qs, tpl, offs, q_lens, t_lens, params,
                                     W, device=dev)
        fwd_args, bwd_args, _aux = pt.kernel_inputs(prep, W)
        for kind, kern, args in (("fwd", pt.fwd_tables, fwd_args),
                                 ("bwd", pt.bwd_tables, bwd_args)):
            kern(*args)
            times = []
            for _ in range(opts.reps):
                a = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                a.record()
                kern(*args)
                e.record()
                torch.cuda.synchronize()
                times.append(a.elapsed_time(e))
            times.sort()
            print(json.dumps(dict(shape=label, B=B, Q=Q, W=W, kind=kind,
                                  median_ms=times[len(times) // 2],
                                  card=torch.cuda.get_device_name(0))),
                  flush=True)


if __name__ == "__main__":
    main()
