"""Count the modification-table entries where the port and ``jtk_tpu``'s
scan engine differ beyond the parity tolerance (rtol 1e-4 / atol 5e-2) on
pileups of 50 reads of 8 % error against a 150-base template, at W 128,
on the CPU, one device (ROADMAP.md §3, the deep multi-base entries)::

    env JAX_PLATFORMS=cpu python tests/torch_modtable_survey.py

Prints, per pileup, the count, the entries compared, the edit columns the
differences fall in, the range of their gains (the scan engine's entry
less its read's lk) and the largest difference, and the same for
``jtk_tpu``'s Pallas engine (interpret mode) against its scan engine.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from jtk_tpu.datamodel import HMMParam
    from jtk_tpu.ops import phmm as jphmm
    from jtk_tpu.ops.modtable import (modification_table_pileup,
                                      modification_table_pileup_pallas)
    from jtk_tpu_torch.ops import modtable as pmod
    from jtk_tpu_torch.ops import phmm as pphmm
    from jtk_tpu_torch.runtime import use_device
    from test_pallas_phmm import _prep_batch
    from test_torch_parallel import _modtable_inputs

    jp = jphmm.PHMMParams.from_hmmparam(HMMParam())
    cases = [(f"test_torch_parallel seed {s}", _modtable_inputs(seed=s)[:5])
             for s in (8, 9, 10)]
    cases += [(f"_prep_batch seed {s}",
               _prep_batch(np.random.default_rng(s), n_reads=50))
              for s in (3, 4, 5)]
    for label, (template, qs, offs, q_lens, W) in cases:
        W = ((int(W) + 127) // 128) * 128
        L = len(template)
        tpl = np.asarray(template, np.int8)
        lk, want = modification_table_pileup(qs, tpl, offs, q_lens,
                                             np.int32(L), jp, W, L)
        want = np.asarray(want)
        gain = want - np.asarray(lk)[:, None, None]
        with use_device("cpu"):
            _lk, got = pmod.modification_table_pileup_pallas(
                qs, tpl, offs, q_lens, np.int32(L),
                pphmm.PHMMParams.default("cpu"), W, L)
        _lk, pal = modification_table_pileup_pallas(
            qs, tpl, offs, q_lens, np.int32(L), jp, W, L, interpret=True)
        for name, x in (("the port", got), ("jtk_tpu's Pallas engine",
                                            np.asarray(pal))):
            m = want > -1e29
            bad = m & (np.abs(x - want) > 5e-2 + 1e-4 * np.abs(want))
            cols = sorted(set(np.argwhere(bad)[:, 2].tolist()))
            worst = float(np.abs(x - want)[bad].max()) if bad.any() else 0.0
            gains = (f"gains {gain[bad].min():.1f} to {gain[bad].max():.1f}"
                     if bad.any() else "no gains")
            print(f"{label}, {name}: {int(bad.sum())} of {int(m.sum())} "
                  f"entries differ from the scan engine, edit columns {cols}, "
                  f"{gains}, largest difference {worst:.3f}")


if __name__ == "__main__":
    main()
