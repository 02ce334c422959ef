"""The modification table's multi-base entries against the float64 oracle.

On 50 reads of 8 % error against a 150-base template (W 128, one device),
the port's copy 2-3 and del 2-3 columns differ from ``jtk_tpu``'s scan
engine beyond its tolerance (rtol 1e-4 / atol 5e-2) at a few dozen
entries, all many nats below the read's lk.  There the scan engine's
float32 column sums (differences of running row sums) cancel; the port's
run in float64.  A seeded sample of those entries, and three entries where
the two agree, is held against ``jtk_tpu.ops.oracle.phmm_forward`` on the
edited template (an unbanded float64 forward, ~1 s an entry here).
"""

import numpy as np

from jtk_tpu.datamodel import HMMParam
from jtk_tpu.ops import phmm as jphmm
from jtk_tpu.ops.modtable import modification_table_pileup
from jtk_tpu_torch.ops import modtable as pmod
from jtk_tpu_torch.ops import phmm as pphmm
from test_torch_parallel import _modtable_inputs
from torch_util import DEEP_COLS, oracle_misses, port_on_cpu  # noqa: F401

SAMPLE, CONTROLS = 12, 3


def test_multi_base_entries_meet_the_float64_oracle():
    template, qs, offs, q_lens, W = _modtable_inputs(seed=8)[:5]
    L = len(template)
    tpl = np.asarray(template, np.int8)
    lk_j, tab_j = modification_table_pileup(
        qs, tpl, offs, q_lens, np.int32(L),
        jphmm.PHMMParams.from_hmmparam(HMMParam()), W, L)
    tab_j = np.asarray(tab_j)
    lk, tab = pmod.modification_table_pileup_pallas(
        qs, tpl, offs, q_lens, np.int32(L), pphmm.PHMMParams.default("cpu"),
        W, L)
    np.testing.assert_allclose(lk, np.asarray(lk_j), rtol=1e-4, atol=2e-2)
    live = tab_j > -1e29
    np.testing.assert_array_equal(tab > -1e29, live)
    off = live & (np.abs(tab - tab_j) > 5e-2 + 1e-4 * np.abs(tab_j))
    flagged = np.argwhere(off)
    print(f"{len(flagged)} entries differ from the scan engine")
    assert len(flagged) > 0
    assert set(flagged[:, 2].tolist()) <= set(DEEP_COLS)
    rng = np.random.default_rng(0)
    pick = flagged[rng.choice(len(flagged), min(SAMPLE, len(flagged)),
                              replace=False)]
    agree = np.argwhere(live & ~off & np.isin(
        np.arange(pmod.NUM_EDIT), DEEP_COLS)[None, None, :])
    controls = agree[rng.choice(len(agree), CONTROLS, replace=False)]
    assert oracle_misses(qs, q_lens, tpl, tab, np.concatenate(
        [pick, controls])) == []


def test_jax_free_oracle_matches_the_oracle():
    """tests/oracle64.py (the card tests' oracle) against
    ``jtk_tpu.ops.oracle`` on edited templates of noisy reads."""
    import oracle64
    from jtk_tpu.ops import oracle
    from jtk_tpu_torch.io import sim
    hmm = HMMParam()
    par = {k: getattr(hmm, k) for k in
           ("mat_mat", "mat_ins", "mat_del", "ins_mat", "ins_ins", "ins_del",
            "del_mat", "del_ins", "del_del", "mat_emit", "ins_emit")}
    rng = np.random.default_rng(3)
    for n, (op, base) in enumerate([("S", 2), ("I", 1), ("D", 3), ("C", 2),
                                    ("C", 3)]):
        t = sim.random_genome(rng, 40 + 7 * n)
        q = sim.noisy_read(rng, t, 0.08)
        pos = int(rng.integers(3, len(t) - 6))
        e = oracle64.apply_edit(t, op, pos, base)
        np.testing.assert_array_equal(e, oracle.apply_edit(t, op, pos, base))
        assert abs(oracle64.phmm_forward(q, e, par)
                   - oracle.phmm_forward(q, e, par)) < 1e-9
