"""The benchmark's simulator against the port's model, and the nodes it
builds from the truth."""

import numpy as np

import sim
import truth
from reference import edit as red


class _Draws:
    """An rng that serves ``io/sim.py::mutate``'s per-base calls from
    given draws, in the order that loop makes them: a base's ``random()``
    (deleted below ``dele``), a substitution's ``integers(0, 3)``, a kept
    base's insertion test ``random()`` and an inserted ``integers(0, 4)``."""

    def __init__(self, x, sub_off, ins_u, ins_base, dele):
        self.x, self.sub_off, self.ins_u = x, sub_off, ins_u
        self.ins_base, self.dele = ins_base, dele
        self.i = 0
        self.ins_next = False

    def random(self):
        if self.ins_next:
            self.ins_next = False
            self.i += 1
            return self.ins_u[self.i - 1]
        v = self.x[self.i]
        if v < self.dele:
            self.i += 1
        else:
            self.ins_next = True
        return v

    def integers(self, lo, hi):
        if hi == 3:
            return int(self.sub_off[self.i]) - 1
        return int(self.ins_base[self.i - 1])


def test_mutate_follows_the_port_rule_draw_for_draw():
    from jtk_tpu_torch.io import sim as port_sim
    rng = np.random.default_rng(5)
    n = 3000
    seq = rng.integers(0, 4, n).astype(np.int8)
    x = rng.random(n)
    sub_off = rng.integers(1, 4, n).astype(np.int8)
    ins_u = rng.random(n)
    ins_base = rng.integers(0, 4, n).astype(np.int8)
    rates = dict(sub=0.05, ins=0.04, dele=0.03)
    got, origin = sim.mutate_from_draws(seq, x, sub_off, ins_u, ins_base,
                                        **rates)
    want = port_sim.mutate(_Draws(x, sub_off, ins_u, ins_base,
                                  rates["dele"]), seq, **rates)
    np.testing.assert_array_equal(got, want)
    kept = origin >= 0
    subbed = (x >= rates["dele"]) & (x < rates["dele"] + rates["sub"])
    np.testing.assert_array_equal(got[kept] != seq[origin[kept]],
                                  subbed[origin[kept]])


def _cfg(kind="diploid"):
    g = {"kind": "diploid", "length": 40000, "het": 0.004, "chunks": 16} \
        if kind == "diploid" else {
            "kind": "segdup", "segdup_len": 16000, "padding": 8000,
            "divergence": 0.05, "het": 0.001, "chunks": 16}
    return {"chunk_len": 2000, "genome": g,
            "reads": {"coverage": 10, "mean_len": 8000, "error": 0.05}}


def test_reads_follow_the_length_and_strand_law():
    cfg = _cfg()
    g, r = sim.simulate(2**31 + 5, cfg)
    n = int(10 * (len(g.haps[0]) + len(g.haps[1])) / 8000)
    assert n - 3 <= len(r) <= n
    lens = np.array([len(c) for c in r.codes])
    assert lens.min() >= 400 and abs(r.fwd.mean() - 0.5) < 0.2
    # the same seed gives the same reads
    g2, r2 = sim.simulate(2**31 + 5, cfg)
    assert all(np.array_equal(a, b) for a, b in zip(r.codes, r2.codes))


def test_truth_nodes_are_the_reads_segments_over_their_windows():
    for kind in ("diploid", "segdup"):
        g, r = sim.simulate(11, _cfg(kind))
        n = 0
        for i in range(len(r)):
            codes, fr = truth.oriented(r, i)
            for ci, fwd, pos, seg, cg in truth.true_nodes(g, r, i):
                L = len(codes)
                lo = pos if fwd else L - pos - len(seg)
                np.testing.assert_array_equal(seg, codes[lo:lo + len(seg)])
                a = int(g.chunk_starts[ci])
                inside = fr[lo:lo + len(seg)]
                assert inside[inside >= 0].min() <= a + 2
                chunk = g.chunk_seq(ci)
                cost = red.cigar_cost(cg, seg, chunk)
                assert cost < 0.15 * len(chunk), (kind, i, ci, cost)
                n += 1
        assert n > 20
        if kind == "segdup":
            assert set(g.copy_nums.tolist()) == {2, 4}


def test_haplotype_windows_hold_each_copy():
    g, _r = sim.simulate(3, _cfg("segdup"))
    for ci in range(len(g.chunk_starts)):
        wins = truth.hap_windows(g, ci)
        assert len(wins) == g.copy_nums[ci]
        np.testing.assert_array_equal(wins[0], g.chunk_seq(ci))


def test_a_read_on_a_copy4_chunk_knows_its_copy():
    g, r = sim.simulate(5, _cfg("segdup"))
    segs, near, far = [], [], []
    for i in range(len(r)):
        for ci, _fwd, _pos, seg, _cg in truth.true_nodes(g, r, i, False):
            if g.copy_nums[ci] != 4 or len(segs) >= 40:
                continue
            wins = truth.hap_windows(g, ci)     # per haplotype: copy 1, 2
            h, c = int(r.hap[i]), int(r.copy[i])
            segs.append(seg)
            near.append(wins[2 * h + c])
            far.append(wins[2 * h + 1 - c])
    assert len(segs) == 40 and 0 < sum(r.copy) < len(r)
    d_near = red.edit_distance(segs, near, "cpu")
    d_far = red.edit_distance(segs, far, "cpu")
    assert (d_near < d_far).all()


def test_a_perturbed_template_is_its_edits_away():
    import os
    import run
    phase = run.load_module(os.path.join(run.HERE, "jobs", "phase.py"),
                            "bench_job_phase_test")
    rng = np.random.default_rng(7)
    for n in (1, 6, 12):
        w = rng.integers(0, 4, 2000).astype(np.int8)
        t = phase.perturb(w, n, rng)
        assert len(t) == len(w) + sum(k % 3 == 1 for k in range(n)) - \
            sum(k % 3 == 2 for k in range(n))
        assert int(red.edit_distance([t], [w], "cpu")[0]) == n
