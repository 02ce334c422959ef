"""Phase jobs: ``local_clustering`` over one group of chunks a job.

Set-up simulates the region and its reads, encodes every read against
every chunk from the simulator's true placements (a node's bases in the
chunk's orientation, its true CIGAR, copy number from the layout), holds
the configuration's HMM and error rate, and starts each chunk's template
from haplotype 1's window with ``template_edits`` edits drawn from the
seed (substitutions, insertions and deletions in turn), so that the
polish has the same amount to repair on every seed.  It cuts the chunks
into interleaved groups (chunk i in group i mod G) and runs group 0 once
as the warm-up, which also fills the gain calibration's cache.  The
window's job j is ``local_clustering(ds, seed, selection=group 1 + j mod
(G - 1))``; what a job changes (the group's chunk sequences, cluster
numbers, scores, and its nodes' CIGARs, clusters and posteriors) is put
back between jobs.

The check holds five of the job's products, on a sample of the groups'
phased chunks drawn from the seed, against the truth and the plain
reference (``benchmark/reference``); where it must, it follows the
program's own state (a stage is held at the inputs the program gave it):

- ``template_excess``: the polished template (K1 and the modification
  table) against the haplotypes' windows, d(t, x) + d(t, y) - d(x, y) at
  the best pair (bases): 0 where the template lies between two of them;
- ``gain_gap``: the variant features, each a modification-table gain,
  against the float64 forward on the edited template (nats);
- ``cigar_gap``: the refreshed CIGARs (K3 and its walk) against each
  read's least edit distance to the polished template (bases);
- ``score_gap``: each chain's best score against the float64 objective of
  the assignment it returned (relative);
- ``truth_shortfall``: the two-cluster chain's best score below the
  objective of the truth partition (haplotypes on a copy-2 chunk, the
  duplicate's copies on a copy-4 one), relative.

A sampled chunk whose features or chains never came reads ``BIG`` in
each number they feed.  The share of chunks left unphased is printed for
the record.
"""

from __future__ import annotations

import math
import time

import numpy as np

import sim
import truth
from tracing import patch, undo
from reference import cluster as rcl
from reference import edit as red
from reference import phmm as rph


class Job:
    def __init__(self, cfg: dict, wl: dict, seed: int, log):
        import torch

        from jtk_tpu_torch import seq as seqmod
        from jtk_tpu_torch.datamodel import (Chunk, DataSet, EncodedRead,
                                             ErrorRate, HMMParam,
                                             HMMParamOnStrands, Node)
        from jtk_tpu_torch.stages import local_clustering as lc
        self.lc, self.log, self.cfg, self.wl = lc, log, cfg, wl
        self.seed = seed
        self.device = "cuda" if torch.cuda.is_available() else "cpu"
        t0 = time.perf_counter()
        self.genome, self.reads = sim.simulate(seed, cfg)
        t1 = time.perf_counter()
        G = self.genome
        trng = np.random.default_rng([seed, 3])
        # one cluster each until phased, as the encoded phase leaves them
        chunks = [Chunk(i, seqmod.decode(perturb(
                            G.chunk_seq(i), int(wl["template_edits"]),
                            trng)).decode(),
                        cluster_num=1, copy_num=int(G.copy_nums[i]))
                  for i in range(len(G.chunk_starts))]
        encoded = []
        for i in range(len(self.reads)):
            nodes = []
            for ci, fwd, pos, codes, cg in truth.true_nodes(G, self.reads, i):
                nodes.append(Node(pos, ci, 0, seqmod.decode(codes).decode(),
                                  fwd, cg, [0.0]))
            if nodes:
                encoded.append(EncodedRead(i, len(self.reads.codes[i]), "",
                                           "", [], nodes))
        hmm = cfg["hmm"]
        self.ds = DataSet(read_type=cfg["read_type"], selected_chunks=chunks,
                          encoded_reads=encoded,
                          model_param=HMMParamOnStrands(
                              HMMParam(**hmm["forward"]),
                              HMMParam(**hmm["reverse"])),
                          error_rate=ErrorRate.from_json(cfg["error_rate"]))
        n_groups = math.ceil(len(chunks) / int(cfg["phase_chunks_per_call"]))
        self.groups = [[c.id for c in chunks if c.id % n_groups == g]
                       for g in range(n_groups)]
        # the pileup of each chunk, in the program's order
        self.pileup = {c.id: [] for c in chunks}
        for ri, er in enumerate(encoded):
            for ni, n in enumerate(er.nodes):
                self.pileup[n.chunk].append((ri, ni))
        # the haploid coverage: half the median pileup (as misc.rs defines
        # it), worked out here again for the reference's size term
        self.coverage = float(np.median(
            [len(p) for p in self.pileup.values() if p])) / 2
        self._saved_chunks = [(c.seq, c.cluster_num, c.score) for c in chunks]
        self._saved_nodes = [[(n.cigar, n.cluster, n.posterior)
                              for n in er.nodes] for er in encoded]
        self._undo = []
        self._rec = self._fresh()
        self.install()
        t2 = time.perf_counter()
        n_nodes = sum(len(p) for p in self.pileup.values())
        log(f"phase set-up: simulate {t1 - t0:.2f} s ({len(self.reads)} "
            f"reads), nodes {t2 - t1:.2f} s ({n_nodes} over {len(chunks)} "
            "chunks)")
        self._run_group(0)
        self._restore(0)
        self._rec = self._fresh()
        log(f"phase warm-up: {time.perf_counter() - t2:.2f} s "
            f"({len(self.groups[0])} chunks)")
        self.reset()

    # -- recorders of the program's state (kept for the check) -----------
    def _fresh(self):
        return {"features": None, "chains": []}

    def install(self):
        """Put the recorders over the features and the chains (through
        :func:`tracing.patch`); :meth:`uninstall` takes them off."""
        depth = [0]

        def features(orig):
            def recorded(per_chunk, *args, **kwargs):
                depth[0] += 1
                try:
                    out = orig(per_chunk, *args, **kwargs)
                finally:
                    depth[0] -= 1
                if depth[0] == 0:
                    self._rec["features"] = (per_chunk, out)
                return out
            return recorded

        def chains(orig):
            def recorded(X, R, size_lk, K, *args, **kwargs):
                assign, score = orig(X, R, size_lk, K, *args, **kwargs)
                self._rec["chains"].append((
                    np.asarray(X), np.asarray(R), int(K),
                    np.asarray(assign).copy(), np.asarray(score).copy()))
                return assign, score
            return recorded

        lc = "jtk_tpu_torch.stages.local_clustering"
        self._undo += patch(f"{lc}:_variant_features_device", features)
        self._undo += patch(f"{lc}:mcmc_cluster_batch", chains)

    def uninstall(self):
        undo(self._undo)

    def reset(self):
        """Forget what earlier windows produced (a new window's check)."""
        self.rng = np.random.default_rng([self.seed, 1])
        self.samples = []
        self.phased = [0, 0]

    # -- the window's jobs ----------------------------------------------
    def _group(self, i: int):
        return 1 + i % (len(self.groups) - 1)

    def _run_group(self, g: int) -> int:
        self.lc.local_clustering(self.ds, seed=int(self.wl["program_seed"]),
                                 selection=set(self.groups[g]))
        return len(self.groups[g])

    def before(self, i: int):
        self._rec = self._fresh()

    def run(self, i: int) -> int:
        return self._run_group(self._group(i))

    def after(self, i: int):
        g = self._group(i)
        chunks = self.ds.selected_chunks
        live = [cid for cid in self.groups[g] if chunks[cid].copy_num >= 2
                and len(self.pileup[cid]) > chunks[cid].copy_num]
        self.phased[1] += len(live)
        self.phased[0] += sum(chunks[cid].cluster_num >= 2 for cid in live)
        self._collect(live)
        self._restore(g)

    def _collect(self, live):
        """Keep what the job produced for a seeded sample of the group's
        chunks that it phases: the template, every pileup read's CIGAR,
        the variant features and the chains' rows, where they came."""
        rec = self._rec
        _per_chunk, out = rec["features"] or ({}, {})
        k = min(int(self.wl["sample_per_job"]), len(live),
                int(self.wl["max_samples"]) - len(self.samples))
        for cid in self.rng.choice(live, k, replace=False):
            cid = int(cid)
            nodes = [self.ds.encoded_reads[ri].nodes[ni]
                     for ri, ni in self.pileup[cid]]
            came = cid in out
            cols, X = out.get(cid, (np.zeros(0, np.int64), None))
            rows = []
            if X is not None and len(cols):
                r, v = X.shape
                for Xb, Rb, K, asn, sc in rec["chains"]:
                    for b in range(Xb.shape[0]):
                        if int(Rb[b]) == r and not Xb[b, :, v:].any() and \
                                np.array_equal(Xb[b, :r, :v], X):
                            rows.append((Xb[b, :r, :v].astype(np.float64), K,
                                         asn[b, :r], float(sc[b])))
            self.samples.append(dict(
                cid=cid, reads=[red.encode(n.seq) for n in nodes],
                strands=np.array([n.is_forward for n in nodes]),
                template=red.encode(self.ds.selected_chunks[cid].seq),
                cigars=[n.cigar for n in nodes],
                cols=np.asarray(cols), came=came,
                X=None if X is None or not len(cols)
                else np.asarray(X, np.float64),
                chains=rows,
                truth=self._truth_labels(cid)))

    def _truth_labels(self, cid):
        """Each pileup read's true cluster: its haplotype on a copy-2
        chunk, its copy of the duplicate on a copy-4 one."""
        R = self.reads
        ids = [self.ds.encoded_reads[ri].id for ri, _ni in self.pileup[cid]]
        lab = R.copy if self.ds.selected_chunks[cid].copy_num > 2 else R.hap
        return np.array([int(lab[i]) for i in ids])

    def _restore(self, g: int):
        ds = self.ds
        for cid in self.groups[g]:
            c = ds.selected_chunks[cid]
            c.seq, c.cluster_num, c.score = self._saved_chunks[cid]
            for ri, ni in self.pileup[cid]:
                n = ds.encoded_reads[ri].nodes[ni]
                n.cigar, n.cluster, n.posterior = self._saved_nodes[ri][ni]
        del ds.processed_stages[:]

    def release(self):
        self.uninstall()
        self.ds = None
        self._saved_nodes = None
        import torch
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------
    def check(self, control: bool = False):
        """[(name, value, limit)].  ``control`` puts the reference, in the
        types below the program's, in the program's place, and gives the
        three numbers it reads: the features from a bfloat16 forward, the
        CIGARs from int8 cells, the chains' scores from a bfloat16
        objective."""
        import torch
        lim = self.wl["limits"]
        self.log(f"record unphased_share "
                 f"{1 - self.phased[0] / max(self.phased[1], 1)!r} "
                 f"sampled_chunks {len(self.samples)}")
        out = []
        if not control:
            out.append(("template_excess", self._template_excess()))
        out += [("gain_gap", self._gain_gap(
                    torch.bfloat16 if control else None)),
                ("cigar_gap", self._cigar_gap(
                    torch.int8 if control else None)),
                ("score_gap", self._score_gap(
                    torch.bfloat16 if control else None))]
        if not control:
            out.append(("truth_shortfall", self._truth_shortfall()))
        return [(n, v, lim[n]) for n, v in out]

    def _entries(self, s):
        """The (read, column) entries of a sample held to the forward: a
        seeded draw of at most ``entries_per_chunk`` of exact edit
        types."""
        R, V = s["X"].shape
        ok = [(r, v) for r in range(R) for v in range(V)
              if int(s["cols"][v]) % rph.NUM_EDIT in rph.EXACT_EDITS]
        n = min(int(self.wl["entries_per_chunk"]), len(ok))
        rng = np.random.default_rng([self.seed, 2, s["cid"]])
        return [ok[k] for k in rng.choice(len(ok), n, replace=False)]

    def _gain_gap(self, control=None):
        """The largest gap between a feature and the forward's gain of its
        edit; ``BIG`` where a sampled chunk's features never came, or no
        sampled chunk has any."""
        if any(not s["came"] for s in self.samples):
            return float(red.BIG)
        hmm = self.cfg["hmm"]
        hmms = [hmm["forward"], hmm["reverse"]]
        qs, ts, st, meta = [], [], [], []
        for si, s in enumerate(self.samples):
            if s["X"] is None:
                continue
            tpl = s["template"]
            for r in range(len(s["reads"])):
                qs.append(s["reads"][r])
                ts.append(tpl)
                st.append(s["strands"][r])
                meta.append((si, r, -1))
            for r, v in self._entries(s):
                j, e = divmod(int(s["cols"][v]), rph.NUM_EDIT)
                qs.append(s["reads"][r])
                ts.append(rph.apply_edit(tpl, e, j))
                st.append(s["strands"][r])
                meta.append((si, r, v))
        if not any(v >= 0 for _si, _r, v in meta):
            return float(red.BIG)
        lk = rph.forward_lk(qs, ts, st, hmms, self.device)
        lk_c = None if control is None else rph.forward_lk(
            qs, ts, st, hmms, self.device, dtype=control)
        base = {(si, r): k for k, (si, r, v) in enumerate(meta) if v < 0}
        gap = 0.0
        for k, (si, r, v) in enumerate(meta):
            if v < 0:
                continue
            b = base[(si, r)]
            want = lk[k] - lk[b]
            got = self.samples[si]["X"][r, v] if lk_c is None \
                else lk_c[k] - lk_c[b]
            gap = max(gap, abs(float(got) - float(want)))
        return gap

    def _cigar_gap(self, control=None):
        """The largest excess of a read's CIGAR over its least edit
        distance to the template it was refreshed against."""
        qs, ts, cgs = [], [], []
        for s in self.samples:
            for q, c in zip(s["reads"], s["cigars"]):
                qs.append(q)
                ts.append(s["template"])
                cgs.append(c)
        if not qs:
            return float(red.BIG)
        best = red.edit_distance(qs, ts, self.device)
        if control is not None:
            qs, ts, best, cgs = red.control_cigars(
                qs, ts, best, int(self.wl["control_pairs"]), control,
                self.device)
        return float(max(red.cigar_cost(c, q, t) - int(b)
                         for c, q, t, b in zip(cgs, qs, ts, best)))

    def _template_excess(self):
        out = 0.0 if self.samples else float(red.BIG)
        for s in self.samples:
            wins = truth.hap_windows(self.genome, s["cid"])
            pairs = [(a, b) for a in range(len(wins))
                     for b in range(a + 1, len(wins))]
            d_t = red.edit_distance([s["template"]] * len(wins), wins,
                                    self.device)
            d_w = red.edit_distance([wins[a] for a, _b in pairs],
                                    [wins[b] for _a, b in pairs], self.device)
            ex = min(int(d_t[a] + d_t[b] - d_w[k])
                     for k, (a, b) in enumerate(pairs))
            out = max(out, float(ex))
        return out

    def _score_gap(self, control=None):
        """The largest gap, relative, between a chain's best score and the
        objective of the assignment it returned; ``BIG`` where a sampled
        chunk with variant columns came without a chain, or none has
        one."""
        if any(self._chainless(s) for s in self.samples):
            return float(red.BIG)
        gap = 0.0
        n = 0
        for s in self.samples:
            for X, K, asn, score in s["chains"]:
                obj = rcl.objective(X, asn, self.coverage, K)
                if control is not None:
                    score = rcl.objective(X, asn, self.coverage, K,
                                          dtype=control)
                gap = max(gap, abs(score - obj) / max(1.0, abs(obj)))
                n += 1
        return gap if n else float(red.BIG)

    @staticmethod
    def _chainless(s):
        return s["X"] is not None and not any(K == 2 for _X, K, _a, _s
                                              in s["chains"])

    def _truth_shortfall(self):
        """The largest shortfall, relative, of a two-cluster chain's best
        score below the objective of the truth partition."""
        if any(self._chainless(s) or not s["came"] for s in self.samples):
            return float(red.BIG)
        out = 0.0
        for s in self.samples:
            for X, K, _asn, score in s["chains"]:
                if K != 2:
                    continue
                obj = rcl.objective(X, s["truth"], self.coverage, K)
                out = max(out, (obj - score) / max(1.0, abs(obj)))
        return out


def perturb(window, n: int, rng) -> np.ndarray:
    """``window`` with ``n`` edits at distinct places drawn from ``rng``,
    at least 10 bases from either end: substitutions, insertions and
    deletions in turn."""
    w = np.asarray(window, np.int8)
    places = np.sort(rng.choice(np.arange(10, len(w) - 10), n,
                                replace=False))
    bases = rng.integers(1, 4, n).astype(np.int8)
    out, last = [], 0
    for k, (p, b) in enumerate(zip(places, bases)):
        out.append(w[last:p])
        kind = k % 3
        if kind == 0:
            out.append(np.array([(w[p] + b) % 4], np.int8))
        elif kind == 1:
            out.append(np.array([(w[p] + b) % 4, w[p]], np.int8))
        last = p + 1
    out.append(w[last:])
    return np.concatenate(out)
