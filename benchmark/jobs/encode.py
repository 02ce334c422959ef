"""Encode jobs: ``encode`` of one batch of reads a job against every
chunk.

Set-up simulates the region and its reads, takes the chunks from the
truth (haplotype 1's windows), cuts the reads into batches, and runs the
warm-up on the first ``warmup_reads`` reads.  The window's job j is
``encode(ds)`` with ``ds.raw_reads`` batch j mod the batch count; its
encoded reads are dropped between jobs.

The check holds a sample of each job's reads, drawn from the seed,
against the simulator's placements and a plain reference
(``benchmark/reference``): ``node_gap`` is the largest excess of a node's
CIGAR (K3 and its walk) over the least edit distance of its bases to its
chunk, or ``BIG`` where a chunk the read truly spans end to end has no
node (an answer that never came) or a node lies on a chunk the read
overlaps by less than half, on the wrong strand, or more than
``place_slack`` bases from the truth (an answer that says the wrong
thing).
"""

from __future__ import annotations

import time

import numpy as np

import sim
import truth
from reference import edit as red


class Job:
    def __init__(self, cfg: dict, wl: dict, seed: int, log):
        import torch

        from jtk_tpu_torch import seq as seqmod
        from jtk_tpu_torch.datamodel import Chunk, DataSet, RawRead
        from jtk_tpu_torch.stages import encode as enc
        self.enc, self.cfg, self.wl, self.seed = enc, cfg, wl, seed
        self.log = log
        self.device = "cuda" if torch.cuda.is_available() else "cpu"
        t0 = time.perf_counter()
        self.genome, self.reads = sim.simulate(seed, cfg)
        G = self.genome
        chunks = [Chunk(i, seqmod.decode(G.chunk_seq(i)).decode(),
                        cluster_num=1, copy_num=int(G.copy_nums[i]))
                  for i in range(len(G.chunk_starts))]
        raws = [RawRead(f"sim_{i}", "", i, seqmod.decode(c).decode())
                for i, c in enumerate(self.reads.codes)]
        # the reads in equal batches of about ``encode_reads_per_call``
        k = max(1, round(len(raws) / int(cfg["encode_reads_per_call"])))
        self.batches = [raws[b * len(raws) // k:(b + 1) * len(raws) // k]
                        for b in range(k)]
        n = len(self.batches[0])
        self.ds = DataSet.with_minimum_data("sim.fa", [], cfg["read_type"])
        self.ds.selected_chunks = chunks
        t1 = time.perf_counter()
        log(f"encode set-up: simulate {t1 - t0:.2f} s ({len(raws)} reads, "
            f"{len(self.batches)} batches of {n})")
        self.ds.raw_reads = raws[:int(wl["warmup_reads"])]
        self.enc.encode(self.ds)
        self.ds.encoded_reads = []
        del self.ds.processed_stages[:]
        log(f"encode warm-up: {time.perf_counter() - t1:.2f} s")
        self.reset()

    def reset(self):
        """Forget what earlier windows produced (a new window's check)."""
        self.rng = np.random.default_rng([self.seed, 1])
        self.samples = []

    def install(self):
        """This job records nothing inside the program."""

    uninstall = install

    def before(self, i: int):
        self.ds.raw_reads = self.batches[i % len(self.batches)]
        self.ds.encoded_reads = []

    def run(self, i: int) -> int:
        self.enc.encode(self.ds)
        return len(self.ds.raw_reads)

    def after(self, i: int):
        batch = self.ds.raw_reads
        k = min(int(self.wl["sample_per_job"]), len(batch),
                int(self.wl["max_samples"]) - len(self.samples))
        pick = {int(batch[j].id) for j in self.rng.choice(len(batch), k,
                                                          replace=False)}
        got = {er.id: er for er in self.ds.encoded_reads if er.id in pick}
        for rid in sorted(pick):
            er = got.get(rid)
            self.samples.append((rid, [] if er is None else [
                (n.chunk, n.is_forward, n.position_from_start, n.seq,
                 n.cigar)
                for n in er.nodes]))
        self.ds.encoded_reads = []
        del self.ds.processed_stages[:]

    def release(self):
        self.batches = None
        self.ds.raw_reads = []
        import torch
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------
    def check(self, control: bool = False):
        """[(name, value, limit)].  ``control`` puts the reference's own
        alignment, its cells int8, in the program's place for
        each node's CIGAR."""
        import torch
        G, R = self.genome, self.reads
        C = G.chunk_len
        slack = int(self.wl["place_slack"])
        qs, ts, cgs = [], [], []
        expected = missed = misplaced = 0
        for rid, nodes in self.samples:
            want = {ci for ci, *_r in truth.true_nodes(G, R, rid, False)}
            expected += len(want)
            missed += len(want - {n[0] for n in nodes})
            for ci, fwd, pos, seq, cg in nodes:
                n_in, tpos = truth.overlap(G, R, rid, ci)
                if n_in < C // 2 or fwd != bool(R.fwd[rid]) or \
                        abs(pos - tpos) > slack:
                    misplaced += 1
                qs.append(red.encode(seq))
                ts.append(G.chunk_seq(ci))
                cgs.append(cg)
        self.log(f"record nodes {len(qs)} expected {expected} missed "
                 f"{missed} misplaced {misplaced}")
        if not expected or not qs:
            gap = float(red.BIG)
        else:
            best = red.edit_distance(qs, ts, self.device)
            if control:
                qs, ts, best, cgs = red.control_cigars(
                    qs, ts, best, int(self.wl["control_nodes"]), torch.int8,
                    self.device)
            gap = float(max(red.cigar_cost(c, q, t) - int(b)
                            for c, q, t, b in zip(cgs, qs, ts, best)))
            if missed or misplaced:
                gap = float(red.BIG)
        return [("node_gap", gap, self.wl["limits"]["node_gap"])]
