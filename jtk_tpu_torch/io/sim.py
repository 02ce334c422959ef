"""Synthetic diploid genome + noisy long-read simulator.

Counterpart of the reference's dev harness (``sandbox/src/bin/gen_sim_genome*.rs``
and the NanoSim scripts, SURVEY.md §2.6): generates a random genome, a diverged
second haplotype (SNVs + small indels + optional SVs), and noisy reads with
ONT-like error profiles — used by tests and benchmarks throughout.
"""

from __future__ import annotations

import numpy as np

from ..datamodel import DataSet, RawRead, ReadType
from .. import seq as seqmod


def random_genome(rng: np.random.Generator, length: int) -> np.ndarray:
    return rng.integers(0, 4, size=length).astype(np.int8)


def mutate(rng: np.random.Generator, seq: np.ndarray, sub: float = 0.0,
           ins: float = 0.0, dele: float = 0.0) -> np.ndarray:
    """Apply random substitutions/insertions/deletions at the given rates."""
    out = []
    for b in seq:
        x = rng.random()
        if x < dele:
            continue
        if x < dele + sub:
            out.append((b + 1 + rng.integers(0, 3)) % 4)
        else:
            out.append(b)
        if rng.random() < ins:
            out.append(rng.integers(0, 4))
    return np.array(out, dtype=np.int8)


def diploid(rng: np.random.Generator, length: int, het: float = 0.001):
    """Two haplotypes diverged by ``het`` (2/3 SNV, 1/6 ins, 1/6 del)."""
    hap1 = random_genome(rng, length)
    hap2 = mutate(rng, hap1, sub=het * 2 / 3, ins=het / 6, dele=het / 6)
    return hap1, hap2


def noisy_read(rng: np.random.Generator, template: np.ndarray, error: float):
    """ONT-ish error mix: 1/3 sub, 1/3 ins, 1/3 del of total ``error``."""
    return mutate(rng, template, sub=error / 3, ins=error / 3, dele=error / 3)


def noisy_read_ont_profile(rng: np.random.Generator, template: np.ndarray,
                           error: float):
    """NanoSim-style ONT error model (the reference simulates its mock reads
    with NanoSim, script/generate_mock_reads_from_mock_genome.sh):
    deletion-heavy mix (~40% del / 20% ins / 40% sub of the total rate) with
    homopolymer-run-amplified indels — runs of length L see their del rate
    scaled by ~(1 + 0.6·(L-1)), the dominant ONT basecaller failure mode."""
    t = np.asarray(template, np.int8)
    n = len(t)
    if n == 0:
        return t.copy()
    # homopolymer run length at each position (length of the run it sits in)
    change = np.concatenate([[True], t[1:] != t[:-1]])
    run_id = np.cumsum(change) - 1
    run_len = np.bincount(run_id)
    L = run_len[run_id].astype(np.float64)
    hp_amp = 1.0 + 0.6 * (L - 1.0)
    p_del = np.minimum(0.40 * error * hp_amp, 0.9)
    p_sub = 0.40 * error
    p_ins = 0.20 * error * (1.0 + 0.3 * (L - 1.0))
    x = rng.random(n)
    deleted = x < p_del
    subbed = (~deleted) & (x < p_del + p_sub)
    ins_after = rng.random(n) < p_ins
    out = []
    for i in range(n):
        if not deleted[i]:
            b = t[i]
            if subbed[i]:
                b = (b + 1 + rng.integers(0, 3)) % 4
            out.append(b)
        if ins_after[i]:
            # half of insertions duplicate the current base (homopolymer
            # lengthening), half are random
            out.append(t[i] if rng.random() < 0.5 else rng.integers(0, 4))
    return np.array(out, dtype=np.int8)


def sample_read_length_ont(rng: np.random.Generator, mean_len: int,
                           min_len: int = 500) -> int:
    """ONT ultra-long length model: lognormal body + heavy tail (NanoSim's
    empirical kernel-density lengths are right-skewed; a lognormal with
    sigma 0.75 reproduces the shape adequately)."""
    sigma = 0.75
    mu = np.log(mean_len) - sigma * sigma / 2
    return max(int(rng.lognormal(mu, sigma)), min_len)


# ---------------------------------------------------------------------------
# SV / repeat genome generators (reference dev-harness parity:
# sandbox/src/bin/gen_sim_genome.rs, gen_sim_genome_segdup.rs)
# ---------------------------------------------------------------------------


def segdup_diploid(rng: np.random.Generator, segdup_len: int = 1_000_000,
                   padding: int = 100_000, divergence: float = 0.05,
                   het: float = 0.001):
    """Two haplotypes each carrying a two-copy segmental duplication.

    hapA = leading + segdup + pad + segdup' + trail where segdup' diverges
    from segdup by ``divergence``; hapB = hapA with ``het`` variants
    (gen_sim_genome_segdup.rs:30-43, scaled by the size arguments).
    """
    segdup = random_genome(rng, segdup_len)
    d = divergence / 3
    segdup2 = mutate(rng, segdup, sub=d, ins=d, dele=d)
    leading = random_genome(rng, padding)
    pad = random_genome(rng, padding)
    trail = random_genome(rng, padding)
    hap_a = np.concatenate([leading, segdup, pad, segdup2, trail])
    h = het / 3
    hap_b = mutate(rng, hap_a, sub=h, ins=h, dele=h)
    return hap_a, hap_b


def shared_repeat_diploid(rng: np.random.Generator, flank: int = 1500,
                          repeat_len: int = 1000, mid: int = 1500,
                          repeat_div: float = 0.0, het: float = 0.0,
                          n_snv: int = 12):
    """Diploid with a NEAR-EXACT two-copy repeat shared by both haplotypes:
    hap = A + R + B + R' + C, haplotypes differing only by flank SNVs.

    The repeat copies collapse to the same chunks (copy_num 2); only reads
    spanning a whole copy can phase the flanks — the workload that exercises
    focus-based repeat resolution (repeat_resolve_by_focus.rs:90-246)."""
    a = random_genome(rng, flank)
    b = random_genome(rng, mid)
    c = random_genome(rng, flank)
    rep = random_genome(rng, repeat_len)
    d = repeat_div / 3
    rep2 = mutate(rng, rep, sub=d, ins=d, dele=d) if repeat_div else rep.copy()
    hap1 = np.concatenate([a, rep, b, rep2, c])
    hap2 = hap1.copy()
    # haplotype SNVs in the UNIQUE regions only (flanks + middle)
    unique_pos = np.concatenate([
        np.arange(50, flank - 50),
        np.arange(flank + repeat_len + 50, flank + repeat_len + mid - 50),
        np.arange(len(hap1) - flank + 50, len(hap1) - 50),
    ])
    snv = rng.choice(unique_pos, size=min(n_snv, len(unique_pos)),
                     replace=False)
    for p in snv:
        hap2[p] = (hap2[p] + 1 + rng.integers(0, 3)) % 4
    if het:
        h = het / 3
        hap2 = mutate(rng, hap2, sub=h, ins=h, dele=h)
    return hap1, hap2, np.sort(snv)


def sv_diploid(rng: np.random.Generator, length: int = 1_000_000,
               scale: float = 1.0, het: float = 0.0005):
    """Reference + two SV-laden haplotypes (gen_sim_genome.rs:4-17 layout,
    coordinates scaled by ``length/1Mbp * scale``).

    hapA: del ref[.05..".08], del [.10..".12], inversion [.32..".37],
          del [.53..".58], 5%-of-length insertion at .70.
    hapB: same except NO [.53..".58] deletion, plus an insertion at .90.
    Both then receive ``het`` random variants.  Returns (ref, hapA, hapB).
    """
    ref = random_genome(rng, length)
    L = length

    def frac(x):
        return int(x * L * scale)

    ins1 = random_genome(rng, frac(0.05))
    ins2 = random_genome(rng, frac(0.05))
    inv = seqmod.revcomp(ref[frac(0.32):frac(0.37)])
    seg1 = np.concatenate([ref[:frac(0.05)], ref[frac(0.08):frac(0.10)],
                           ref[frac(0.12):frac(0.20)]])
    seg2 = np.concatenate([ref[frac(0.20):frac(0.32)], inv,
                           ref[frac(0.37):frac(0.40)]])
    seg3_a = np.concatenate([ref[frac(0.40):frac(0.53)],
                             ref[frac(0.58):frac(0.60)]])
    seg3_b = ref[frac(0.40):frac(0.60)]
    seg4 = np.concatenate([ref[frac(0.60):frac(0.70)], ins1,
                           ref[frac(0.70):frac(0.80)]])
    seg5_a = ref[frac(0.80):]
    seg5_b = np.concatenate([ref[frac(0.80):frac(0.90)], ins2,
                             ref[frac(0.90):]])
    hap_a = np.concatenate([seg1, seg2, seg3_a, seg4, seg5_a])
    hap_b = np.concatenate([seg1, seg2, seg3_b, seg4, seg5_b])
    h = het / 3
    hap_a = mutate(rng, hap_a, sub=h, ins=h, dele=h)
    hap_b = mutate(rng, hap_b, sub=h, ins=h, dele=h)
    return ref, hap_a, hap_b


def simulate_reads(rng: np.random.Generator, haplotypes, coverage: float,
                   mean_len: int, error: float, min_len: int = 500,
                   clip_ends: bool = False, profile: str | None = None):
    """Sample reads uniformly over the haplotypes; ~half reverse strand.

    ``clip_ends=True`` samples reads as if the region were EXTRACTED from a
    larger genome (reads overlapping the boundary are clipped to it), giving
    uniform coverage all the way to the region ends — the reference's
    COX_PGF-style workflow (README.md:16-21).  Default sampling confines
    reads inside the region, which tapers coverage over ~read-length at each
    end (realistic for a complete molecule, harsh for tiny test genomes).

    Returns list of dicts: codes, hap (index), start, end, is_forward.
    """
    reads = []
    total = sum(len(h) for h in haplotypes)
    n_reads = max(int(coverage * total / mean_len), 1)
    for _ in range(n_reads):
        h = int(rng.integers(0, len(haplotypes)))
        hap = haplotypes[h]
        if profile == "ont":
            ln = min(sample_read_length_ont(rng, mean_len, min_len),
                     len(hap))
        else:
            ln = int(np.clip(rng.normal(mean_len, mean_len / 4), min_len,
                             len(hap)))
        if clip_ends:
            start = int(rng.integers(-(ln - min_len),
                                     max(len(hap) - min_len, 1)))
            end = min(start + ln, len(hap))
            start = max(start, 0)
            if end - start < min_len:
                continue
            ln = end - start
        else:
            start = int(rng.integers(0, max(len(hap) - ln, 1)))
        frag = hap[start:start + ln]
        codes = noisy_read_ont_profile(rng, frag, error) \
            if profile == "ont" else noisy_read(rng, frag, error)
        fwd = bool(rng.random() < 0.5)
        if not fwd:
            codes = seqmod.revcomp(codes)
        reads.append({"codes": codes, "hap": h, "start": start,
                      "end": start + ln, "is_forward": fwd})
    return reads


def reads_to_dataset(reads, read_type: str = ReadType.ONT,
                     input_file: str = "sim.fa") -> DataSet:
    raws = []
    for i, r in enumerate(reads):
        raws.append(RawRead(f"sim_{i}", "", i,
                            seqmod.decode(r["codes"]).decode()))
    return DataSet.with_minimum_data(input_file, raws, read_type)
