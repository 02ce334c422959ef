"""The benchmark's simulator: haplotypes, reads and each base's true origin.

A frozen, vectorised copy of the port's ``io/sim.py`` models
(``diploid``, ``segdup_diploid``, ``mutate``/``noisy_read``,
``simulate_reads`` with ``clip_ends``): the same rates, mixes and length
law, drawn in bulk so that a 1 Mbp region at 60x (120 Mbp of reads) takes
seconds instead of a per-base Python loop.  Each mutation step also
returns its coordinate map (``origin``: for every output base the index
of the source base it copies, or -1 for an inserted base), so every read
base is placed exactly on haplotype 1 and on the chunk windows.

Imports numpy only: nothing of the program under test.
"""

from __future__ import annotations

import numpy as np

COMP = np.array([3, 2, 1, 0, 4], np.int8)


def revcomp(codes: np.ndarray) -> np.ndarray:
    return COMP[np.asarray(codes)[::-1]]


def mutate_from_draws(seq, x, sub_off, ins_u, ins_base, sub: float,
                      ins: float, dele: float):
    """``io/sim.py::mutate``'s rule on given draws: base i is deleted when
    ``x[i] < dele``, else substituted by ``(b + sub_off[i]) % 4``
    (``sub_off`` in 1..3) when ``x[i] < dele + sub``; a kept base is
    followed by ``ins_base[i]`` when ``ins_u[i] < ins``.

    Returns (out int8, origin int32)."""
    seq = np.asarray(seq, np.int8)
    kept = x >= dele
    subbed = kept & (x < dele + sub)
    ins_after = kept & (ins_u < ins)
    cnt = kept.astype(np.int64) + ins_after
    ends = np.cumsum(cnt)
    starts = ends - cnt
    total = int(ends[-1]) if len(ends) else 0
    out = np.empty(total, np.int8)
    origin = np.full(total, -1, np.int32)
    kidx = np.nonzero(kept)[0]
    base = np.where(subbed, (seq + sub_off) % 4, seq).astype(np.int8)
    out[starts[kidx]] = base[kidx]
    origin[starts[kidx]] = kidx
    iidx = np.nonzero(ins_after)[0]
    out[starts[iidx] + 1] = ins_base[iidx]
    return out, origin


def mutate(rng: np.random.Generator, seq, sub=0.0, ins=0.0, dele=0.0):
    """Random substitutions, insertions and deletions at the given rates
    (``io/sim.py::mutate``'s model).  Returns (out, origin)."""
    n = len(seq)
    x = rng.random(n)
    sub_off = rng.integers(1, 4, n).astype(np.int8)
    ins_u = rng.random(n)
    ins_base = rng.integers(0, 4, n).astype(np.int8)
    return mutate_from_draws(seq, x, sub_off, ins_u, ins_base, sub, ins,
                             dele)


def random_genome(rng, length: int) -> np.ndarray:
    return rng.integers(0, 4, size=length).astype(np.int8)


def compose(outer: np.ndarray, inner: np.ndarray) -> np.ndarray:
    """Origin through two steps: ``outer`` maps into the sequence whose
    own origin is ``inner``."""
    return np.where(outer >= 0, inner[np.maximum(outer, 0)], -1) \
        .astype(np.int32)


class Genome:
    """Two haplotypes and, for each, every base's coordinate on the chunk
    frame (haplotype 1, with a duplicate's second copy folded onto its
    first), or -1 where the base has none."""

    def __init__(self, haps, frames, chunk_starts, copy_nums, chunk_len,
                 second_copy=None):
        self.haps = haps
        # per haplotype, the index from which its bases are nearer the
        # duplicate's second copy than its first
        self.second_copy = second_copy or [len(h) for h in haps]
        self.frames = frames
        self.chunk_starts = np.asarray(chunk_starts, np.int64)
        self.copy_nums = np.asarray(copy_nums, np.int64)
        self.chunk_len = int(chunk_len)

    def chunk_seq(self, i: int) -> np.ndarray:
        """Haplotype 1's bases at chunk ``i``'s window (its first copy)."""
        a = int(self.chunk_starts[i])
        fr = self.frames[0]
        lo = int(np.argmax(fr == a))
        seq = self.haps[0][lo:lo + self.chunk_len]
        assert fr[lo] == a and fr[lo + self.chunk_len - 1] == a + \
            self.chunk_len - 1
        return seq


def _chunk_layout(spans, length: int, n_chunks: int, chunk_len: int):
    """``n_chunks`` windows of ``chunk_len`` spread evenly over the union
    of ``spans`` (pairs of frame coordinates)."""
    total = sum(b - a for a, b in spans)
    step = total / n_chunks
    starts = []
    for i in range(n_chunks):
        off = int(round(i * step))
        for a, b in spans:
            if off < b - a:
                starts.append(a + min(off, b - a - chunk_len))
                break
            off -= b - a
    return np.array(starts, np.int64)


def make_genome(rng, cfg: dict) -> Genome:
    """The configuration's region: ``diploid`` (one copy) or ``segdup``
    (``upstream``'s two-copy duplication between paddings)."""
    g = cfg["genome"]
    C = int(cfg["chunk_len"])
    if g["kind"] == "diploid":
        L = int(g["length"])
        hap1 = random_genome(rng, L)
        het = float(g["het"])
        hap2, o2 = mutate(rng, hap1, sub=het * 2 / 3, ins=het / 6,
                          dele=het / 6)
        frames = [np.arange(L, dtype=np.int32), o2]
        starts = _chunk_layout([(0, L)], L, int(g["chunks"]), C)
        return Genome([hap1, hap2], frames, starts,
                      np.full(len(starts), 2), C)
    if g["kind"] == "segdup":
        S, P = int(g["segdup_len"]), int(g["padding"])
        d = float(g["divergence"]) / 3
        segdup = random_genome(rng, S)
        segdup2, o_dup = mutate(rng, segdup, sub=d, ins=d, dele=d)
        leading, pad, trail = (random_genome(rng, P) for _ in range(3))
        hap_a = np.concatenate([leading, segdup, pad, segdup2, trail])
        # frame of hap_a: the second copy folds onto the first
        fr_a = np.concatenate([
            np.arange(P + S + P, dtype=np.int32),
            np.where(o_dup >= 0, P + o_dup, -1).astype(np.int32),
            np.arange(len(trail), dtype=np.int32) + 2 * P + S])
        h = float(g["het"]) / 3
        hap_b, o_b = mutate(rng, hap_a, sub=h, ins=h, dele=h)
        frames = [fr_a, compose(o_b, fr_a)]
        # chunk frame: leading | copy 1 | pad | trail
        spans = [(0, P + S + P), (P + S + P, 2 * P + S + P)]
        starts = _chunk_layout(spans, 3 * P + S, int(g["chunks"]), C)
        # a window wholly inside the first copy gathers both copies' reads
        in_dup = (starts >= P) & (starts + C <= P + S)
        cps = np.where(in_dup, 4, 2)
        mid = P + S + P // 2
        second = [mid, int(np.argmax(o_b >= mid))]
        return Genome([hap_a, hap_b], frames, starts, cps, C, second)
    raise ValueError(f"unknown genome kind {g['kind']!r}")


class Reads:
    """Simulated reads: codes as sequenced, and for each base its frame
    coordinate (-1 where it has none).  ``hap``, ``fwd`` per read, and
    ``copy``: 1 where the read lies on a duplicate's second copy."""

    def __init__(self, codes, frames, hap, fwd, copy=None):
        self.codes = codes
        self.frames = frames
        self.hap = np.asarray(hap, np.int64)
        self.fwd = np.asarray(fwd, bool)
        self.copy = np.zeros(len(self.hap), np.int64) if copy is None \
            else np.asarray(copy, np.int64)

    def __len__(self):
        return len(self.codes)


def simulate_reads(rng, genome: Genome, cfg: dict) -> Reads:
    """``io/sim.py::simulate_reads`` with ``clip_ends=True``: reads
    uniform over both haplotypes, lengths normal(mean, mean/4) clipped to
    [min_len, haplotype], starts as if the region were cut from a longer
    genome, errors 1/3 each of sub, ins, del, half reversed."""
    r = cfg["reads"]
    mean, err = int(r["mean_len"]), float(r["error"])
    min_len = int(r.get("min_len", 500))
    haps = genome.haps
    total = sum(len(h) for h in haps)
    n = max(int(float(r["coverage"]) * total / mean), 1)
    hap = rng.integers(0, len(haps), n)
    hl = np.array([len(haps[h]) for h in hap])
    ln = np.clip(rng.normal(mean, mean / 4, n), min_len, hl).astype(np.int64)
    start = np.floor(rng.random(n) * (hl - min_len + ln - min_len)) \
        .astype(np.int64) - (ln - min_len)
    end = np.minimum(start + ln, hl)
    start = np.maximum(start, 0)
    fwd = rng.random(n) < 0.5
    keep = end - start >= min_len
    codes, frames = [], []
    e3 = err / 3
    for i in np.nonzero(keep)[0]:
        h = int(hap[i])
        frag = haps[h][start[i]:end[i]]
        out, org = mutate(rng, frag, sub=e3, ins=e3, dele=e3)
        fr = np.where(org >= 0, genome.frames[h][start[i] + np.maximum(org, 0)],
                      -1).astype(np.int32)
        if not fwd[i]:
            out, fr = revcomp(out), fr[::-1].copy()
        codes.append(out)
        frames.append(fr)
    second = np.array([genome.second_copy[h] for h in hap])
    copy = (start + end) // 2 >= second
    return Reads(codes, frames, hap[keep], fwd[keep], copy[keep])


def node_span(read_frame_fwd: np.ndarray, a: int, C: int):
    """The read bases (in the chunk's orientation) that cover frame window
    [a, a + C): (lo, hi) with hi exclusive, or None where the read does not
    span the window from end to end (within two bases at each end)."""
    fr = read_frame_fwd
    inside = np.nonzero((fr >= a) & (fr < a + C))[0]
    if len(inside) == 0:
        return None
    lo, hi = int(inside[0]), int(inside[-1]) + 1
    if fr[lo] > a + 2 or fr[hi - 1] < a + C - 3:
        return None
    return lo, hi


def true_cigar(seg_frame: np.ndarray, a: int, C: int):
    """The CIGAR of a node's bases against its chunk from their frame
    coordinates: M for a base whose coordinate lies in the window and
    passes every earlier one, I for any other, D for each window
    coordinate no base has."""
    co = np.where((seg_frame >= a) & (seg_frame < a + C), seg_frame,
                  -1).astype(np.int64)
    best = np.maximum.accumulate(np.concatenate([[a - 1], co]))
    prev = best[:-1]
    m = co > prev
    d = np.where(m, co - prev - 1, 0)
    tail = a + C - 1 - int(best[-1])
    # entries: an optional D run before each base, then the base's M or I
    cnt = 1 + (d > 0)
    pos = np.cumsum(cnt) - 1
    n = int(pos[-1]) + 1 if len(pos) else 0
    kinds = np.empty(n + 1, np.int8)
    lens = np.empty(n + 1, np.int64)
    kinds[pos] = np.where(m, 0, 1)
    lens[pos] = 1
    dpos = pos[d > 0] - 1
    kinds[dpos] = 2
    lens[dpos] = d[d > 0]
    kinds[n], lens[n] = 2, tail
    keep = lens > 0
    kinds, lens = kinds[keep], lens[keep]
    starts = np.concatenate([[0], np.nonzero(np.diff(kinds))[0] + 1])
    sums = np.add.reduceat(lens, starts)
    return list(zip(np.array(list("MID"))[kinds[starts]].tolist(),
                    sums.tolist()))


def simulate(seed: int, cfg: dict):
    """(genome, reads) of the configuration from ``seed``."""
    rng = np.random.default_rng(seed)
    genome = make_genome(rng, cfg)
    return genome, simulate_reads(rng, genome, cfg)
