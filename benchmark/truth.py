"""Truth-built inputs and truth lookups shared by the jobs.

From the simulator's placements: each read's bases in the chunks'
orientation with their frame coordinates, the nodes a read truly has
(chunk, strand, position, sequence, CIGAR), and each chunk's haplotype
windows.  Imports numpy and the benchmark's simulator only.
"""

from __future__ import annotations

import numpy as np

import sim


def oriented(reads: sim.Reads, i: int):
    """Read ``i``'s codes and frame coordinates in the chunks' orientation
    (as the haplotype runs)."""
    c, fr = reads.codes[i], reads.frames[i]
    if reads.fwd[i]:
        return c, fr
    return sim.revcomp(c), fr[::-1]


def true_nodes(genome: sim.Genome, reads: sim.Reads, i: int,
               with_cigar: bool = True):
    """The nodes read ``i`` truly has: (chunk index, is_forward,
    position_from_start, codes in the chunk's orientation, CIGAR or None),
    by position."""
    codes, fr = oriented(reads, i)
    C = genome.chunk_len
    ok = fr[fr >= 0]
    if len(ok) == 0:
        return []
    starts = genome.chunk_starts
    # chunks whose window the read's coordinates could span
    cand = np.nonzero((starts >= ok.min() - 2)
                      & (starts + C - 3 <= ok.max()))[0]
    out = []
    L = len(codes)
    for ci in cand:
        a = int(starts[ci])
        sp = sim.node_span(fr, a, C)
        if sp is None:
            continue
        lo, hi = sp
        pos = lo if reads.fwd[i] else L - hi
        cg = sim.true_cigar(fr[lo:hi], a, C) if with_cigar else None
        out.append((int(ci), bool(reads.fwd[i]), int(pos), codes[lo:hi], cg))
    out.sort(key=lambda n: n[2])
    return out


def overlap(genome: sim.Genome, reads: sim.Reads, i: int, ci: int):
    """(bases of read ``i`` whose coordinate falls in chunk ``ci``'s
    window, position_from_start of the first of them)."""
    codes, fr = oriented(reads, i)
    a, C = int(genome.chunk_starts[ci]), genome.chunk_len
    inside = np.nonzero((fr >= a) & (fr < a + C))[0]
    if len(inside) == 0:
        return 0, -1
    lo, hi = int(inside[0]), int(inside[-1]) + 1
    return len(inside), (lo if reads.fwd[i] else len(codes) - hi)


def hap_windows(genome: sim.Genome, ci: int):
    """Each haplotype's copies of chunk ``ci``'s window: the runs of bases
    whose coordinates cover it end to end."""
    a, C = int(genome.chunk_starts[ci]), genome.chunk_len
    out = []
    for h, fr in zip(genome.haps, genome.frames):
        idx = np.nonzero((fr >= a) & (fr < a + C))[0]
        if len(idx) == 0:
            continue
        cuts = np.nonzero(np.diff(idx) > C)[0] + 1
        for run in np.split(idx, cuts):
            if fr[run[0]] <= a + 2 and fr[run[-1]] >= a + C - 3:
                out.append(h[run[0]:run[-1] + 1])
    return out
