"""Standalone contig polishing from external alignments (``jtk polish``).

Reference: ``haplotyper/src/polish_segments.rs`` — applies the windowed
pair-HMM polisher to external contigs (FASTA/GFA) using external SAM/PAF
alignments, with probabilistic primary-alignment selection per read
(softmax over scores, :100-136) and GFA-aware output (:303-389); uses the
default (untrained) HMM (:41-53).
"""

from __future__ import annotations

import logging

import numpy as np

from .. import seq as seqmod
from ..datamodel import HMMParam, ReadType
from ..io.sam import read_paf, read_sam
from ..ops.phmm import PHMMParams
from ..ops.polish import polish_until_converge
from .consensus import _stitch, trim_segments
from .entry import read_fasta

logger = logging.getLogger(__name__)


def _load_contigs(path: str):
    if path.endswith(".gfa"):
        from ..io.gfa import parse_gfa
        with open(path) as f:
            segs, _ = parse_gfa(f.read())
        return {name: rec["seq"] for name, rec in segs.items()}, True
    return {name: seq for name, _d, seq in read_fasta(path)}, False


def polish_segments_files(reads_path: str, contigs_path: str, aln_path: str,
                          fmt: str, out_path: str, window: int = 2000,
                          read_type: str = "ONT", seed: int = 42,
                          overlap: int = 100, cap: int = 30,
                          min_cov: int = 4) -> None:
    reads = {name: seq for name, _d, seq in read_fasta(reads_path)}
    contigs, is_gfa = _load_contigs(contigs_path)
    alns = list(read_sam(aln_path) if fmt == "sam" else read_paf(aln_path))
    params = PHMMParams.from_hmmparam(HMMParam())
    rng = np.random.default_rng(seed)
    # probabilistic primary selection (register_sam,
    # polish_segments.rs:100-136): per read, repeatedly softmax-sample one
    # alignment by cigar score and drop others overlapping it >10% on the
    # read, so split reads keep their non-overlapping pieces
    per_read: dict[str, list] = {}
    for a in alns:
        per_read.setdefault(a.qname, []).append(a)
    by_contig: dict[str, list] = {}
    for qname, bucket in per_read.items():
        rlen = max((a.qend for a in bucket), default=1)
        while bucket:
            scores = np.array([a.score for a in bucket], float)
            w = np.exp(scores - scores.max())
            pick = bucket[rng.choice(len(bucket), p=w / w.sum())]
            bucket = [a for a in bucket if a is not pick and
                      (min(a.qend, pick.qend) - max(a.qstart, pick.qstart))
                      < 0.1 * max(rlen, 1)]
            by_contig.setdefault(pick.tname, []).append(pick)
    out = {}
    for tname, cseq_str in contigs.items():
        cseq = seqmod.encode(cseq_str)
        aligns = by_contig.get(tname, [])
        if not aligns or len(cseq) < 200:
            out[tname] = cseq_str
            continue
        parts = []
        n_win = max((len(cseq) + window - 1) // window, 1)
        for wi in range(n_win):
            w0, w1 = wi * window, min((wi + 1) * window, len(cseq))
            ext0, ext1 = max(w0 - overlap, 0), min(w1 + overlap, len(cseq))
            template = cseq[ext0:ext1]
            segs = []
            for a in aligns:
                if a.tstart > ext0 + 50 or a.tend < ext1 - 50:
                    continue
                rseq = reads.get(a.qname)
                if rseq is None:
                    continue
                codes = seqmod.encode(rseq)
                # anchors are in forward-query coords
                qs_arr = np.array([p[0] for p in a.anchors])
                ts_arr = np.array([p[1] for p in a.anchors])
                lo = int(np.interp(ext0, ts_arr, qs_arr)) - 150
                hi = int(np.interp(ext1, ts_arr, qs_arr)) + 150
                if a.strand < 0:
                    codes = seqmod.revcomp(codes)
                seg = codes[max(lo, 0):min(hi, len(codes))]
                if len(seg) >= (ext1 - ext0) // 2:
                    segs.append(seg)
            if len(segs) > cap:
                idx = rng.permutation(len(segs))[:cap]
                segs = [segs[i] for i in idx]
            segs = trim_segments(template, segs, 150)
            if len(segs) >= min_cov:
                band = max(ReadType.band_width(read_type, len(template)), 64)
                band = ((band + 63) // 64) * 64
                template, _ = polish_until_converge(template, segs, params,
                                                    W=band, max_rounds=6)
            parts.append(template)
        stitched = None
        for tpl in parts:
            stitched = tpl if stitched is None \
                else _stitch(stitched, tpl, 2 * overlap)[0]
        out[tname] = seqmod.decode(stitched).decode() if stitched is not None \
            else cseq_str
    with open(out_path, "w") as f:
        if is_gfa:
            f.write("H\tVN:Z:1.0\n")
            for name, seq in out.items():
                f.write(f"S\t{name}\t{seq}\tLN:i:{len(seq)}\n")
        else:
            for name, seq in out.items():
                f.write(f">{name}\n{seq}\n")
    logger.info("polish_segments: %d contigs -> %s", len(out), out_path)
