"""Minimal SAM / PAF alignment readers (bio_utils counterpart).

Only the fields the polisher needs: query name/seq, target, strand, target
start, and (query,target) anchor points walked from the CIGAR.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Alignment:
    qname: str
    tname: str
    strand: int          # +1 / -1
    tstart: int
    tend: int
    qstart: int
    qend: int
    anchors: list        # [(qpos, tpos)] sparse anchor points (fwd q coords)
    score: float = 0.0
    seq: str | None = None  # SAM SEQ field if present (already rev-comped)


def _walk_cigar(cigar: str, qstart: int, tstart: int, step: int = 256):
    """Anchor points every ~step bases along the alignment."""
    anchors = [(qstart, tstart)]
    q, t = qstart, tstart
    num = 0
    last = qstart
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + int(ch)
            continue
        if ch in "M=X":
            q += num
            t += num
        elif ch in "IS":
            q += num
        elif ch in "DN":
            t += num
        elif ch in "HP":
            pass
        if q - last >= step and ch in "M=X":
            anchors.append((q, t))
            last = q
        num = 0
    anchors.append((q, t))
    return anchors, q, t


def read_sam(path: str):
    """Yield Alignment records from a SAM file (primary alignments only)."""
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 11:
                continue
            qname, flag, rname, pos, _mapq, cigar = fields[:6]
            flag = int(flag)
            if rname == "*" or cigar == "*" or flag & 0x4:
                continue  # unmapped (secondary/supplementary kept so the
                #            softmax primary selection can arbitrate)
            strand = -1 if flag & 0x10 else 1
            tstart = int(pos) - 1
            # leading soft/hard clip -> qstart; cigar score = aligned - errors
            num = 0
            qstart = 0
            score = 0
            first = True
            for ch in cigar:
                if ch.isdigit():
                    num = num * 10 + int(ch)
                    continue
                if first and ch in "SH":
                    qstart = num
                if ch in "M=":
                    score += num
                elif ch in "XID":
                    score -= num
                num = 0
                first = False
            anchors, qend, tend = _walk_cigar(cigar, qstart, tstart)
            seq = fields[9] if fields[9] != "*" else None
            yield Alignment(qname, rname, strand, tstart, tend, qstart, qend,
                            anchors, seq=seq, score=float(score))


def read_paf(path: str):
    """Yield Alignment records from a PAF file (cg:Z cigar used if present)."""
    with open(path) as f:
        for line in f:
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 12:
                continue
            qname, qlen, qstart, qend, strand, tname, _tlen, tstart, tend = \
                fields[:9]
            qlen = int(qlen)
            qstart, qend = int(qstart), int(qend)
            tstart, tend = int(tstart), int(tend)
            sgn = 1 if strand == "+" else -1
            cigar = None
            for tag in fields[12:]:
                if tag.startswith("cg:Z:"):
                    cigar = tag[5:]
            if cigar and sgn > 0:
                anchors, _q, _t = _walk_cigar(cigar, qstart, tstart)
            elif sgn > 0:
                anchors = [(qstart, tstart), (qend, tend)]
            else:
                # anchors in aligned-frame (rev-comped query) coordinates
                anchors = [(qlen - qend, tstart), (qlen - qstart, tend)]
            yield Alignment(qname, tname, sgn, tstart, tend, qstart, qend,
                            anchors)
