"""Entry stage: FASTA/FASTQ -> DataSet.

Reference: ``haplotyper/src/entry.rs:3-63`` — uppercases, rejects reads with
non-ACGT characters, and compresses homopolymers longer than a read-type
threshold (>100 bp for ONT/CCS, >40 bp for CLR) to tame alignment artifacts.
"""

from __future__ import annotations

from ..datamodel import DataSet, RawRead, ReadType


def _compress_homopolymers(seq: str, max_run: int) -> str:
    out = []
    prev = ""
    run = 0
    for ch in seq:
        if ch == prev:
            run += 1
        else:
            prev, run = ch, 1
        if run <= max_run:
            out.append(ch)
    return "".join(out)


def read_fasta(path: str):
    """Plain FASTA/FASTQ reader (bio_utils counterpart). Yields (name, desc, seq)."""
    name, desc, seq = None, "", []
    with open(path) as f:
        first = f.read(1)
        f.seek(0)
        if first == ">":
            for line in f:
                line = line.rstrip("\n")
                if line.startswith(">"):
                    if name is not None:
                        yield name, desc, "".join(seq)
                    fields = line[1:].split(None, 1)
                    name = fields[0] if fields else ""
                    desc = fields[1] if len(fields) > 1 else ""
                    seq = []
                else:
                    seq.append(line)
            if name is not None:
                yield name, desc, "".join(seq)
        elif first == "@":
            while True:
                hdr = f.readline().rstrip("\n")
                if not hdr:
                    break
                s = f.readline().rstrip("\n")
                f.readline()
                f.readline()
                fields = hdr[1:].split(None, 1)
                yield fields[0] if fields else "", \
                    fields[1] if len(fields) > 1 else "", s


def entry(input_file: str, read_type: str = ReadType.ONT) -> DataSet:
    max_run = 40 if read_type in (ReadType.CLR, ReadType.NONE) else 100
    raws = []
    rid = 0
    for name, desc, seq in read_fasta(input_file):
        seq = seq.upper()
        if any(c not in "ACGT" for c in seq):
            continue
        seq = _compress_homopolymers(seq, max_run)
        raws.append(RawRead(name, desc, rid, seq))
        rid += 1
    ds = DataSet.with_minimum_data(input_file, raws, read_type)
    ds.push_stage("Entry", [read_type])
    return ds
