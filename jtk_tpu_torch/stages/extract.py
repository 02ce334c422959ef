"""Extract stage: dump reads / chunks / encoded reads to TSV
(reference: haplotyper/src/extract.rs — which leaves the encoded-read dump as
an unimplemented stub; implemented fully here)."""

from __future__ import annotations

from ..datamodel import DataSet, ops_to_str


def extract(ds: DataSet, target: str) -> str:
    out = []
    if target == "raw_reads":
        for r in ds.raw_reads:
            out.append(f"{r.id}\t{r.name}\t{len(r.seq)}\t{r.seq}")
    elif target == "chunks":
        for c in ds.selected_chunks:
            out.append(f"{c.id}\t{len(c.seq)}\t{c.cluster_num}\t{c.copy_num}"
                       f"\t{c.score:.3f}\t{c.seq}")
    elif target == "encoded_reads":
        for er in ds.encoded_reads:
            for n in er.nodes:
                out.append(
                    f"{er.id}\t{n.position_from_start}\t{n.chunk}\t{n.cluster}"
                    f"\t{int(n.is_forward)}\t{ops_to_str(n.cigar)}")
    else:
        raise ValueError(f"unknown extract target: {target}")
    return "\n".join(out) + "\n"
