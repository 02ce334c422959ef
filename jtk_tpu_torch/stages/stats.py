"""Stats report (reference: haplotyper/src/stats.rs:13-203).

Human-readable summary: read/chunk/encoding counts, N50, coverage and
error-rate summaries, terminal histograms.
"""

from __future__ import annotations

import numpy as np

from ..datamodel import DataSet


def n50(lengths) -> int:
    if not lengths:
        return 0
    ls = sorted(lengths, reverse=True)
    half = sum(ls) / 2
    acc = 0
    for l in ls:
        acc += l
        if acc >= half:
            return l
    return ls[-1]


def histogram(values, bins: int = 20, width: int = 40) -> str:
    """Terminal histogram (histgram_viz counterpart)."""
    if len(values) == 0:
        return "(empty)"
    counts, edges = np.histogram(values, bins=bins)
    peak = counts.max() or 1
    lines = []
    for c, lo, hi in zip(counts, edges, edges[1:]):
        bar = "#" * int(width * c / peak)
        lines.append(f"{lo:>10.1f}-{hi:<10.1f} {c:>6} {bar}")
    return "\n".join(lines)


def stats_report(ds: DataSet) -> str:
    out = []
    raw_lens = [len(r.seq) for r in ds.raw_reads]
    out.append("# Raw reads")
    out.append(f"reads\t{len(raw_lens)}")
    out.append(f"total_bp\t{sum(raw_lens)}")
    out.append(f"mean_len\t{np.mean(raw_lens):.0f}" if raw_lens else "mean_len\t0")
    out.append(f"N50\t{n50(raw_lens)}")
    if raw_lens:
        out.append(histogram(raw_lens))
    out.append("# Chunks")
    out.append(f"chunks\t{len(ds.selected_chunks)}")
    if ds.selected_chunks:
        lens = [len(c.seq) for c in ds.selected_chunks]
        out.append(f"mean_chunk_len\t{np.mean(lens):.0f}")
        cn = [c.cluster_num for c in ds.selected_chunks]
        out.append(f"mean_cluster_num\t{np.mean(cn):.2f}")
        cp = [c.copy_num for c in ds.selected_chunks]
        out.append(f"mean_copy_num\t{np.mean(cp):.2f}")
    out.append("# Encoded reads")
    out.append(f"encoded_reads\t{len(ds.encoded_reads)}")
    if ds.encoded_reads:
        rates = [er.encoded_rate() for er in ds.encoded_reads]
        out.append(f"mean_encoded_rate\t{np.mean(rates):.3f}")
        nnodes = [len(er.nodes) for er in ds.encoded_reads]
        out.append(f"total_nodes\t{sum(nnodes)}")
        out.append(f"mean_nodes_per_read\t{np.mean(nnodes):.2f}")
        # per-node error rates
        chunks = {c.id: c.seq for c in ds.selected_chunks}
        errs = []
        for er in ds.encoded_reads:
            for n in er.nodes:
                mat, mism, ins, dele = n.aln_stats(chunks[n.chunk])
                aln = mat + mism + ins + dele
                if aln:
                    errs.append((mism + ins + dele) / aln)
        if errs:
            out.append(f"median_node_error\t{np.median(errs):.4f}")
            mad = np.median(np.abs(np.array(errs) - np.median(errs)))
            out.append(f"mad_node_error\t{mad:.4f}")
    if ds.coverage.is_available:
        out.append(f"haploid_coverage\t{ds.coverage.unwrap():.2f}")
    return "\n".join(out) + "\n"
