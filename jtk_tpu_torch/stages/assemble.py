"""Assemble stage: encoded reads -> ditch graph -> cleaned graph -> GFA.

Reference: ``haplotyper/src/assemble/mod.rs:119-253`` — build DitchGraph,
remove light edges, ``clean_up_graph_for_assemble`` (copy-number assignment,
tip/zero-copy removal, repeat resolution), ``spell`` to GFA with cv:i/cp:i
tags, optional consensus polishing.
"""

from __future__ import annotations

import logging

import numpy as np

from ..datamodel import DataSet
from ..graph.copy_number import assign_copy_numbers
from ..graph.ditch_graph import HEAD, TAIL, DitchGraph
from ..io.gfa import contigs_to_gfa
from .util import update_coverage

logger = logging.getLogger(__name__)


def build_graph(ds: DataSet, lightweight_frac: float = 0.15) -> DitchGraph:
    chunk_seqs = {c.id: c.seq for c in ds.selected_chunks}
    g = DitchGraph.from_encoded_reads(ds.encoded_reads, chunk_seqs)
    cov = ds.coverage.unwrap() if ds.coverage.is_available else update_coverage(ds)
    thr = max(1, int(lightweight_frac * cov))
    # assemble/mod.rs:180-181: aggressive low pass first, then the retain-
    # single-edge pass at the full threshold
    g.remove_lightweight_edges(thr // 2 + 1, False)
    g.remove_lightweight_edges(thr, True)
    return g


def clean_up_graph_for_assemble(g: DitchGraph, cov: float,
                                encoded_reads=None, min_span: int = 2,
                                min_llr: float = 1.0) -> None:
    """ditch_graph/mod.rs:645-701 cleanup sequence: copy-number assignment,
    tip removal, the descending-LLR loop of {zero-copy removal, focus repeat
    resolution, overclustering zip}, then net squishing, sibling merging and
    a final weak-focus pass."""
    from ..graph.foci import resolve_repeats
    assign_copy_numbers(g, cov)
    g.remove_tips(0.8, 4)
    g.remove_tips(0.8, 4)
    # descending LLR thresholds: resolve confident foci first
    llrs = [float(i) + 1e-5
            for i in range(int(10.0 + min_llr) - 1, int(min_llr) - 1, -1)
            if float(i) + 1e-5 > min_llr]
    for llr in llrs:
        assign_copy_numbers(g, cov)
        g.remove_zero_copy_elements(0.8)
        g.remove_zero_copy_path(0.1)
        if encoded_reads is not None:
            resolve_repeats(g, encoded_reads, min_span=min_span, llr_thr=llr,
                            bimatch=True, use_branch=False)
        g.zip_up_overclustering(2)
    assign_copy_numbers(g, cov)
    g.remove_zero_copy_elements(0.9)
    g.remove_zero_copy_path(0.3)
    g.remove_lightweight_edges(0, True)
    g.remove_tips(0.8, 4)
    g.squish_small_net(3)
    assign_copy_numbers(g, cov)
    g.zip_up_overclustering_dev()
    if encoded_reads is not None:
        for llr in llrs:
            resolve_repeats(g, encoded_reads, min_span=min_span, llr_thr=llr,
                            bimatch=False, use_branch=True)
    assign_copy_numbers(g, cov)
    if encoded_reads is not None:
        from ..graph.foci import bypass_repeats
        bypass_repeats(g, encoded_reads, llr_thr=min_llr, min_span=min_span)
    g.remove_zero_copy_elements(100.0)


def contig_links(g: DitchGraph, contigs):
    """L-lines: edges remaining between contig end nodes."""
    ends = {}
    for i, c in enumerate(contigs):
        path = c["path"]
        first, first_exit = path[0]
        last, last_exit = path[-1]
        # entry plug of the first node = opposite of its exit plug
        ends.setdefault((first, TAIL if first_exit == HEAD else HEAD), []).append((i, "-"))
        ends.setdefault((last, last_exit), []).append((i, "+"))
    links = []
    seen = set()
    for e in g.edges.values():
        a = ends.get((e.from_node, e.from_plug))
        b = ends.get((e.to_node, e.to_plug))
        if not a or not b:
            continue
        for (i, oi) in a:
            for (j, oj) in b:
                # '-' on the from side means the link attaches to the contig
                # start: in GFA terms the from-contig is traversed '-'
                key = (i, oi, j, oj)
                if key in seen or (j, oj, i, oi) in seen:
                    continue
                if (i, oi) == (j, oj):
                    continue
                seen.add(key)
                links.append((i, "+" if oi == "+" else "-", j,
                              "-" if oj == "+" else "+", e.occ, e.offset()))
    return links


def assemble(ds: DataSet, out_path: str | None = None,
             lightweight_frac: float = 0.15, to_polish: bool = True,
             window_size: int = 2000, seed: int = 42,
             dump_prefix: str | None = None, gfa2: bool = False) -> str:
    cov = ds.coverage.unwrap() if ds.coverage.is_available else update_coverage(ds)
    g = build_graph(ds, lightweight_frac)
    clean_up_graph_for_assemble(g, cov, ds.encoded_reads)
    g.sanity_check()
    raw = g.spell_with_paths()
    contigs = [c for c in raw if len(c["seq"]) > 0]
    if to_polish and contigs:
        from .consensus import polish_contigs
        window = min(window_size, max(
            int(np.median([len(r.seq) for r in ds.raw_reads]) // 2), 500)) \
            if ds.raw_reads else window_size
        polish_contigs(ds, contigs, window=window, seed=seed)
    links = contig_links(g, contigs)
    if dump_prefix:
        from .consensus import dump_coverage, dump_sam
        dump_coverage(ds, contigs, f"{dump_prefix}.coverage.tsv")
        dump_sam(ds, contigs, f"{dump_prefix}.sam")
    if gfa2:
        from ..io.gfa import contigs_to_gfa2
        gfa = contigs_to_gfa2(contigs, links)
    else:
        gfa = contigs_to_gfa(contigs, links)
    if out_path:
        with open(out_path, "w") as f:
            f.write(gfa)
    logger.info("assemble: %d contigs, %d links, graph=%s",
                len(contigs), len(links), g.stats())
    ds.push_stage("Assemble", [])
    return gfa
