"""Multiplicity estimation: per-chunk copy numbers from the draft graph.

Reference: ``haplotyper/src/multiplicity_estimation.rs:30-141`` — build a
DitchGraph from encoded reads, remove light edges, run the flow copy-number
optimizer, write per-chunk ``copy_num`` (min 1); ``purge_multiplicity(upper)``
drops chunks with copy_num >= upper or 0 and strips them from reads.
"""

from __future__ import annotations

import logging

from ..datamodel import DataSet
from ..graph.copy_number import assign_copy_numbers
from ..graph.ditch_graph import DitchGraph
from .determine_chunks import compaction_chunks, purge_chunks
from .util import update_coverage

logger = logging.getLogger(__name__)


def estimate_multiplicity(ds: DataSet, thr: int = 3, draft_gfa: str | None = None,
                          seed: int = 42) -> DataSet:
    cov = ds.coverage.unwrap() if ds.coverage.is_available else update_coverage(ds)
    chunk_seqs = {c.id: c.seq for c in ds.selected_chunks}
    g = DitchGraph.from_encoded_reads(ds.encoded_reads, chunk_seqs)
    # multiplicity_estimation.rs:41-50: low aggressive pass, then the full
    # threshold — keep the harsher graph only if it stays connected
    thr = max(int(round(0.15 * cov)), thr)
    g.remove_lightweight_edges(max(thr // 2 + 1, 1), False)
    import copy as _copy
    old = _copy.deepcopy(g)
    old.remove_lightweight_edges(thr, True)
    g.remove_lightweight_edges(thr, False)
    if len(g.connected_components()) != 1:
        g = old
    assign_copy_numbers(g, cov)
    # per-chunk copy number = sum over its clusters, min 1
    per_chunk: dict[int, int] = {}
    for (chunk, _cl), n in g.nodes.items():
        per_chunk[chunk] = per_chunk.get(chunk, 0) + (n.copy_num or 0)
    for c in ds.selected_chunks:
        c.copy_num = max(per_chunk.get(c.id, 0), 1)
        c.cluster_num = min(c.cluster_num, c.copy_num)
    if draft_gfa:
        from ..io.gfa import contigs_to_gfa
        contigs = g.spell()
        with open(draft_gfa, "w") as f:
            f.write(contigs_to_gfa(contigs))
    ds.push_stage("MultiplicityEstimation", [])
    return ds


def purge_multiplicity(ds: DataSet, upper: int = 10) -> DataSet:
    drop = {c.id for c in ds.selected_chunks if c.copy_num >= upper}
    if drop:
        logger.info("purge_multiplicity: dropping %d chunks", len(drop))
        purge_chunks(ds, drop)
        compaction_chunks(ds)
    ds.push_stage("PurgeMultiplicity", [f"upper={upper}"])
    return ds
