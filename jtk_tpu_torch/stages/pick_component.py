"""Pick top-N connected components of the chunk graph.

Reference: ``haplotyper/src/pick_component.rs:22-85`` — build DitchGraph,
remove edges with occ < 8% coverage, keep the largest N components, drop
reads touching removed chunks, renumber.
"""

from __future__ import annotations

import logging

from ..datamodel import DataSet
from ..graph.ditch_graph import DitchGraph
from .determine_chunks import compaction_chunks, purge_chunks
from .util import update_coverage

logger = logging.getLogger(__name__)


def pick_top_n_component(ds: DataSet, component_num: int = 1) -> DataSet:
    cov = ds.coverage.unwrap() if ds.coverage.is_available else update_coverage(ds)
    chunk_seqs = {c.id: c.seq for c in ds.selected_chunks}
    g = DitchGraph.from_encoded_reads(ds.encoded_reads, chunk_seqs)
    g.remove_lightweight_edges(max(1, int(0.08 * cov)),
                               retain_single_edge=True)
    comps = g.connected_components()
    comps.sort(key=len, reverse=True)
    keep_chunks = set()
    for comp in comps[:component_num]:
        keep_chunks.update(ch for ch, _cl in comp)
    drop = {c.id for c in ds.selected_chunks if c.id not in keep_chunks}
    if drop:
        logger.info("pick_component: dropping %d/%d chunks", len(drop),
                    len(ds.selected_chunks))
        purge_chunks(ds, drop)
        compaction_chunks(ds)
    ds.push_stage("PickComponent", [f"component_num={component_num}"])
    return ds
