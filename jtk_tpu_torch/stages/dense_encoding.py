"""Dense encoding — new chunks across collapsed multi-copy diplotigs.

Reference: ``haplotyper/src/dense_encoding.rs`` — runs a draft assembly with
weak thresholds (:334-343), finds short multi-copy contigs with edges on both
sides, takes the consensus of read sequences crossing them
(take_consensus_on_multitig :432-546), splits the consensus into new
mean-length chunks, and re-encodes reads through them (two-round edlib infix +
guided global :627-759); the new chunks are then locally clustered (:49-87).

Here the crossing-read consensus is the K1/K2 polisher, and re-encoding is the
K4 mapper restricted to the new chunk set; results are merged into the
existing encodings (same machinery as deletion fill).
"""

from __future__ import annotations

import logging

import numpy as np

from .. import seq as seqmod
from ..datamodel import Chunk, DataSet, ReadType
from ..graph.copy_number import assign_copy_numbers
from ..graph.ditch_graph import DitchGraph
from ..mapper import ChunkIndex, extend_candidates
from ..ops.phmm import PHMMParams
from ..ops.polish import polish_until_converge
from .encode import _dedup_nodes, _node_from_result, nodes_to_encoded_read
from .util import update_coverage

logger = logging.getLogger(__name__)

MIN_SPAN_LEN = 400     # CONS_MIN_LENGTH
MAX_NEW_LEN = 10000    # CONS_MAX_LENGTH


def _label_consensus(labels, params, read_type, cov_thr):
    """Reference consensus() (dense_encoding.rs:548-579): median-length
    draft, [median/2, 2*median) length filter, coverage gate, polish."""
    if not labels:
        return None
    lens = sorted(len(x) for x in labels)
    median = lens[len(lens) // 2]
    upper, lower = 2 * median, max(median, MIN_SPAN_LEN) // 2
    if upper <= lower or median > MAX_NEW_LEN:
        return None
    kept = [x for x in labels if lower <= len(x) < upper]
    if len(kept) <= cov_thr:
        return None
    draft = min(kept, key=lambda y: abs(len(y) - median))
    band = max(min(max(median // 20, 10), 50), 16)
    band = ((band + 63) // 64) * 64
    cons, _ = polish_until_converge(draft, kept[:30], params, W=band,
                                    max_rounds=4)
    return cons if len(cons) > MIN_SPAN_LEN else None


def _edge_keys(a, b):
    """Oriented edge keys of an adjacent node pair
    (get_forward/reverse_d_edge_from_window, dense_encoding.rs:582-594)."""
    fwd = ((a.chunk, a.cluster, a.is_forward),
           (b.chunk, b.cluster, b.is_forward))
    rev = ((b.chunk, b.cluster, not b.is_forward),
           (a.chunk, a.cluster, not a.is_forward))
    return fwd, rev


def dense_encoding(ds: DataSet, length: int = 15, seed: int = 42,
                   min_span_reads: int = 4,
                   draft_gfa: str | None = None) -> DataSet:
    """Per-edge-label consensus across collapsed multi-copy contigs
    (enumerate_polyploid_edges + take_consensus_on/to_multitig,
    dense_encoding.rs:334-546).  ``draft_gfa``: dump the intermediate draft
    graph like the reference's {prefix}.draft2.gfa (cli/src/pipeline.rs:113).
    """
    cov = ds.coverage.unwrap() if ds.coverage.is_available else update_coverage(ds)
    chunk_seqs = {c.id: c.seq for c in ds.selected_chunks}
    if not chunk_seqs:
        ds.push_stage("DenseEncoding", [])
        return ds
    g = DitchGraph.from_encoded_reads(ds.encoded_reads, chunk_seqs)
    g.remove_lightweight_edges(max(1, int(0.05 * cov)))  # weak thresholds
    assign_copy_numbers(g, cov)
    contigs = g.spell()
    if draft_gfa:
        from ..io.gfa import contigs_to_gfa
        with open(draft_gfa, "w") as f:
            f.write(contigs_to_gfa([c for c in contigs if c["seq"]]))
    mean_len = int(np.mean([len(s) for s in chunk_seqs.values()]))
    params = PHMMParams.from_hmmparam(ds.model_param.forward)
    next_id = max(chunk_seqs) + 1
    cov_thr = max(int(cov) // 5, 1)
    from ..graph.ditch_graph import HEAD, TAIL
    # multicopy contigs with edges on BOTH sides -> their internal edges
    # (and boundary-entering edges) become consensus targets
    target_edges: dict = {}      # oriented DEdge key -> copy number
    boundary_edges: dict = {}    # same, for edges entering the multitig
    for c in contigs:
        summary = c["summary"]
        if not summary or len(summary) > length:
            continue
        cps = [s[4] for s in summary]
        copy_num = int(round(sum(cps) / len(cps)))
        if copy_num < 2:
            continue
        path = c["path"]
        f_node, f_exit = path[0]
        l_node, l_exit = path[-1]
        f_entry = TAIL if f_exit == HEAD else HEAD
        if not g.edges_at(f_node, f_entry) or not g.edges_at(l_node, l_exit):
            continue
        for (u, uc, ud, _o1, _c1), (v, vc, vd, _o2, _c2) in zip(
                summary, summary[1:]):
            target_edges[((u, uc, ud), (v, vc, vd))] = copy_num
        # edges entering the contig at its boundaries
        for node, plug in ((f_node, f_entry), (l_node, l_exit)):
            for _k, _e, tn, _tp in g.half_edges(node, plug):
                key = ((tn[0], tn[1], None), (node[0], node[1], None))
                boundary_edges[key] = copy_num
    # gather read edge labels per target edge (oriented)
    materials: dict = {}
    for er in ds.encoded_reads:
        for a, e, b in zip(er.nodes, er.edges, er.nodes[1:]):
            if not e.label:
                continue
            fwd, rev = _edge_keys(a, b)
            hit = None
            if fwd in target_edges:
                hit, lab = fwd, seqmod.encode(e.label.upper())
            elif rev in target_edges:
                hit = rev
                lab = seqmod.revcomp(seqmod.encode(e.label.upper()))
            else:
                bf = ((a.chunk, a.cluster, None), (b.chunk, b.cluster, None))
                br = ((b.chunk, b.cluster, None), (a.chunk, a.cluster, None))
                if bf in boundary_edges:
                    hit, lab = bf, seqmod.encode(e.label.upper())
                elif br in boundary_edges:
                    hit = br
                    lab = seqmod.revcomp(seqmod.encode(e.label.upper()))
            if hit is not None:
                materials.setdefault(hit, []).append(lab)
    new_chunks = []
    for key, labels in sorted(materials.items(), key=lambda kv: str(kv[0])):
        cons = _label_consensus(labels, params, ds.read_type, cov_thr)
        if cons is None:
            continue
        copy_num = target_edges.get(key) or boundary_edges.get(key, 2)
        n_pieces = max(int(np.ceil(len(cons) / mean_len)), 1)
        piece = int(np.ceil(len(cons) / n_pieces))
        for i in range(n_pieces):
            seg = cons[i * piece: (i + 1) * piece]
            if len(seg) < MIN_SPAN_LEN // 2:
                continue
            new_chunks.append(Chunk(next_id, seqmod.decode(seg).decode(),
                                    1, copy_num))
            next_id += 1
    if not new_chunks:
        ds.push_stage("DenseEncoding", [])
        return ds
    logger.info("dense_encoding: %d new chunks", len(new_chunks))
    ds.selected_chunks.extend(new_chunks)
    # re-encode reads against the new chunks only; merge into existing
    new_seqs = {c.id: c.codes() for c in new_chunks}
    cluster_num = {c.id: c.cluster_num for c in ds.selected_chunks}
    index = ChunkIndex(new_seqs)
    read_ascii = [er.recover_raw_read() for er in ds.encoded_reads]
    read_codes = [seqmod.encode(s) for s in read_ascii]
    cands = []
    for i, codes in enumerate(read_codes):
        cands.extend(index.candidates(codes, i, min_hits=4, margin=200))
    results = extend_candidates(cands, read_codes, new_seqs, W=256,
                                margin=200)
    sim_thr = ReadType.sim_thr(ds.read_type)
    per_read = {}
    for res in results:
        c = res["cand"]
        if res["dist"] > sim_thr * len(new_seqs[c.chunk_id]):
            continue
        n = _node_from_result(res, read_codes, read_ascii)
        if n is not None:
            per_read.setdefault(c.read_idx, []).append(n)
    for idx, new_nodes in per_read.items():
        er = ds.encoded_reads[idx]
        nodes = [{
            "chunk": n.chunk, "is_forward": n.is_forward,
            "start": n.position_from_start,
            "end": n.position_from_start + n.query_length(),
            "seq": n.seq, "cigar": n.cigar, "dist": 0,
        } for n in er.nodes]
        nodes.extend(new_nodes)
        merged = _dedup_nodes(nodes)
        new_er = nodes_to_encoded_read(er.id, read_ascii[idx], merged,
                                       cluster_num)
        if new_er is not None:
            orig = {(n.chunk, n.position_from_start, n.is_forward): n
                    for n in er.nodes}
            for n in new_er.nodes:
                o = orig.get((n.chunk, n.position_from_start, n.is_forward))
                if o is not None:
                    n.cluster = o.cluster
                    n.posterior = o.posterior
            er.leading_gap = new_er.leading_gap
            er.trailing_gap = new_er.trailing_gap
            er.nodes = new_er.nodes
            er.edges = new_er.edges
    # cluster only the new chunks
    from .local_clustering import local_clustering
    local_clustering(ds, seed=seed, selection={c.id for c in new_chunks})
    ds.push_stage("DenseEncoding", [f"length={length}"])
    return ds
