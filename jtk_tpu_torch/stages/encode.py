"""Encode stage: align every read to the chunk set, produce EncodedReads.

Reference: ``haplotyper/src/encode/mod.rs`` — minimap2 mapping (:315-355),
PAF filtering to near-full-chunk hits (:41-64), node construction (:181-208),
per-read cleanup ``remove_slippy_alignment`` (:288-313) and
``remove_overlapping_encoding`` (:248-286), and ``nodes_to_encoded_read``
(:94-119).  Here the mapping+extension is the K4 mapper (device-batched K3
kernels); chunk alignments are global-in-chunk / free-in-read, so near-full
coverage of the chunk is guaranteed by construction and bad placements are
dropped by the identity filter alone.
"""

from __future__ import annotations

import logging

from .. import seq as seqmod
from .. import trace
from ..datamodel import DataSet, Edge, EncodedRead, Node, ReadType
from ..mapper import ChunkIndex, extend_candidates, flip_cigar

logger = logging.getLogger(__name__)


def _node_from_result(res, read_codes, read_ascii):
    c = res["cand"]
    L = len(read_codes[c.read_idx])
    s, e = res["span_start"], res["span_end"]
    if e <= s:
        return None
    cigar = flip_cigar(res["ops"])
    if c.is_forward:
        start, end = s, e
        seq = read_ascii[c.read_idx][start:end].upper()
    else:
        start, end = L - e, L - s
        seq = seqmod.revcomp_ascii(
            read_ascii[c.read_idx][start:end].upper().encode()).decode()
    return {
        "chunk": c.chunk_id, "is_forward": c.is_forward,
        "start": start, "end": end, "seq": seq, "cigar": cigar,
        "dist": res["dist"],
    }


def _dedup_nodes(nodes):
    """remove_slippy_alignment + remove_overlapping_encoding equivalents:
    same-(chunk,strand) overlapping duplicates keep the best; fully-contained
    spans are dropped."""
    nodes = sorted(nodes, key=lambda n: (n["start"], -(n["end"] - n["start"])))
    out = []
    for n in nodes:
        drop = False
        conflict = True
        # after evicting a worse duplicate, re-scan the survivor against the
        # remaining kept nodes — mutually overlapping encodings must not
        # survive just because the first conflict was resolved in n's favour
        while conflict and not drop:
            conflict = False
            for m in out:
                if m["chunk"] == n["chunk"] \
                        and m["is_forward"] == n["is_forward"] \
                        and n["start"] < m["end"]:
                    # slippy duplicate: keep the better one
                    if n["dist"] < m["dist"]:
                        out.remove(m)
                        conflict = True
                    else:
                        drop = True
                    break
                if m["start"] <= n["start"] and n["end"] <= m["end"]:
                    drop = True  # contained
                    break
        if not drop:
            out.append(n)
    return sorted(out, key=lambda n: n["start"])


def nodes_to_encoded_read(read_id, read_ascii, nodes, cluster_num):
    """encode/mod.rs:94-119."""
    if not nodes:
        return None
    objs = []
    for n in nodes:
        node = Node.new(n["chunk"], n["is_forward"], n["seq"], n["cigar"],
                        n["start"], cluster_num.get(n["chunk"], 1))
        objs.append(node)
    edges = [Edge.from_nodes(a, b, read_ascii)
             for a, b in zip(objs, objs[1:])]
    lead = read_ascii[: objs[0].position_from_start]
    last_end = objs[-1].position_from_start + objs[-1].query_length()
    trail = read_ascii[last_end:]
    return EncodedRead(read_id, len(read_ascii), lead, trail, edges, objs)


def encode(ds: DataSet, sim_thr: float | None = None, margin: int = 200,
           min_hits: int = 4, W: int = 256, k: int | None = None,
           stride: int = 3) -> DataSet:
    if sim_thr is None:
        sim_thr = ReadType.sim_thr(ds.read_type)
    # per-readtype seeding (reference: minimap2 -k{15,17,18} [-H],
    # encode/mod.rs:344-349)
    k_rt, hpc = ReadType.mapper_params(ds.read_type)
    if k is None:
        k = k_rt
    trace.count("encode.reads", len(ds.raw_reads))
    chunk_seqs = {c.id: c.codes() for c in ds.selected_chunks}
    cluster_num = {c.id: c.cluster_num for c in ds.selected_chunks}
    index = ChunkIndex(chunk_seqs, k=k, hpc=hpc)
    read_ascii = [r.seq for r in ds.raw_reads]
    read_codes = [seqmod.encode(s) for s in read_ascii]
    cands = index.candidates_batch(read_codes, min_hits=min_hits,
                                   margin=margin, stride=stride)
    logger.info("encode: %d candidates", len(cands))
    results = extend_candidates(cands, read_codes, chunk_seqs, W=W,
                                margin=margin)
    with trace.span("encode.nodes"):
        per_read: dict[int, list] = {}
        for res in results:
            c = res["cand"]
            clen = len(chunk_seqs[c.chunk_id])
            if res["dist"] > sim_thr * clen:
                continue
            n = _node_from_result(res, read_codes, read_ascii)
            if n is None:
                continue
            per_read.setdefault(c.read_idx, []).append(n)
        encoded = []
        for i, r in enumerate(ds.raw_reads):
            nodes = _dedup_nodes(per_read.get(i, []))
            er = nodes_to_encoded_read(r.id, read_ascii[i], nodes,
                                       cluster_num)
            if er is not None:
                encoded.append(er)
    ds.encoded_reads = encoded
    ds.push_stage("Encode", [f"sim_thr={sim_thr}"])
    return ds
