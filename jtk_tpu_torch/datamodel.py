"""The serialized ``DataSet`` state — the single value flowing through the pipeline.

JSON ABI parity with the reference's ``definitions`` crate
(``definitions/src/lib.rs:6-34`` for DataSet, ``:361-998`` for the members), so
intermediate state files are interchangeable with the reference and every stage
can be re-run / diffed in isolation (SURVEY.md §3.5).

Serde conventions reproduced here:
  * ``Coverage`` enum  -> ``"NotAvailable"`` | ``{"Protected": x}`` | ``{"Estimated": x}``
  * ``ReadType``       -> ``"CCS" | "CLR" | "ONT" | "None"``
  * ``DNASeq``         -> plain string (SerializeDisplay)
  * ``Ops`` (CIGAR)    -> compact string like ``"120M2D30M1I"`` (SerializeDisplay)
  * ``Edge.from``      -> JSON key ``"from"`` (Python attr ``from_``)

The per-platform presets mirror ``definitions/src/lib.rs:156-243``.
"""

from __future__ import annotations

import json
import os
import math
from dataclasses import dataclass, field

import numpy as np

from . import seq as seqmod

# ---------------------------------------------------------------------------
# Read-type presets (definitions/src/lib.rs:164-243)
# ---------------------------------------------------------------------------

CLR_BAND_WIDTH = 200
HIFI_BAND_WIDTH = 80
ONT_BAND_WIDTH = 100

CLR_CTG_SIM = 0.20
CLR_CLR_SIM = 0.20
HIFI_SIM_THR = 0.05
ONT_SIM_THR = 0.15

CLR_BAND_FRAC = 0.05
ONT_BAND_FRAC = 0.03
HIFI_BAND_FRAC = 0.01


class ReadType:
    CCS = "CCS"
    CLR = "CLR"
    ONT = "ONT"
    NONE = "None"

    _ALL = ("CCS", "CLR", "ONT", "None")

    @staticmethod
    def sim_thr(rt: str) -> float:
        return {"CCS": HIFI_SIM_THR, "ONT": ONT_SIM_THR}.get(rt, CLR_CLR_SIM)

    @staticmethod
    def overlap_identity_thr(rt: str) -> float:
        return 0.95 if rt == "CCS" else 0.85

    @staticmethod
    def sd_of_error(rt: str) -> float:
        return {"CCS": 0.005, "CLR": 0.02, "ONT": 0.01}.get(rt, 0.01)

    @staticmethod
    def band_frac(rt: str) -> float:
        return {"CCS": HIFI_BAND_FRAC, "ONT": ONT_BAND_FRAC}.get(rt, CLR_BAND_FRAC)

    @staticmethod
    def band_width(rt: str, length: int) -> int:
        return int(math.ceil(length * ReadType.band_frac(rt)))

    @staticmethod
    def min_span_reads(rt: str) -> int:
        return {"CCS": 1, "CLR": 3, "ONT": 2}.get(rt, 3)

    @staticmethod
    def min_llr_value(rt: str) -> float:
        return {"CCS": 0.1, "CLR": 1.0, "ONT": 0.7}.get(rt, 1.0)

    @staticmethod
    def mapper_params(rt: str):
        """(k, use_hpc_kmers) for the K4 read<->chunk mapper — mirrors the
        reference's per-readtype minimap2 invocation (encode/mod.rs:344-349:
        CCS ``-H -k18``, CLR ``-H -k15``, ONT ``-k17``; ``-H`` =
        homopolymer-compressed seeds)."""
        return {"CCS": (18, True), "CLR": (15, True),
                "ONT": (17, False)}.get(rt, (15, False))

    @staticmethod
    def weak_llr(rt: str) -> float:
        return 1.3

    @staticmethod
    def weak_span_reads(rt: str) -> int:
        return 4


# ---------------------------------------------------------------------------
# HMM parameters (definitions/src/lib.rs:95-147)
# ---------------------------------------------------------------------------


@dataclass
class HMMParam:
    """3-state (Match/Ins/Del) pair-HMM parameters.

    ``mat_emit[4*ref + query]`` = Pr{query | ref}; ``ins_emit[4*prev + query]``
    with prev in {A,C,G,T,start} (5*4 = 20 entries).
    """

    mat_mat: float = 0.97
    mat_ins: float = 0.01
    mat_del: float = 0.01
    ins_mat: float = 0.97
    ins_ins: float = 0.01
    ins_del: float = 0.01
    del_mat: float = 0.97
    del_ins: float = 0.01
    del_del: float = 0.01
    mat_emit: list = field(
        default_factory=lambda: [
            0.97, 0.01, 0.01, 0.01,
            0.01, 0.97, 0.01, 0.01,
            0.01, 0.01, 0.97, 0.01,
            0.01, 0.01, 0.01, 0.97,
        ]
    )
    ins_emit: list = field(default_factory=lambda: [0.25] * 20)

    def to_json(self):
        return {
            "mat_mat": self.mat_mat, "mat_ins": self.mat_ins, "mat_del": self.mat_del,
            "ins_mat": self.ins_mat, "ins_ins": self.ins_ins, "ins_del": self.ins_del,
            "del_mat": self.del_mat, "del_ins": self.del_ins, "del_del": self.del_del,
            "mat_emit": list(self.mat_emit), "ins_emit": list(self.ins_emit),
        }

    @classmethod
    def from_json(cls, d):
        return cls(**d)


@dataclass
class HMMParamOnStrands:
    forward: HMMParam = field(default_factory=HMMParam)
    reverse: HMMParam = field(default_factory=HMMParam)

    def to_json(self):
        return {"forward": self.forward.to_json(), "reverse": self.reverse.to_json()}

    @classmethod
    def from_json(cls, d):
        return cls(HMMParam.from_json(d["forward"]), HMMParam.from_json(d["reverse"]))


# ---------------------------------------------------------------------------
# Error rates (definitions/src/lib.rs:898-998)
# ---------------------------------------------------------------------------


@dataclass
class ErrorRate:
    del_: float = 0.0
    del_sd: float = 0.0
    ins: float = 0.0
    ins_sd: float = 0.0
    mismatch: float = 0.0
    mism_sd: float = 0.0
    total: float = 0.0
    total_sd: float = 0.0

    @classmethod
    def guess(cls, read_type: str) -> "ErrorRate":
        if read_type == "CCS":
            return cls(0.005, 0.001, 0.005, 0.001, 0.005, 0.001, 0.01, 0.005)
        if read_type == "ONT":
            return cls(0.01, 0.005, 0.01, 0.005, 0.01, 0.005, 0.03, 0.008)
        return cls(0.07, 0.02, 0.06, 0.02, 0.02, 0.01, 0.15, 0.03)  # CLR / None

    def sum(self) -> float:
        return self.del_ + self.ins + self.mismatch

    def to_json(self):
        return {
            "del": self.del_, "del_sd": self.del_sd, "ins": self.ins,
            "ins_sd": self.ins_sd, "mismatch": self.mismatch, "mism_sd": self.mism_sd,
            "total": self.total, "total_sd": self.total_sd,
        }

    @classmethod
    def from_json(cls, d):
        return cls(d["del"], d["del_sd"], d["ins"], d["ins_sd"], d["mismatch"],
                   d["mism_sd"], d["total"], d["total_sd"])


# ---------------------------------------------------------------------------
# CIGAR ops (definitions/src/lib.rs:816-895)
# ---------------------------------------------------------------------------

# An Ops value is a list of (kind, length) with kind in "MID":
#   M consumes query+ref (match or mismatch), I consumes query, D consumes ref.


def ops_to_str(ops) -> str:
    return "".join(f"{l}{k}" for k, l in ops)


def ops_from_str(s: str):
    ops = []
    num = 0
    for ch in s:
        if ch.isdigit():
            num = num * 10 + int(ch)
        else:
            ops.append((ch, num))
            num = 0
    return ops


def ops_query_length(ops) -> int:
    """definitions/src/lib.rs:753-762 (Match/Ins consume query)."""
    return sum(l for k, l in ops if k in "MI")


def ops_ref_length(ops) -> int:
    return sum(l for k, l in ops if k in "MD")


def compress_ops(flat) -> list:
    """Run-length-encode a flat op-kind sequence ('M','I','D' chars)."""
    out = []
    for k in flat:
        if out and out[-1][0] == k:
            out[-1][1] += 1
        else:
            out.append([k, 1])
    return [(k, l) for k, l in out]


# ---------------------------------------------------------------------------
# Core records
# ---------------------------------------------------------------------------


@dataclass
class RawRead:
    """definitions/src/lib.rs:361-386."""

    name: str
    desc: str
    id: int
    seq: str

    def seq_bytes(self) -> bytes:
        return self.seq.encode()

    def codes(self) -> np.ndarray:
        return seqmod.encode(self.seq)

    def to_json(self):
        return {"name": self.name, "desc": self.desc, "id": self.id, "seq": self.seq}

    @classmethod
    def from_json(cls, d):
        return cls(d["name"], d["desc"], d["id"], d["seq"])


@dataclass
class Chunk:
    """A ~2 kbp reference unit (definitions/src/lib.rs:403-484)."""

    id: int
    seq: str
    cluster_num: int = 1
    copy_num: int = 2
    score: float = 0.0

    def codes(self) -> np.ndarray:
        return seqmod.encode(self.seq)

    def __len__(self):
        return len(self.seq)

    def to_json(self):
        return {"id": self.id, "seq": self.seq, "cluster_num": self.cluster_num,
                "copy_num": self.copy_num, "score": self.score}

    @classmethod
    def from_json(cls, d):
        return cls(d["id"], d["seq"], d["cluster_num"], d["copy_num"], d["score"])


@dataclass
class Node:
    """One chunk alignment inside a read (definitions/src/lib.rs:672-814).

    ``seq`` is already rev-comped into the chunk frame when ``is_forward`` is
    False; ``cigar`` maps ``seq`` (query) onto the chunk (reference).
    """

    position_from_start: int
    chunk: int
    cluster: int
    seq: str
    is_forward: bool
    cigar: list  # [(kind, len)]
    posterior: list

    @classmethod
    def new(cls, chunk, is_forward, seq, cigar, position_from_start, cluster_num):
        """definitions/src/lib.rs:713-733 — uniform log-posterior init."""
        post = math.log(1.0 / max(cluster_num, 1))
        return cls(position_from_start, chunk, 0, seq, is_forward, cigar,
                   [post] * cluster_num)

    def codes(self) -> np.ndarray:
        return seqmod.encode(self.seq)

    def query_length(self) -> int:
        return ops_query_length(self.cigar)

    def original_seq(self) -> str:
        """Back to read orientation (definitions/src/lib.rs:737-752)."""
        if self.is_forward:
            return self.seq
        return seqmod.revcomp_ascii(self.seq.encode()).decode()

    def is_biased(self, thr: float) -> bool:
        """definitions/src/lib.rs:700-709."""
        if len(self.posterior) <= 1:
            return True
        t = 1.0 / len(self.posterior) + thr
        return any(math.exp(x) >= t for x in self.posterior)

    def aln_stats(self, chunk_seq: str):
        """(match, mismatch, ins, del) counts from cigar against ``chunk_seq``."""
        q, r = 0, 0
        mat = mism = ins = dele = 0
        qs = self.seq
        for k, l in self.cigar:
            if k == "M":
                for a, b in zip(qs[q:q + l], chunk_seq[r:r + l]):
                    if a.upper() == b.upper():
                        mat += 1
                    else:
                        mism += 1
                q += l
                r += l
            elif k == "I":
                ins += l
                q += l
            else:
                dele += l
                r += l
        return mat, mism, ins, dele

    def to_json(self):
        return {
            "position_from_start": self.position_from_start,
            "chunk": self.chunk, "cluster": self.cluster, "seq": self.seq,
            "is_forward": self.is_forward, "cigar": ops_to_str(self.cigar),
            "posterior": list(self.posterior),
        }

    @classmethod
    def from_json(cls, d):
        return cls(d["position_from_start"], d["chunk"], d["cluster"], d["seq"],
                   d["is_forward"], ops_from_str(d["cigar"]), d["posterior"])


@dataclass
class Edge:
    """Gap label between adjacent nodes (definitions/src/lib.rs:628-670)."""

    from_: int
    to: int
    offset: int
    label: str

    @classmethod
    def from_nodes(cls, n1: Node, n2: Node, read_seq: str) -> "Edge":
        """definitions/src/lib.rs:645-668."""
        end = n1.position_from_start + n1.query_length()
        start = n2.position_from_start
        label = "" if start <= end else read_seq[end:start].upper()
        return cls(n1.chunk, n2.chunk, start - end, label)

    def to_json(self):
        return {"from": self.from_, "to": self.to, "offset": self.offset,
                "label": self.label}

    @classmethod
    def from_json(cls, d):
        return cls(d["from"], d["to"], d["offset"], d["label"])


@dataclass
class EncodedRead:
    """Read as alternating node/edge string (definitions/src/lib.rs:486-626)."""

    id: int
    original_length: int
    leading_gap: str
    trailing_gap: str
    edges: list  # list[Edge]
    nodes: list  # list[Node]

    def is_gappy(self) -> bool:
        return not self.nodes

    def encoded_length(self) -> int:
        s = sum(n.query_length() for n in self.nodes)
        s += sum(e.offset for e in self.edges if e.offset < 0)
        return max(s, 0)

    def encoded_rate(self) -> float:
        return self.encoded_length() / self.original_length if self.original_length else 0.0

    def recover_raw_read(self) -> str:
        """Lossless raw-read reconstruction (definitions/src/lib.rs:604-619)."""
        out = [self.leading_gap]
        for n, e in zip(self.nodes, self.edges):
            s = n.original_seq()
            if e.offset < 0:
                s = s[: len(s) + e.offset] if -e.offset <= len(s) else ""
            out.append(s)
            out.append(e.label)
        if self.nodes:
            out.append(self.nodes[-1].original_seq())
        out.append(self.trailing_gap)
        return "".join(out)

    def remove(self, i: int) -> None:
        """Remove the i-th node, preserving losslessness
        (definitions/src/lib.rs:540-603)."""
        assert i < len(self.nodes)
        assert len(self.nodes) == len(self.edges) + 1
        n = len(self.nodes)
        removed = self.nodes.pop(i)
        if not self.nodes:
            assert not self.edges
            self.leading_gap = self.leading_gap + removed.original_seq()
            return
        if i + 1 == n:
            e = self.edges.pop(i - 1)
            skip = -e.offset if e.offset < 0 else 0
            tail = e.label + removed.original_seq() + self.trailing_gap
            self.trailing_gap = tail[skip:]
        elif i == 0:
            e = self.edges.pop(0)
            lead = self.leading_gap + removed.original_seq() + e.label
            if e.offset < 0:
                lead = lead[: len(lead) + e.offset]
            self.leading_gap = lead
        else:
            e = self.edges.pop(i)
            prev = self.edges[i - 1]
            mid = prev.label + removed.original_seq() + e.label
            if prev.offset < 0:
                mid = mid[-prev.offset:] if -prev.offset <= len(mid) else ""
            if e.offset < 0:
                mid = mid[: len(mid) + e.offset] if -e.offset <= len(mid) else ""
            prev.to = e.to
            prev.label = mid
            prev.offset += removed.query_length() + e.offset
        assert len(self.nodes) == len(self.edges) + 1

    def contains(self, chunk: int, cluster: int) -> bool:
        return any(n.chunk == chunk and n.cluster == cluster for n in self.nodes)

    def to_json(self):
        return {
            "id": self.id, "original_length": self.original_length,
            "leading_gap": self.leading_gap, "trailing_gap": self.trailing_gap,
            "edges": [e.to_json() for e in self.edges],
            "nodes": [n.to_json() for n in self.nodes],
        }

    @classmethod
    def from_json(cls, d):
        return cls(d["id"], d["original_length"], d["leading_gap"],
                   d["trailing_gap"], [Edge.from_json(e) for e in d["edges"]],
                   [Node.from_json(n) for n in d["nodes"]])


# ---------------------------------------------------------------------------
# DataSet
# ---------------------------------------------------------------------------


@dataclass
class MaskInfo:
    k: int = 0
    thr: int = 0

    def to_json(self):
        return {"k": self.k, "thr": self.thr}

    @classmethod
    def from_json(cls, d):
        return cls(d["k"], d["thr"])


class Coverage:
    """Haploid coverage (definitions/src/lib.rs:46-93); serde-enum JSON shape."""

    def __init__(self, value=None, protected=False):
        self.value = value
        self.protected = protected

    @property
    def is_available(self):
        return self.value is not None

    def unwrap(self) -> float:
        if self.value is None:
            raise ValueError("Please estimate the haploid coverage first.")
        return self.value

    def set(self, cov: float):
        if not self.protected:
            self.value = cov

    def to_json(self):
        if self.value is None:
            return "NotAvailable"
        return {"Protected" if self.protected else "Estimated": self.value}

    @classmethod
    def from_json(cls, d):
        if d == "NotAvailable" or d is None:
            return cls()
        if "Protected" in d:
            return cls(d["Protected"], True)
        return cls(d["Estimated"], False)


@dataclass
class DataSet:
    """The whole-run state (definitions/src/lib.rs:6-34)."""

    input_file: str = ""
    masked_kmers: MaskInfo = field(default_factory=MaskInfo)
    coverage: Coverage = field(default_factory=Coverage)
    raw_reads: list = field(default_factory=list)
    hic_pairs: list = field(default_factory=list)
    selected_chunks: list = field(default_factory=list)
    encoded_reads: list = field(default_factory=list)
    hic_edges: list = field(default_factory=list)
    read_type: str = ReadType.NONE
    model_param: HMMParamOnStrands = field(default_factory=HMMParamOnStrands)
    error_rate: ErrorRate = field(default_factory=ErrorRate)
    processed_stages: list = field(default_factory=list)

    @classmethod
    def with_minimum_data(cls, input_file, raw_reads, read_type) -> "DataSet":
        return cls(input_file=input_file, raw_reads=raw_reads, read_type=read_type,
                   error_rate=ErrorRate.guess(read_type))

    def push_stage(self, name: str, args: list[str] | None = None):
        self.processed_stages.append({"stage_name": name, "arg": list(args or [])})

    # -- invariants (definitions/src/lib.rs:296-358) --
    def sanity_check(self):
        chunk_ids = {c.id for c in self.selected_chunks}
        assert len(chunk_ids) == len(self.selected_chunks), "duplicate chunk id"
        for c in self.selected_chunks:
            assert c.cluster_num <= c.copy_num, (c.id, c.cluster_num, c.copy_num)
        max_cl = {c.id: c.cluster_num for c in self.selected_chunks}
        for r in self.encoded_reads:
            for n in r.nodes:
                assert n.chunk in chunk_ids, f"node chunk {n.chunk} not selected"
                assert n.cluster <= max_cl[n.chunk]
        raw = {r.id: r.seq.upper() for r in self.raw_reads}
        for er in self.encoded_reads:
            orig = raw[er.id]
            rec = er.recover_raw_read().upper()
            assert er.original_length == len(orig)
            assert rec == orig, f"read {er.id}: lossless recovery failed"

    # -- JSON round trip --
    def to_json(self):
        return {
            "input_file": self.input_file,
            "masked_kmers": self.masked_kmers.to_json(),
            "coverage": self.coverage.to_json(),
            "raw_reads": [r.to_json() for r in self.raw_reads],
            "hic_pairs": list(self.hic_pairs),
            "selected_chunks": [c.to_json() for c in self.selected_chunks],
            "encoded_reads": [r.to_json() for r in self.encoded_reads],
            "hic_edges": list(self.hic_edges),
            "read_type": self.read_type,
            "model_param": self.model_param.to_json(),
            "error_rate": self.error_rate.to_json(),
            "processed_stages": list(self.processed_stages),
        }

    @classmethod
    def from_json(cls, d):
        return cls(
            input_file=d["input_file"],
            masked_kmers=MaskInfo.from_json(d["masked_kmers"]),
            coverage=Coverage.from_json(d["coverage"]),
            raw_reads=[RawRead.from_json(r) for r in d["raw_reads"]],
            hic_pairs=list(d.get("hic_pairs", [])),
            selected_chunks=[Chunk.from_json(c) for c in d["selected_chunks"]],
            encoded_reads=[EncodedRead.from_json(r) for r in d["encoded_reads"]],
            hic_edges=list(d.get("hic_edges", [])),
            read_type=d["read_type"],
            model_param=HMMParamOnStrands.from_json(d["model_param"]),
            error_rate=ErrorRate.from_json(d["error_rate"]),
            processed_stages=list(d.get("processed_stages", [])),
        )

    def dumps(self) -> str:
        return json.dumps(self.to_json())

    @classmethod
    def loads(cls, s: str) -> "DataSet":
        return cls.from_json(json.loads(s))

    def dump(self, path: str):
        if path.endswith(".npz"):
            self.dump_npz(path)
            return
        with open(path, "w") as f:
            json.dump(self.to_json(), f)

    @classmethod
    def load(cls, path: str) -> "DataSet":
        if path.endswith(".npz"):
            return cls.load_npz(path)
        with open(path) as f:
            return cls.from_json(json.load(f))

    # -- columnar npz snapshot (SURVEY §2.1 TPU note: the DataSet as a
    # columnar store).  JSON stays the CLI/stage ABI; npz is the fast
    # checkpoint format: at 1 Mb x 60x the per-phase JSON is ~260 MB and
    # takes minutes to (de)serialize, the columnar snapshot is seconds. --
    def dump_npz(self, path: str):
        def blob(strs):
            enc = [s.encode() for s in strs]
            lens = np.fromiter((len(e) for e in enc), np.int64, len(enc))
            offs = np.zeros(len(enc) + 1, np.int64)
            np.cumsum(lens, out=offs[1:])
            data = np.frombuffer(b"".join(enc), np.uint8) if enc else \
                np.zeros(0, np.uint8)
            return data, offs

        a = {}
        a["rr_seq"], a["rr_seq_o"] = blob([r.seq for r in self.raw_reads])
        a["rr_name"], a["rr_name_o"] = blob([r.name for r in self.raw_reads])
        a["rr_desc"], a["rr_desc_o"] = blob([r.desc for r in self.raw_reads])
        a["rr_id"] = np.array([r.id for r in self.raw_reads], np.int64)
        a["ch_seq"], a["ch_seq_o"] = blob([c.seq
                                           for c in self.selected_chunks])
        a["ch_meta"] = np.array(
            [[c.id, c.cluster_num, c.copy_num] for c in self.selected_chunks],
            np.int64).reshape(-1, 3)
        a["ch_score"] = np.array([c.score for c in self.selected_chunks],
                                 np.float64)
        ers = self.encoded_reads
        a["er_meta"] = np.array(
            [[er.id, er.original_length, len(er.nodes), len(er.edges)]
             for er in ers], np.int64).reshape(-1, 4)
        a["er_lead"], a["er_lead_o"] = blob([er.leading_gap for er in ers])
        a["er_trail"], a["er_trail_o"] = blob([er.trailing_gap for er in ers])
        nodes = [n for er in ers for n in er.nodes]
        edges = [e for er in ers for e in er.edges]
        a["n_meta"] = np.array(
            [[n.position_from_start, n.chunk, n.cluster, int(n.is_forward)]
             for n in nodes], np.int64).reshape(-1, 4)
        a["n_seq"], a["n_seq_o"] = blob([n.seq for n in nodes])
        a["n_cigar"], a["n_cigar_o"] = blob([ops_to_str(n.cigar)
                                             for n in nodes])
        post_lens = np.array([len(n.posterior) for n in nodes], np.int64)
        a["n_post_o"] = np.concatenate([[0], np.cumsum(post_lens)])
        a["n_post"] = np.array([x for n in nodes for x in n.posterior],
                               np.float64)
        a["e_meta"] = np.array([[e.from_, e.to, e.offset] for e in edges],
                               np.int64).reshape(-1, 3)
        a["e_label"], a["e_label_o"] = blob([e.label for e in edges])
        header = {
            "input_file": self.input_file,
            "masked_kmers": self.masked_kmers.to_json(),
            "coverage": self.coverage.to_json(),
            "hic_pairs": list(self.hic_pairs),
            "hic_edges": list(self.hic_edges),
            "read_type": self.read_type,
            "model_param": self.model_param.to_json(),
            "error_rate": self.error_rate.to_json(),
            "processed_stages": list(self.processed_stages),
        }
        a["header"] = np.frombuffer(json.dumps(header).encode(), np.uint8)
        tmp = path + ".tmp.npz"
        with open(tmp, "wb") as f:
            np.savez(f, **a)  # uncompressed: zlib costs more than the bytes
        os.replace(tmp, path)

    @classmethod
    def load_npz(cls, path: str) -> "DataSet":
        with np.load(path) as zf:
            # materialize ONCE — NpzFile re-reads the zip member on every
            # __getitem__, which turned the node loop quadratic
            z = {k: zf[k] for k in zf.files}

        def cuts(blob, offs):
            b = blob.tobytes()
            return [b[offs[i]:offs[i + 1]].decode()
                    for i in range(len(offs) - 1)]

        header = json.loads(bytes(z["header"]).decode())
        names = cuts(z["rr_name"], z["rr_name_o"])
        descs = cuts(z["rr_desc"], z["rr_desc_o"])
        seqs = cuts(z["rr_seq"], z["rr_seq_o"])
        rr = [RawRead(names[i], descs[i], int(z["rr_id"][i]), seqs[i])
              for i in range(len(z["rr_id"]))]
        cm = z["ch_meta"]
        ch_seqs = cuts(z["ch_seq"], z["ch_seq_o"])
        chunks = [Chunk(int(cm[i, 0]), ch_seqs[i], int(cm[i, 1]),
                        int(cm[i, 2]), float(z["ch_score"][i]))
                  for i in range(cm.shape[0])]
        nm = z["n_meta"]
        n_post, n_post_o = z["n_post"], z["n_post_o"]
        n_seqs = cuts(z["n_seq"], z["n_seq_o"])
        n_cigars = cuts(z["n_cigar"], z["n_cigar_o"])
        all_nodes = [Node(int(nm[i, 0]), int(nm[i, 1]), int(nm[i, 2]),
                          n_seqs[i], bool(nm[i, 3]),
                          ops_from_str(n_cigars[i]),
                          n_post[n_post_o[i]:n_post_o[i + 1]].tolist())
                     for i in range(nm.shape[0])]
        em = z["e_meta"]
        e_labels = cuts(z["e_label"], z["e_label_o"])
        all_edges = [Edge(int(em[i, 0]), int(em[i, 1]), int(em[i, 2]),
                          e_labels[i])
                     for i in range(em.shape[0])]
        ers = []
        npos = epos = 0
        erm = z["er_meta"]
        leads = cuts(z["er_lead"], z["er_lead_o"])
        trails = cuts(z["er_trail"], z["er_trail_o"])
        for i in range(erm.shape[0]):
            nn, ne = int(erm[i, 2]), int(erm[i, 3])
            ers.append(EncodedRead(
                int(erm[i, 0]), int(erm[i, 1]), leads[i], trails[i],
                all_edges[epos:epos + ne], all_nodes[npos:npos + nn]))
            npos += nn
            epos += ne
        return cls(
            input_file=header["input_file"],
            masked_kmers=MaskInfo.from_json(header["masked_kmers"]),
            coverage=Coverage.from_json(header["coverage"]),
            raw_reads=rr,
            hic_pairs=list(header.get("hic_pairs", [])),
            selected_chunks=chunks,
            encoded_reads=ers,
            hic_edges=list(header.get("hic_edges", [])),
            read_type=header["read_type"],
            model_param=HMMParamOnStrands.from_json(header["model_param"]),
            error_rate=ErrorRate.from_json(header["error_rate"]),
            processed_stages=list(header.get("processed_stages", [])),
        )
