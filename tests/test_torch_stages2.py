"""The port's quality-loop stages against the JAX package, on the fixtures
of tests/test_stages.py, tests/test_deletion_fill.py and
tests/test_dense_encoding.py: each fixture is built once with ``jtk_tpu``,
carried to the port through the DataSet JSON ABI, run through the stage
in both packages, and the two ``DataSet.dumps()`` must be identical (the
stages are host code, integer K3 alignments and numpy random streams).

Where a stage re-clusters (``purge_diverged``, ``correct_deletion(
re_cluster=True)``, ``dense_encoding``), local clustering is replaced in
both packages by the same recording stub: its MCMC draws from
``jax.random`` in one package and ``torch.Generator`` in the other, and it
has its own parity tests (tests/test_torch_cluster.py).  The stub checks
that both packages re-cluster the same chunks.
"""

import numpy as np
import pytest

import jtk_tpu.stages.local_clustering as jlc
import jtk_tpu_torch.stages.local_clustering as plc
from jtk_tpu import seq as seqmod
from jtk_tpu.datamodel import (Chunk, DataSet, Edge, EncodedRead, Node,
                               RawRead, ReadType)
from jtk_tpu.io import sim
from jtk_tpu_torch.datamodel import DataSet as PDataSet
from test_stages import _mk_ds_with_pileup
from torch_util import port_on_cpu  # noqa: F401


@pytest.fixture
def recluster_log(monkeypatch):
    """Replace local clustering in both packages by a stub that records the
    selection it was asked to re-cluster."""
    calls = {"jax": [], "port": []}

    def stub(tag):
        def local_clustering(ds, seed=42, selection=None, **_kw):
            calls[tag].append(sorted(selection) if selection is not None
                              else None)
            return ds
        return local_clustering

    monkeypatch.setattr(jlc, "local_clustering", stub("jax"))
    monkeypatch.setattr(plc, "local_clustering", stub("port"))
    return calls


def _both(jds, jfn, pfn):
    """Run the stage on the JAX-side dataset and on its port copy."""
    pds = PDataSet.loads(jds.dumps())
    jfn(jds)
    pfn(pds)
    return jds.dumps(), pds.dumps()


def _squish_fixture(rng):
    ds = DataSet.with_minimum_data("x.fa", [], ReadType.ONT)
    for cid in range(3):
        ds.selected_chunks.append(Chunk(cid, "ACGT" * 50, 2, 2))
    for rid in range(20):
        hap = rid % 2
        nodes = []
        for cid in range(3):
            cl = hap if cid < 2 else int(rng.integers(0, 2))
            n = Node.new(cid, True, "ACGT" * 50, [("M", 200)], cid * 220, 2)
            n.cluster = cl
            n.posterior = [0.0, -10.0] if cl == 0 else [-10.0, 0.0]
            nodes.append(n)
        ds.raw_reads.append(RawRead(f"r{rid}", "", rid, "ACGT" * 200))
        ds.encoded_reads.append(EncodedRead(rid, 800, "", "", [], nodes))
    return ds


def _correction_fixture(rng):
    ds = DataSet.with_minimum_data("x.fa", [], ReadType.ONT)
    K = 5
    for cid in range(K):
        ds.selected_chunks.append(Chunk(cid, "ACGT" * 50, 2, 2))
    for rid in range(24):
        hap = rid % 2
        nodes = []
        for cid in range(K):
            cl = hap
            if cid == 2 and rng.random() < 0.3:
                cl = 1 - hap
            n = Node.new(cid, True, "ACGT" * 50, [("M", 200)], cid * 210, 2)
            n.cluster = cl
            n.posterior = [-0.1, -2.4] if cl == 0 else [-2.4, -0.1]
            nodes.append(n)
        ds.raw_reads.append(RawRead(f"r{rid}", "", rid, "ACGT" * 300))
        ds.encoded_reads.append(EncodedRead(rid, 1200, "", "", [], nodes))
    return ds


def _erroneous_fixture():
    ds = DataSet.with_minimum_data("x.fa", [], ReadType.ONT)
    for cid in range(11):
        ds.selected_chunks.append(Chunk(cid, "ACGT" * 50, 1, 1))

    def mk(rid, chunks):
        nodes = []
        for i, ch in enumerate(chunks):
            nodes.append(Node.new(ch, True, "ACGT" * 50, [("M", 200)],
                                  200 * i, 1))
        seq = "ACGT" * 50 * len(chunks)
        edges = [Edge.from_nodes(a, b, seq) for a, b in zip(nodes, nodes[1:])]
        ds.raw_reads.append(RawRead(f"r{rid}", "", rid, seq))
        return EncodedRead(rid, len(seq), "", "", edges, nodes)

    for rid in range(20):
        ds.encoded_reads.append(mk(rid, list(range(10))))
    ds.encoded_reads.append(mk(20, [0, 10, 1]))
    return ds


def test_remove_erroneous_nodes_identical():
    from jtk_tpu.stages.remove_erroneous import remove_erroneous_nodes as j
    from jtk_tpu_torch.stages.remove_erroneous import \
        remove_erroneous_nodes as p
    jd, pd = _both(_erroneous_fixture(), j, p)
    assert jd == pd
    assert '"chunk": 10' not in pd


@pytest.mark.parametrize("seed", [2, 9])
def test_squish_identical(seed):
    from jtk_tpu.stages.squish import squish_erroneous_clusters as j
    from jtk_tpu_torch.stages.squish import squish_erroneous_clusters as p
    jd, pd = _both(_squish_fixture(np.random.default_rng(seed)),
                   lambda ds: j(ds, count=5), lambda ds: p(ds, count=5))
    assert jd == pd


@pytest.mark.parametrize("seed", [3, 4])
def test_correct_clustering_identical(seed):
    from jtk_tpu.stages.correction import correct_clustering as j
    from jtk_tpu_torch.stages.correction import correct_clustering as p
    jd, pd = _both(_correction_fixture(np.random.default_rng(seed)), j, p)
    assert jd == pd


def test_purge_largeindel_identical():
    from jtk_tpu.stages.purge_diverged import purge_largeindel as j
    from jtk_tpu_torch.stages.purge_diverged import purge_largeindel as p
    ds, _ = _mk_ds_with_pileup(np.random.default_rng(1), n_chunks=1, cov=10)
    for er in ds.encoded_reads:
        n = er.nodes[0]
        if n.cluster == 0:
            L = len(n.seq)
            n.cigar = [("M", L // 2), ("D", 150), ("M", L - L // 2)]
    jd, pd = _both(ds, lambda d: j(d, indel_size=100),
                   lambda d: p(d, indel_size=100))
    assert jd == pd


def _diverged_fixture(rng, n_reads=20, sub_bad=0.3):
    """Reads spanning three 2-cluster chunks (so the error model can tell
    read terms from chunk terms); the members of (chunk 1, cluster 1)
    carry a 30 % substitution rate."""
    ds = DataSet.with_minimum_data("x.fa", [], ReadType.ONT)
    tpls = [sim.random_genome(rng, 200) for _ in range(3)]
    for cid, t in enumerate(tpls):
        ds.selected_chunks.append(Chunk(cid, seqmod.decode(t).decode(), 2, 2))
    for rid in range(n_reads):
        hap = rid % 2
        nodes, parts = [], []
        for cid, t in enumerate(tpls):
            rate = sub_bad if (cid, hap) == (1, 1) else 0.02
            codes = sim.mutate(rng, t, sub=rate)
            seq = seqmod.decode(codes).decode()
            n = Node.new(cid, True, seq, [("M", len(seq))], 200 * cid, 2)
            n.cluster = hap
            n.posterior = [0.0, -10.0] if hap == 0 else [-10.0, 0.0]
            nodes.append(n)
            parts.append(seq)
        read = "".join(parts)
        edges = [Edge.from_nodes(a, b, read) for a, b in zip(nodes, nodes[1:])]
        ds.raw_reads.append(RawRead(f"r{rid}", "", rid, read))
        ds.encoded_reads.append(
            EncodedRead(rid, len(read), "", "", edges, nodes))
    return ds


@pytest.mark.parametrize("re_cluster", [False, True])
def test_purge_diverged_identical(recluster_log, re_cluster):
    from jtk_tpu.stages.purge_diverged import purge_diverged as j
    from jtk_tpu_torch.stages.purge_diverged import purge_diverged as p
    ds = _diverged_fixture(np.random.default_rng(0))
    before = ds.dumps().count('"chunk": 1,')
    jd, pd = _both(ds, lambda d: j(d, re_cluster=re_cluster),
                   lambda d: p(d, re_cluster=re_cluster))
    assert jd == pd
    assert recluster_log["jax"] == recluster_log["port"]
    assert recluster_log["port"] == ([[1]] if re_cluster else [])
    assert pd.count('"chunk": 1,') < before


def _deletion_fixture():
    from jtk_tpu.stages.encode import encode
    rng = np.random.default_rng(11)
    genome = sim.random_genome(rng, 14000)
    reads = sim.simulate_reads(rng, [genome], coverage=14, mean_len=12500,
                               error=0.02)
    ds = sim.reads_to_dataset(reads)
    ds.selected_chunks = [
        Chunk(i, seqmod.decode(genome[1000 + 2000 * i:3000 + 2000 * i])
              .decode())
        for i in range(6)]
    encode(ds)
    for er in ds.encoded_reads:
        chunks = [n.chunk for n in er.nodes]
        if all(c in chunks for c in (1, 2, 3, 4)):
            for c in (2, 3):
                i = next(i for i, n in enumerate(er.nodes) if n.chunk == c)
                er.remove(i)
            break
    return ds


def test_correct_deletion_recluster_identical(recluster_log):
    from jtk_tpu.stages.deletion_fill import correct_deletion as j
    from jtk_tpu_torch.stages.deletion_fill import correct_deletion as p
    jd, pd = _both(_deletion_fixture(), lambda d: j(d, re_cluster=True),
                   lambda d: p(d, re_cluster=True))
    assert jd == pd
    assert recluster_log["jax"] == recluster_log["port"]
    assert recluster_log["port"] and {2, 3} <= set(recluster_log["port"][0])


def _dense_fixture():
    """tests/test_dense_encoding.py's collapsed pair of chunks."""
    rng = np.random.default_rng(3)
    chunk_seqs = {i: seqmod.decode(sim.random_genome(rng, 300)).decode()
                  for i in range(6)}
    gap_a = seqmod.decode(sim.random_genome(rng, 600)).decode()
    gap_b_codes = seqmod.encode(gap_a)
    for p in rng.choice(np.arange(20, 580), 12, replace=False):
        gap_b_codes[p] = (gap_b_codes[p] + 1 + rng.integers(0, 3)) % 4
    gap_b = seqmod.decode(gap_b_codes).decode()
    ds = DataSet.with_minimum_data("x.fa", [], ReadType.ONT)
    ds.selected_chunks = [Chunk(i, chunk_seqs[i], 1, 1) for i in range(6)]
    rid = 0
    for flank, exit_, gap in ((0, 4, gap_a), (1, 5, gap_b)):
        for _ in range(10):
            walk = [flank, 2, 3, exit_]
            nodes, parts, pos = [], [], 0
            for wi, ch in enumerate(walk):
                s = chunk_seqs[ch]
                nodes.append(Node.new(ch, True, s, [("M", len(s))], pos, 1))
                parts.append(s)
                pos += len(s)
                if wi == 1:
                    parts.append(gap)
                    pos += len(gap)
            read_seq = "".join(parts)
            edges = [Edge.from_nodes(a, b, read_seq)
                     for a, b in zip(nodes, nodes[1:])]
            ds.raw_reads.append(RawRead(f"r{rid}", "", rid, read_seq))
            ds.encoded_reads.append(
                EncodedRead(rid, len(read_seq), "", "", edges, nodes))
            rid += 1
    ds.coverage.value = 10.0
    ds.coverage.protected = True
    return ds


def test_dense_encoding_identical(recluster_log):
    from jtk_tpu.stages.dense_encoding import dense_encoding as j
    from jtk_tpu_torch.stages.dense_encoding import dense_encoding as p
    jds = _dense_fixture()
    n_before = len(jds.selected_chunks)
    pds = PDataSet.loads(jds.dumps())
    j(jds, min_span_reads=3)
    p(pds, min_span_reads=3)
    assert len(pds.selected_chunks) > n_before
    assert [(c.id, c.seq) for c in pds.selected_chunks] == \
        [(c.id, c.seq) for c in jds.selected_chunks]

    def nodes(ds):
        return [[(n.chunk, n.is_forward, n.position_from_start, n.cigar)
                 for n in er.nodes] for er in ds.encoded_reads]

    assert nodes(pds) == nodes(jds)
    assert recluster_log["jax"] == recluster_log["port"]
