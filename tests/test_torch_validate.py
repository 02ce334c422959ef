"""The port's twin of ``scripts/validate_medium.py``
(``jtk_tpu_torch.tools.validate_medium``) against the script's own recipe:
the same simulated region and reads, and the same record fields from a
DataSet and a GFA."""

import numpy as np
import pytest
import torch

from jtk_tpu_torch.datamodel import Chunk, DataSet, EncodedRead, Node
from jtk_tpu_torch.io import sim as psim
from jtk_tpu_torch.runtime import use_device
from jtk_tpu_torch.tools import validate_medium as vm
from torch_util import port_on_cpu  # noqa: F401


def test_simulation_is_the_scripts():
    """default_rng(2026) through the port's simulator gives the bytes
    the script's calls through jtk_tpu.io.sim give."""
    from jtk_tpu.io import sim as jsim
    rng = np.random.default_rng(2026)
    h1, h2 = jsim.diploid(rng, 20_000, het=0.004)
    want = jsim.simulate_reads(rng, [h1, h2], coverage=4, mean_len=15_000,
                               error=0.05, clip_ends=True)
    g1, g2, got = vm.simulate(20_000, 4)
    assert g1.tobytes() == h1.tobytes() and g2.tobytes() == h2.tobytes()
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype


def _hand_made():
    """Two haplotypes, reads of both, three chunks (one unphased), nodes
    with clusters that split the reads mostly by haplotype, and a GFA of
    one contig of each haplotype with a few errors and a short one."""
    rng = np.random.default_rng(5)
    h1 = psim.random_genome(rng, 1500)
    h2 = h1.copy()
    h2[rng.choice(1500, 12, replace=False)] ^= 1
    reads = [{"hap": int(h), "codes": np.zeros(1, np.int8)}
             for h in rng.integers(0, 2, 12)]
    chunks = [Chunk(0, "ACGT", cluster_num=2), Chunk(1, "ACGT"),
              Chunk(2, "ACGT", cluster_num=2)]
    ers = []
    for i, r in enumerate(reads):
        nodes = [Node(10 * c, c, (r["hap"] + (i == 3 and c == 0)) % 2
                      if chunks[c].cluster_num == 2 else 0,
                      "ACGT", True, [("M", 4)], [0.0, 0.0])
                 for c in range(3) if (i + c) % 5]
        ers.append(EncodedRead(i, 100, "", "", [], nodes))
    ds = DataSet(selected_chunks=chunks, encoded_reads=ers)
    c1 = h1.copy()
    c1[[100, 700]] ^= 2
    c2 = np.delete(h2, [50, 900])
    dec = {0: "A", 1: "C", 2: "G", 3: "T"}
    seqs = ["".join(dec[int(x)] for x in c) for c in (c1, c2, h1[:200])]
    gfa = "H\tVN:Z:1.0\n" + "".join(
        f"S\ttig_{i}\t{s}\tLN:i:{len(s)}\n" for i, s in enumerate(seqs))
    return reads, ds, gfa, [h1, h2]


def test_record_is_the_scripts(tmp_path):
    """The twin's record against validate_medium.py's recipe, through
    jtk_tpu's ARI and assembly metrics on the same DataSet (loaded by
    jtk_tpu from the port's dump) and GFA."""
    from jtk_tpu.datamodel import DataSet as JDataSet
    from jtk_tpu.io.eval import assembly_metrics
    from jtk_tpu.stages.util import adjusted_rand_index
    reads, ds, gfa, haps = _hand_made()
    path = str(tmp_path / "v.clustered.json")
    ds.dump(path)
    got = vm.record(20_000, 4.0, reads, 12.34, {"encoded": 1.5}, 99.9,
                    DataSet.load(path), gfa, haps)
    # the script's recipe
    jds = JDataSet.load(path)
    aris = []
    for c in jds.selected_chunks:
        if c.cluster_num < 2:
            continue
        asn, truth = [], []
        for er in jds.encoded_reads:
            for n in er.nodes:
                if n.chunk == c.id:
                    asn.append(n.cluster)
                    truth.append(reads[er.id]["hap"])
        aris.append(adjusted_rand_index(truth, asn))
    m = assembly_metrics(gfa, haps)
    want = {
        "region": 20_000, "coverage": 4.0, "n_reads": len(reads),
        "wall_s": 12.3, "stage_s": {"encoded": 1.5}, "peak_rss_mb": 99.9,
        "phased_chunks": len(aris), "total_chunks": 3,
        "mean_phasing_ari": round(float(np.mean(aris)), 3),
        "contigs": len(m["contigs"]), "assembly_len": m["total_len"],
        "mean_contig_error": round(m["mean_error"], 5),
    }
    assert got == want
    assert got["phased_chunks"] == 2 and 0 < got["mean_phasing_ari"] < 1
    assert got["contigs"] == 2 and 0 < got["mean_contig_error"] < 0.01
    assert vm.phasing_aris(ds, reads) == aris


def test_asking_for_cuda_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vm.main(["20000", "4", "--device", "cuda",
                 "--work-dir", str(tmp_path)])
    with use_device("cpu"), pytest.raises(RuntimeError,
                                          match="no CUDA device"):
        vm.main(["20000", "4", "--devices", "cpu,cuda",
                 "--work-dir", str(tmp_path)])
    assert list(tmp_path.iterdir()) == []


def test_work_dir_is_keyed_by_scale():
    assert vm.default_work_dir(500_000, 60) != vm.default_work_dir(500_000,
                                                                    30)
    assert vm.default_work_dir(500_000, 60.0).endswith("_500000_60")
