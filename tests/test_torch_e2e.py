"""Port twin of tests/test_e2e.py: synthetic diploid genome -> chunks ->
encode -> local clustering -> graph -> GFA through jtk_tpu_torch, verified
against the two truth haplotypes with the same assertions."""

import numpy as np

from jtk_tpu_torch.io import sim
from jtk_tpu_torch.io.gfa import parse_gfa
from jtk_tpu_torch.stages.assemble import assemble
from jtk_tpu_torch.stages.determine_chunks import select_chunks
from jtk_tpu_torch.stages.local_clustering import local_clustering
from jtk_tpu_torch.stages.multiplicity import (estimate_multiplicity,
                                               purge_multiplicity)
from jtk_tpu_torch.stages.pick_component import pick_top_n_component
from jtk_tpu_torch.stages.repeat_masking import mask_repeats
from jtk_tpu_torch.stages.util import adjusted_rand_index
from torch_util import port_on_cpu  # noqa: F401


def test_e2e_diploid_assembly():
    rng = np.random.default_rng(7)
    hap1 = sim.random_genome(rng, 6000)
    hap2 = hap1.copy()
    # dense SNVs so every 500 bp chunk carries several
    n_snv = 90
    snv_pos = rng.choice(np.arange(100, 5900), n_snv, replace=False)
    for p in snv_pos:
        hap2[p] = (hap2[p] + 1 + rng.integers(0, 3)) % 4
    reads = sim.simulate_reads(rng, [hap1, hap2], coverage=16, mean_len=2200,
                               error=0.05)
    ds = sim.reads_to_dataset(reads)
    mask_repeats(ds)
    select_chunks(ds, chunk_len=500, take_num=18, margin=100, seed=11,
                  encode_kwargs=dict(margin=100))
    assert len(ds.selected_chunks) >= 5
    ds.sanity_check()
    pick_top_n_component(ds, 1)
    estimate_multiplicity(ds)
    purge_multiplicity(ds, 10)
    ds.sanity_check()
    local_clustering(ds, seed=5, flips_per_read=600, restarts=8)
    # at least some chunks should phase into 2 clusters with good ARI
    phased = [c for c in ds.selected_chunks if c.cluster_num == 2]
    assert len(phased) >= 2, [c.cluster_num for c in ds.selected_chunks]
    aris = []
    for c in phased:
        asn, truth = [], []
        for er in ds.encoded_reads:
            for n in er.nodes:
                if n.chunk == c.id:
                    asn.append(n.cluster)
                    truth.append(reads[er.id]["hap"])
        aris.append(adjusted_rand_index(truth, asn))
    assert np.mean(aris) > 0.6, aris
    gfa = assemble(ds)
    segs, links = parse_gfa(gfa)
    assert len(segs) >= 2
    # every contig >= 300 bp must match one haplotype with high identity
    from jtk_tpu_torch.io.eval import assembly_metrics
    m = assembly_metrics(gfa, [hap1, hap2])
    for name, rec in m["contigs"].items():
        assert rec["error"] < 0.08, (name, rec)
    assert m["total_len"] > 4000, m
    assert m["mean_error"] < 0.05, m
