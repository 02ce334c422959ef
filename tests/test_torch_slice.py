"""The slice across packages: encoding the same reads against fixed chunks
gives the JAX package's nodes and CIGARs, and a DataSet the JAX package
dumped loads in the port and dumps back unchanged."""

import numpy as np
import pytest

from jtk_tpu import seq as jseq
from jtk_tpu.datamodel import Chunk as JChunk
from jtk_tpu.datamodel import DataSet as JDataSet
from jtk_tpu.io import sim as jsim
from jtk_tpu.stages.encode import encode as jencode
from jtk_tpu_torch.datamodel import Chunk as PChunk
from jtk_tpu_torch.datamodel import DataSet as PDataSet
from jtk_tpu_torch.stages.encode import encode as pencode
from torch_util import port_on_cpu  # noqa: F401


@pytest.fixture(scope="module")
def sim_reads():
    rng = np.random.default_rng(1)
    genome = jsim.random_genome(rng, 6000)
    clen = 500
    starts = list(range(250, 5500, clen + 250))
    reads = jsim.simulate_reads(rng, [genome], coverage=8, mean_len=2500,
                                error=0.08)
    chunks = [jseq.decode(genome[s:s + clen]).decode() for s in starts]
    return reads, chunks


@pytest.fixture(scope="module")
def jax_encoded(sim_reads):
    reads, chunks = sim_reads
    ds = jsim.reads_to_dataset(reads)
    ds.selected_chunks = [JChunk(i, s) for i, s in enumerate(chunks)]
    jencode(ds, margin=100, W=256)
    return ds


def test_encode_matches_jax(sim_reads, jax_encoded):
    from jtk_tpu_torch.io import sim as psim
    reads, chunks = sim_reads
    ds = psim.reads_to_dataset(reads)
    ds.selected_chunks = [PChunk(i, s) for i, s in enumerate(chunks)]
    pencode(ds, margin=100, W=256)
    ds.sanity_check()
    n_nodes = 0
    for a, b in zip(ds.encoded_reads, jax_encoded.encoded_reads):
        assert a.id == b.id
        assert [(n.chunk, n.position_from_start, n.is_forward, n.cigar)
                for n in a.nodes] == \
            [(n.chunk, n.position_from_start, n.is_forward, n.cigar)
             for n in b.nodes]
        n_nodes += len(a.nodes)
    assert n_nodes > 20
    assert ds.dumps() == jax_encoded.dumps()


@pytest.mark.parametrize("fmt", ["json", "npz"])
def test_dataset_dumped_by_jax_loads_in_port(jax_encoded, tmp_path, fmt):
    path = str(tmp_path / f"state.{fmt}")
    jax_encoded.dump(path)
    ds = PDataSet.load(path)
    ds.sanity_check()
    assert ds.dumps() == jax_encoded.dumps()
    assert JDataSet.loads(ds.dumps()).dumps() == jax_encoded.dumps()
