"""The port's data parallelism (jtk_tpu_torch.parallel and its call sites)
on the CPU: every sharded function gives the same bits (``torch.equal``)
on the device sets ["cpu"] * 3 (uneven shards) and ["cpu"] * 4 as on
["cpu"]; the k-mer histogram equals ``np.bincount``, and ``mask_repeats``'
device histogram gives the threshold and mask of a host pass (np.unique).
"""

import functools

import numpy as np
import pytest
import torch

from jtk_tpu_torch import parallel as ppar
from jtk_tpu_torch.datamodel import DataSet, RawRead
from jtk_tpu_torch.io import sim
from jtk_tpu_torch.mapper import Candidate, extend_candidates
from jtk_tpu_torch.ops import modtable as pmod
from jtk_tpu_torch.ops import phmm as pphmm
from jtk_tpu_torch.ops import phmm_grad as pg
from jtk_tpu_torch.ops.banded_align import linear_offsets
from jtk_tpu_torch import runtime
from jtk_tpu_torch import seq as seqmod
from jtk_tpu_torch.stages import repeat_masking as rm
from torch_util import DEEP_COLS, oracle_misses, port_on_cpu  # noqa: F401

SHARDS = [3, 4]   # ["cpu"] * 3 cuts 16 reads 6 / 5 / 5


def test_device_set_defaults_and_contexts():
    assert runtime.devices() == [torch.device("cpu")]
    with runtime.use_devices(["cpu"] * 3) as devs:
        assert devs == [torch.device("cpu")] * 3
        assert runtime.devices() == devs
        assert runtime.device() == devs[0]
        with runtime.use_device("cpu"):
            assert runtime.devices() == [torch.device("cpu")]
        assert len(runtime.devices()) == 3
    assert runtime.devices() == [torch.device("cpu")]
    with pytest.raises(ValueError):
        with runtime.use_devices([]):
            pass
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            with runtime.use_devices(["cpu", "cuda"]):
                pass


def test_cli_devices_sets_the_device_set(monkeypatch):
    from jtk_tpu_torch import cli
    seen = []
    monkeypatch.setattr(cli, "_dispatch",
                        lambda args: seen.append(runtime.devices()))
    cli.main(["stats", "--file", "x", "--devices", "cpu,cpu,cpu"])
    cli.main(["stats", "--file", "x", "--device", "cpu"])
    assert seen == [[torch.device("cpu")] * 3, [torch.device("cpu")]]


def test_shard_helpers():
    assert ppar.shard_bounds(16, 3) == [(0, 6), (6, 11), (11, 16)]
    assert ppar.shard_bounds(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    x = np.arange(33).reshape(11, 3)
    y = torch.arange(11)
    xs, ys = ppar.shard_leading(["cpu"] * 4, x, y)
    assert [len(t) for t in xs] == [3, 3, 3, 2]
    _equal(ppar.gather(xs, "cpu"), torch.as_tensor(x))
    _equal(ppar.gather(ys, "cpu"), y)
    (r0, r1), = ppar.replicate(["cpu"] * 2, y)
    assert r0 is y and r1 is y
    (c0, c1), = ppar.replicate(["cpu"] * 2, x)
    assert c0 is c1
    _equal(c0, torch.as_tensor(x))


def test_launch_refuses_tensors_off_one_cuda_device():
    """Checked before any library is built or loaded."""
    from jtk_tpu_torch.ops import cuda_build
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_build.launch("edit_dp", "edit_dp_launch", torch.zeros(2), 3)
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_build.launch("edit_dp", "edit_dp_launch", 3)


def _on(n, dev="cpu"):
    return runtime.use_devices([dev] * n)


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def train_inputs(n=16, L=192, W=128, seed=4):
    """n reads of exactly the padded length L (substitutions, or a noisy
    read trimmed or topped up from the template), their band offsets at W,
    and the weights of a batch padded as _fit_strand pads it."""
    rng = np.random.default_rng(seed)
    template = sim.random_genome(rng, L).astype(np.int8)
    qs = np.empty((n, L), np.int8)
    for i in range(n):
        if i % 3 == 2:
            r = sim.noisy_read(rng, template, 0.06)
            r = np.concatenate([r, template[len(r):]])[:L]
        else:
            r = template.copy()
            m = rng.random(L) < 0.06
            r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
        qs[i] = r
    q_lens = np.full(n, L, np.int32)
    offs = np.stack([linear_offsets(L, L, L, W)] * n)
    wts = np.ones(n, np.float32)
    wts[-2:] = 0.0
    return template, qs, offs, q_lens, wts, W


def _train(n_dev, dev="cpu", n_inner=10):
    template, qs, offs, q_lens, wts, W = train_inputs()
    with _on(n_dev, dev):
        batch = pg.PairBatch(qs, template, offs, q_lens, len(template), W)
        theta = ppar.params_to_theta(pphmm.PHMMParams.default())
        many = ppar.make_train_steps(W, n_inner=n_inner)
        theta, losses = many(theta, batch, torch.as_tensor(wts, device=dev))
    return {k: v.cpu() for k, v in theta.items()}, losses.cpu()


@functools.lru_cache(maxsize=None)
def _train_one():
    return _train(1)


@pytest.mark.parametrize("n_dev", SHARDS)
def test_ten_train_steps_bit_identical(n_dev):
    theta1, losses1 = _train_one()
    theta, losses = _train(n_dev)
    _equal(theta, theta1)
    _equal(losses, losses1)
    assert losses1[-1] < losses1[0]


def test_shard_batch_cuts_pairs_in_order():
    """The train step's shards: contiguous runs of pairs, in order, every
    per-pair tensor cut and none other."""
    template, qs, offs, q_lens, wts, W = train_inputs()
    batch = pg.PairBatch(qs, template, offs, q_lens, len(template), W)
    shards = ppar.shard_batch(batch, ["cpu"] * 3)
    assert [len(b.q_lens) for b in shards] == [6, 5, 5]
    for name in ("qs", "offs", "strand"):
        _equal(torch.cat([b.prep[name] for b in shards]), batch.prep[name])
    for i, t in enumerate(batch.lk_args):
        _equal(torch.cat([b.lk_args[i] for b in shards]), t)
    assert ppar.shard_batch(batch, ["cpu"]) == [batch]


def _pileup_lk(n_dev, seed=6, dev="cpu"):
    template, qs, offs, q_lens, _w, W = train_inputs(seed=seed)
    with _on(n_dev, dev):
        return ppar.make_sharded_pileup_lk(W)(qs, template, offs, q_lens,
                                              len(template)).cpu()


@pytest.mark.parametrize("n_dev", SHARDS)
def test_sharded_pileup_lk_bit_identical(n_dev):
    want = _pileup_lk(1)
    _equal(_pileup_lk(n_dev), want)
    template, qs, offs, q_lens, _w, W = train_inputs(seed=6)
    direct = pphmm.likelihood_pileup(qs, template, offs, q_lens,
                                     len(template),
                                     pphmm.PHMMParams.default("cpu"), W)
    np.testing.assert_array_equal(want.numpy(), direct)


@pytest.mark.parametrize("n_dev", [1] + SHARDS)
def test_kmer_hist_equals_bincount(n_dev):
    rng = np.random.default_rng(1)
    kmers = rng.integers(0, 1 << 30, 1001).astype(np.uint32)
    with _on(n_dev):
        hist = ppar.make_sharded_kmer_hist(128)(kmers)
    assert hist.dtype == torch.int64
    np.testing.assert_array_equal(
        hist.numpy(), np.bincount(kmers.astype(np.int64) % 128,
                                  minlength=128))


def _repeat_dataset(seed=3):
    """Reads of a 3 kb region holding four copies of a 150 bp repeat."""
    rng = np.random.default_rng(seed)
    rep = sim.random_genome(rng, 150)
    parts = []
    for _ in range(4):
        parts += [sim.random_genome(rng, 600), rep]
    genome = np.concatenate(parts)
    reads = sim.simulate_reads(rng, [genome], coverage=6, mean_len=900,
                               error=0.03)
    return sim.reads_to_dataset(reads)


def _masked(n_dev, dev="cpu", **kw):
    ds = _repeat_dataset()
    with _on(n_dev, dev):
        annot = rm.mask_repeats(ds, **kw)
    return ds.masked_kmers.thr, annot.kmers, [r.seq for r in ds.raw_reads]


def _host_counts(ds, k):
    """The reference histogram: one host pass, np.unique of the reads'
    canonical k-mers."""
    return np.unique(rm._kmer_values(ds, k), return_counts=True)


def _host_mask(ds, k, freq, min_count):
    """The reference threshold and masked k-mers from :func:`_host_counts`."""
    uniq, counts = _host_counts(ds, k)
    thr = max(int(np.quantile(counts, 1.0 - freq)), min_count)
    return thr, set(uniq[counts > thr].tolist())


@pytest.mark.parametrize("n_dev", [1] + SHARDS)
def test_mask_repeats_device_path_matches_host(n_dev):
    """The device histogram at any device count: the host pass's counts,
    threshold and mask, and the same lowercased reads at every count."""
    kw = dict(k=9, freq=0.01, min_count=3)
    with _on(n_dev):
        uniq, counts = rm.count_kmers(_repeat_dataset(), kw["k"])
    _equal((uniq, counts), _host_counts(_repeat_dataset(), kw["k"]))
    thr, kmers, seqs = _masked(n_dev, **kw)
    assert (thr, kmers) == _host_mask(_repeat_dataset(), **kw)
    assert kmers and any(c.islower() for s in seqs for c in s)
    if n_dev > 1:
        assert seqs == _masked(1, **kw)[2]


def test_mask_repeats_threshold_interpolates_as_numpy():
    """A threshold that falls between two counts (numpy's linear
    interpolation, 8.6 here), at one device and four."""
    def dataset():
        return DataSet(read_type="ONT", raw_reads=[
            RawRead(name=f"r{i}", desc="", id=i,
                    seq=seqmod.decode(np.random.default_rng(i).integers(
                        0, 4, 400).astype(np.int8)).decode())
            for i in range(6)])

    q = np.quantile(_host_counts(dataset(), 5)[1], 1.0 - 0.05)
    assert q != int(q)
    thr, want = _host_mask(dataset(), 5, 0.05, 2)
    assert thr == int(q) and want
    out = []
    for n_dev in (1, 4):
        ds = dataset()
        with _on(n_dev):
            got = rm.mask_repeats(ds, k=5, freq=0.05, min_count=2).kmers
        assert ds.masked_kmers.thr == thr and got == want
        out.append([r.seq for r in ds.raw_reads])
    assert out[0] == out[1]


def _modtable_inputs(seed=8, n=50, L=150, W=128):
    rng = np.random.default_rng(seed)
    template = sim.random_genome(rng, L).astype(np.int8)
    reads = [sim.noisy_read(rng, template, 0.08) for _ in range(n)]
    q_lens = np.array([len(r) for r in reads], np.int32)
    Qpad = ((int(q_lens.max()) + 63) // 64) * 64
    qs = np.full((n, Qpad), 4, np.int8)
    for i, r in enumerate(reads):
        qs[i, :len(r)] = r
    offs = np.stack([linear_offsets(int(q), L, Qpad, W) for q in q_lens])
    strands = rng.random(n) < 0.5
    seg = rng.integers(0, 3, n).astype(np.int32)
    return template, qs, offs, q_lens, W, strands, seg


def _modtables(n_dev, dev="cpu"):
    template, qs, offs, q_lens, W, strands, seg = _modtable_inputs()
    L = len(template)
    pf = pphmm.PHMMParams.default(dev)
    pr = pphmm.params_from_numpy(*(x.cpu().numpy() * 0.9 + 0.1 / x.shape[1]
                                   for x in pf), dev)
    args = (qs, template, offs, q_lens, np.int32(L), pf, W, L)
    kw = dict(strands=strands, params_rev=pr)
    exp_mat = np.full((3, L + 1, pmod.NUM_EDIT), 0.5, np.float32)
    with _on(n_dev, dev):
        lk, tab = pmod.modification_table_pileup_pallas(*args, **kw)
        lk2, tot = pmod.modtable_pileup_gains(*args, seg, 3, **kw)
        tot = tot.cpu().numpy()
        lk3, tot_dev = pmod.modtable_pileup_gains(*args, seg, 3, **kw)
        _lk, tot_k = pmod.modtable_pileup_gains(*args, seg, 3, **kw)
        sparse = pmod.finish_gains(tot_k, 3, 8, 0.0)
        lks, stats, gather = pmod.modtable_pileup_stats_pallas(
            qs, template, offs, q_lens, np.int32(L), pf, W, L, strands, pr,
            seg, 3, exp_mat)
        cols = np.array([0, 5, 77, 14 * 40 + 3, 14 * L + 13], np.int64)
        raw, comp = gather(cols)
    return dict(lk=lk, tab=tab, lk2=lk2, tot=tot, lk3=lk3,
                tot_dev=tot_dev.cpu(),
                sparse=[sparse.vals, sparse.idx, sparse.ev, sparse.counts],
                lks=lks, stats=stats.cpu(), raw=raw, comp=comp)


@functools.lru_cache(maxsize=None)
def _modtables_one():
    return _modtables(1)


def _record_stats_blocks(monkeypatch):
    """The variant-stats engine's float32 block of each slice (its six
    planes' segment sums), as numpy, in the order the slices ran."""
    blocks = []
    orig = pmod._segsum_matmul

    def recorded(x, seg, n_rows):
        out = orig(x, seg, n_rows)
        if out.shape[-1] == 6:
            blocks.append(out.cpu().numpy().copy())
        return out
    monkeypatch.setattr(pmod, "_segsum_matmul", recorded)
    return blocks


@pytest.mark.parametrize("n_dev", SHARDS)
def test_modtable_engines_bit_identical(n_dev, monkeypatch):
    """50 pairs in slices of 16 (MAXB cut to the slice floor): four
    slices, so three entries take one slice each and one takes two.  The
    variant stats are the slices' float32 blocks summed in float64 in
    slice order on the primary, bit for bit as numpy sums them."""
    monkeypatch.setattr(pmod, "MAXB", 16)
    want = _modtables_one()
    blocks = _record_stats_blocks(monkeypatch)
    before = dict(pmod.SLICE_CALLS)
    got = _modtables(n_dev)
    assert pmod.SLICE_CALLS[4] - before.get(4, 0) == 5
    _equal(got, want)
    assert want["tab"].shape == (50, 151, pmod.NUM_EDIT)
    assert len(blocks) == 4
    host = functools.reduce(np.add, (b.astype(np.float64) for b in blocks))
    assert got["stats"].dtype == torch.float64
    assert np.array_equal(got["stats"].numpy().view(np.int64),
                          host.view(np.int64))


def _extend_inputs(seed=11):
    """Reads holding noisy copies of chunks on either strand, a candidate
    for each copy and some for chunks a read does not hold."""
    rng = np.random.default_rng(seed)
    chunks = {c: sim.random_genome(rng, 180 + 20 * c).astype(np.int8)
              for c in range(5)}
    reads, cands, margin = [], [], 40
    for i in range(9):
        c = i % 5
        fwd = i % 2 == 0
        left = rng.integers(50, 120)
        body = sim.noisy_read(rng, chunks[c], 0.05)
        read = np.concatenate([sim.random_genome(rng, left), body,
                               sim.random_genome(rng, 70)]).astype(np.int8)
        if not fwd:
            read = seqmod.revcomp(read)
        reads.append(read)
        start = left if fwd else len(read) - left - len(body)
        cands.append(Candidate(i, c, fwd, int(start) - margin,
                               len(chunks[c]) + 2 * margin, 9))
        cands.append(Candidate(i, (c + 2) % 5, True, 10, 260, 3))
    reads[3] = reads[3].copy()
    reads[3][80] = 4     # an N in a window: the legacy path
    return cands, reads, chunks, margin


def _extend(n_dev, dev="cpu"):
    cands, reads, chunks, margin = _extend_inputs()
    with _on(n_dev, dev):
        res = extend_candidates(cands, reads, chunks, W=128, margin=margin,
                                batch=7)
    return [{k: v for k, v in r.items() if k != "cand"} | {
        "cand": (r["cand"].read_idx, r["cand"].chunk_id)} for r in res]


@functools.lru_cache(maxsize=None)
def _extend_one():
    return _extend(1)


@pytest.mark.parametrize("n_dev", SHARDS)
def test_extend_candidates_bit_identical(n_dev):
    want = _extend_one()
    assert sum(r["dist"] < 40 for r in want) >= 8
    _equal(_extend(n_dev), want)


# ---------------------------------------------------------------------------
# against jtk_tpu's mesh functions on a 4-device virtual CPU mesh
# ---------------------------------------------------------------------------

_MESH_SCRIPT = r"""
import os, sys
import jax
import numpy as np
jax.config.update("jax_compilation_cache_dir", os.path.join(os.getcwd(),
                                                            ".jax_cache_cpu"))
from jtk_tpu import parallel as jpar
from jtk_tpu.datamodel import HMMParam
from jtk_tpu.ops import phmm as jphmm
from jtk_tpu.ops.modtable import modification_table_pileup_sharded

d = dict(np.load(sys.argv[1]))
mesh = jpar.make_mesh(4)
assert mesh.size == 4 and jpar.get_mesh().size == 4
params = jphmm.PHMMParams.from_hmmparam(HMMParam())
W, L = int(d["W"]), len(d["template"])
qs, offs, q_lens, wts = jpar.shard_leading(mesh, d["qs"], d["offs"],
                                           d["q_lens"], d["wts"])
tpl, = jpar.replicate(mesh, d["template"])
theta, losses = jpar.make_train_steps(mesh, W, n_inner=10)(
    jpar.params_to_theta(params), qs, tpl, offs, q_lens, np.int32(L), wts)
lk = jpar.make_sharded_pileup_lk(mesh, W)(qs, tpl, offs, q_lens,
                                          np.int32(L))
hist = jpar.make_sharded_kmer_hist(mesh, 128)(d["kmers"])
Lm = len(d["m_template"])
lk_m, tab_m = modification_table_pileup_sharded(
    d["m_qs"], d["m_template"], d["m_offs"], d["m_q_lens"], np.int32(Lm),
    params, int(d["m_W"]), Lm)
np.savez(sys.argv[2], lk=np.asarray(lk), losses=np.asarray(losses),
         hist=np.asarray(hist), lk_m=np.asarray(lk_m), tab_m=np.asarray(tab_m),
         **{"theta_" + k: np.asarray(v) for k, v in theta.items()})
"""


def _mesh_inputs():
    template, qs, offs, q_lens, wts, W = train_inputs()
    m_template, m_qs, m_offs, m_q_lens, m_W = _modtable_inputs()[:5]
    kmers = np.random.default_rng(1).integers(0, 1 << 30, 1000).astype(
        np.uint32)
    return dict(template=template, qs=qs, offs=offs, q_lens=q_lens, wts=wts,
                W=W, kmers=kmers, m_template=m_template, m_qs=m_qs,
                m_offs=m_offs, m_q_lens=m_q_lens, m_W=m_W)


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    """jtk_tpu's mesh functions on 4 virtual CPU devices, in one
    subprocess (the 4-device lowering is paid once)."""
    import os
    import subprocess
    import sys

    from envutil import cpu_subprocess_env
    tmp = tmp_path_factory.mktemp("mesh")
    inp, out = str(tmp / "in.npz"), str(tmp / "out.npz")
    np.savez(inp, **_mesh_inputs())
    res = subprocess.run(
        [sys.executable, "-c", _MESH_SCRIPT, inp, out],
        env=cpu_subprocess_env(4),
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(out))


def test_train_steps_match_jax_mesh(jax_mesh):
    theta, losses = _train(4)
    for k in ppar.KEYS:
        np.testing.assert_allclose(theta[k].numpy(), jax_mesh["theta_" + k],
                                   atol=1e-4)
    np.testing.assert_allclose(losses.numpy(), jax_mesh["losses"],
                               rtol=1e-5)


def test_sharded_pileup_lk_matches_jax_mesh(jax_mesh):
    np.testing.assert_allclose(_pileup_lk(4, seed=4).numpy(),
                               jax_mesh["lk"], atol=2e-2)


def test_kmer_hist_matches_jax_mesh(jax_mesh):
    kmers = _mesh_inputs()["kmers"]
    with _on(4):
        hist = ppar.make_sharded_kmer_hist(128)(kmers)
    np.testing.assert_array_equal(hist.numpy(), jax_mesh["hist"])


# The port's multi-base copy and deletion columns (copy 2-3, del 2-3) hold
# entries of negative gain where jtk_tpu's float32 column sums cancel and
# the port's, in float64, meet the float64 oracle (ROADMAP.md section 3.6,
# tests/test_torch_modtable_oracle.py): those may differ from the scan
# engine, and a seeded sample of them is held against the oracle instead.
ORACLE_SAMPLE = 8


def test_modtable_matches_jax_mesh(jax_mesh, monkeypatch):
    """50 pairs in four slices of <= 16 over four entries, against the
    scan engine on jtk_tpu's 4-device mesh: lk and every entry at the
    parity tolerance, except deep entries of negative gain, which may
    differ and then meet the float64 oracle (a seeded sample of 8)."""
    monkeypatch.setattr(pmod, "MAXB", 16)
    template, qs, offs, q_lens, W = _modtable_inputs()[:5]
    L = len(template)
    before = pmod.SLICE_CALLS.get(4, 0)
    with _on(4):
        lk, tab = pmod.modification_table_pileup_pallas(
            qs, template, offs, q_lens, np.int32(L),
            pphmm.PHMMParams.default("cpu"), W, L)
    assert pmod.SLICE_CALLS[4] == before + 1
    np.testing.assert_allclose(lk, jax_mesh["lk_m"], rtol=1e-4, atol=2e-2)
    tj = jax_mesh["tab_m"]
    mask = tj > -1e29
    np.testing.assert_array_equal(tab > -1e29, mask)
    off = mask & (np.abs(tab - tj) > 5e-2 + 1e-4 * np.abs(tj))
    deep = np.zeros_like(mask)
    deep[:, :, list(DEEP_COLS)] = True
    deep &= mask & (tj < jax_mesh["lk_m"][:, None, None])
    np.testing.assert_array_equal(off & ~deep, False)
    flagged = np.argwhere(off)
    print(f"{len(flagged)} deep entries differ from the scan engine")
    pick = flagged[np.random.default_rng(1).choice(
        len(flagged), min(ORACLE_SAMPLE, len(flagged)), replace=False)]
    assert oracle_misses(qs, q_lens, np.asarray(template, np.int8), tab,
                         pick) == []


# ---------------------------------------------------------------------------
# tests/test_mesh_determinism.py's stage chain through the port
# ---------------------------------------------------------------------------


def _stage_chain_gfa(n_dev):
    from jtk_tpu_torch.stages.assemble import assemble
    from jtk_tpu_torch.stages.determine_chunks import select_chunks
    from jtk_tpu_torch.stages.local_clustering import local_clustering
    from jtk_tpu_torch.stages.model_tune import update_models_on_both_strands
    from jtk_tpu_torch.stages.multiplicity import (estimate_multiplicity,
                                                   purge_multiplicity)
    from jtk_tpu_torch.stages.pick_component import pick_top_n_component
    with _on(n_dev):
        rng = np.random.default_rng(7)
        hap1 = sim.random_genome(rng, 4000)
        hap2 = hap1.copy()
        for p in rng.choice(np.arange(100, 3900), 60, replace=False):
            hap2[p] = (hap2[p] + 1 + rng.integers(0, 3)) % 4
        reads = sim.simulate_reads(rng, [hap1, hap2], coverage=14,
                                   mean_len=1800, error=0.05)
        ds = sim.reads_to_dataset(reads)
        rm.mask_repeats(ds)
        select_chunks(ds, chunk_len=500, take_num=10, margin=100, seed=11,
                      encode_kwargs=dict(margin=100))
        pick_top_n_component(ds, 1)
        estimate_multiplicity(ds)
        purge_multiplicity(ds, 10)
        update_models_on_both_strands(ds, polish_rounds=1)
        local_clustering(ds, seed=5, flips_per_read=400, restarts=6)
        return assemble(ds, to_polish=False)


@pytest.mark.slow
def test_stage_chain_gfa_identical_at_1_and_4_devices():
    """Golden determinism through the port (on the CPU ~11 min on one
    device and ~26 min on four: model tuning's plain K1 passes are Python
    loops over rows, once a shard)."""
    gfa1 = _stage_chain_gfa(1)
    assert gfa1.count("\nS\t") + gfa1.startswith("S\t") >= 1
    assert _stage_chain_gfa(4) == gfa1
