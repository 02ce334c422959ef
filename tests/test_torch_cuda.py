"""The CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU and the CUDA toolkit and skip elsewhere.
They import only the port, so they run on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from torch_util import require_cuda

pytestmark = pytest.mark.cuda


def _k3_inputs(rng, B=48, clen=700, W=256, margin=120):
    from jtk_tpu_torch.io import sim
    from jtk_tpu_torch.ops import edit_dp as k3
    from jtk_tpu_torch.ops.banded_align import diagonal_offsets
    Q = max(768, (clen + 127) // 64 * 64)
    T = clen + 2 * margin + 64
    qs = np.full((B, Q), 4, np.int8)
    rs = np.full((B, T), 4, np.int8)
    q_lens = np.zeros(B, np.int64)
    t_lens = np.zeros(B, np.int64)
    offs = np.zeros((B, Q + 1), np.int64)
    for b in range(B):
        L = clen - int(rng.integers(0, 60))
        c = sim.random_genome(rng, L)
        win = np.concatenate([sim.random_genome(rng, margin),
                              sim.noisy_read(rng, c, 0.06),
                              sim.random_genome(rng, margin)])[:T]
        qs[b, :L], rs[b, :len(win)] = c, win
        q_lens[b], t_lens[b] = L, len(win)
        offs[b] = diagonal_offsets(L, margin, len(win), Q, W)
    dev = torch.device("cuda")

    def t(x, dt):
        return torch.as_tensor(x, dtype=dt, device=dev)

    tl = t(t_lens, torch.int64)
    args = k3.k3_inputs(t(qs, torch.int32), t(rs, torch.int32),
                        t(offs, torch.int64), tl, W, "infix")
    return args + (t(q_lens, torch.int32), tl.to(torch.int32))


@pytest.mark.parametrize("W,B,clen", [(256, 48, 700), (1152, 6, 1300),
                                      (1500, 4, 1650), (2048, 4, 2300)],
                         ids=["W256", "W1152-2-lanes", "W1500-2-lanes-masked",
                              "W2048-2-lanes"])
def test_edit_dp_kernel_matches_plain(W, B, clen):
    """K3 bit-exact on each pair's stream rows below its q_len (the kernel
    writes no others) and on the last row, in the warp form: two warps a
    pair at W 256, nine at 1152, twelve at 1500 (lanes past W), sixteen at
    2048.  (The block form, above 2048, is held in chip_smoke.py.)"""
    require_cuda()
    from jtk_tpu_torch.ops import edit_dp as k3
    args = _k3_inputs(np.random.default_rng(3 + W), B=B, clen=clen, W=W)
    n0 = k3.LAUNCHES.count
    got = k3.edit_dp(*args)
    assert k3.LAUNCHES.count == n0 + 1
    want = k3.edit_dp_plain(*args)
    assert _rows_equal(got[0], want[0], args[6]) and torch.equal(got[1],
                                                                  want[1])


def _rows_equal(got, want, qlen):
    """Streams equal on each pair's rows below its q_len."""
    rows = torch.arange(got.shape[0], device=got.device)[:, None, None] \
        < qlen[None, :, None]
    return torch.equal(torch.where(rows, got, 0), torch.where(rows, want, 0))


@pytest.mark.parametrize("W,B,clen", [(64, 40, 600), (128, 37, 700),
                                      (256, 23, 900), (512, 9, 1100),
                                      (1152, 5, 1300)],
                         ids=["W64", "W128", "W256", "W512", "W1152"])
def test_edit_dp_and_walk_kernels_match_plain(W, B, clen):
    """The DP kernel and the walk kernel against their plain versions on
    the same inputs: the stream on rows below q_len, the last row, and
    the walk's deletions, ops and starts (B not a multiple of the pairs a
    block holds; one pair of q_len 0)."""
    require_cuda()
    from jtk_tpu_torch.ops import edit_dp as k3
    args = list(_k3_inputs(np.random.default_rng(11 + W), B=B, clen=clen,
                           W=W))
    args[6][0] = 0
    qlen, tlen = args[6], args[7]
    packed, last = k3.edit_dp(*args)
    want, want_last = k3.edit_dp_plain(*args)
    assert _rows_equal(packed, want, qlen) and torch.equal(last, want_last)
    Q = packed.shape[0]
    off = torch.cat([args[5][:, :1].long(), args[5][:, :1].long()
                     + torch.cumsum(args[2].long(), 1)], 1)
    _score, end = k3.select_end(last, off, qlen.long(), tlen.long(), W,
                                "infix")
    n0 = k3.TB_LAUNCHES.count
    got = k3.traceback_packed(packed, off, qlen, end, W)
    assert k3.TB_LAUNCHES.count == n0 + 1
    ref = k3.traceback_packed_plain(packed, off, qlen, end, W)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    assert got[1].shape == (B, Q) and int((got[1] > 0).sum()) == \
        int(qlen.sum())


@pytest.mark.parametrize("W,B,spread", [
    (128, 24, False), (160, 24, False), (256, 23, False), (512, 22, False),
    (1000, 6, False), (1152, 6, False), (128, 23, True), (1152, 5, True),
    (2176, 3, False), (4096, 2, True)],
    ids=["W128", "W160", "W256-B23", "W512", "W1000", "W1152",
         "W128-qlen-spread-B23", "W1152-qlen-spread", "W2176-wide",
         "W4096-wide-qlen-spread"])
def test_table_kernels_match_plain(W, B, spread):
    """Both table kernels against their plain versions at every geometry
    the band widths of the pipeline reach (W 128: one warp a pair; 160 and
    256: two; 512: four; 1000: eight, with masked lanes; 1152: sixteen).
    ``spread`` draws each pair's length from Q/2 to Q (the early stop at
    q_len and the frozen rows after it); B 22 and 23 are not multiples of
    the pairs a block holds (4 at one warp a pair, 2 at two)."""
    require_cuda()
    from jtk_tpu_torch.io import sim
    from jtk_tpu_torch.ops import phmm_tables as pt
    from jtk_tpu_torch.ops.banded_align import linear_offsets
    from jtk_tpu_torch.ops.phmm import PHMMParams
    rng = np.random.default_rng(W + B)
    T = max(600, W + 200)
    Q = ((T + 40 + 63) // 64) * 64
    tpl = np.full((B, T), 4, np.int8)
    qs = np.full((B, Q), 4, np.int8)
    q_lens = np.zeros(B, np.int64)
    t_lens = np.zeros(B, np.int64)
    offs = np.zeros((B, Q + 1), np.int64)
    for b in range(B):
        n = int(rng.integers(Q // 2, T)) if spread else \
            T - int(rng.integers(0, 30))
        t = sim.random_genome(rng, n)
        r = sim.noisy_read(rng, t, 0.05)[:Q]
        tpl[b, :len(t)], qs[b, :len(r)] = t, r
        q_lens[b], t_lens[b] = len(r), len(t)
        offs[b] = linear_offsets(len(r), len(t), Q, W)
    par = PHMMParams.default("cuda")
    rev = PHMMParams(par.trans * 0.98 + 0.0066, par.mat_emit, par.ins_emit)
    prep = pt.prep_tables_inputs(qs, tpl, offs, q_lens, t_lens, par, W,
                                 strands=rng.random(B) < 0.5,
                                 params_rev=rev, device="cuda")
    fwd_args, bwd_args, _aux = pt.kernel_inputs(prep, W)
    for kern, plain, args, counter in (
            (pt.fwd_tables, pt.fwd_tables_plain, fwd_args, pt.FWD_LAUNCHES),
            (pt.bwd_tables, pt.bwd_tables_plain, bwd_args, pt.BWD_LAUNCHES)):
        n0 = counter.count
        got, want = kern(*args), plain(*args)
        assert counter.count == n0 + 1
        for g, w in zip(got[:3], want[:3]):
            torch.testing.assert_close(g, w, rtol=2e-3, atol=1e-5)
        torch.testing.assert_close(torch.cumsum(got[3], 1),
                                   torch.cumsum(want[3], 1), rtol=1e-4,
                                   atol=2e-2)


def test_wrapper_raises_on_bad_input():
    require_cuda()
    from jtk_tpu_torch.ops import edit_dp as k3
    args = list(_k3_inputs(np.random.default_rng(4), B=4))
    args[1] = args[1].to(torch.int64)
    with pytest.raises(ValueError):
        k3.edit_dp(*args)


def _pileup_cuda(rng, B=16, tlen=600, W=128):
    from jtk_tpu_torch.io import sim
    from jtk_tpu_torch.ops.banded_align import linear_offsets
    from jtk_tpu_torch.ops.polish import effective_band
    tpl = sim.random_genome(rng, tlen)
    reads = [sim.noisy_read(rng, tpl, 0.06) for _ in range(B)]
    q_lens = np.array([len(r) for r in reads], np.int64)
    W = effective_band(W, q_lens, tlen)
    Q = ((int(q_lens.max()) + 63) // 64) * 64
    qs = np.full((B, Q), 4, np.int8)
    for b, r in enumerate(reads):
        qs[b, :len(r)] = r
    offs = np.stack([linear_offsets(int(n), tlen, Q, W) for n in q_lens])
    return tpl, qs, offs, q_lens, W


def _pairs_cuda(rng, B, W, with_n=False):
    """B reads against their own templates, band exactly W (as the gain
    calibration launches K1l at W 64): qs, templates, offsets, lengths."""
    from jtk_tpu_torch.io import sim
    from jtk_tpu_torch.ops.banded_align import linear_offsets
    T = max(200, W + 100)
    Q = ((T + 40 + 63) // 64) * 64
    qs = np.full((B, Q), 4, np.int8)
    rs = np.full((B, T), 4, np.int8)
    q_lens = np.zeros(B, np.int64)
    t_lens = np.zeros(B, np.int64)
    offs = np.zeros((B, Q + 1), np.int64)
    for b in range(B):
        t = sim.random_genome(rng, T - int(rng.integers(0, 20)))
        r = sim.noisy_read(rng, t, 0.05)[:Q]
        rs[b, :len(t)], qs[b, :len(r)] = t, r
        q_lens[b], t_lens[b] = len(r), len(t)
        offs[b] = linear_offsets(len(r), len(t), Q, W)
    if with_n:
        qs[1, 30] = 4   # an in-read N emits with probability 0
    return qs, rs, offs, q_lens, t_lens


@pytest.mark.parametrize("W,B,with_n", [
    (64, 24, False), (128, 13, False), (130, 6, False), (256, 9, False),
    (1152, 5, False), (128, 8, True), (2176, 3, False), (4096, 2, False)],
    ids=["W64", "W128", "W130-masked", "W256", "W1152", "W128-N",
         "W2176-wide", "W4096-wide"])
def test_lk_kernel_matches_plain(W, B, with_n):
    """K1l at one warp a pair with 2 and 4 lanes a thread (W 64, 128; four
    and three pairs a block), two warps (W 130, most lanes of the second
    masked; 256), sixteen (1152), and a read with an N."""
    require_cuda()
    from jtk_tpu_torch.ops import phmm_lk as k1l
    from jtk_tpu_torch.ops.phmm import PHMMParams
    qs, rs, offs, q_lens, t_lens = _pairs_cuda(np.random.default_rng(5 + W),
                                               B, W, with_n)
    args = k1l.lk_inputs(qs, rs, offs, q_lens, t_lens, W, device="cuda")
    tabs = k1l.tables8(PHMMParams.default("cuda"), "cuda")
    n0 = k1l.LAUNCHES.count
    got = k1l.phmm_lk(*args, *tabs)
    assert k1l.LAUNCHES.count == n0 + 1
    want = k1l.phmm_lk_plain(*args, *tabs)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-2)
    if with_n:
        assert float(got[1]) < float(got[0]) - 1000


@pytest.mark.parametrize("W", [130, 256, 1152, 2176, 4096])
def test_counts_kernel_wide_band_matches_plain_bitwise_repeatable(W):
    """The counts kernel at two and nine band chunks a row (W 130: rows of
    a width that is not a multiple of 4, so 4-byte loads), against its
    plain version, and the same bits from two calls."""
    require_cuda()
    from jtk_tpu_torch.ops import phmm_grad as pg
    from jtk_tpu_torch.ops.phmm import PHMMParams
    qs, rs, offs, q_lens, t_lens = _pairs_cuda(np.random.default_rng(W), 6,
                                               W)
    batch = pg.PairBatch(qs, rs, offs, q_lens, t_lens, W, device="cuda")
    args = pg.counts_args(pg.counts_prep(PHMMParams.default("cuda"), batch),
                          W)
    got = pg.phmm_counts(*args)
    assert torch.equal(got, pg.phmm_counts(*args))
    torch.testing.assert_close(got, pg.phmm_counts_plain(*args), rtol=1e-3,
                               atol=1e-4)


def test_counts_kernel_matches_plain_and_gradient_matches_autograd():
    require_cuda()
    from jtk_tpu_torch.ops import phmm_grad as pg
    from jtk_tpu_torch.ops import phmm_lk as k1l
    from jtk_tpu_torch.ops.phmm import PHMMParams
    from jtk_tpu_torch.parallel import params_to_theta, theta_to_params
    tpl, qs, offs, q_lens, W = _pileup_cuda(np.random.default_rng(6))
    batch = pg.PairBatch(qs, tpl, offs, q_lens, len(tpl), W, device="cuda")
    params = PHMMParams.default("cuda")
    args = pg.counts_args(pg.counts_prep(params, batch), W)
    n0 = pg.LAUNCHES.count
    got = pg.phmm_counts(*args)
    assert pg.LAUNCHES.count == n0 + 1
    torch.testing.assert_close(got, pg.phmm_counts_plain(*args), rtol=1e-3,
                               atol=1e-4)
    grads = []
    for kernel in (True, False):
        th = {k: v.clone().requires_grad_(True)
              for k, v in params_to_theta(params).items()}
        p = theta_to_params(th)
        lk = pg.pair_likelihood(p, batch) if kernel else \
            k1l.phmm_lk_plain(*batch.lk_args, *k1l.tables8(p, "cuda"))
        (-lk.sum()).backward()
        grads.append([th[k].grad / float(q_lens.sum()) for k in th])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)


def _table_inputs_cuda(rng, B, W, spread=False):
    from jtk_tpu_torch.io import sim
    from jtk_tpu_torch.ops import phmm_tables as pt
    from jtk_tpu_torch.ops.banded_align import linear_offsets
    from jtk_tpu_torch.ops.phmm import PHMMParams
    T = max(600, W + 200)
    Q = ((T + 40 + 63) // 64) * 64
    tpl = np.full((B, T), 4, np.int8)
    qs = np.full((B, Q), 4, np.int8)
    q_lens = np.zeros(B, np.int64)
    t_lens = np.zeros(B, np.int64)
    offs = np.zeros((B, Q + 1), np.int64)
    for b in range(B):
        n = int(rng.integers(Q // 2, T)) if spread else \
            T - int(rng.integers(0, 30))
        t = sim.random_genome(rng, n)
        r = sim.noisy_read(rng, t, 0.05)[:Q]
        tpl[b, :len(t)], qs[b, :len(r)] = t, r
        q_lens[b], t_lens[b] = len(r), len(t)
        offs[b] = linear_offsets(len(r), len(t), Q, W)
    return pt.prep_tables_inputs(qs, tpl, offs, q_lens, t_lens,
                                 PHMMParams.default("cuda"), W,
                                 device="cuda")


@pytest.mark.parametrize("W,B", [(128, 9), (256, 5), (1000, 3), (1152, 3),
                                 (2176, 2), (4096, 2)])
def test_float64_table_kernels_match_plain(W, B):
    """The gradient's float64 tables, forward and backward, against their
    plain versions in float64: the register form up to 1024 lanes, the
    wide form (8 lanes a thread to 2048, 16 to 4096) above."""
    require_cuda()
    from jtk_tpu_torch.ops import phmm_tables as pt
    prep = _table_inputs_cuda(np.random.default_rng(W + 7), B, W)
    fwd_args, bwd_args, _aux = pt.kernel_inputs(prep, W, torch.float64)
    for kern, plain, args in ((pt.fwd_tables, pt.fwd_tables_plain, fwd_args),
                              (pt.bwd_tables, pt.bwd_tables_plain, bwd_args)):
        got, want = kern(*args), plain(*args)
        assert all(g.dtype == torch.float64 for g in got)
        for g, w in zip(got[:3], want[:3]):
            torch.testing.assert_close(g, w, rtol=2e-3, atol=1e-5)
        torch.testing.assert_close(torch.cumsum(got[3], 1),
                                   torch.cumsum(want[3], 1), rtol=1e-4,
                                   atol=2e-2)


def test_counts_of_a_read_40_bases_late():
    """A read that starts 40 bases late: the kernel's counts, from the
    float64 tables, against the plain version, and its M + I emissions sum
    to its length (in float32 tables they were off by ~1e13)."""
    require_cuda()
    from jtk_tpu_torch.io import sim
    from jtk_tpu_torch.ops import phmm_grad as pg
    from jtk_tpu_torch.ops.banded_align import linear_offsets
    from jtk_tpu_torch.ops.phmm import PHMMParams
    from jtk_tpu_torch.ops.polish import effective_band
    rng = np.random.default_rng(0)
    tlen = 300
    tpl = sim.random_genome(rng, tlen)
    reads = [sim.noisy_read(rng, tpl, 0.05)[:tlen + 16] for _ in range(6)]
    reads[0] = reads[0][40:]
    q_lens = np.array([len(r) for r in reads], np.int64)
    W = effective_band(64, q_lens, tlen)
    Q = ((int(q_lens.max()) + 63) // 64) * 64
    qs = np.full((len(reads), Q), 4, np.int8)
    for b, r in enumerate(reads):
        qs[b, :len(r)] = r
    offs = np.stack([linear_offsets(int(n), tlen, Q, W) for n in q_lens])
    batch = pg.PairBatch(qs, tpl, offs, q_lens, tlen, W, device="cuda")
    args = pg.counts_args(pg.counts_prep(PHMMParams.default("cuda"), batch),
                          W)
    got = pg.phmm_counts(*args)
    torch.testing.assert_close(got, pg.phmm_counts_plain(*args), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(got[:, 9:].sum(1).cpu().numpy(), q_lens,
                               rtol=1e-4)


def _chain_case(rng, B, S, K, V, Rmax):
    """Planted clusters for B chunks, the chain's start on the card, its
    inputs and a generator for its draws."""
    from jtk_tpu_torch.ops import cluster as pcl
    dev = torch.device("cuda")
    X = np.zeros((B, Rmax, V), np.float32)
    Rs = np.zeros(B, np.int64)
    for b in range(B):
        R = Rmax - int(rng.integers(0, 8))
        truth = rng.integers(0, K, R)
        x = rng.normal(0, 0.6, (R, V))
        for c in range(K):
            cols = np.arange(V) % K == c
            x[np.ix_(truth == c, cols)] += 2.0
            x[np.ix_(truth != c, cols)] -= 1.0
        X[b, :R] = x
        Rs[b] = R
    size_lk = np.stack([pcl.poisson_size_table(Rmax, Rmax / K, K)] * B)
    Xt = torch.tensor(X, device=dev)
    Rt = torch.tensor(Rs, device=dev)
    slt = torch.tensor(size_lk, device=dev)
    w = (torch.arange(Rmax, device=dev)[None] < Rt[:, None]).float()
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 30)))
    g0 = pcl._gumbel((B, S, K, Rmax), gen, dev)
    return Xt, Rt, slt, pcl.chain_start(Xt, w, slt, K, g0), gen


@pytest.mark.parametrize("B,S,K,V,Rmax", [(27, 20, 2, 8, 128),
                                          (1, 20, 4, 12, 64),
                                          (3, 4, 8, 40, 96)],
                         ids=["path-b", "K4-V12", "K8-V40-column-groups"])
def test_chain_kernel_matches_plain_bitwise(B, S, K, V, Rmax):
    """The chain kernel against mcmc_chain_plain on the card, from the same
    start and the same draws, over four draw blocks: every state tensor
    (assignments, aggregates, sizes, lk, best lk and best assignment) is
    the same bits after each block.  Path (b)'s shape (K 2 at compile
    time), a run-time K, and V over 32 (two column groups)."""
    require_cuda()
    from jtk_tpu_torch.ops import cluster as pcl
    X, Rt, size_lk, st, gen = _chain_case(np.random.default_rng(K * V), B,
                                          S, K, V, Rmax)
    plain = {k: v.clone() for k, v in st.items()}
    for _block in range(4):
        draws = pcl.block_draws(*pcl.generator_block(
            gen, (pcl.DRAW_BLOCK, B, S), K, X.device), Rt, Rmax)
        n0 = pcl.CHAIN_LAUNCHES.count
        pcl.mcmc_chain(st, X, size_lk, *draws)
        assert pcl.CHAIN_LAUNCHES.count == n0 + 1
        pcl.mcmc_chain_plain(plain, X, size_lk, *draws)
        for name, v in plain.items():
            assert torch.equal(st[name], v), name
    assert (st["best_lk"] >= st["lk"]).all()


@pytest.mark.parametrize("B,S,K,V,Rmax,general", [
    (414, 20, 2, 8, 128, False), (27, 20, 2, 8, 128, True)],
    ids=["scale-414-chunks", "path-b-general-form"])
def test_chain_kernel_forms_match_plain_bitwise(B, S, K, V, Rmax, general):
    """The chain at a 1 Mb run's 414 chunks (the register form), and the
    general form at path (b)'s K 2 (forced), against mcmc_chain_plain over
    two draw blocks: every state tensor the same bits after each."""
    require_cuda()
    from jtk_tpu_torch.ops import cluster as pcl
    X, Rt, size_lk, st, gen = _chain_case(np.random.default_rng(B + K), B,
                                          S, K, V, Rmax)
    plain = {k: v.clone() for k, v in st.items()}
    for _block in range(2):
        draws = pcl.block_draws(*pcl.generator_block(
            gen, (pcl.DRAW_BLOCK, B, S), K, X.device), Rt, Rmax)
        pcl.mcmc_chain(st, X, size_lk, *draws, general=general)
        pcl.mcmc_chain_plain(plain, X, size_lk, *draws)
        for name, v in plain.items():
            assert torch.equal(st[name], v), name


def _beyond_pairs_cuda(rng, W, B=2, qlen=300):
    """B reads of ~``qlen`` bases from the two ends of a template W + 200
    long, in a band of W: a short read against a long template, the
    layout past the K1 family's old limit of 4096."""
    from jtk_tpu_torch.io import sim
    from jtk_tpu_torch.ops.banded_align import linear_offsets
    tlen = W + 200
    tpl = sim.random_genome(rng, tlen)
    reads = [sim.noisy_read(rng, tpl[s:s + qlen], 0.05)
             for s in ((0, tlen - qlen) * B)[:B]]
    q_lens = np.array([len(r) for r in reads], np.int64)
    Q = ((int(q_lens.max()) + 63) // 64) * 64
    qs = np.full((B, Q), 4, np.int8)
    for b, r in enumerate(reads):
        qs[b, :len(r)] = r
    offs = np.stack([linear_offsets(int(n), tlen, Q, W) for n in q_lens])
    return tpl, qs, offs, q_lens


@pytest.mark.parametrize("W", [4224, 8192])
def test_k1_family_beyond_old_limit_matches_plain(W):
    """K1f and K1b (float32 and float64), K1l and counts past the old limit
    of 4096 (the scratch form) against their plain versions: tables rtol
    2e-3 / atol 1e-5, cumulative log scales and lk rtol 1e-4 / atol 2e-2,
    counts rtol 1e-3 / atol 1e-4 and the same bits from two calls."""
    require_cuda()
    from jtk_tpu_torch.ops import phmm_grad as pg
    from jtk_tpu_torch.ops import phmm_lk as k1l
    from jtk_tpu_torch.ops import phmm_tables as pt
    from jtk_tpu_torch.ops.phmm import PHMMParams
    tpl, qs, offs, q_lens = _beyond_pairs_cuda(np.random.default_rng(W), W)
    tlen = len(tpl)
    params = PHMMParams.default("cuda")
    prep = pt.prep_tables_inputs(qs, tpl, offs, q_lens, tlen, params, W,
                                 device="cuda")
    for dtype in (torch.float32, torch.float64):
        fwd_args, bwd_args, _aux = pt.kernel_inputs(prep, W, dtype)
        for kern, plain, args in (
                (pt.fwd_tables, pt.fwd_tables_plain, fwd_args),
                (pt.bwd_tables, pt.bwd_tables_plain, bwd_args)):
            got, want = kern(*args), plain(*args)
            assert all(g.dtype == dtype for g in got)
            for g, w in zip(got[:3], want[:3]):
                torch.testing.assert_close(g, w, rtol=2e-3, atol=1e-5)
            torch.testing.assert_close(torch.cumsum(got[3], 1),
                                       torch.cumsum(want[3], 1), rtol=1e-4,
                                       atol=2e-2)
    args = k1l.lk_inputs(qs, tpl, offs, q_lens, tlen, W, device="cuda")
    tabs = k1l.tables8(params, "cuda")
    torch.testing.assert_close(k1l.phmm_lk(*args, *tabs),
                               k1l.phmm_lk_plain(*args, *tabs), rtol=1e-4,
                               atol=2e-2)
    batch = pg.PairBatch(qs, tpl, offs, q_lens, tlen, W, device="cuda")
    cargs = pg.counts_args(pg.counts_prep(params, batch), W)
    got = pg.phmm_counts(*cargs)
    assert torch.equal(got, pg.phmm_counts(*cargs))
    torch.testing.assert_close(got, pg.phmm_counts_plain(*cargs), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("W", [8320, 16384])
def test_edit_dp_and_walk_beyond_old_limit_match_plain(W):
    """K3 and its walk past the old limit of 8192 (the scratch form, int32
    cells; its state in shared memory at 8320, in device memory at 16 384)
    against their plain versions, bit-exact, on one ~W-long chunk in a read
    window (a consensus tile's layout)."""
    require_cuda()
    from jtk_tpu_torch.ops import edit_dp as k3
    args = _k3_inputs(np.random.default_rng(W), B=1, clen=W + 100, W=W,
                      margin=300)
    qlen, tlen = args[6], args[7]
    packed, last = k3.edit_dp(*args)
    want, want_last = k3.edit_dp_plain(*args)
    assert packed.dtype == torch.int32
    assert _rows_equal(packed, want, qlen) and torch.equal(last, want_last)
    off = torch.cat([args[5][:, :1].long(), args[5][:, :1].long()
                     + torch.cumsum(args[2].long(), 1)], 1)
    _score, end = k3.select_end(last, off, qlen.long(), tlen.long(), W,
                                "infix")
    got = k3.traceback_packed(packed, off, qlen, end, W)
    ref = k3.traceback_packed_plain(packed, off, qlen, end, W)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


def test_walk_with_a_left_run_past_8192_matches_plain():
    """A query against a reference with an 8.3 kb insertion (global, W
    8448): the DP kernel's int32 cells hold the left run of ~8300 lanes,
    and the walk kernel takes it as one deletion run, as the plain
    versions do."""
    require_cuda()
    from jtk_tpu_torch.ops import edit_dp as k3
    from jtk_tpu_torch.ops.banded_align import linear_offsets
    rng = np.random.default_rng(29)
    Q, ins, W = 150, 8300, 8448
    q = rng.integers(0, 2, Q)
    r = np.concatenate([q[:75], rng.integers(2, 4, ins), q[75:]])
    T = len(r)
    dev = torch.device("cuda")
    off = torch.as_tensor(linear_offsets(Q, T, Q, W)[None], device=dev)
    ql = torch.tensor([Q], dtype=torch.int32, device=dev)
    tl = torch.tensor([T], dtype=torch.int32, device=dev)
    args = k3.k3_inputs(torch.as_tensor(q[None], device=dev),
                        torch.as_tensor(r[None], device=dev), off, tl.long(),
                        W, "global")
    packed, last = k3.edit_dp(*args, ql, tl)
    want, want_last = k3.edit_dp_plain(*args, ql, tl)
    assert _rows_equal(packed, want, ql) and torch.equal(last, want_last)
    _score, end = k3.select_end(last, off, ql.long(), tl.long(), W, "global")
    got = k3.traceback_packed(packed, off, ql, end, W)
    ref = k3.traceback_packed_plain(packed, off, ql, end, W)
    for g, w in zip(got, ref):
        assert torch.equal(g, w)
    assert int(got[0].max()) >= 8192


@pytest.mark.parametrize("B,W", [(600, 256), (800, 640)],
                         ids=["mapper-like-W256", "W640-many-pairs"])
def test_walk_windows_match_plain(B, W):
    """With many pairs an SM the walk copies a window of each row around
    its column and reads a cell outside it from device memory: bit-exact
    against the plain walk (including pairs of q_len 0 and pairs whose
    walk leaves the window on long deletions)."""
    require_cuda()
    from jtk_tpu_torch.ops import edit_dp as k3
    args = list(_k3_inputs(np.random.default_rng(B + W), B=B, clen=600,
                           W=W, margin=150))
    args[6][:3] = 0
    qlen, tlen = args[6], args[7]
    packed, last = k3.edit_dp(*args)
    off = torch.cat([args[5][:, :1].long(), args[5][:, :1].long()
                     + torch.cumsum(args[2].long(), 1)], 1)
    _score, end = k3.select_end(last, off, qlen.long(), tlen.long(), W,
                                "infix")
    got = k3.traceback_packed(packed, off, qlen, end, W)
    ref = k3.traceback_packed_plain(packed, off, qlen, end, W)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_edit_dp_and_walk_at_w32768_read_device_memory():
    """At W 32 768 a stream row of int32 cells takes 128 KB, more than half
    of a block's shared memory: K3's scratch form keeps its state in device
    memory and the walk reads its cells from device memory, with no ring.
    Both bit-exact against their plain versions (random pairs, infix)."""
    require_cuda()
    from jtk_tpu_torch.ops import edit_dp as k3
    B, Q, W = 2, 600, 32768
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    T = Q + W
    q = torch.randint(0, 4, (B, Q), generator=g, device=dev)
    r = torch.randint(0, 4, (B, T), generator=g, device=dev)
    ii = torch.arange(Q + 1, device=dev)
    off = (ii - W // 4).clamp(0, T - W + 1)[None].expand(B, Q + 1) \
        .contiguous()
    tl = torch.full((B,), T, dtype=torch.int64, device=dev)
    qlen = torch.full((B,), Q, dtype=torch.int32, device=dev)
    args = k3.k3_inputs(q, r, off, tl, W, "infix") + (qlen,
                                                       tl.to(torch.int32))
    packed, last = k3.edit_dp(*args)
    want, want_last = k3.edit_dp_plain(*args)
    assert _rows_equal(packed, want, qlen) and torch.equal(last, want_last)
    _score, end = k3.select_end(last, off, qlen.long(), tl, W, "infix")
    got = k3.traceback_packed(packed, off, qlen, end, W)
    ref = k3.traceback_packed_plain(packed, off, qlen, end, W)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the device set: the card listed four times, and every card of the host
# ---------------------------------------------------------------------------


def _sharded(what):
    """(function of (n_dev, dev), prepare(monkeypatch)) of
    tests/test_torch_parallel.py's sharded paths."""
    import test_torch_parallel as tp
    from jtk_tpu_torch.ops import modtable as pmod

    def modtable(monkeypatch):   # four slices of 16 pairs
        monkeypatch.setattr(pmod, "MAXB", 16)

    def masked(n_dev, dev):
        return tp._masked(n_dev, dev, k=9, freq=0.01, min_count=3)

    return {"train": (tp._train, None),
            "pileup_lk": (lambda n, dev: tp._pileup_lk(n, dev=dev), None),
            "modtable": (tp._modtables, modtable),
            "extend": (tp._extend, None),
            "mask_repeats": (masked, None)}[what]


SHARDED = ["train", "pileup_lk", "modtable", "extend", "mask_repeats"]


@pytest.mark.parametrize("what", SHARDED)
def test_card_listed_four_times_matches_one_card(what, monkeypatch):
    """Every split, per-shard launch and merge of a sharded path, on one
    card: the same bits as the card alone."""
    require_cuda()
    import test_torch_parallel as tp
    fn, prepare = _sharded(what)
    if prepare:
        prepare(monkeypatch)
    tp._equal(fn(4, "cuda"), fn(1, "cuda"))


@pytest.mark.parametrize("what", SHARDED)
def test_every_card_matches_one_card(what, monkeypatch):
    require_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices: this host has "
                    f"{torch.cuda.device_count()}")
    import test_torch_parallel as tp
    from jtk_tpu_torch.runtime import use_devices
    fn, prepare = _sharded(what)
    if prepare:
        prepare(monkeypatch)
    want = fn(1, "cuda")
    cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    monkeypatch.setattr(tp, "_on", lambda n, dev: use_devices(cards))
    tp._equal(fn(len(cards), "cuda"), want)


class _FakeLibrary:
    """Stands for a kernel library: records the current device and the
    stream each entry point is called with."""

    def __init__(self, seen):
        self.seen = seen

    def __getattr__(self, name):
        def entry(*args):   # the stream pointer; 0, the default stream
            self.seen.append((torch.cuda.current_device(),
                              args[-1].value or 0))
            return 0
        return entry


def test_launch_uses_its_tensors_stream_and_refuses_two_devices(monkeypatch):
    require_cuda()
    from jtk_tpu_torch.ops import cuda_build
    seen = []
    monkeypatch.setattr(cuda_build, "library",
                        lambda name: _FakeLibrary(seen))
    x = torch.zeros(4, device="cuda")
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        cuda_build.launch("lib", "entry", x, 3)
    assert seen[-1] == (x.device.index, side.cuda_stream)
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_build.launch("lib", "entry", x, torch.zeros(2))
    with pytest.raises(ValueError, match="expected a tensor on"):
        cuda_build.check(x, torch.float32, (4,), "x",
                         device=torch.device("cuda", x.device.index + 1))


def test_kernel_on_a_side_stream_matches_plain():
    require_cuda()
    from jtk_tpu_torch.ops import phmm_grad as pg
    from jtk_tpu_torch.ops import phmm_lk as k1l
    from jtk_tpu_torch.ops.phmm import PHMMParams
    tpl, qs, offs, q_lens, W = _pileup_cuda(np.random.default_rng(12))
    batch = pg.PairBatch(qs, tpl, offs, q_lens, len(tpl), W, device="cuda")
    params = PHMMParams.default("cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = pg.pair_lk(params, batch)
    torch.cuda.current_stream().wait_stream(side)
    want = k1l.phmm_lk_plain(*batch.lk_args, *k1l.tables8(params, "cuda"))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-2)


def test_launch_on_a_second_card(monkeypatch):
    require_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices: this host has "
                    f"{torch.cuda.device_count()}")
    from jtk_tpu_torch.ops import cuda_build
    seen = []
    monkeypatch.setattr(cuda_build, "library",
                        lambda name: _FakeLibrary(seen))
    torch.cuda.set_device(0)
    y = torch.zeros(4, device="cuda:1")
    cuda_build.launch("lib", "entry", y)
    assert seen[-1] == (1, torch.cuda.current_stream(1).cuda_stream)
    assert torch.cuda.current_device() == 0
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_build.launch("lib", "entry", y, torch.zeros(4, device="cuda:0"))
