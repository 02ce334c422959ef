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
    """K3 bit-exact at one lane a thread (W 256) and at two (W > 1024)."""
    require_cuda()
    from jtk_tpu_torch.ops import edit_dp as k3
    args = _k3_inputs(np.random.default_rng(3 + W), B=B, clen=clen, W=W)
    n0 = k3.LAUNCHES.count
    got = k3.edit_dp(*args)
    assert k3.LAUNCHES.count == n0 + 1
    want = k3.edit_dp_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("W,B,spread", [
    (128, 24, False), (160, 24, False), (256, 23, False), (512, 22, False),
    (1000, 6, False), (1152, 6, False), (128, 23, True), (1152, 5, True)],
    ids=["W128", "W160", "W256-B23", "W512", "W1000", "W1152",
         "W128-qlen-spread-B23", "W1152-qlen-spread"])
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
    (1152, 5, False), (128, 8, True)],
    ids=["W64", "W128", "W130-masked", "W256", "W1152", "W128-N"])
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


@pytest.mark.parametrize("W", [130, 256, 1152])
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
