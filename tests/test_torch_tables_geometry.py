"""Launch geometry of the K1 table kernels, and the port's tables against
the JAX package at a band wider than 1024 (through the plain versions,
at tests/test_pallas_phmm.py's tolerances: tables rtol 2e-3 / atol 1e-5,
cumulative log scales rtol 1e-4 / atol 2e-2, lk atol 2e-2)."""

import os
import re

import numpy as np
import pytest
import torch

from jtk_tpu.datamodel import HMMParam
from jtk_tpu.io import sim
from jtk_tpu.ops import phmm as jphmm
from jtk_tpu.ops.banded_align import linear_offsets
from jtk_tpu.ops.polish import effective_band
from jtk_tpu_torch.ops import phmm as pphmm
from jtk_tpu_torch.ops import phmm_tables as pt
from torch_util import port_on_cpu  # noqa: F401

CU = os.path.join(os.path.dirname(pt.__file__), os.pardir, "csrc",
                  "phmm_tables.cu")


def _built_geometries(dtype=torch.float32):
    """(lanes, warps) pairs the CUDA source instantiates for ``dtype``."""
    with open(CU) as f:
        src = f.read()
    name = "F64" if dtype == torch.float64 else "F32"
    body = re.search(rf"#define TABLE_GEOMETRIES_{name}\(X\)(.*?)\n\n", src,
                     re.S).group(1)
    return {(int(a), int(b)) for a, b in
            re.findall(r"X\((\d+), (\d+)\)", body)}


@pytest.mark.parametrize("W", [1, 31, 32, 128, 160, 512, 1024, 1152, 2048,
                               2049, 2176, 4096, 4097, 8192, 65536])
def test_tables_geometry_covers_band(W):
    lanes, warps, pairs = pt.tables_geometry(W)
    assert 32 * lanes * warps >= W
    if W > pt.SHARED_FORM_W:
        # the scratch form: one block of SCRATCH_THREADS threads a pair
        assert (32 * warps, pairs) == (pt.SCRATCH_THREADS, 1)
        assert lanes == -(-W // pt.SCRATCH_THREADS)
        return
    assert (lanes, warps) in _built_geometries()
    if W > pt.register_form_w():
        # the wide form: the state in shared memory, one pair a block
        assert (warps, pairs) == (pt.WIDE_WARPS, 1)
        assert lanes > pt.MAX_LANES and 16 * lanes * warps < W
        return
    # no more threads than the band needs: half of them would not cover it
    assert lanes == 1 and warps == 1 or 16 * lanes * warps < W
    # the register budget: a thread keeps at most MAX_LANES lanes of each
    # table (chip_smoke.py fails on a ptxas spill of any built geometry)
    assert lanes <= pt.MAX_LANES
    # a block holds 4 warps, or one pair of more
    assert pairs >= 1 and warps * pairs == max(4, warps)


@pytest.mark.parametrize("W", [1, 128, 256, 1024, 1025, 2048, 2049, 4096,
                               4097, 65536])
def test_float64_tables_geometry_is_built(W):
    """The gradient's float64 tables: the register form up to 1024 lanes
    (at most 8 warps, so 256 threads a block), the wide form up to 4096,
    the scratch form above (as in float32)."""
    lanes, warps, pairs = pt.tables_geometry(W, dtype=torch.float64)
    assert 32 * lanes * warps >= W
    if W > pt.SHARED_FORM_W:
        assert (lanes, warps, pairs) == pt.tables_geometry(W)
        lanes = -(-W // pt.SCRATCH_THREADS) * pt.SCRATCH_THREADS
        assert pt.scratch_bytes(W, torch.float64) == lanes * 2 * (3 * 8 + 4)
        return
    assert (lanes, warps) in _built_geometries(torch.float64)
    if W <= 1024:
        assert (lanes, warps, pairs) == pt.tables_geometry(W)
        assert warps <= 8
    else:
        assert (lanes, warps, pairs) == ((8 if W <= 2048 else 16), 8, 1)


@pytest.mark.parametrize("W", [0, 4097, 8192])
def test_tables_geometry_rejects_band(W):
    """Only a band below one lane is refused; 4097 and 8192, past the old
    limit, take the scratch form in both types."""
    if W < 1:
        with pytest.raises(ValueError):
            pt.tables_geometry(W)
        with pytest.raises(ValueError):
            pt.tables_geometry(W, dtype=torch.float64)
        return
    for dtype in (torch.float32, torch.float64):
        lanes, warps, pairs = pt.tables_geometry(W, dtype=dtype)
        assert (lanes, 32 * warps, pairs) == (
            -(-W // pt.SCRATCH_THREADS), pt.SCRATCH_THREADS, 1)


def test_tables_match_jax_at_band_1152():
    """A pileup with one read ~1 kb shorter than its template widens the
    band to 1152 (``effective_band``), past the old 1024 limit."""
    rng = np.random.default_rng(11)
    jp = jphmm.PHMMParams.from_hmmparam(HMMParam())
    pp = pphmm.params_from_numpy(np.asarray(jp.trans),
                                 np.asarray(jp.mat_emit),
                                 np.asarray(jp.ins_emit), "cpu")
    tlen = 1100
    template = sim.random_genome(rng, tlen)
    reads = [sim.noisy_read(rng, template, 0.08) for _ in range(2)]
    start = int(rng.integers(0, tlen - 100))
    reads.append(sim.noisy_read(rng, template[start:start + 100], 0.08))
    q_lens = np.array([len(r) for r in reads], np.int32)
    W = effective_band(64, q_lens, tlen)
    assert W == 1152
    Qpad = ((int(q_lens.max()) + 127) // 128) * 128
    qs = np.full((len(reads), Qpad), 4, np.int8)
    for i, r in enumerate(reads):
        qs[i, :len(r)] = r
    offs = np.stack([linear_offsets(int(n), tlen, Qpad, W) for n in q_lens])
    lk, (fM, fI, fD), fcum, rcs, (bM, bI, bD), bcum = pt.tables_from_arrays(
        qs, template, offs, q_lens, tlen, pp, W)
    tpl = np.asarray(template, np.int8)
    for i in range(len(qs)):
        lk_w, (fMw, fIw, fDw), fcum_w, rcs_w = jphmm.forward_banded(
            qs[i], tpl, offs[i], np.int32(q_lens[i]), np.int32(tlen), jp, W)
        (bMw, bIw, bDw), bcum_w = jphmm.backward_banded(
            qs[i], tpl, offs[i], np.int32(q_lens[i]), np.int32(tlen), jp, W)
        assert abs(float(lk[i]) - float(lk_w)) < 2e-2
        for got, want in ((fM, fMw), (fI, fIw), (fD, fDw), (bM, bMw),
                          (bI, bIw), (bD, bDw)):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                       rtol=2e-3, atol=1e-5)
        np.testing.assert_allclose(fcum[i].numpy(), np.asarray(fcum_w),
                                   rtol=1e-4, atol=2e-2)
        np.testing.assert_allclose(bcum[i].numpy(), np.asarray(bcum_w),
                                   rtol=1e-4, atol=2e-2)
        np.testing.assert_array_equal(rcs[i].numpy(), np.asarray(rcs_w))
