"""Launch geometry of K1l, the counts kernel and K3: each Python geometry
function against what its CUDA source instantiates, and the band widths
each wrapper accepts (the K1 family, tables, K1l and counts, up to 4096;
K3 up to 8192).  The wrappers check the width before anything reaches the
card, so these run without one."""

import os
import re

import pytest
import torch

from jtk_tpu_torch.ops import edit_dp as k3
from jtk_tpu_torch.ops import phmm_grad as pg
from jtk_tpu_torch.ops import phmm_tables as pt

CSRC = os.path.join(os.path.dirname(pt.__file__), os.pardir, "csrc")


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _macro(src, name):
    return re.search(rf"#define {name}\(X\)(.*?)\n\n", src, re.S).group(1)


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("W", [1, 64, 128, 256, 1000, 1152, 2048, 2049,
                               2176, 4096])
def test_lk_geometry_is_built(W):
    """K1l launches with the table kernels' geometry; phmm_lk.cu builds
    every (lanes, warps) pair tables_geometry picks."""
    src = _source("phmm_lk.cu")
    built = {(int(a), int(b)) for a, b in
             re.findall(r"X\((\d+), (\d+)\)", _macro(src, "LK_GEOMETRIES"))}
    lanes, warps, _pairs = pt.tables_geometry(W, "phmm_lk")
    assert (lanes, warps) in built
    assert _constant(src, "MAX_W") == pt.MAX_W


@pytest.mark.parametrize("W,Q", [(1, 1), (64, 128), (128, 2048), (130, 77),
                                 (256, 2112), (1152, 2048), (2048, 2048),
                                 (2176, 2304), (4096, 2048)])
def test_counts_geometry_matches_source(W, Q):
    """A unit is one warp's strip of rows by chunk of band lanes; the
    wrapper sizes the partials' scratch with the C side's constants."""
    src = _source("phmm_counts.cu")
    strip, chunk = _constant(src, "STRIP"), _constant(src, "CHUNK")
    assert (strip, chunk) == (pg.COUNTS_STRIP, pg.COUNTS_CHUNK)
    assert chunk == 32 * 4 and strip <= 32   # 4 lanes a thread, a lane a row
    assert _constant(src, "MAX_W") == pt.MAX_W
    units = pg.counts_geometry(W, Q)
    assert units == -(-(Q + 1) // strip) * -(-W // chunk)


@pytest.mark.parametrize("W", [1, 31, 64, 65, 128, 256, 512, 640, 1024,
                               1025, 1152, 2048, 2049, 4096, 4097, 8192])
def test_edit_dp_geometry_is_built(W):
    """K3's warp form up to 2048 lanes: the fewest lanes a thread (1, 2 or
    4) that one warp needs, then as many warps as the band needs (1 to 16,
    several only at 4 lanes; edit_dp.cu builds each), 4 warps a block or
    one wider pair; above, the block form: one pair a block of at most 1024
    threads at 4 lanes, or 8 where 4 would need more."""
    src = _source("edit_dp.cu")
    warp_form = {(int(a), int(b)) for a, b in re.findall(
        r"X\((\d+), (\d+)\)", _macro(src, "EDIT_WARP_GEOMETRIES"))}
    block_lanes = {int(x) for x in re.findall(
        r"X\((\d+)\)", _macro(src, "EDIT_BLOCK_LANES"))}
    max_warps = _constant(src, "MAX_WARPS")
    max_threads = _constant(src, "MAX_THREADS")
    assert (max_warps, max_threads) == (k3.MAX_WARPS, k3.MAX_THREADS)
    assert k3.WARP_FORM_W == 32 * k3.MAX_LANES * max_warps
    lanes, warps, ppb = k3.edit_dp_geometry(W)
    assert lanes * 32 * warps >= W > lanes * 32 * (warps - 1)
    if W <= k3.WARP_FORM_W:
        assert (lanes, warps) in warp_form and lanes <= k3.MAX_LANES
        assert warps <= max_warps and (warps == 1 or lanes == 4)
        assert lanes == 1 or 32 * (lanes // 2) < W
        assert ppb * warps <= max(4, warps) and ppb == max(1, 4 // warps)
    else:
        assert lanes in block_lanes and ppb == 1
        assert max_warps < warps and 32 * warps <= max_threads
        assert lanes == 4 or -(-W // 4) > max_threads


@pytest.mark.parametrize("W,ok", [(4096, True), (4097, False)])
def test_lk_and_counts_band_limit(W, ok):
    if ok:
        pt.tables_geometry(W, "phmm_lk")
        pg.counts_geometry(W, 2048)
        return
    with pytest.raises(ValueError, match="phmm_lk: band width 4097"):
        pt.tables_geometry(W, "phmm_lk")
    with pytest.raises(ValueError, match="phmm_counts: band width 4097"):
        pg.counts_geometry(W, 2048)


@pytest.mark.parametrize("W,ok", [(2048, True), (2049, True), (4096, True),
                                  (4097, False)])
def test_k1_family_band_limits_match_sources(W, ok):
    """The K1 family's limit, 4096, in each wrapper and each C source
    (tables in both types, K1l, counts); at 2048 the register form, past
    it the wide form (shared-memory state) that each source builds."""
    tables, lk, counts = (_source(n) for n in (
        "phmm_tables.cu", "phmm_lk.cu", "phmm_counts.cu"))
    for src in (tables, lk, counts):
        assert _constant(src, "MAX_W") == pt.MAX_W == 4096
    lk_built = {(int(a), int(b)) for a, b in re.findall(
        r"X\((\d+), (\d+)\)", _macro(lk, "LK_GEOMETRIES"))}
    if not ok:
        for kernel in ("fwd_tables", "bwd_tables", "phmm_lk"):
            with pytest.raises(ValueError, match=f"{kernel}: band width 4097"):
                pt.tables_geometry(W, kernel)
        with pytest.raises(ValueError, match="band width 4097"):
            pt.tables_geometry(W, dtype=torch.float64)
        with pytest.raises(ValueError, match="phmm_counts: band width 4097"):
            pg.counts_geometry(W, 2048)
        return
    for dtype, macro in ((torch.float32, "TABLE_GEOMETRIES_F32"),
                         (torch.float64, "TABLE_GEOMETRIES_F64")):
        built = {(int(a), int(b)) for a, b in re.findall(
            r"X\((\d+), (\d+)\)", _macro(tables, macro))}
        lanes, warps, _pairs = pt.tables_geometry(W, dtype=dtype)
        assert (lanes, warps) in built
        assert (lanes > _constant(tables, "MAX_REG_LANES")) == (
            W > pt.register_form_w(dtype))
    lanes, warps, _pairs = pt.tables_geometry(W, "phmm_lk")
    assert (lanes, warps) in lk_built
    assert (lanes > _constant(lk, "MAX_REG_LANES")) == (W > 2048)
    assert pg.counts_geometry(W, 2048) == 129 * -(-W // pg.COUNTS_CHUNK)


@pytest.mark.parametrize("W,ok", [(8192, True), (8193, False)])
def test_edit_dp_band_limit(W, ok):
    if ok:
        assert k3.edit_dp_geometry(W) == (8, 32, 1)
        # ptr | run << 2 with run <= W - 1 still fits an int16
        assert 2 | (W - 1) << 2 <= 2 ** 15 - 1
        return
    with pytest.raises(ValueError, match="edit_dp: band width 8193"):
        k3.edit_dp_geometry(W)
