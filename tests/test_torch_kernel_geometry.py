"""Launch geometry of K1l, the counts kernel and K3: each Python geometry
function against what its CUDA source instantiates, up to W 65 536, and
the forms each wrapper picks past the old band limits (the K1 family's
scratch form above 4096, K3's above 8192 with int32 cells).  The geometry
is computed before anything reaches the card, so these run without one."""

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


def _scratch_form(lanes, warps, pairs, W):
    """The K1 family's scratch form: one block of SCRATCH_THREADS threads
    a pair (band_scratch.cuh's constants), ceil(W / 512) lanes a thread."""
    src = _source("band_scratch.cuh")
    threads = _constant(src, "SCRATCH_THREADS")
    assert threads == pt.SCRATCH_THREADS
    return (lanes, 32 * warps, pairs) == (-(-W // threads), threads, 1)


@pytest.mark.parametrize("W", [1, 64, 128, 256, 1000, 1152, 2048, 2049,
                               2176, 4096, 4097, 8192, 16384, 65536])
def test_lk_geometry_is_built(W):
    """K1l launches with the table kernels' geometry; phmm_lk.cu builds
    every (lanes, warps) pair tables_geometry picks up to SHARED_FORM_W,
    and the scratch form above it."""
    src = _source("phmm_lk.cu")
    built = {(int(a), int(b)) for a, b in
             re.findall(r"X\((\d+), (\d+)\)", _macro(src, "LK_GEOMETRIES"))}
    lanes, warps, pairs = pt.tables_geometry(W, "phmm_lk")
    assert _constant(src, "SHARED_FORM_W") == pt.SHARED_FORM_W
    if W > pt.SHARED_FORM_W:
        assert _scratch_form(lanes, warps, pairs, W)
        assert pt.scratch_bytes(W) == -(-W // 512) * 512 * 2 * (3 * 4 + 4)
    else:
        assert (lanes, warps) in built and pt.scratch_bytes(W) == 0


@pytest.mark.parametrize("W,Q", [(1, 1), (64, 128), (128, 2048), (130, 77),
                                 (256, 2112), (1152, 2048), (2048, 2048),
                                 (2176, 2304), (4096, 2048), (4224, 4480),
                                 (65536, 66000)])
def test_counts_geometry_matches_source(W, Q):
    """A unit is one warp's strip of rows by chunk of band lanes; the
    wrapper sizes the partials' scratch with the C side's constants, at any
    band width (the source has no limit)."""
    src = _source("phmm_counts.cu")
    strip, chunk = _constant(src, "STRIP"), _constant(src, "CHUNK")
    assert (strip, chunk) == (pg.COUNTS_STRIP, pg.COUNTS_CHUNK)
    assert chunk == 32 * 4 and strip <= 32   # 4 lanes a thread, a lane a row
    assert "MAX_W" not in src
    units = pg.counts_geometry(W, Q)
    assert units == -(-(Q + 1) // strip) * -(-W // chunk)


@pytest.mark.parametrize("W", [1, 31, 64, 65, 128, 256, 512, 640, 1024,
                               1025, 1152, 2048, 2049, 4096, 4097, 8192,
                               8193, 16384, 65536])
def test_edit_dp_geometry_is_built(W):
    """K3's warp form up to 2048 lanes: the fewest lanes a thread (1, 2 or
    4) that one warp needs, then as many warps as the band needs (1 to 16,
    several only at 4 lanes; edit_dp.cu builds each), 4 warps a block or
    one wider pair; above, the block form: one pair a block of at most 1024
    threads at 4 lanes, or 8 where 4 would need more; above 8192 the
    scratch form: 1024 threads, ceil(W / 1024) lanes a thread."""
    src = _source("edit_dp.cu")
    warp_form = {(int(a), int(b)) for a, b in re.findall(
        r"X\((\d+), (\d+)\)", _macro(src, "EDIT_WARP_GEOMETRIES"))}
    block_lanes = {int(x) for x in re.findall(
        r"X\((\d+)\)", _macro(src, "EDIT_BLOCK_LANES"))}
    max_warps = _constant(src, "MAX_WARPS")
    max_threads = _constant(src, "MAX_THREADS")
    assert (max_warps, max_threads) == (k3.MAX_WARPS, k3.MAX_THREADS)
    assert _constant(src, "STREAM_INT16_W") == k3.STREAM_INT16_W
    assert _constant(src, "EDIT_SMEM_STATE") == k3.EDIT_SMEM_STATE
    assert k3.WARP_FORM_W == 32 * k3.MAX_LANES * max_warps
    lanes, warps, ppb = k3.edit_dp_geometry(W)
    if W <= k3.STREAM_INT16_W:
        assert lanes * 32 * warps >= W > lanes * 32 * (warps - 1)
    if W <= k3.WARP_FORM_W:
        assert (lanes, warps) in warp_form and lanes <= k3.MAX_LANES
        assert warps <= max_warps and (warps == 1 or lanes == 4)
        assert lanes == 1 or 32 * (lanes // 2) < W
        assert ppb * warps <= max(4, warps) and ppb == max(1, 4 // warps)
    elif W <= k3.STREAM_INT16_W:
        assert lanes in block_lanes and ppb == 1
        assert max_warps < warps and 32 * warps <= max_threads
        assert lanes == 4 or -(-W // 4) > max_threads
    else:
        assert (lanes, 32 * warps, ppb) == (-(-W // max_threads),
                                            max_threads, 1)
        assert lanes * max_threads >= W > (lanes - 1) * max_threads
        assert lanes > max(block_lanes)


@pytest.mark.parametrize("W,form", [(4096, "shared"), (4097, "scratch")])
def test_lk_and_counts_band_limit(W, form):
    """The old limit, 4096: K1l and counts take the band on either side of
    it, K1l in its shared-memory form up to it and the scratch form past
    it."""
    lanes, warps, pairs = pt.tables_geometry(W, "phmm_lk")
    assert _scratch_form(lanes, warps, pairs, W) == (form == "scratch")
    assert pg.counts_geometry(W, 2048) == 129 * -(-W // pg.COUNTS_CHUNK)


@pytest.mark.parametrize("W,ok", [(2048, True), (2049, True), (4096, True),
                                  (4097, False)])
def test_k1_family_band_limits_match_sources(W, ok):
    """The K1 family's shared-memory limit, 4096, in each wrapper and each
    C source (tables in both types, K1l); at 2048 the register form, past
    it the wide form (shared-memory state) that each source builds, past
    4096 (``ok`` False: the old limit) the scratch form, in both types."""
    tables, lk = (_source(n) for n in ("phmm_tables.cu", "phmm_lk.cu"))
    for src in (tables, lk):
        assert _constant(src, "SHARED_FORM_W") == pt.SHARED_FORM_W == 4096
    lk_built = {(int(a), int(b)) for a, b in re.findall(
        r"X\((\d+), (\d+)\)", _macro(lk, "LK_GEOMETRIES"))}
    if not ok:
        for kernel in ("fwd_tables", "bwd_tables", "phmm_lk"):
            assert _scratch_form(*pt.tables_geometry(W, kernel), W)
        assert _scratch_form(*pt.tables_geometry(W, dtype=torch.float64), W)
        assert pt.scratch_bytes(W, torch.float64) == 9 * 512 * 2 * (3 * 8 + 4)
        assert pg.counts_geometry(W, 2048) == 129 * 33
        return
    for dtype, macro in ((torch.float32, "TABLE_GEOMETRIES_F32"),
                         (torch.float64, "TABLE_GEOMETRIES_F64")):
        built = {(int(a), int(b)) for a, b in re.findall(
            r"X\((\d+), (\d+)\)", _macro(tables, macro))}
        lanes, warps, _pairs = pt.tables_geometry(W, dtype=dtype)
        assert (lanes, warps) in built
        assert (lanes > _constant(tables, "MAX_REG_LANES")) == (
            W > pt.register_form_w(dtype))
        assert pt.scratch_bytes(W, dtype) == 0
    lanes, warps, _pairs = pt.tables_geometry(W, "phmm_lk")
    assert (lanes, warps) in lk_built
    assert (lanes > _constant(lk, "MAX_REG_LANES")) == (W > 2048)
    assert pg.counts_geometry(W, 2048) == 129 * -(-W // pg.COUNTS_CHUNK)


@pytest.mark.parametrize("W,ok", [(8192, True), (8193, False)])
def test_edit_dp_band_limit(W, ok):
    """The old limit, 8192: up to it int16 cells in the block form, past
    it (``ok`` False) int32 cells in the scratch form, its state in shared
    memory (15 bytes a lane, under EDIT_SMEM_STATE up to ~13 600 lanes)."""
    if ok:
        assert k3.edit_dp_geometry(W) == (8, 32, 1)
        assert k3.cell_dtype(W) == torch.int16
        # ptr | run << 2 with run <= W - 1 still fits an int16
        assert 2 | (W - 1) << 2 <= 2 ** 15 - 1
        return
    assert k3.edit_dp_geometry(W) == (9, 32, 1)
    assert k3.cell_dtype(W) == torch.int32
    assert 2 | (W - 1) << 2 > 2 ** 15 - 1
    assert k3.edit_state_bytes(W) == 15 * 9 * 1024   # 9 lanes a thread
    assert k3.edit_state_bytes(W) <= k3.EDIT_SMEM_STATE
    assert k3.edit_state_bytes(16384) > k3.EDIT_SMEM_STATE
