"""Launch geometry of K1l, the counts kernel and K3: each Python geometry
function against what its CUDA source instantiates, and the band widths
each wrapper accepts (K1l and counts up to the K1 tables' 2048, K3 up to
8192).  The wrappers check the width before anything reaches the card, so
these run without one."""

import os
import re

import pytest

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


@pytest.mark.parametrize("W", [1, 64, 128, 256, 1000, 1152, 2048])
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
                                 (256, 2112), (1152, 2048), (2048, 2048)])
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


@pytest.mark.parametrize("W", [1, 31, 256, 1024, 1025, 1152, 2048, 4096,
                               8192])
def test_edit_dp_geometry_is_built(W):
    """K3 takes the fewest lanes a thread (a power of two that edit_dp.cu
    builds) that leave at most 1024 threads, in whole warps."""
    src = _source("edit_dp.cu")
    built = {int(x) for x in re.findall(r"X\((\d+)\)",
                                        _macro(src, "EDIT_LANES"))}
    max_threads = _constant(src, "MAX_THREADS")
    lanes, threads = k3.edit_dp_geometry(W)
    assert lanes in built and lanes <= k3.MAX_LANES
    assert threads % 32 == 0 and threads <= max_threads
    assert lanes * threads >= W > lanes * (threads - 32)
    assert lanes == 1 or -(-W // (lanes // 2)) > max_threads
    if W <= 1024:   # one lane a thread, as before the limit was lifted
        assert lanes == 1


@pytest.mark.parametrize("W,ok", [(2048, True), (2049, False)])
def test_lk_and_counts_band_limit(W, ok):
    if ok:
        pt.tables_geometry(W, "phmm_lk")
        pg.counts_geometry(W, 2048)
        return
    with pytest.raises(ValueError, match="phmm_lk: band width 2049"):
        pt.tables_geometry(W, "phmm_lk")
    with pytest.raises(ValueError, match="phmm_counts: band width 2049"):
        pg.counts_geometry(W, 2048)


@pytest.mark.parametrize("W,ok", [(8192, True), (8193, False)])
def test_edit_dp_band_limit(W, ok):
    if ok:
        assert k3.edit_dp_geometry(W) == (8, 1024)
        # ptr | run << 2 with run <= W - 1 still fits an int16
        assert 2 | (W - 1) << 2 <= 2 ** 15 - 1
        return
    with pytest.raises(ValueError, match="edit_dp: band width 8193"):
        k3.edit_dp_geometry(W)
