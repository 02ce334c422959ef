"""K2's column walk (``csrc/modtable_assembly.cu``) against the plain
assembly, on the CPU.

The kernel cannot run here; ``tests/k2_model.py`` runs its recurrence (a
thread a template column, rows in increasing order, the previous row's
values carried, float64 column sums) in plain PyTorch.  The card tests
(tests/test_torch_cuda.py) hold the kernel itself to the plain version.
"""

import pytest
import torch

from jtk_tpu_torch.ops import modtable as pmod
from k2_model import k2_case, k2_model
from torch_util import port_on_cpu  # noqa: F401


@pytest.mark.parametrize("seed,B,W,per_pair,T", [
    (1, 12, 128, True, 300), (2, 8, 128, False, 260), (3, 6, 256, True, 420),
    (4, 5, 96, True, 200)],
    ids=["W128-per-pair", "W128-one-template", "W256-per-pair",
         "W96-per-pair"])
def test_column_walk_matches_plain(seed, B, W, per_pair, T):
    """The same live entries, and every live entry within 1e-4 nats (the
    float32 terms are the plain version's; only the float64 sums' order
    differs).  Some reads end early or start late; strands are mixed."""
    args, tpl, Tpad = k2_case(seed, B, W, per_pair=per_pair, T=T)
    lk, want = pmod.modification_table_from_tables_plain(*args)
    got = k2_model(*args[:11], tpl, *args[12:])
    live = want > -1e29
    assert torch.equal(got > -1e29, live)
    assert float((got - want).abs()[live].max()) < 1e-4
    assert torch.equal(got[~live], want[~live])


def test_plain_is_the_cpu_path():
    args, tpl, _Tpad = k2_case(5, 3, 128, T=200)
    lk, tab = pmod.modification_table_from_tables(*args, tpl)
    lk2, tab2 = pmod.modification_table_from_tables_plain(*args)
    assert torch.equal(lk, lk2) and torch.equal(tab, tab2)


def test_kernel_wrapper_refuses_cpu_tensors():
    args, tpl, _Tpad = k2_case(6, 2, 128, T=200)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pmod._launch_assembly(*args[:11], tpl, *args[12:])
