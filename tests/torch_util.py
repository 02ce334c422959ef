"""Shared helpers for the port's tests (``tests/test_torch_*.py``).

The tests run the port on the CPU (its plain PyTorch versions) against the
JAX package on the same numpy inputs.  Tests of the CUDA kernels carry the
``cuda`` marker and skip, inside the test, when no card is present.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def port_on_cpu():
    """Run the port on the CPU with few threads (tier-1 runs many
    workers)."""
    from jtk_tpu_torch.runtime import use_device
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with use_device("cpu"):
        yield
    torch.set_num_threads(threads)


def require_cuda():
    """Skip the calling test unless a CUDA device is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# The modification table's multi-base columns: copy 2-3 and del 2-3.
COPY1, DEL1 = 8, 11
DEEP_COLS = (COPY1 + 1, COPY1 + 2, DEL1 + 1, DEL1 + 2)


def oracle_misses(qs, q_lens, template, tab, entries, oracle=None):
    """Entries (read, pos, col) of a copy or deletion column whose value in
    ``tab`` misses the float64 oracle: a deletion by more than 3e-2 nats;
    a copy of 2-3 bases above oracle + 3e-2 or more than 0.6 below it (the
    closed form drops the insertion states between the copied columns,
    tests/test_modtable.py).  The oracle is ``jtk_tpu.ops.oracle``, or
    ``oracle`` (a module with its ``phmm_forward`` and ``apply_edit``, such
    as tests/oracle64.py) with the port's default HMM."""
    if oracle is None:
        from jtk_tpu.datamodel import HMMParam
        from jtk_tpu.ops import oracle
    else:
        from jtk_tpu_torch.datamodel import HMMParam
    hmm = HMMParam()      # the default HMM, as the oracle takes it
    par = {k: getattr(hmm, k) for k in
           ("mat_mat", "mat_ins", "mat_del", "ins_mat", "ins_ins", "ins_del",
            "del_mat", "del_ins", "del_del", "mat_emit", "ins_emit")}
    out = []
    for b, j, e in entries:
        q = np.asarray(qs[b, :q_lens[b]])
        edit = ("D", e - DEL1 + 1) if e >= DEL1 else ("C", e - COPY1 + 1)
        want = oracle.phmm_forward(
            q, oracle.apply_edit(template, edit[0], j, edit[1]), par)
        got = float(tab[b, j, e])
        if e >= DEL1 or e == COPY1:
            ok = abs(got - want) < 3e-2
        else:
            ok = got <= want + 3e-2 and abs(got - want) < 0.6
        if not ok:
            out.append(((int(b), int(j), int(e)), got, want))
    return out
