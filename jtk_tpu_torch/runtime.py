"""The one device the port's device work runs on.

Entry points run on the card ("cuda") unless the caller asks for the CPU::

    from jtk_tpu_torch.runtime import use_device
    with use_device("cpu"):
        ...

Asking for cuda on a machine without a GPU raises; nothing falls back to
the CPU silently.  Op functions take a ``device`` argument that defaults to
:func:`device`.

On the card the port computes in full float32: selecting cuda turns TF32
off for matrix products and cuDNN (the modtable's one-hot segment sums are
matrix products and would otherwise keep only ~3 decimal digits).
"""

from __future__ import annotations

import contextlib

import torch

_STACK = ["cuda"]


def _check(name) -> torch.device:
    d = torch.device(name)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available; pass use_device('cpu') to run "
                               "on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return d


def device() -> torch.device:
    """The current device (default cuda)."""
    return _check(_STACK[-1])


def resolve(dev=None) -> torch.device:
    """``dev`` if given, else the current device."""
    return _check(dev) if dev is not None else device()


def set_device(name) -> None:
    """Set the default device for the rest of the process."""
    _check(name)
    _STACK[0] = str(name)


@contextlib.contextmanager
def use_device(name):
    """Run the enclosed block on device ``name``."""
    _check(name)
    _STACK.append(str(name))
    try:
        yield torch.device(name)
    finally:
        _STACK.pop()
