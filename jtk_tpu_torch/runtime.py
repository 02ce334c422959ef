"""The device the port's device work runs on, and the set its shards run on.

Entry points run on the card ("cuda") unless the caller asks for the CPU::

    from jtk_tpu_torch.runtime import use_device
    with use_device("cpu"):
        ...

Asking for cuda on a machine without a GPU raises; nothing falls back to
the CPU silently.  Op functions take a ``device`` argument that defaults to
:func:`device`.

:func:`devices` is the device set that the data-parallel paths
(:mod:`jtk_tpu_torch.parallel` and its call sites: model tuning, the
modtable engines, the mapper, repeat masking) cut their work over, in one
process: by default every visible GPU when the device is cuda and more than
one is visible, else the device alone.  Its first entry, the primary, is
:func:`device` itself: shards are gathered and merged there.
:func:`use_devices` sets it for a block; an entry may repeat, and each
entry is one shard (``use_devices(["cpu"] * 4)`` cuts every sharded path
four ways on the CPU; ``use_devices(["cuda"])`` keeps a multi-GPU host on
one card).

On the card the port computes in full float32: selecting cuda turns TF32
off for matrix products and cuDNN (the modtable's one-hot segment sums are
matrix products and would otherwise keep only ~3 decimal digits).
"""

from __future__ import annotations

import contextlib

import torch

# (device name, device set or None for the default set of that device)
_STACK: list[tuple[str, tuple | None]] = [("cuda", None)]


def _check(name) -> torch.device:
    d = torch.device(name)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available; pass use_device('cpu') to run "
                               "on the CPU")
        if d.index is not None and d.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {d} requested but only "
                               f"{torch.cuda.device_count()} CUDA devices "
                               "are visible")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return d


def device() -> torch.device:
    """The current device (default cuda): the primary of :func:`devices`."""
    return _check(_STACK[-1][0])


def devices() -> list[torch.device]:
    """The current device set, primary first (see the module docstring)."""
    name, devs = _STACK[-1]
    if devs is not None:
        return [_check(d) for d in devs]
    d = device()
    if d.type == "cuda" and torch.cuda.device_count() > 1:
        first = d.index if d.index is not None \
            else torch.cuda.current_device()
        return [d] + [torch.device("cuda", i)
                      for i in range(torch.cuda.device_count()) if i != first]
    return [d]


def resolve(dev=None) -> torch.device:
    """``dev`` if given, else the current device."""
    return _check(dev) if dev is not None else device()


def resolve_set(devs=None) -> list[torch.device]:
    """The device set ``devs`` if given, else the current set."""
    return [_check(d) for d in devs] if devs is not None else devices()


def set_device(name) -> None:
    """Set the default device for the rest of the process (its device set
    is the default one, see :func:`devices`)."""
    _check(name)
    _STACK[0] = (str(name), None)


@contextlib.contextmanager
def use_device(name):
    """Run the enclosed block on device ``name`` (and its default set)."""
    _check(name)
    _STACK.append((str(name), None))
    try:
        yield torch.device(name)
    finally:
        _STACK.pop()


@contextlib.contextmanager
def use_devices(names):
    """Run the enclosed block on the device set ``names`` (one shard an
    entry; entries may repeat); its first entry is the device."""
    names = tuple(str(n) for n in names)
    if not names:
        raise ValueError("use_devices: the device set is empty")
    for n in names:
        _check(n)
    _STACK.append((names[0], names))
    try:
        yield [torch.device(n) for n in names]
    finally:
        _STACK.pop()
