"""The launch counts of the kernel wrappers, and the device a launch takes.

Each counting wrapper keeps one counts object in ``wrapper.counts`` (the
panel wrappers' ``ops.panel.LaunchCounts``, the butterfly transform's
``ops.butterfly.ButterflyCounts``, the mixed refinement's kernels'
``ops.mixed_refine.KernelCounts``); :func:`reset_counts` replaces every
one with a fresh object of its kind.
"""

from __future__ import annotations

import torch

_COUNTED = []


def counted(wrapper, counts):
    """Give ``wrapper`` a fresh ``counts()`` in ``wrapper.counts``, which
    :func:`reset_counts` replaces with a fresh one."""
    wrapper.counts = counts()
    _COUNTED.append(wrapper)
    return wrapper


def reset_counts() -> None:
    """Zero the counts of every counting wrapper (the panel kernels' and
    the butterfly transform's and the mixed refinement's)."""
    for wrapper in _COUNTED:
        wrapper.counts = type(wrapper.counts)()


def device_index(device) -> int:
    """The CUDA device index of ``device`` (None: the current device)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    return dev.index if dev.index is not None else torch.cuda.current_device()
