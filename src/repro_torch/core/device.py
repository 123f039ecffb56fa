"""Where the port runs: the CUDA card unless the caller names a device."""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake

__all__ = ["resolve_device", "holds_data"]


def resolve_device(device=None) -> torch.device:
    """``None`` → the CUDA card, raising if there is none (never a silent
    drop to the CPU); anything else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the CUDA card by default and torch sees none; "
                "pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def holds_data(t: torch.Tensor) -> bool:
    """False for a tensor that has a shape, a dtype and a device but no
    data: a fake tensor (``torch._subclasses.FakeTensor``) or one on the
    ``meta`` device, as the dry run traces (``launch/dryrun.py``)."""
    return t.device.type != "meta" and not is_fake(t)
