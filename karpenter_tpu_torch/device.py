"""Which device the port's entry points run on.

The default is the CUDA card. The CPU is used only when the caller asks for
it (`device="cpu"`, as the tests do); without a card, asking for CUDA
raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device to run on; a CUDA device always with its index, so
    two resolutions of one card compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: the port runs on 'cuda' or 'cpu'")
    return dev
