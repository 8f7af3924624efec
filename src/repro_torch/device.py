"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``.  A CUDA device with no CUDA runtime raises:
    the port never drops to the CPU behind the caller's back, so a run
    that was meant for the card cannot silently measure the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
