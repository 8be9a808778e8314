"""Device selection for the port (the counterpart of
``gpustack_tpu/utils/platform.py``).

Every entry point runs on the card unless its caller asks for the CPU by
name. There is no silent fallback: without CUDA, a request for the default
device raises instead of quietly running a CPU build.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(
    device: Optional[Union[str, torch.device]] = None,
) -> torch.device:
    """``None`` or ``"cuda"`` → the current CUDA device (raises when CUDA is
    unavailable); ``"cpu"`` → the CPU; any other torch device string is
    taken as given (a CUDA one is checked for availability)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' explicitly to "
                "run the port on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def rank_device(device: torch.device, rank: int) -> torch.device:
    """The device of rank ``rank`` of a multi-GPU replica whose processes
    were asked for ``device``: ``cuda:<local rank>`` on the card (one host,
    so the local rank is the rank, modulo the cards it has), the CPU when
    the CPU was asked for."""
    if device.type == "cpu":
        return device
    return resolve_device(
        torch.device("cuda", rank % torch.cuda.device_count())
    )
