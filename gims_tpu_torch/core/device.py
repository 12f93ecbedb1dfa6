"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The card unless the caller names another device.

    Entry points run on ``cuda`` by default. A caller that wants the CPU
    passes ``device="cpu"``. Asking for CUDA where there is none raises:
    the port never carries on quietly on the CPU. ``cuda`` resolves to the
    current card's index, as a tensor's device reads, so that two resolved
    devices compare equal when they name the same card.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev

