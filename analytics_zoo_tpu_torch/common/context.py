"""Device selection: the port's counterpart of the reference's context
(which builds a JAX mesh). Entry points default to CUDA and never fall
back to the CPU on their own."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``"cuda"``. Raises when CUDA is asked for (or
    defaulted to) and no GPU is visible; pass ``device="cpu"`` to run on
    the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return dev
