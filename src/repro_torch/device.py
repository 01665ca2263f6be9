"""Where the port's entry points run: ``cuda`` unless the caller asks for
the CPU, or for ``meta`` (shapes and dtypes alone, no data: the dry run of
:mod:`repro_torch.launch.dryrun`)."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another (``cpu`` or ``meta``). Raises rather than run on the CPU when
    CUDA is missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "torch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
