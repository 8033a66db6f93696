"""The one device policy of the port.

Entry points (``TorchBackend``, ``cli.main``) run on CUDA.  Without CUDA
they raise; they never fall back to the CPU.  The CPU is used only when a
caller names it (``device="cpu"``), which is what the CPU tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (``RuntimeError`` when CUDA is unavailable);
    an explicit ``"cpu"``/``"cuda[:n]"``/``torch.device`` is honoured."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "sam2consensus_torch runs on a CUDA device and none is "
                "available; pass device='cpu' explicitly to run the plain "
                "PyTorch versions on the CPU")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    return dev


def device_name(device: torch.device) -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``cpu``: the
    run manifest's record of where a run ran."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
