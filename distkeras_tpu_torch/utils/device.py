"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU by name. With no
CUDA device and no explicit ``"cpu"``, they raise: a run that silently falls
back to the CPU would report host numbers under a device's name.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; ``"cpu"`` only when given explicitly.

    Raises ``RuntimeError`` when a CUDA device is asked for (or implied) and
    none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    return dev
