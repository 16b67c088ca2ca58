"""Device selection: every entry point of the port runs on the card.

``resolve_device(None)`` is ``cuda`` and raises when no CUDA device is
present — the port never drops to the CPU on its own.  Callers that want
the plain PyTorch path on the CPU (the tests) pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)
