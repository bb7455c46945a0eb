"""Device choice for the port's entry points.

Every entry point takes a ``device`` argument and resolves it here:
``None`` means the card (``cuda``), and a host without CUDA raises
instead of carrying on on the CPU.  A CPU run is something the caller
asks for by name (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The ``torch.device`` an entry point runs on: ``cuda`` by
    default; ``"cpu"`` only when asked for.  Raises RuntimeError when a
    CUDA device is wanted and none is available."""
    dev = torch.device("cuda" if device is None or device == "" else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda|cpu)")
    return dev

