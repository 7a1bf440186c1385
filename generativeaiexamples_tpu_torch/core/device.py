"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: asking
for CUDA on a machine without one raises instead of quietly running on
the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "false; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def host_to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Host tensor -> ``device`` without a host sync (pinned, non-blocking
    on CUDA).  The caller must not write ``host`` afterwards: the copy may
    still be in flight."""
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)
