"""Device selection for the port's entry points.

Every entry point that takes host data takes ``device=`` and defaults to
the CUDA card. Asking for CUDA without a card raises: the port never
carries on silently on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "genome_tpu_torch: device 'cuda' requested but no CUDA device "
            "is available (pass device='cpu' to run the plain versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
