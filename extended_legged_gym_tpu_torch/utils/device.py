"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)`` after checking it can be used.

    Entry points default to ``"cuda"`` and raise here when CUDA is absent;
    the CPU is used only when the caller asks for it.  Also switches TF32 off
    for matmuls and cuDNN convolutions: the physics and the optimizer run in
    full float32."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
