"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. A host
without a GPU raises instead of carrying on there.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return the torch.device to run on, or raise when it is a CUDA
    device and no GPU is visible.

    On CUDA this also turns TF32 off for convolutions and matmuls: cuDNN
    runs float32 convolutions in TF32 by default, which keeps about three
    decimal digits, and the port's float32 path is held to float32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """Copy a CPU tensor to `device` without waiting: to a GPU through
    pinned memory with a non-blocking copy (a copy from pageable memory
    would wait for the stream), to the CPU as it is."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
