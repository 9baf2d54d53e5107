"""The one dispatch rule behind every ``*_auto`` function.

A tensor on the CPU takes the plain PyTorch version of an op; a CUDA tensor
on a Hopper card (compute capability 9.x, the ``sm_90a`` target the kernels
are built for) takes the hand-written kernel.  Any other device raises: a
GPU never drops silently to the plain path.
"""

from __future__ import annotations

import torch


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True to launch the CUDA kernel, False for the plain CPU version."""
    device = tensors[0].device
    for t in tensors[1:]:
        if t.device != device:
            raise ValueError(f"tensors on different devices: {device} and {t.device}")
    if device.type == "cpu":
        return False
    if device.type == "cuda":
        cap = torch.cuda.get_device_capability(device)
        if cap[0] == 9:
            return True
        raise RuntimeError(
            f"{torch.cuda.get_device_name(device)} has compute capability "
            f"{cap}; the kernels are built for sm_90a (Hopper) only"
        )
    raise RuntimeError(f"no kernel or plain path for device {device}")

