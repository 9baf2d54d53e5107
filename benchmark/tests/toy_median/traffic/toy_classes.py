"""Input generator of the toy median configuration: ``staged`` batches of
[batch, H, W] uint8 classes drawn uniformly below ``classes`` from the
seed, on the device."""

from __future__ import annotations

import torch


def make(p: dict, seed: int, device) -> list:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = (p["batch"], *p["plane"])
    return [torch.randint(0, p["classes"], shape, generator=gen, device=device,
                          dtype=torch.uint8) for _ in range(p["staged"])]
