"""Input generator: Ilastik-like uint8 class planes.

The recipe of the port's ``bench.make_plane`` (background class 3, discs of
the particle class 2, small discs of the cell class 1, then speckle of
random classes for the median to clean), drawn on the device, all planes
of a batch in a few large calls.

Every seed gets the same work: the planes are drawn once from the traffic
file's ``layout_seed``, and ``--seed`` moves each plane by a cyclic shift
of its own (rows and columns), so the seed changes where every disc lies,
never how many there are or how large.  Parameters, from the traffic
file: ``plane`` [H, W]; ``batch``; ``staged`` batches; ``background``;
``particles`` a plane with radii in ``particle_r`` [lo, hi) and centres
``particle_margin`` from the edges; ``cells`` a plane with radii in
``cell_r`` and centres ``cell_margin`` from the edges; ``speckle``, the
share of pixels set to a class drawn from ``speckle_vals`` [lo, hi).
"""

from __future__ import annotations

import torch

from benchmark.plain import shift_planes


def _randint(lo, hi, shape, gen, device):
    return torch.randint(lo, hi, shape, generator=gen, device=device)


def _batch(p: dict, gen: torch.Generator, device) -> torch.Tensor:
    B = p["batch"]
    H, W = p["plane"]
    arr = torch.full((B, H, W), p["background"], dtype=torch.uint8, device=device)
    yy = torch.arange(H, device=device, dtype=torch.int32).reshape(1, H, 1)
    xx = torch.arange(W, device=device, dtype=torch.int32).reshape(1, 1, W)
    pm = p["particle_margin"]
    for _ in range(p["particles"]):
        cy = _randint(pm, H - pm, (B, 1, 1), gen, device).to(torch.int32)
        cx = _randint(pm, W - pm, (B, 1, 1), gen, device).to(torch.int32)
        r = _randint(*p["particle_r"], (B, 1, 1), gen, device).to(torch.int32)
        arr[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = p["particle_val"]
    cm, n = p["cell_margin"], p["cells"]
    cy = _randint(cm, H - cm, (B, n, 1), gen, device)
    cx = _randint(cm, W - cm, (B, n, 1), gen, device)
    r = _randint(*p["cell_r"], (B, n, 1), gen, device)
    reach = p["cell_r"][1] - 1
    d = torch.arange(-reach, reach + 1, device=device)
    dy, dx = (t.reshape(1, 1, -1) for t in torch.meshgrid(d, d, indexing="ij"))
    hit = (dy * dy + dx * dx <= r * r).expand(B, n, dy.shape[-1])
    plane = torch.arange(B, device=device).reshape(B, 1, 1).expand_as(hit)
    arr[plane[hit], (cy + dy).expand_as(hit)[hit], (cx + dx).expand_as(hit)[hit]] = p["cell_val"]
    noise = torch.rand((B, H, W), generator=gen, device=device) < p["speckle"]
    vals = _randint(*p["speckle_vals"], (B, H, W), gen, device).to(torch.uint8)
    return torch.where(noise, vals, arr)


def make(p: dict, seed: int, device) -> list:
    """``p["staged"]`` distinct [batch, H, W] uint8 batches on ``device``."""
    layout = torch.Generator(device=device)
    layout.manual_seed(p["layout_seed"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return [shift_planes(_batch(p, layout, device), gen) for _ in range(p["staged"])]
