"""Input generator: Ilastik-like boundary-probability maps of touching cells.

The recipe of ``chip_smoke.refine_relief`` (config #3's relief): ``pairs``
pairs of touching discs, centres ``margin`` from the edges, r² in ``r2``
[lo, hi), the second disc 1.5·r columns right of the first (clipped at the
plane's edges); the map is 1 − d / max d, d the Euclidean distance of a
disc pixel to the nearest pixel outside every disc (0 outside).  ``levels``
> 0 rounds the map to that many levels (the plateaus of a uint8 export; 16
is the port's ``bench.quantize16``).

Every seed gets the same work: each staged batch's relief is drawn once,
on the device, from the traffic file's ``layout_seed``; the batch's planes
are its images under the symmetries of the plane (flips of rows and of
columns, and on a square plane the transpose: 8 images, 4 on another
plane), plane b the image b modulo their number; and ``--seed`` orders the
batch's planes.  So every seed's batches hold the same planes, in another
order, and every seed's calls take the same watershed steps and passes.
A flip or a transpose keeps each disc whole and the plane's edges where
they were; a cyclic shift (``refine_relief``'s 17·b columns) would split
the discs at its seam and change the steps with the seed.
"""

from __future__ import annotations

import torch

from benchmark import plain


def _relief(p: dict, gen: torch.Generator, device) -> torch.Tensor:
    H, W = p["plane"]
    n, mg = p["pairs"], p["margin"]
    cy = torch.randint(mg, H - mg, (n, 1), generator=gen, device=device)
    cx = torch.randint(mg, W - mg, (n, 1), generator=gen, device=device)
    r2 = torch.randint(*p["r2"], (n, 1), generator=gen, device=device)
    step = torch.floor(1.5 * torch.sqrt(r2.to(torch.float64))).to(torch.int64)
    reach = int((p["r2"][1] - 1) ** 0.5) + 1
    d = torch.arange(-reach, reach + 1, device=device)
    dy, dx = (t.reshape(1, -1) for t in torch.meshgrid(d, d, indexing="ij"))
    disc = dy * dy + dx * dx <= r2
    m = torch.zeros((H, W), dtype=torch.bool, device=device)
    for x0 in (cx, cx + step):
        rows, cols = cy + dy, x0 + dx
        hit = disc & (rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
        m[rows[hit], cols[hit]] = True
    dist = torch.sqrt(plain.edt_sq(~m[None])[0].to(torch.float64))
    prob = (1.0 - dist / max(1.0, float(dist.max()))).to(torch.float32)
    if p["levels"]:
        q = p["levels"] - 1
        prob = torch.round(prob * q) / q
    return prob


def _images(x: torch.Tensor, batch: int) -> torch.Tensor:
    """[batch, H, W]: plane b is ``x``'s image under symmetry b modulo 8 (4
    where H != W): bit 2 transposes, bit 0 flips the rows, bit 1 the
    columns."""
    n = 8 if x.shape[0] == x.shape[1] else 4
    planes = []
    for k in range(batch):
        y = x.t() if k % n & 4 else x
        dims = [d for d, bit in ((0, 1), (1, 2)) if k % n & bit]
        planes.append(y.flip(dims) if dims else y)
    return torch.stack(planes)


def make(p: dict, seed: int, device) -> list:
    """``p["staged"]`` distinct [batch, H, W] float32 batches on ``device``."""
    layout = torch.Generator(device=device)
    layout.manual_seed(p["layout_seed"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return [_images(_relief(p, layout, device), p["batch"])[
                torch.randperm(p["batch"], generator=gen, device=device)]
            for _ in range(p["staged"])]
