"""Input generator: one channel's uint16 z-stacks of a microscope.

The recipe of the port's ``bench.config2_stacks`` (uniform noise below
``noise`` on every pixel), with what a z-stack of the upstream project's
acquisitions holds besides, drawn on the device: ``particles`` chitin
particles a stack, discs of radius in ``particle_r`` [lo, hi) whose
autofluorescence adds ``particle_gain`` on every plane, and ``cells``
cells a stack, discs of radius in ``cell_r``, each with a focal plane z₀
uniform in [0, planes) and a peak uniform in ``cell_peak`` [lo, hi) that
falls off the focus as exp(−((z − z₀) / ``cell_depth``)²).  Sums saturate
at 65535.  Every draw is vectorised: the cells in chunks of ``CHUNK``.

Every seed gets the same work: each staged stack is drawn once from the
traffic file's ``layout_seed``, and ``--seed`` permutes each stack's
planes and flips each plane by its rows, its columns, both or neither.  A
flip keeps every disc whole and the plane's edges where they were, and a
plane is never transposed (a transpose moves a kernel's work).

Parameters, from the traffic file: ``plane`` [H, W]; ``batch``, the planes
of a stack (a call's batch); ``staged`` stacks; ``noise``; ``particles``,
``particle_r``, ``particle_margin`` (centres that far from the edges),
``particle_gain``; ``cells``, ``cell_r``, ``cell_margin``, ``cell_peak``,
``cell_depth``.
"""

from __future__ import annotations

import torch

CHUNK = 4096  # cells drawn at once: a chunk's index tensors stay near 0.2 GB at 50 planes
U16_MAX = 65535


def _randint(lo, hi, shape, gen, device):
    return torch.randint(lo, hi, shape, generator=gen, device=device)


def _stack(p: dict, gen: torch.Generator, device) -> torch.Tensor:
    P = p["batch"]
    H, W = p["plane"]
    acc = (torch.rand((P, H, W), generator=gen, device=device) * p["noise"]).to(torch.int32)
    yy = torch.arange(H, device=device).reshape(H, 1)
    xx = torch.arange(W, device=device).reshape(1, W)
    pm = p["particle_margin"]
    particle = torch.zeros((H, W), dtype=torch.bool, device=device)
    for _ in range(p["particles"]):
        cy = _randint(pm, H - pm, (1, 1), gen, device)
        cx = _randint(pm, W - pm, (1, 1), gen, device)
        r = _randint(*p["particle_r"], (1, 1), gen, device)
        particle |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    acc += particle.to(torch.int32) * p["particle_gain"]
    reach = p["cell_r"][1] - 1
    d = torch.arange(-reach, reach + 1, device=device)
    dy, dx = (t.reshape(1, -1) for t in torch.meshgrid(d, d, indexing="ij"))
    z = torch.arange(P, device=device, dtype=torch.float32).reshape(1, P, 1)
    cm, flat = p["cell_margin"], acc.view(-1)
    for n in [min(CHUNK, p["cells"] - i) for i in range(0, p["cells"], CHUNK)]:
        cy = _randint(cm, H - cm, (n, 1), gen, device)
        cx = _randint(cm, W - cm, (n, 1), gen, device)
        r = _randint(*p["cell_r"], (n, 1), gen, device)
        z0 = torch.rand((n, 1, 1), generator=gen, device=device) * P
        lo, hi = p["cell_peak"]
        peak = lo + torch.rand((n, 1, 1), generator=gen, device=device) * (hi - lo)
        gain = (peak * torch.exp(-((z - z0) / p["cell_depth"]) ** 2)).to(torch.int32)
        disc = dy * dy + dx * dx <= r * r  # [n, taps]
        pix = (cy + dy) * W + (cx + dx)  # [n, taps]
        planes = torch.arange(P, device=device).reshape(1, P, 1) * (H * W)
        idx = (planes + pix[:, None, :]).expand(n, P, pix.shape[-1])
        hit = disc[:, None, :].expand_as(idx)
        flat.index_add_(0, idx[hit], gain.expand_as(idx)[hit])
    return acc.clamp_(0, U16_MAX).to(torch.uint16)


def _reorder(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """The stack's planes permuted, each flipped by rows (bit 0) and
    columns (bit 1) of a draw of its own."""
    P = x.shape[0]
    x = x.view(torch.int16)  # few ops take uint16; the bits are moved, not read
    order = torch.randperm(P, generator=gen, device=gen.device).tolist()
    flips = torch.randint(0, 4, (P,), generator=gen, device=gen.device).tolist()
    planes = []
    for b, f in zip(order, flips):
        dims = [d for d, bit in ((0, 1), (1, 2)) if f & bit]
        planes.append(x[b].flip(dims) if dims else x[b])
    return torch.stack(planes).view(torch.uint16)


def make(p: dict, seed: int, device) -> list:
    """``p["staged"]`` distinct [batch, H, W] uint16 stacks on ``device``."""
    layout = torch.Generator(device=device)
    layout.manual_seed(p["layout_seed"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return [_reorder(_stack(p, layout, device), gen) for _ in range(p["staged"])]
