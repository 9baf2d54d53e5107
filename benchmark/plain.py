"""Plain PyTorch image operations for the benchmark's inputs and references.

Nothing here imports the program under test.  Each function is written from
the definition of what it computes, on [B, H, W] blocks of planes on any
device, with no iteration budget: the loops run to their fixpoint.  The
integer and float types are parameters, so that the lower-precision control
(``control.py``) runs the same code in int16 or bfloat16.
"""

from __future__ import annotations

import torch

OFFSETS4 = ((-1, 0), (1, 0), (0, -1), (0, 1))
OFFSETS8 = OFFSETS4 + ((-1, -1), (-1, 1), (1, -1), (1, 1))

# the float32 sentinel of an unreached watershed cost (3.4e38 rounded to
# float32); the int32 "no label" sentinel
F32_INF = 3.4e38
I32_BIG = 2**31 - 1

# a fixpoint that runs past this many rounds is reported as not converged
MAX_ROUNDS = 1 << 14


def shifted(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """``out[..., r, c] = x[..., r - dy, c - dx]``; ``fill`` where that lies
    outside the plane."""
    H, W = x.shape[-2:]
    out = torch.full_like(x, fill)
    out[..., max(0, dy):H - max(0, -dy), max(0, dx):W - max(0, -dx)] = (
        x[..., max(0, -dy):H - max(0, dy), max(0, -dx):W - max(0, dx)]
    )
    return out


def inside(shape, dy: int, dx: int, device) -> torch.Tensor:
    """bool [H, W]: True where the neighbour at offset (-dy, -dx) lies in
    the plane."""
    return shifted(torch.ones(shape[-2:], dtype=torch.bool, device=device), dy, dx, False)


def symmetric_index(n: int, half: int, device) -> torch.Tensor:
    """Source index of each position of an axis padded by ``half`` as scipy's
    mode 'reflect' pads it (-1 -> 0, -2 -> 1, n -> n - 1)."""
    i = torch.arange(-half, n + half, device=device) % (2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def median_filter(x: torch.Tensor, size: int, num_classes: int) -> torch.Tensor:
    """``scipy.ndimage.median_filter(x, size, mode='reflect')`` of integer
    planes [B, H, W] whose values are clamped to ``num_classes - 1``: the
    median of a window is the least value v whose count of values <= v
    reaches the middle rank."""
    B, H, W = x.shape
    half = size // 2
    xp = x.clamp(max=num_classes - 1)
    xp = xp.index_select(-2, symmetric_index(H, half, x.device))
    xp = xp.index_select(-1, symmetric_index(W, half, x.device))
    rank = size * size // 2 + 1
    med = torch.zeros((B, H, W), dtype=torch.int16, device=x.device)
    for v in range(num_classes - 1):
        le = (xp <= v).to(torch.int16)
        rows = sum(le[..., :, o:o + W] for o in range(size))
        count = sum(rows[..., o:o + H, :] for o in range(size))
        med += (count < rank).to(torch.int16)
    return med.to(x.dtype)


def _run_min(lab: torch.Tensor, vals: torch.Tensor, big) -> torch.Tensor:
    """Each pixel takes the least label of its run: the stretch of equal
    ``vals`` along its row that holds it."""
    start = torch.ones(vals.shape, dtype=torch.bool, device=vals.device)
    start[..., 1:] = vals[..., 1:] != vals[..., :-1]
    run = torch.cumsum(start.flatten(), 0) - 1
    least = torch.full((lab.numel(),), big, dtype=lab.dtype, device=lab.device)
    least.scatter_reduce_(0, run, lab.flatten(), reduce="amin")
    return least[run].reshape(lab.shape)


def ccl(vals: torch.Tensor, connectivity: int = 8, background=None,
        dtype: torch.dtype = torch.int32):
    """Connected components of equal values in [B, H, W] planes (4- or
    8-connected), each pixel labelled with the least linear index in its
    plane of a pixel of its component, -1 where ``vals`` equals
    ``background``.  Labels are held in ``dtype`` (int16 wraps: the
    control).  Returns (labels, converged)."""
    B, H, W = vals.shape
    big = torch.iinfo(dtype).max
    lin = torch.arange(H * W, device=vals.device).to(dtype).reshape(1, H, W).expand(B, H, W)
    fg = (torch.ones(vals.shape, dtype=torch.bool, device=vals.device) if background is None
          else vals != background)
    offsets = OFFSETS8 if connectivity == 8 else OFFSETS4
    links = [fg & inside(vals.shape, dy, dx, vals.device) & (shifted(vals, dy, dx, 0) == vals)
             for dy, dx in offsets]
    cols = vals.transpose(-1, -2).contiguous()
    lab = torch.where(fg, lin, big)
    converged = False
    for _ in range(MAX_ROUNDS):
        new = lab
        for (dy, dx), link in zip(offsets, links):
            new = torch.where(link, torch.minimum(new, shifted(lab, dy, dx, big)), new)
        new = _run_min(new, vals, big)
        new = _run_min(new.transpose(-1, -2).contiguous(), cols, big).transpose(-1, -2)
        flat = torch.where(fg, new, big).reshape(B, H * W)
        for _ in range(2):  # pointer jumping
            hop = torch.gather(flat, 1, flat.to(torch.int64).clamp(0, H * W - 1))
            flat = torch.minimum(flat, hop)
        new = torch.where(fg, flat.reshape(B, H, W), big)
        if torch.equal(new, lab):
            converged = True
            break
        lab = new
    return torch.where(fg, lab, torch.full_like(lab, -1)), converged


def compact(raw: torch.Tensor, dtype: torch.dtype = torch.int32):
    """Component ids in raster order of each component's first pixel:
    (seg [B, H, W], num [B]) from ``ccl``'s labels; 0 on background."""
    B, H, W = raw.shape
    flat = raw.reshape(B, H * W)
    lin = torch.arange(H * W, device=raw.device).to(raw.dtype)
    fg = flat >= 0
    prefix = torch.cumsum((fg & (flat == lin)).to(torch.int64), dim=1)
    seg = torch.where(fg, torch.gather(prefix, 1, flat.to(torch.int64).clamp(0, H * W - 1)), 0)
    return seg.to(dtype).reshape(B, H, W), prefix[:, -1].to(dtype)


def binned_sums(ids: torch.Tensor, weights, R: int) -> torch.Tensor:
    """int64 [B, R + 1]: the sum of ``weights`` (broadcast to ``ids``'
    [B, H, W]; 1 where None) over the pixels of each id in [0, R]; other
    ids are dropped."""
    B = ids.shape[0]
    flat = ids.reshape(B, -1).to(torch.int64)
    keep = (flat >= 0) & (flat <= R)
    bins = torch.where(keep, flat + (R + 1) * torch.arange(B, device=ids.device)[:, None],
                       B * (R + 1)).flatten()
    src = (torch.ones_like(bins) if weights is None
           else weights.expand(ids.shape).reshape(-1).to(torch.int64))
    out = torch.zeros(B * (R + 1) + 1, dtype=torch.int64, device=ids.device)
    out.index_add_(0, bins, src)
    return out[:-1].reshape(B, R + 1)


def edt_sq(feature: torch.Tensor) -> torch.Tensor:
    """int64 [B, H, W]: the squared Euclidean distance of every pixel to the
    nearest True pixel of ``feature`` in its plane.

    Each row's distance to its nearest feature, then the least of
    ``dy² + row distance²`` over rows within K; the result is exact once
    no distance exceeds K, and K doubles until it does (or spans the
    plane)."""
    B, H, W = feature.shape
    far = H + W
    col = torch.arange(W, device=feature.device)
    left = torch.where(feature, col, -far).cummax(-1).values
    right = torch.where(feature, col, W + far).flip(-1).cummin(-1).values.flip(-1)
    f2 = torch.minimum(col - left, right - col).to(torch.int64) ** 2
    inf = torch.iinfo(torch.int64).max // 4
    k = 32
    while True:
        d2 = f2.clone()
        for dy in range(1, min(k, H - 1) + 1):
            d2 = torch.minimum(d2, shifted(f2, dy, 0, inf) + dy * dy)
            d2 = torch.minimum(d2, shifted(f2, -dy, 0, inf) + dy * dy)
        if k >= H or int(d2.max()) <= k * k:
            return d2
        k *= 2


def local_maxima(v: torch.Tensor) -> torch.Tensor:
    """bool [B, H, W]: ``skimage.morphology.local_maxima`` (8-connected,
    plateaus, borders allowed): pixels whose 8-connected plateau of equal
    values has no strictly higher neighbour."""
    B, H, W = v.shape
    higher = torch.zeros(v.shape, dtype=torch.bool, device=v.device)
    for dy, dx in OFFSETS8:
        higher |= inside(v.shape, dy, dx, v.device) & (shifted(v, dy, dx, 0) > v)
    comp, converged = ccl(v, 8)
    if not converged:
        raise RuntimeError("local_maxima: the plateau labelling did not converge")
    key = comp.to(torch.int64) + (H * W) * torch.arange(B, device=v.device)[:, None, None]
    flag = torch.zeros(B * H * W, dtype=torch.bool, device=v.device)
    flag[key[higher]] = True
    return ~flag[key]


def shift_planes(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Each plane of [B, H, W] rolled by its own (rows, columns) drawn from
    ``gen``."""
    B, H, W = x.shape
    dy = torch.randint(0, H, (B,), generator=gen, device=gen.device).tolist()
    dx = torch.randint(0, W, (B,), generator=gen, device=gen.device).tolist()
    return torch.stack([torch.roll(x[b], (dy[b], dx[b]), dims=(0, 1)) for b in range(B)])
