"""Plain ORB extraction: the yardstick's frozen copy of the atlas path.

Plain PyTorch, float32, batched over a leading [B]: the cascaded pyramid
by antialiased resize matrices, one canvas of all levels with a 19-px
reflect apron each, the exact FAST-9 score, the dual-threshold cell
fallback and 3x3 non-maximum suppression, the per-cell top-1 selection
with a per-level budget, the intensity-centroid angle over the radius-15
disc and the rotated BRIEF-256 test on the rounded 7x7 Gaussian blur
(ORBextractor.cpp's operations, in the order whose roundings the
program under test keeps). It imports nothing of the program, and holds
no kernel: every step is ordinary tensor arithmetic.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["OrbParams", "Keypoints", "Extractor", "EDGE", "umax_table", "brief_pattern"]

EDGE = 19            # apron of every level block (ORBextractor.cpp:90)
HALF_PATCH = 15
FAST_CELL = 35       # dual-threshold fallback cell, px
SELECT_CELL = 12     # top-1-per-cell selection grid, px
RING = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3))


class OrbParams(NamedTuple):
    n_features: int
    scale_factor: float
    n_levels: int
    ini_th_fast: int
    min_th_fast: int

    @property
    def capacity(self) -> int:
        return ((self.n_features + 255) // 256) * 256

    def budgets(self) -> Tuple[int, ...]:
        inv = 1.0 / self.scale_factor
        want = self.n_features * (1 - inv) / (1 - inv ** self.n_levels)
        out, total = [], 0
        for _ in range(self.n_levels - 1):
            n = int(round(want))
            out.append(n)
            total += n
            want *= inv
        out.append(max(self.n_features - total, 0))
        return tuple(out)

    def scales(self) -> Tuple[float, ...]:
        return tuple(self.scale_factor ** i for i in range(self.n_levels))

    def level_shapes(self, h: int, w: int) -> Tuple[Tuple[int, int], ...]:
        return tuple((int(round(h / s)), int(round(w / s))) for s in self.scales())


class Keypoints(NamedTuple):
    xy: torch.Tensor      # [B, N, 2] level-0 pixel coords
    octave: torch.Tensor  # [B, N] int32
    angle: torch.Tensor   # [B, N] degrees
    desc: torch.Tensor    # [B, N, 8] int32
    valid: torch.Tensor   # [B, N] bool
    canvas_xy: torch.Tensor  # [B, N, 2] canvas coords of each keypoint (interior)


@functools.lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    pat = np.load(Path(__file__).with_name("brief_pattern.npy"))
    if pat.shape != (256, 4) or pat.dtype != np.int32:
        raise ValueError(f"bad BRIEF pattern {pat.shape} {pat.dtype}")
    return pat


@functools.lru_cache(maxsize=1)
def umax_table() -> Tuple[int, ...]:
    r = HALF_PATCH
    umax = [0] * (r + 1)
    vmax = int(np.floor(r * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(r * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(np.rint(np.sqrt(float(r * r) - v * v)))
    v0 = 0
    for v in range(r, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return tuple(umax)


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] antialiased linear resize (a triangle kernel at
    half-pixel positions, widened by the downsampling factor)."""
    scale = n_in / n_out
    c = max(scale, 1.0)
    pos = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    j = np.arange(n_in, dtype=np.float64)
    w = np.maximum(0.0, 1.0 - np.abs((pos[:, None] - j[None, :]) / c))
    s = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(s) > 1e-4, w / np.where(s == 0, 1.0, s), 0.0)
    in_range = (pos >= -0.5) & (pos <= n_in - 0.5)
    return np.where(in_range[:, None], w, 0.0).astype(np.float32)


def reflect_pad(img: torch.Tensor, pad: int) -> torch.Tensor:
    h, w = img.shape[-2:]
    out = F.pad(img.reshape((-1, 1, h, w)), (pad, pad, pad, pad), mode="reflect")
    return out.reshape(img.shape[:-2] + out.shape[-2:])


def blur(img: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Separable 7x7 Gaussian, reflect-101 border, rows then columns, each a
    left-to-right sum of ``k[i] * shifted``."""
    k = taps.shape[0]
    r = k // 2
    p = reflect_pad(img, r)
    h, w = img.shape[-2:]
    horiz = sum(taps[i] * p[..., :, i: i + w] for i in range(k))
    return sum(taps[i] * horiz[..., i: i + h, :] for i in range(k))


def fast_score(padded: torch.Tensor, pad: int = EDGE) -> torch.Tensor:
    """Exact FAST-9 score max(bright, dark) of every interior pixel."""
    h = padded.shape[-2] - 2 * pad
    w = padded.shape[-1] - 2 * pad
    c = padded[..., pad: pad + h, pad: pad + w]
    ring = torch.stack([padded[..., pad + dy: pad + dy + h, pad + dx: pad + dx + w]
                        for dx, dy in RING])
    d = ring - c[None]
    return torch.maximum(_arc_max_min(d), _arc_max_min(-d))


def _arc_max_min(d: torch.Tensor) -> torch.Tensor:
    d24 = torch.cat([d, d[:8]], dim=0)
    m2 = torch.minimum(d24[:-1], d24[1:])
    m4 = torch.minimum(m2[:-2], m2[2:])
    m8 = torch.minimum(m4[:-4], m4[4:])
    return torch.minimum(m8[:16], d24[8:24]).amax(dim=0)


def _cell_max(x: torch.Tensor, cs: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    lead = x.shape[:-2]
    ph, pw = (-h) % cs, (-w) % cs
    xp = F.pad(x, (0, pw, 0, ph), value=float("-inf"))
    ny, nx = (h + ph) // cs, (w + pw) // cs
    cells = xp.reshape(lead + (ny, cs, nx, cs)).amax(dim=(-3, -1))
    back = cells[..., :, None, :, None].expand(lead + (ny, cs, nx, cs))
    return back.reshape(lead + (ny * cs, nx * cs))[..., :h, :w]


def detect(score: torch.Tensor, ini_th: int, min_th: int, pad: int = EDGE) -> torch.Tensor:
    h, w = score.shape[-2:]
    b = pad - 3
    ys = torch.arange(h, device=score.device)[:, None]
    xs = torch.arange(w, device=score.device)[None, :]
    region = (ys >= b) & (ys < h - b) & (xs >= b) & (xs < w - b)
    score = torch.where(region, score, 0.0)
    hi = score > ini_th
    lo = score > min_th
    cm = _cell_max(torch.where(hi, score, 0.0), FAST_CELL)
    score = torch.where(hi | (lo & ~(cm > ini_th)), score, 0.0)
    pooled = F.max_pool2d(score.reshape((-1, 1, h, w)), 3, stride=1, padding=1)
    return torch.where((score >= pooled.reshape(score.shape)) & (score > 0.0), score, 0.0)


def select(score: torch.Tensor, budget: int, cs: int = SELECT_CELL):
    """Per-cell argmax, then the ``budget`` best cells by a stable
    descending sort: (xy [B, budget, 2], response, valid)."""
    h, w = score.shape[-2:]
    lead = score.shape[:-2]
    ph, pw = (-h) % cs, (-w) % cs
    ny, nx = (h + ph) // cs, (w + pw) // cs
    if ny * nx < budget:
        raise ValueError(f"{ny}x{nx} cells hold fewer than a budget of {budget}")
    sp = F.pad(score, (0, pw, 0, ph))
    cells = sp.reshape(lead + (ny, cs, nx, cs)).transpose(-3, -2).reshape(lead + (ny * nx, cs * cs))
    best, arg = cells.max(dim=-1)
    order = torch.sort(best, dim=-1, descending=True, stable=True).indices[..., :budget]
    resp = best.gather(-1, order)
    flat = arg.gather(-1, order)
    y = (order // nx) * cs + flat // cs
    x = (order % nx) * cs + flat % cs
    return torch.stack([x, y], dim=-1).to(torch.float32), resp, resp > 0.0


def disc_moments(canvas: torch.Tensor, yc: torch.Tensor, xc: torch.Tensor,
                 umax: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m10, m01) of the radius-15 disc round canvas pixels (yc, xc) [N]:
    per row dx = 1..umax[|dy|] accumulated, then rows dy = -15..15."""
    r = HALF_PATCH
    h, w = canvas.shape
    off = torch.arange(-r, r + 1, device=canvas.device)
    rows = (yc.long()[:, None] + off).clamp(0, h - 1)
    cols = (xc.long()[:, None] + off).clamp(0, w - 1)
    win = canvas[rows[:, :, None], cols[:, None, :]]
    t_acc = torch.zeros_like(win[:, :, r])
    u_acc = win[:, :, r]
    T, U = [t_acc], [u_acc]
    for dx in range(1, r + 1):
        plus, minus = win[:, :, r + dx], win[:, :, r - dx]
        t_acc = t_acc + dx * (plus - minus)
        u_acc = u_acc + plus + minus
        T.append(t_acc)
        U.append(u_acc)
    m10 = m01 = canvas.new_zeros(yc.shape[0])
    for dy in range(-r, r + 1):
        u = int(umax[abs(dy)])
        m10 = m10 + T[u][:, r + dy]
        if dy != 0:
            m01 = m01 + dy * U[u][:, r + dy]
    return m10, m01


def sample_coords(xy: torch.Tensor, angle: torch.Tensor, pattern_xy: torch.Tensor,
                  hp: int, wp: int, pad: int = EDGE):
    """(sy, sx) [N, 512] int64: the BRIEF pattern rotated by each keypoint's
    angle, rounded, round the keypoints at integer canvas-interior coords
    ``xy`` and clamped to the padded [hp, wp] canvas."""
    px, py = pattern_xy[0], pattern_xy[1]
    th = torch.deg2rad(angle)
    ca, sa = torch.cos(th), torch.sin(th)
    rx = torch.round(px[None, :] * ca[:, None] - py[None, :] * sa[:, None])
    ry = torch.round(px[None, :] * sa[:, None] + py[None, :] * ca[:, None])
    sx = ((xy[:, 0:1] + rx).to(torch.int32) + pad).clamp(0, wp - 1).long()
    sy = ((xy[:, 1:2] + ry).to(torch.int32) + pad).clamp(0, hp - 1).long()
    return sy, sx


def describe(blurred_round: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor,
             pattern_xy: torch.Tensor, pad: int = EDGE) -> torch.Tensor:
    """rBRIEF words [N, 8] int32 at integer canvas-interior coords ``xy``."""
    hp, wp = blurred_round.shape
    sy, sx = sample_coords(xy, angle, pattern_xy, hp, wp, pad)
    vals = blurred_round.reshape(-1)[sy * wp + sx]
    bits = vals[:, :256] < vals[:, 256:]
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits.reshape(-1, 8, 32).to(torch.int64) << shifts).sum(dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


class Extractor:
    """The plain extractor for one image size and ``OrbParams``."""

    def __init__(self, height: int, width: int, p: OrbParams, device):
        self.p, self.h, self.w = p, height, width
        self.shapes = p.level_shapes(height, width)
        offs, row = [], 0
        for hl, _ in self.shapes:
            offs.append(row)
            row += hl + 2 * EDGE
        self.offsets, self.canvas_h = tuple(offs), row
        wc = max(wl for _, wl in self.shapes) + 2 * EDGE
        self.canvas_w = ((wc + 127) // 128) * 128
        self.resize = [(torch.tensor(resize_matrix(h0, h1), device=device),
                        torch.tensor(resize_matrix(w0, w1), device=device))
                       for (h0, w0), (h1, w1) in zip(self.shapes[:-1], self.shapes[1:])]
        x = torch.arange(-3, 4, dtype=torch.float32, device=device)
        k = torch.exp(-(x * x) / 8.0)
        self.taps = k / k.sum()
        pat = brief_pattern()
        self.pattern_xy = torch.tensor(
            np.stack([np.concatenate([pat[:, 0], pat[:, 2]]),
                      np.concatenate([pat[:, 1], pat[:, 3]])]), dtype=torch.float32,
            device=device)
        self.umax = umax_table()

    def canvas(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W] -> [B, canvas_h, canvas_w]: the padded levels stacked."""
        blocks, cur = [], images
        for lvl in range(len(self.shapes)):
            if lvl > 0:
                mh, mw = self.resize[lvl - 1]
                cur = (mh @ cur) @ mw.T
            padded = reflect_pad(cur, EDGE)
            blocks.append(F.pad(padded, (0, self.canvas_w - padded.shape[-1])))
        return torch.cat(blocks, dim=-2)

    def __call__(self, images: torch.Tensor) -> Keypoints:
        p = self.p
        canvas = self.canvas(images)
        score = fast_score(canvas)
        blurred = blur(canvas, self.taps)
        xy_c, xs, valids = [], [], []
        for lvl, ((hl, wl), off) in enumerate(zip(self.shapes, self.offsets)):
            det = detect(score[..., off: off + hl, :wl], p.ini_th_fast, p.min_th_fast)
            xy, _, valid = select(det, p.budgets()[lvl])
            xy_c.append(torch.stack([xy[..., 0], xy[..., 1] + float(off)], dim=-1))
            xs.append(xy * p.scales()[lvl])
            valids.append(valid)
        xy_c = torch.cat(xy_c, dim=-2)
        yc = xy_c[..., 1].to(torch.int32) + EDGE
        xc = xy_c[..., 0].to(torch.int32) + EDGE
        angles, descs = [], []
        for b in range(images.shape[0]):
            m10, m01 = disc_moments(canvas[b], yc[b], xc[b], self.umax)
            ang = torch.rad2deg(torch.atan2(m01, m10))
            ang = torch.where(ang < 0, ang + 360.0, ang)
            angles.append(ang)
            descs.append(describe(torch.round(blurred[b]), xy_c[b], ang, self.pattern_xy))
        B, dev = images.shape[0], images.device
        octave = torch.cat([torch.full((n,), lvl, dtype=torch.int32, device=dev)
                            for lvl, n in enumerate(p.budgets())]).expand(B, -1)
        pad_n = p.capacity - xy_c.shape[-2]
        return Keypoints(
            xy=F.pad(torch.cat(xs, dim=-2), (0, 0, 0, pad_n)),
            octave=F.pad(octave, (0, pad_n)),
            angle=F.pad(torch.stack(angles), (0, pad_n)),
            desc=F.pad(torch.stack(descs), (0, 0, 0, pad_n)),
            valid=F.pad(torch.cat(valids, dim=-1), (0, pad_n)),
            canvas_xy=F.pad(xy_c, (0, 0, 0, pad_n)))
