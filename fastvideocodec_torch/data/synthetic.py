"""Seeded synthetic clips (numpy only): copies of ``synth_gop``,
``synth_mv_gop``, ``synth_gop_multi`` and ``synth_gop_lowrate`` from
fastvideocodec_tpu/data/synthetic.py, with the same draw order, so that
the port imports nothing of the JAX package and both packages see
identical clips from one seed; and ``row_views``, the port's multi-view
clips at sizes ``synth_mv_gop`` does not make. The golden RD tests draw
their held-out clips from seed 123; the shipped tiny checkpoints were
trained on seed 0."""

from __future__ import annotations

import numpy as np


def _smooth(base: np.ndarray, rounds: int = 3) -> np.ndarray:
    for _ in range(rounds):
        base = (
            base
            + np.roll(base, 1, 0) + np.roll(base, -1, 0)
            + np.roll(base, 1, 1) + np.roll(base, -1, 1)
        ) / 5.0
    return (base - base.min()) / (base.max() - base.min() + 1e-6)


def synth_gop(rng: np.random.Generator, size: int = 64, gop: int = 4):
    """Smooth translating texture plus light noise: the training
    distribution of the shipped tiny checkpoints. Returns [T, H, W, 3]
    float32 in [0, 1]."""
    H = W = size
    T = gop
    base = rng.random((H * 2, W * 2, 3)).astype(np.float32)
    base = _smooth(base)
    dx, dy = rng.integers(-3, 4, size=2)
    frames = []
    ox, oy = H // 2, W // 2
    for t in range(T):
        f = base[ox + t * dy : ox + t * dy + H, oy + t * dx : oy + t * dx + W]
        f = np.clip(f + rng.normal(0, 0.01, f.shape).astype(np.float32), 0, 1)
        frames.append(f)
    return np.stack(frames)


def synth_mv_gop(rng: np.random.Generator, views: int = 3, size: int = 64,
                 gop: int = 4):
    """V offset crops of one translating texture (multi-view redundancy);
    identical draw order to the original TestGoldenRDMCVC._synth_mv_gop at
    the 3/64/4 defaults. Views 5 and 6 start a whole frame to the right
    and below, and run past the texture's edge (numpy raises on the
    stack) when the drawn motion is positive in that axis, as in the JAX
    package. Returns [T, V, H, W, 3]."""
    V = views
    H = W = size
    T = gop
    base = rng.random((H * 3, W * 3, 3)).astype(np.float32)
    base = _smooth(base)
    dx, dy = rng.integers(-3, 4, size=2)
    offs = [(0, 0), (0, W // 2), (H // 2, 0), (H // 2, W // 2),
            (0, W), (H, 0)][:V]
    frames = []
    for t in range(T):
        view_list = []
        for vy, vx in offs:
            sy, sx = H + vy + t * dy, W + vx + t * dx
            f = base[sy : sy + H, sx : sx + W]
            view_list.append(np.clip(
                f + rng.normal(0, 0.01, f.shape).astype(np.float32), 0, 1
            ))
        frames.append(np.stack(view_list))
    return np.stack(frames)  # [T, V, H, W, 3]


def synth_gop_multi(rng: np.random.Generator, size: int = 128, gop: int = 8,
                    n_objects: int = 2, max_bg_motion: int = 4,
                    max_obj_motion: int = 8, noise: float = 0.005,
                    smooth_rounds: int = 3):
    """Multi-object motion clips with real motion boundaries.

    A smooth background translates by a per-clip constant (|v| <=
    max_bg_motion px/frame); n_objects soft-edged elliptical patches of a
    DIFFERENT smooth texture ride on top, each with its own constant motion
    (|v| <= max_obj_motion px/frame). Opposite-sign vertical motions across
    an object edge give tiles up to (max_obj_motion + max_bg_motion) * T px
    of vertical source-coordinate divergence — past the Pallas v5 window
    budget, which is exactly what the kernel-vs-exact training-parity test
    needs to exercise.

    Returns [T, size, size, 3] float32 in [0, 1].
    """
    H = W = size
    T = gop
    pad = max(max_bg_motion, max_obj_motion) * T + 8
    bg = _smooth(rng.random((H + 2 * pad, W + 2 * pad, 3)).astype(np.float32),
                 rounds=smooth_rounds)
    bg_v = rng.integers(-max_bg_motion, max_bg_motion + 1, size=2)  # (dy, dx)

    objs = []
    for _ in range(n_objects):
        r_h = int(rng.integers(H // 8, H // 3))
        r_w = int(rng.integers(W // 8, W // 3))
        tex = _smooth(rng.random((2 * r_h, 2 * r_w, 3)).astype(np.float32),
                      rounds=smooth_rounds)
        # soft elliptical alpha so edges don't ring
        yy = (np.arange(2 * r_h) - r_h + 0.5) / r_h
        xx = (np.arange(2 * r_w) - r_w + 0.5) / r_w
        d = np.sqrt(yy[:, None] ** 2 + xx[None, :] ** 2)
        alpha = np.clip((1.0 - d) * 4.0, 0.0, 1.0).astype(np.float32)[..., None]
        cy = int(rng.integers(r_h, H - r_h))
        cx = int(rng.integers(r_w, W - r_w))
        v = rng.integers(-max_obj_motion, max_obj_motion + 1, size=2)
        objs.append((tex, alpha, cy, cx, v))

    frames = []
    for t in range(T):
        oy = pad + t * int(bg_v[0])
        ox = pad + t * int(bg_v[1])
        f = bg[oy : oy + H, ox : ox + W].copy()
        for tex, alpha, cy, cx, v in objs:
            py = cy + t * int(v[0]) - tex.shape[0] // 2
            px = cx + t * int(v[1]) - tex.shape[1] // 2
            y0, y1 = max(py, 0), min(py + tex.shape[0], H)
            x0, x1 = max(px, 0), min(px + tex.shape[1], W)
            if y1 <= y0 or x1 <= x0:
                continue
            ty0, tx0 = y0 - py, x0 - px
            a = alpha[ty0 : ty0 + y1 - y0, tx0 : tx0 + x1 - x0]
            f[y0:y1, x0:x1] = (
                a * tex[ty0 : ty0 + y1 - y0, tx0 : tx0 + x1 - x0]
                + (1 - a) * f[y0:y1, x0:x1]
            )
        if noise:
            f = f + rng.normal(0, noise, f.shape).astype(np.float32)
        frames.append(np.clip(f, 0, 1))
    return np.stack(frames)


def synth_gop_lowrate(rng: np.random.Generator, size: int = 128, gop: int = 8):
    """The low-entropy form of ``synth_gop_multi``: the same scene, without
    noise and smoothed over 8 rounds, so that trained codecs run at low
    rates (the low-rate golden rung, lr_* checkpoints)."""
    return synth_gop_multi(rng, size=size, gop=gop, noise=0.0, smooth_rounds=8)


def row_views(clip: np.ndarray, views: int, h: int) -> np.ndarray:
    """V views of h rows cut from one clip [T, n, W, 3] (n >= h rows): view
    v starts at row v*(n - h)//(V - 1) rounded down to a multiple of 64,
    the last at n - h (0, 320, 640 and 1024 for 4 views of 1024 rows of a
    2048-row clip), a single view at row 0. Returns [T, V, h, W, 3]."""
    n = clip.shape[1]
    rows = [0] if views == 1 else [v * (n - h) // (views - 1) // 64 * 64
                                   for v in range(views - 1)] + [n - h]
    return np.stack([clip[:, r:r + h] for r in rows], axis=1)
