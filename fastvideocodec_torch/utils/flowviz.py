"""Optical-flow I/O and visualization, ported from
fastvideocodec_tpu/utils/flowviz.py (reference DVC/subnet/flowlib.py): the
Middlebury colour-wheel rendering of a flow field and the ``.flo`` file
format. Host numpy, the same arithmetic as the JAX package's (float64), so
that the same flow renders to the same bytes.

A flow here is [H, W, 2] (x then y displacement, pixels), as the files
hold it; the port's flows are [B, 2, H, W] tensors: take
``flow[b].permute(1, 2, 0).cpu().numpy()``.
"""

from __future__ import annotations

import numpy as np

_FLO_MAGIC = 202021.25


def read_flo(path: str) -> np.ndarray:
    """The [H, W, 2] float32 flow of a Middlebury ``.flo`` file."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, 1)[0]
        if magic != _FLO_MAGIC:
            raise ValueError(f"bad .flo magic in {path}")
        w = int(np.fromfile(f, np.int32, 1)[0])
        h = int(np.fromfile(f, np.int32, 1)[0])
        data = np.fromfile(f, np.float32, 2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray):
    """Writes an [H, W, 2] flow as a ``.flo`` file (float32)."""
    h, w, _ = flow.shape
    with open(path, "wb") as f:
        np.asarray([_FLO_MAGIC], np.float32).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def _color_wheel() -> np.ndarray:
    """The 55 colours of the Middlebury wheel, [55, 3] in 0..255."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    n = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((n, 3))
    col = 0
    wheel[:RY, 0] = 255
    wheel[:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


def flow_to_image(flow: np.ndarray, max_flow: float | None = None) -> np.ndarray:
    """flow [H, W, 2] -> uint8 RGB [H, W, 3] (Middlebury colour wheel): the
    hue is the direction, the saturation the length over ``max_flow`` (the
    longest vector when None or 0); longer vectors are darkened."""
    u, v = flow[..., 0].astype(np.float64), flow[..., 1].astype(np.float64)
    rad = np.sqrt(u ** 2 + v ** 2)
    maxrad = max_flow if max_flow else max(rad.max(), 1e-8)
    u, v = u / maxrad, v / maxrad
    rad = np.sqrt(u ** 2 + v ** 2)
    wheel = _color_wheel()
    n = wheel.shape[0]
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1.0) / 2.0 * (n - 1)
    k0 = np.floor(fk).astype(int) % n
    k1 = (k0 + 1) % n
    f = fk - np.floor(fk)
    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for c in range(3):
        col0 = wheel[k0, c] / 255.0
        col1 = wheel[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        img[..., c] = np.floor(255 * col).astype(np.uint8)
    return img
