"""MMPTracking multi-camera data, ported from
fastvideocodec_tpu/data/multiview.py (reference MultiViewVideoDataset,
dataset.py:175-266): five categories of 4 to 6 camera views, GOPs of
[GOP, V, 3, S, S] float32 NCHW numpy arrays in [0, 1] (the JAX package's
[GOP, V, S, S, 3] arrays, transposed), an 80/20 train/test split by frame
id, and a streaming-rate simulator (``sample``) that grows the train pool
as the camera-to-server ratio dictates. PIL is imported where the images
are read, so the package imports without it."""

from __future__ import annotations

import os

import numpy as np

CATEGORY_VIEWS = {
    "retail_0": 6, "lobby_0": 4, "industry_safety_0": 4,
    "cafe_shop_0": 4, "office_0": 5,
}
CATEGORIES = list(CATEGORY_VIEWS)


class MultiViewVideoDataset:
    """The frames of category ``category_id`` are
    ``{root_dir}/{category}/rgb_{frame id}_{view}.jpg`` (views from 1); a
    GOP holds ``gop_size`` consecutive frame ids, every view of each,
    resized to ``frame_size`` square."""

    def __init__(self, root_dir: str, category_id: int = 0, gop_size: int = 16,
                 frame_size: int = 256, split: str = "train", c2s_ratio: float = 1.0,
                 sample_interval: int = 0, max_pool_size: int = 0):
        self.category = CATEGORIES[category_id]
        self.num_views = CATEGORY_VIEWS[self.category]
        self.gop_size = gop_size
        self.frame_size = frame_size
        self.c2s_ratio = c2s_ratio
        self.sample_interval = sample_interval
        self.max_pool_size = max_pool_size
        self._dir = os.path.join(root_dir, self.category)
        frame_ids = sorted({f.split("_")[1] for f in os.listdir(self._dir)
                            if f.endswith(".jpg")})
        cut = int(len(frame_ids) * 0.8)
        self._frame_ids = frame_ids[:cut] if split == "train" else frame_ids[cut:]
        self._pool_size = len(self._frame_ids)

    def __len__(self):
        return max(0, self._pool_size - self.gop_size)

    def sample(self, step: int) -> int:
        """Streaming-rate pool growth (dataset.py:231-236): every
        ``sample_interval`` steps the pool grows by gop * c2s_ratio frames,
        up to the split's frames and ``max_pool_size`` (when > 0). Returns
        the pool's size."""
        if self.sample_interval > 0:
            grown = int(self.gop_size
                        + step // self.sample_interval * self.gop_size * self.c2s_ratio)
            self._pool_size = min(len(self._frame_ids), grown)
            if self.max_pool_size > 0:
                self._pool_size = min(self._pool_size, self.max_pool_size)
        return self._pool_size

    def _load(self, frame_id: str, view: int) -> np.ndarray:
        from PIL import Image

        path = os.path.join(self._dir, f"rgb_{frame_id}_{view + 1}.jpg")
        with Image.open(path) as im:
            img = im.convert("RGB").resize((self.frame_size, self.frame_size), Image.BILINEAR)
        return np.asarray(img, dtype=np.float32).transpose(2, 0, 1) / 255.0

    def __getitem__(self, idx):
        start = idx % max(1, self._pool_size - self.gop_size)
        return np.stack([
            np.stack([self._load(self._frame_ids[start + t], v) for v in range(self.num_views)])
            for t in range(self.gop_size)])  # [GOP, V, 3, S, S]
