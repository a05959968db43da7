"""Vimeo-90k septuplet training data, ported from
fastvideocodec_tpu/data/vimeo.py (reference FrameDataset,
dataset.py:129-171): 7-frame clips, one RandomResizedCrop shared across the
7 frames, [7, S, S, 3] float32 NHWC numpy arrays in [0, 1], as the JAX
package gives them. PIL is imported where the images are read, so the
package imports without it."""

from __future__ import annotations

import os
import random

import numpy as np


class FrameDataset:
    def __init__(self, root_dir: str, frame_size: int = 256, split: str = "train"):
        self._dir = os.path.join(root_dir, "sequences")
        self._frame_size = frame_size
        list_file = os.path.join(
            root_dir, "sep_trainlist.txt" if split == "train" else "sep_testlist.txt"
        )
        with open(list_file) as f:
            self._samples = [ln.strip() for ln in f if ln.strip()]

    def __len__(self):
        return len(self._samples)

    def _random_resized_crop_params(self, w, h, rng: random.Random):
        """torchvision RandomResizedCrop defaults: scale (0.08, 1.0),
        ratio (3/4, 4/3)."""
        area = w * h
        for _ in range(10):
            target_area = rng.uniform(0.08, 1.0) * area
            aspect = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                x = rng.randint(0, w - cw)
                y = rng.randint(0, h - ch)
                return x, y, cw, ch
        s = min(w, h)
        return (w - s) // 2, (h - s) // 2, s, s

    def __getitem__(self, idx):
        from PIL import Image

        seq = self._samples[idx % len(self._samples)]
        # the crop follows Python's hash of the sample, as the JAX package's
        # does: the same within one process (str hashing is salted per run)
        rng = random.Random(hash((idx, seq)))
        frames = []
        box = None
        for i in range(1, 8):
            with Image.open(os.path.join(self._dir, seq, f"im{i}.png")) as im:
                img = im.convert("RGB")
            if box is None:
                x, y, cw, ch = self._random_resized_crop_params(*img.size, rng)
                box = (x, y, x + cw, y + ch)
            img = img.crop(box).resize(
                (self._frame_size, self._frame_size), Image.BILINEAR
            )
            frames.append(np.asarray(img, dtype=np.float32) / 255.0)
        return np.stack(frames)  # [7, S, S, 3]
