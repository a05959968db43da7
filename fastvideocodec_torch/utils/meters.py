"""Running averages, ported from fastvideocodec_tpu/utils/meters.py
(``AverageMeter``, reference models.py:1414-1430). The JAX package's
stage timers and xprof trace wait for the entry points that use them."""

from __future__ import annotations


class AverageMeter:
    """Running average (reference models.py:1414-1430)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
