"""Running averages and stage timers, ported from
fastvideocodec_tpu/utils/meters.py (``AverageMeter``, reference
models.py:1414-1430; ``StageTimers``, models.py:81-86). JAX's
``xprof_trace`` is a TPU profiler hook and has no counterpart here:
``torch.profiler`` traces the card."""

from __future__ import annotations

import contextlib
import time

import torch


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


def synchronize(device) -> None:
    """Waits for the card's queued work when ``device`` is a CUDA device;
    nothing on the CPU."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class StageTimers:
    """Named wall-clock stage meters (the reference's E-FL/E-MV/... set,
    models.py:81-86). ``with timers.stage('E-MV'): ...`` times the block;
    on a CUDA ``device`` the card is synchronised before each reading of
    the clock, so the work the block queued is inside its time."""

    STAGES = (
        "E-FL", "E-MV", "eEMV", "E-MC", "E-RES", "eERES", "E-NET",
        "D-MV", "eDMV", "D-MC", "D-RES", "eDRES", "D-NET",
    )

    def __init__(self, device=None):
        self.device = device
        self.meters = {s: AverageMeter() for s in self.STAGES}

    @contextlib.contextmanager
    def stage(self, name: str):
        if name not in self.meters:
            self.meters[name] = AverageMeter()
        synchronize(self.device)
        t0 = time.perf_counter()
        yield
        synchronize(self.device)
        self.meters[name].update(time.perf_counter() - t0)

    @property
    def encoding_time(self) -> float:
        return sum(
            self.meters[s].avg
            for s in ("E-FL", "E-MV", "E-MC", "E-RES", "D-MV", "D-MC", "D-RES")
        )

    @property
    def decoding_time(self) -> float:
        return sum(self.meters[s].avg for s in ("D-MV", "D-MC", "D-RES"))
