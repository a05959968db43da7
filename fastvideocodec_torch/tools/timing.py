"""Timing on the card, shared by ``chip_smoke.py``, ``warp_ab.py`` and the
tools (``speed_sweep``, ``warp_bench``): CUDA events over warm calls
(``cuda_ms``), one launch with the L2 cache flushed first (``cold_ms``),
the kernels' device time under ``torch.profiler`` (``device_ms``), the
host's time to enqueue (``host_ms``, ``timed_runs``), and a warp's byte
bound (``bound_ms``). The functions take the ``torch`` module as their
first argument, as the scripts that import it late pass it. The card's
rates are the H100 SXM's data-sheet figures.
"""

from __future__ import annotations

import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
FLUSH_BYTES = 256 * 2**20  # written between launches: five times the 50 MB L2


def cuda_ms(torch, fn, *args, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of fn(*args) on the card, by CUDA events."""
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(torch, fn, *args, flush, reps: int = 5) -> float:
    """Mean milliseconds of one launch of fn(*args) on the card with the L2
    cache flushed first: a write of ``flush`` (FLUSH_BYTES) before each
    launch, the launch alone between two CUDA events. A spin of the card
    (torch.cuda._sleep, about 0.2 ms) after the flush lets the host enqueue
    the launch before the start event fires, so the events time the kernel
    and not the host's call."""
    fn(*args)
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        torch.cuda._sleep(400_000)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_ms(torch, fn, inputs, reps: int = 3):
    """(mean device milliseconds of one pass of fn(*args) over ``inputs``,
    kernels a call): under torch.profiler, the sum of the spans of the
    kernels the calls launch on the card, the host's calls left out; None
    where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for args in inputs:
                fn(*args)
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        return None, 0.0
    return sum(spans) / 1e3 / reps, len(spans) / (reps * len(inputs))


def host_ms(torch, fn, inputs, reps: int = 20) -> float:
    """Mean host milliseconds to enqueue one pass of fn(*args) over
    ``inputs``: the host clock around ``reps`` passes, the card
    synchronised before the start only (the queue holds them all)."""
    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        for args in inputs:
            fn(*args)
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e3 / reps


def timed_runs(torch, fn, *args, runs: int = 3) -> tuple:
    """(card ms, host enqueue ms) of each of ``runs`` calls: CUDA events
    around the call, and the host clock until the call returns, before
    the card is waited for."""
    times, enqueue = [], []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        fn(*args)
        enqueue.append((time.perf_counter() - t0) * 1e3)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times, enqueue


def bound_ms(img, flow) -> float:
    """Least milliseconds for one warp on the card: each input read once and
    the output written once (each tensor at its own element size), over the
    HBM rate. The arithmetic (about 40 float ops of coordinates per output
    pixel and 9 per channel) is far below the float32 rate, so bytes bound
    it."""
    nbytes = 2 * img.numel() * img.element_size() + flow.numel() * flow.element_size()
    pixels = flow.numel() // 2  # full-resolution output pixels, for every flow layout
    flops = pixels * (40 + 9 * img.numel() // pixels)
    if flops / F32_FLOPS >= nbytes / HBM_BYTES_PER_S:
        raise ValueError("warp bound by operations")
    return nbytes / HBM_BYTES_PER_S * 1e3
