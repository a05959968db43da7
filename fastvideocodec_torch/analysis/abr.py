"""BOLA adaptive-bitrate simulation over bandwidth traces, ported from
fastvideocodec_tpu/analysis/abr.py (reference simulation.py:19-345).

A BOLA-style buffer-based level selector downloads GOP segments over a
throughput/latency trace; a decode queue (per-level decode-time tables)
models the client's playback. The result: QoE = mean quality - gamma *
rebuffer ratio, with the quality, the rebuffer ratio, the stall frequency
and the bandwidth used. Defaults are the reference's: GOP 16, 2048x1024 at
30 fps, a 60 s buffer. Host numpy in float64, the JAX package's arithmetic
in its order, so that the same tables and traces give the same numbers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class AbrConfig:
    gop: int = 16
    fps: int = 30
    width: int = 2048
    height: int = 1024
    q_max: float = 60.0   # max buffer seconds (simulation.py Q_max)
    q_low: float = 10.0
    trace_dur: float = 10.0  # seconds per trace sample
    use_psnr_utility: bool = True

    @property
    def seg_seconds(self) -> float:
        return self.gop / self.fps

    @property
    def pix_per_sec(self) -> float:
        return self.width * self.height * self.fps


def segment_tables(per_level_psnr, per_level_bpp, per_level_dect, cfg: AbrConfig):
    """[levels, segments] tables of PSNR, bitrate (bits/s) and decode time
    (s a GOP) from each level's per-frame PSNR list, its bpp and its decode
    seconds a frame (the reference parses these from the two-line eval
    logs, simulation.py:113-205)."""
    levels = len(per_level_psnr)
    num_segments = min(len(p) for p in per_level_psnr) // cfg.gop
    all_psnr = np.zeros((levels, num_segments))
    all_bitrate = np.zeros((levels, num_segments))
    all_dect = np.zeros((levels, num_segments))
    for lvl in range(levels):
        p = np.asarray(per_level_psnr[lvl][: num_segments * cfg.gop])
        all_psnr[lvl] = p.reshape(num_segments, cfg.gop).mean(axis=-1)
        all_bitrate[lvl] = per_level_bpp[lvl] * cfg.pix_per_sec
        all_dect[lvl] = per_level_dect[lvl] * cfg.gop
    return all_psnr, all_bitrate, all_dect


def bola_simulate(
    all_psnr: np.ndarray,
    all_bitrate: np.ndarray,
    all_dect: np.ndarray,
    downthrpt: np.ndarray,
    latency: np.ndarray,
    cfg: AbrConfig = AbrConfig(),
):
    """One trace run: (QoE, mean quality, rebuffer ratio, stall frequency,
    mean bandwidth)."""
    p = cfg.seg_seconds
    rates = np.sort(all_bitrate.mean(axis=-1))
    psnrs = np.sort(all_psnr.mean(axis=-1))
    s1, s2 = rates[0] * p, rates[1] * p
    if cfg.use_psnr_utility:
        v1, v2, v_max = psnrs[0], psnrs[1], psnrs[-1]
    else:
        v1, v2, v_max = 0.0, np.log(s2 / s1), np.log(rates[-1] * p / s1)
    alpha = (s1 * v2 - s2 * v1) / (s2 - s1)
    V = (cfg.q_max - cfg.q_low) / (v_max + alpha)
    gamma = (v_max * cfg.q_low + alpha * cfg.q_max) / (cfg.q_max - cfg.q_low) / p

    levels, num_segments = all_psnr.shape
    t_download = 0.0
    buf_virtual = 0.0
    buf_real = 0.0
    t_decode_done = 0.0
    stalls = 0
    quality_sum = 0.0
    remaining = num_segments
    trace_idx = 0

    def utility(lvl, seg):
        if cfg.use_psnr_utility:
            return all_psnr[lvl, seg]
        return np.log(all_bitrate[lvl, seg] / s1)

    while remaining > 0:
        seg = num_segments - remaining
        # BOLA's objective rho per level: the argmax of the non-negative ones
        best, best_rho = -1, -1e9
        for lvl in range(levels):
            rho = (V * utility(lvl, seg) + V * gamma * p - buf_virtual) / (
                all_bitrate[lvl, seg] * p
            )
            if rho >= 0 and rho > best_rho:
                best_rho, best = rho, lvl
        if best == -1:
            # the buffer is too full: drain until the best level is viable
            target = V * max(utility(l, seg) for l in range(levels)) + V * gamma * p
            t_download += buf_virtual - target
            buf_virtual = target
            continue

        # download the segment over the piecewise-constant bandwidth trace
        remain_bits = all_bitrate[best, seg] * p
        while remain_bits > 0:
            trace_idx = min(int(t_download / cfg.trace_dur), len(downthrpt) - 1)
            trace_end = (trace_idx + 1) * cfg.trace_dur
            can = (trace_end - t_download) * downthrpt[trace_idx]
            if can >= remain_bits:
                t_download += remain_bits / downthrpt[trace_idx]
                remain_bits = 0.0
            else:
                t_download = trace_end
                remain_bits -= can
        t_download += latency[trace_idx] if len(latency) else 0.0

        remaining -= 1
        quality_sum += all_psnr[best, seg]

        # the decode queue
        last_done = t_decode_done
        t_decode_done = max(t_decode_done, t_download) + all_dect[best, seg]
        if buf_real < (t_decode_done - last_done):
            stalls += 1
        buf_virtual = p + max(buf_virtual - (t_decode_done - last_done), 0.0)
        buf_real = p + max(buf_real - (t_decode_done - last_done), 0.0)

    mean_bw = float(np.mean(downthrpt[: trace_idx + 1]))
    finish_time = t_decode_done + buf_virtual
    rebuffer_ratio = finish_time / (num_segments * p) - 1.0
    stall_freq = stalls / num_segments
    mean_quality = quality_sum / num_segments
    qoe = mean_quality - gamma * rebuffer_ratio
    return qoe, mean_quality, rebuffer_ratio, stall_freq, mean_bw
