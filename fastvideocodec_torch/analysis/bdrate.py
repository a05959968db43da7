"""BD-rate / BD-PSNR (Bjøntegaard deltas): the port's own copy of
fastvideocodec_tpu/analysis/bdrate.py, a cubic polynomial fit of PSNR
against log10(bpp) (or the reverse) integrated over the interval where
the two curves overlap."""

from __future__ import annotations

import numpy as np


def _fit_and_integrate(x, y, lo, hi):
    p = np.polyfit(x, y, 3)
    pint = np.polyint(p)
    return np.polyval(pint, hi) - np.polyval(pint, lo)


def bd_psnr(rate_anchor, psnr_anchor, rate_test, psnr_test) -> float:
    """Average PSNR gain (dB) of test over anchor at equal rate."""
    la, lt = np.log10(np.asarray(rate_anchor)), np.log10(np.asarray(rate_test))
    lo = max(la.min(), lt.min())
    hi = min(la.max(), lt.max())
    if hi <= lo:
        raise ValueError("RD curves do not overlap in rate")
    int_a = _fit_and_integrate(la, np.asarray(psnr_anchor), lo, hi)
    int_t = _fit_and_integrate(lt, np.asarray(psnr_test), lo, hi)
    return (int_t - int_a) / (hi - lo)


def bd_rate(rate_anchor, psnr_anchor, rate_test, psnr_test) -> float:
    """Average rate delta (%) of test against anchor at equal quality;
    negative: test needs fewer bits."""
    pa, pt = np.asarray(psnr_anchor), np.asarray(psnr_test)
    la, lt = np.log10(np.asarray(rate_anchor)), np.log10(np.asarray(rate_test))
    lo = max(pa.min(), pt.min())
    hi = min(pa.max(), pt.max())
    if hi <= lo:
        raise ValueError("RD curves do not overlap in quality")
    int_a = _fit_and_integrate(pa, la, lo, hi)
    int_t = _fit_and_integrate(pt, lt, lo, hi)
    avg_exp_diff = (int_t - int_a) / (hi - lo)
    return (10 ** avg_exp_diff - 1) * 100
