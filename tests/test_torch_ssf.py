"""The SSF-TPU slice of the port against the JAX package, on the CPU, in
float32 (and one bfloat16 case).

Both packages code the same synth_gop_multi clip (numpy seed 0, 64x128,
GOP 4) with the same weights: SSF-TPU-TINY with the shipped
tiny_ssftpu_l2, and SSF-TPU at its full widths (mid 128, planes 192) with
``seeded_flat("SSF-TPU", 0)``, one numpy-seeded dict loaded into both. The
trained tiny model's decoded flows run to hundreds of pixels, far past the
TPU kernel's 56 px bound and off the frame.

Tolerances, for float32 conv stacks summed in different orders (measured:
recon 1e-6, bpp 5e-7 relative, PSNR 1e-5 dB, no latent rounding flip):
- recon: 1e-4 absolute (pixels in [0, 1]);
- bpp: 1e-5 relative; per-frame PSNR: 1e-3 dB.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.data.synthetic import synth_gop_multi
from fastvideocodec_torch.ops import warp as twarp
from fastvideocodec_torch.weights import load_flat, seeded_flat
from fastvideocodec_tpu.gop import rollout as jax_rollout
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model
from fastvideocodec_tpu.ops.warp import space_to_depth as jax_space_to_depth
from test_torch_train_common import one_torch_thread  # noqa: F401 (autouse)

GOP, H, W = 4, 64, 128
CONFIGS = [("SSF-TPU-TINY", "tiny_ssftpu_l2"), ("SSF-TPU", "seeded 0")]


def clip() -> np.ndarray:
    return synth_gop_multi(np.random.default_rng(0), size=128, gop=GOP)[:, :H, :W]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


@functools.lru_cache(maxsize=2)
def flat_params(weights: str) -> dict:
    if weights == "seeded 0":
        return seeded_flat("SSF-TPU", 0)
    with np.load(ft.weights.asset_path(weights)) as data:
        return {k: data[k].astype(np.float32) for k in data.files}


def jax_params(weights: str) -> dict:
    tree: dict = {}
    for key, value in flat_params(weights).items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(value)
    return tree


def port_model(name, weights, dtype=torch.float32):
    spec = ft.get_codec_model(name, dtype=dtype, device="cpu")
    load_flat(spec.module, flat_params(weights))
    return spec


def bits(lik) -> float:
    """The rate of a likelihood array, summed in float64."""
    p = np.asarray(lik, np.float64)
    return float(np.sum(np.clip(-np.log(p + 1e-5) / np.log(2.0), 0.0, 50.0)))


@pytest.mark.parametrize("name, weights", CONFIGS)
def test_rollout_matches_jax(name, weights):
    gop = clip()
    spec = jax_get_codec_model(name)
    with jax.default_matmul_precision("highest"):
        com, m = jax.jit(lambda p, g: jax_rollout(spec, p, g, training=False))(
            jax_params(weights), jnp.asarray(gop)
        )
    tcom, tm = ft.rollout(port_model(name, weights), nchw(gop))
    assert tcom.shape == (GOP - 1, 3, H, W)
    np.testing.assert_allclose(
        tcom.permute(0, 2, 3, 1).numpy(), np.asarray(com)[:, 0], rtol=0, atol=1e-4
    )
    for key in ("bpp_est", "bpp_res_est", "img_loss"):
        np.testing.assert_allclose(tm[key].numpy(), np.asarray(m[key]), rtol=1e-5, atol=0)
    np.testing.assert_allclose(tm["psnr"].numpy(), np.asarray(m["psnr"]), rtol=0, atol=1e-3)


def test_forward_matches_jax():
    """The full forward (keyframe + chained inter frames, over the first
    three frames) of the tiny model: recon, and each frame's rate per
    likelihood term."""
    frames = clip()[:3, None]  # [T, B=1, H, W, 3]
    spec = jax_get_codec_model("SSF-TPU-TINY")
    with jax.default_matmul_precision("highest"):
        out, liks = jax.jit(lambda p, f: spec.module.apply(p, f, training=False))(
            jax_params("tiny_ssftpu_l2"), jnp.asarray(frames)
        )
    tspec = port_model("SSF-TPU-TINY", "tiny_ssftpu_l2")
    with torch.inference_mode():
        tout, tliks = tspec.module(nchw(frames[:, 0])[:, None])
    assert tout.shape == (3, 1, 3, H, W)
    np.testing.assert_allclose(
        tout[:, 0].permute(0, 2, 3, 1).numpy(), np.asarray(out)[:, 0], rtol=0, atol=1e-4
    )
    assert [sorted(t) for t in tliks] == [sorted(j) for j in liks]
    for tlik, jlik in zip(tliks, liks):
        for part in tlik:
            for key in ("y", "z"):
                got, want = bits(tlik[part][key]), bits(jlik[part][key])
                assert abs(got - want) <= 1e-5 * want, (part, key, got, want)


def test_bf16_inter_frames_close_to_jax_bf16():
    """Full-width SSF-TPU with bfloat16 activations in both packages, at
    LSVC's bfloat16 bars: recon mean abs diff 0.01, per-frame PSNR 0.25 dB,
    rate 0.5% relative (measured: 7e-4, 0.0014 dB, 0.11%; the free
    chain 0.0014 and 0.003 dB).

    The two round at different places: the port lerps warps and computes
    every rate in float32, JAX computes the Gaussian likelihood and the bit
    sums in bfloat16 (its rollout's bpp_est sits 0.6-1.1% above the
    float64 sum of its own likelihoods on this clip). So both rates are
    summed here in float64 from the likelihood arrays, and PSNR is taken on
    both recons in float32. Each P-frame of the port codes the same inputs
    as JAX's (the frame and JAX's previous recon). Left to run its own
    chain, the port's recon drifts by bfloat16 noise, which flips the
    rounding of 5 of the 6144 motion latents of frame 2 (and 1 of frame 3)
    and moves that frame's rate by 0.62%: counted and reported here, not
    absorbed into the bar. The free chain is held to the recon and PSNR
    bars."""
    gop = clip()
    spec = jax_get_codec_model("SSF-TPU", dtype=jnp.bfloat16)
    params = jax_params("seeded 0")
    step = jax.jit(lambda p, cur, ref: spec.module.apply(
        p, cur, ref, training=False, method=spec.module.forward_inter))
    x = jax_space_to_depth(jnp.asarray(gop, jnp.bfloat16), 2)
    tspec = port_model("SSF-TPU", "seeded 0", torch.bfloat16)
    frames = twarp.space_to_depth(nchw(gop).to(torch.bfloat16))

    def as_np(t):
        return t.float().permute(0, 2, 3, 1).numpy()

    def psnr(r, target):
        return 10 * np.log10(1.0 / np.mean((r - target) ** 2))

    ref, free = x[0:1], frames[0:1]
    for i in range(1, GOP):
        target = np.asarray(x[i:i + 1].astype(jnp.float32))
        with jax.default_matmul_precision("highest"):
            next_ref, lik = step(params, x[i:i + 1], ref)
        want = np.asarray(next_ref.astype(jnp.float32))
        with torch.inference_mode():
            same_ref = nchw(np.asarray(ref.astype(jnp.float32))).to(torch.bfloat16)
            rec, tlik = tspec.module.forward_inter(frames[i:i + 1], same_ref)
            free, _ = tspec.module.forward_inter(frames[i:i + 1], free)
        for got in (as_np(rec), as_np(free)):
            assert np.abs(got - want).mean() <= 0.01
            assert abs(psnr(got, target) - psnr(want, target)) <= 0.25
        rate = sum(bits(tlik[p][k]) for p in tlik for k in ("y", "z"))
        want_rate = sum(bits(lik[p][k]) for p in lik for k in ("y", "z"))
        assert abs(rate - want_rate) <= 5e-3 * want_rate, (i, rate, want_rate)
        ref = next_ref


def test_trained_flows_pass_the_tpu_bound():
    """The tiny model's decoded level-0 flows on this clip reach past 56 px
    and sample outside the frame: the correctness phases cover the case
    the TPU kernel clamped."""
    spec = port_model("SSF-TPU-TINY", "tiny_ssftpu_l2")
    frames = twarp.space_to_depth(nchw(clip()))
    m = spec.module
    with torch.inference_mode():
        y_hat, _ = m.motion_hyperprior(m.motion_encoder(torch.cat([frames[1:2], frames[0:1]], 1)))
        motion = m.motion_decoder(y_hat)
    flow_px = motion[:, :4].abs() * (W / 2)
    assert float(flow_px.max()) > 56.0
    assert float(flow_px.max()) > W


def test_launch_counts_stay_zero_on_cpu():
    """On CPU tensors the wrappers run the plain versions and count nothing."""
    from fastvideocodec_torch.ops.kernels import warp as kw

    kw.reset_launches()
    ft.rollout(port_model(*CONFIGS[0]), nchw(clip()))
    assert set(kw.LAUNCHES.values()) == {0}


def test_bf16_rate_symbols_are_the_decoded_symbols():
    """In bfloat16 the rate of y is the float32 likelihood of the symbol the
    decoder receives, round(y - means) taken in bfloat16 as y_hat takes it,
    and not of round(y - means) taken in float32. The latent is drawn wide
    (sigma 40) so that the two rounds differ on some elements, as they do
    on the trained tiny model's latents at 128x256; the test asserts that
    they do before it checks the rate. Equality is exact: both sides run the
    same ops on the same symbols."""
    from fastvideocodec_torch.ops.math import gaussian_likelihood

    hp = port_model("SSF-TPU-TINY", "tiny_ssftpu_l2", torch.bfloat16).module.res_hyperprior
    seen = {}
    real = hp.gaussian

    def record(y, scales, means):
        seen.update(scales=scales, means=means)
        return real(y, scales, means)

    hp.gaussian = record
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.normal(0, 40, (1, 48, 8, 16)).astype(np.float32)).bfloat16()
    with torch.inference_mode():
        y_hat, lik = hp(y)
    means, scales = seen["means"], seen["scales"]
    q = torch.round(y - means)
    assert (q.float() != torch.round(y.float() - means.float())).sum() > 0
    assert y_hat.dtype == torch.bfloat16
    torch.testing.assert_close(y_hat, q + means, rtol=0, atol=0)
    want = gaussian_likelihood(q.float() + means.float(), scales.float(), means.float())
    torch.testing.assert_close(lik["y"], want, rtol=0, atol=0)
