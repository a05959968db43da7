"""MS-SSIM in the port (``ops/msssim.py``) and training under loss type "M"
against the JAX package, on the CPU, in float32.

What is held to JAX:
- ``ms_ssim`` and ``msssim_db`` on seeded images (numpy seed 0): 192x192,
  and odd sizes, where the 2x2 pool pads only the bottom and the right
  (161x171 and 177x243, odd at more than one scale): ms_ssim within
  MSSSIM_REL = 2e-6 relative and msssim_db within what that bar moves it
  (-10 log10(1 - q) turns dq into 10 / ln 10 dq / (1 - q): at q = 0.98 a
  relative gap of 1e-6 in q is 1.2e-5 of the dB), the gradient of
  ``ms_ssim`` with respect to x at the gradient bar; the pool itself at
  1e-7; H or W of 160 raises the same ValueError;
- ``gop_loss`` under loss type "M" (r from the MS-SSIM lambdas, d = 1 -
  ms_ssim over the GOP in place of the distortion, broadcast over the
  frames) for LSVC-TPU-TINY (tiny_lsvctpu_l2), DVC-TINY (tiny_dvc_l2) and
  MCVC-IA-TINY (tiny_mcvc_l3, 2 views, every view alive) at 192x192, GOP 3,
  under JAX's recorded draws (JAX's function under ``jax.jit``, once
  each): the loss and metrics at the shared bars of
  tests/test_torch_train_common.py;
- for LSVC-TPU-TINY and DVC-TINY, the gradient of r * d with respect to the
  recon against JAX's ``_msssim_distortion`` at the gradient bar, and a
  finite backward of the whole loss that reaches the motion path. The
  whole model's float32 gradients at 192x192 part from JAX's by more than
  the gradient bar, in either loss type, and the port's own float32 from
  its float64 by up to 1.1e-3 of a parameter's max (ROADMAP.md section 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.data.synthetic import synth_gop, synth_mv_gop
from fastvideocodec_torch.ops import ms_ssim, msssim_db
from fastvideocodec_torch.ops.msssim import avg_pool2_pad
from fastvideocodec_torch.ops.math import UniformNoise
from fastvideocodec_torch.train import TrainConfig, gop_loss, ready_for_training
from fastvideocodec_torch.train.trainer import msssim_distortion
from fastvideocodec_torch.weights import load_flat
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model
from fastvideocodec_tpu.ops import msssim as jms
from fastvideocodec_tpu.train import trainer as jax_trainer
from test_torch_train_common import (  # noqa: F401 (one_torch_thread: autouse here)
    GRAD_REL,
    LR,
    Replay,
    asset_flat,
    assert_close_to_scale,
    assert_metrics_close,
    jax_loss_grads,
    nchw,
    nhwc,
    one_torch_thread,
    port_grads,
)

SIZES = [(192, 192), (161, 171), (177, 243)]
MSSSIM_REL = 2e-6  # float32 convolutions summed in another order (measured up to 1e-6)
LOSS_SIZE, LOSS_GOP, VIEWS = 192, 3, 2
# name: shipped weights
LOSS_MODELS = {"LSVC-TPU-TINY": "tiny_lsvctpu_l2", "DVC-TINY": "tiny_dvc_l2",
               "MCVC-IA-TINY": "tiny_mcvc_l3"}
GRADIENT_MODELS = ("LSVC-TPU-TINY", "DVC-TINY")


def image_pair(h: int, w: int):
    """Two NHWC batches of 2: a smooth image and its noisy copy in [0, 1]."""
    rng = np.random.default_rng(0)
    x = synth_gop(rng, size=max(h, w), gop=2)[:, :h, :w].astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.05, x.shape), 0, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("h, w", SIZES)
def test_ms_ssim_and_db_match_jax(h, w):
    x, y = image_pair(h, w)
    want = float(jax.jit(jms.ms_ssim)(jnp.asarray(x), jnp.asarray(y)))
    want_db = float(jax.jit(jms.msssim_db)(jnp.asarray(x), jnp.asarray(y)))
    xt = nchw(x).requires_grad_()
    got = ms_ssim(xt, nchw(y))
    assert 0.5 < want < 1.0
    np.testing.assert_allclose(float(got.detach()), want, rtol=MSSSIM_REL)
    # -10 log10(1 - q) moves by 10 / ln 10 * dq / (1 - q): q's bar carried over
    db_bar = 10 / np.log(10) * MSSSIM_REL * want / (1 - want)
    assert abs(float(msssim_db(nchw(x), nchw(y))) - want_db) <= db_bar
    (gx,) = torch.autograd.grad(got, [xt])
    # eager: under jax.jit XLA's fused float32 sits 3.2e-4 of the max from a
    # float64 recompute at 192x192, eagerly 5.7e-5 (the port's 2.9e-5)
    jgx = jax.grad(jms.ms_ssim)(jnp.asarray(x), jnp.asarray(y))
    assert_close_to_scale(gx, nchw(jgx), GRAD_REL, "d ms_ssim / dx")


@pytest.mark.parametrize("h, w", [(161, 171), (7, 10), (6, 9)])
def test_pool_pads_bottom_and_right_as_jax(h, w):
    x = np.random.default_rng(1).random((2, h, w, 3), dtype=np.float32)
    want = np.asarray(jms._avg_pool2_pad(jnp.asarray(x)))
    got = nhwc(avg_pool2_pad(nchw(x)))
    assert got.shape == want.shape == (2, (h + 1) // 2, (w + 1) // 2, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("h, w", [(160, 192), (192, 160), (160, 160)])
def test_160_px_raises_as_jax(h, w):
    x = np.zeros((1, h, w, 3), np.float32)
    with pytest.raises(ValueError, match="H and W > 160"):
        jms.ms_ssim(jnp.asarray(x), jnp.asarray(x))
    with pytest.raises(ValueError, match="H and W > 160"):
        ms_ssim(nchw(x), nchw(x))


def loss_clip(name: str) -> np.ndarray:
    """[T, H, W, 3], or MCVC's [T, V, H, W, 3], numpy seed 0."""
    rng = np.random.default_rng(0)
    if name.startswith("MCVC"):
        return synth_mv_gop(rng, views=VIEWS, size=LOSS_SIZE, gop=LOSS_GOP)
    return synth_gop(rng, size=LOSS_SIZE, gop=LOSS_GOP)


def port_clip(name: str) -> torch.Tensor:
    a = loss_clip(name)
    if a.ndim == 5:
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 1, 4, 2, 3)))
    return nchw(a)


def views_kw(name: str) -> dict:
    return {"num_views": VIEWS} if name.startswith("MCVC") else {}


@pytest.fixture(scope="module")
def reference():
    cases = []
    for name, asset in LOSS_MODELS.items():
        spec = jax_get_codec_model(name, loss_type="M", **views_kw(name))
        mask = (jnp.ones((VIEWS,), jnp.float32),) if name.startswith("MCVC") else ()
        cases.append((spec, asset_flat(asset), loss_clip(name),
                      jax_trainer.TrainConfig(learning_rate=LR), *mask))
    return dict(zip(LOSS_MODELS, jax_loss_grads(jax_trainer.gop_loss, cases, grads=False)))


@pytest.mark.parametrize("name", list(LOSS_MODELS))
def test_msssim_loss_matches_jax(reference, name):
    """Loss type M: r = 32 (level 2 of the MS-SSIM lambdas), img_loss the
    GOP's 1 - ms_ssim (the whole GOP for MCVC, the P-frames otherwise);
    the loss and metrics against JAX's."""
    jm, _, draws = reference[name]
    spec = ft.get_codec_model(name, device="cpu", loss_type="M", **views_kw(name))
    assert spec.r == 32.0
    load_flat(spec.module, asset_flat(LOSS_MODELS[name]))
    noise = Replay(draws)
    mask = np.ones(VIEWS, np.float32) if name.startswith("MCVC") else None
    with torch.no_grad():
        _, metrics = gop_loss(spec, port_clip(name), True, noise, TrainConfig(learning_rate=LR),
                              mask)
    assert noise.used == len(draws)
    assert_metrics_close(metrics, jm)
    assert 0.0 < float(metrics["img_loss"]) < 1.0


@pytest.mark.parametrize("name", GRADIENT_MODELS)
def test_msssim_loss_gradients(name):
    """The gradient of the loss's M distortion with respect to the recon
    (clipped, as the rollout returns it) against JAX's
    ``_msssim_distortion``, at the gradient bar; and the whole backward of
    gop_loss under loss M reaches the motion path, finite. (The whole
    model's gradients against JAX's: ROADMAP.md section 3, float32 at
    192x192.)"""
    spec = ft.get_codec_model(name, device="cpu", loss_type="M")
    load_flat(spec.module, asset_flat(LOSS_MODELS[name]))
    params = ready_for_training(spec)
    gop = port_clip(name)
    with torch.no_grad():
        recon, _ = ft.rollout(spec, gop, training=True, noise=UniformNoise(0))
    assert recon.shape == gop[1:].shape
    x_hat = recon.clone().requires_grad_()
    (got,) = torch.autograd.grad(spec.r * msssim_distortion(spec, x_hat, gop), [x_hat])
    jspec = jax_get_codec_model(name, loss_type="M")
    want = jax.grad(lambda a: jspec.r * jax_trainer._msssim_distortion(
        jspec, a, jnp.asarray(loss_clip(name))))(jnp.asarray(nhwc(recon)))
    assert_close_to_scale(got, nchw(want), GRAD_REL, "d loss / d recon")
    loss, _ = gop_loss(spec, gop, True, UniformNoise(0), TrainConfig(learning_rate=LR))
    loss.backward()
    grads = port_grads(params)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert any(float(g.abs().max()) > 0 for n, g in grads.items()
               if n.startswith(("optic_flow", "mv_encoder")))
