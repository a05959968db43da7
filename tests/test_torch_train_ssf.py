"""SSF training in the port against the JAX package, on the CPU, in
float32, under the same quantization noise: JAX's draws recorded and
replayed, and the bars, as tests/test_torch_train_common.py sets them
out. The JAX functions run under ``jax.jit``.

What is held to JAX:
- QReLU's surrogate gradient (``layers/blocks.py:_QReLU``) against JAX's
  ``_qrelu_bwd`` below 0, inside, above 255 and exactly at 0 and 255:
  1e-6 relative (XLA's exp and PyTorch's may differ in the last bit);
- the training forwards of ``EntropyBottleneck``, ``GaussianConditional``
  and ``SSFHyperprior`` (with and without an SPnet, ``sp`` on and off)
  alone, on seeded parameters: their outputs within 1e-5 relative of the
  largest value, and the gradients of a scalar of all outputs with
  respect to the input and every parameter at the gradient bar;
- the three pixel warps' plain vjps (``ops.warp.plain_warp_vjp``, the
  plain version of their backward kernels) against JAX's custom_vjp
  backwards ``_ppw_bwd``, ``_ppws_bwd`` and ``_ppwss_bwd`` on ragged
  shapes (odd H and W; odd H/2 and W/2 for the s2d forms) and flows up to
  +-40 px: 1e-5 of the largest gradient (the image gradient is a
  scatter-add summed in another order);
- SSF-TPU-TINY on tiny_ssftpu_l2 and SSF-TINY on tiny_ssf_l2, a synth_gop
  clip (numpy seed 0) of 64x64, GOP 4, through JAX's ``make_train_step``
  for two steps (the first step's gradients read from a pass-through optax
  stage chained before the optimizer): the draws in JAX's order and
  shapes; the loss and gop_loss's metrics, every gradient, and the
  parameters after each of the two steps at the shared bars;
- MCVC-Original, stock SSF at full width on seeded_flat("MCVC-Original", 0),
  with 3 views of 64x64 (synth_mv_gop, seed 0, GOP 3) as the batch: loss
  and metrics as above, the gradients within GRAD_REL_FULL_WIDTH = 5e-4
  of each parameter's max |grad| (measured 1.6e-4, in the motion decoder).
And ``rollout(training=True)`` builds and runs for every SSF name, and the
families that came later (DVC, RLVC and Base, item 7.3) train.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.data.synthetic import synth_gop, synth_mv_gop
from fastvideocodec_torch.entropy import factorized as tfact
from fastvideocodec_torch.entropy import gaussian as tgauss
from fastvideocodec_torch.entropy import hyperprior as thyper
from fastvideocodec_torch.layers.blocks import qrelu
from fastvideocodec_torch.ops import warp as twarp
from fastvideocodec_torch.ops.math import UniformNoise, bits_estimate
from fastvideocodec_torch.train import TrainConfig, gop_loss, make_train_step, ready_for_training
from fastvideocodec_torch.weights import flatten_params, load_flat, load_params
from fastvideocodec_tpu.entropy import factorized as jfact
from fastvideocodec_tpu.entropy import gaussian as jgauss
from fastvideocodec_tpu.entropy import hyperprior as jhyper
from fastvideocodec_tpu.layers.blocks import _qrelu_bwd
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model
from fastvideocodec_tpu.ops import bits_estimate as jax_bits
from fastvideocodec_tpu.ops.pallas import warp_kernel as jwk
from fastvideocodec_tpu.train import trainer as jax_trainer
from fastvideocodec_tpu.train.checkpoint import asset_params
from test_torch_train_common import (  # noqa: F401 (one_torch_thread: autouse here)
    GOP,
    GRAD_REL,
    LR,
    METRIC_REL,
    METRICS,
    SIZE,
    JaxDraws,
    Replay,
    assert_close_to_scale,
    assert_grads_close,
    assert_metrics_close,
    assert_params_close,
    clip,
    grab_grads,
    in_port_layout,
    nchw,
    nhwc,
    one_torch_thread,
    port_grads,
)

# MCVC-Original at full width (mid 128, planes 192) on seeded weights: its
# motion decoder's gradient comes through the 18-channel volume warp's flow
# gradient, sums of differences of neighbouring samples that cancel
# (measured 1.6e-4 of the max at motion_decoder.PolyphaseDeconv_0.bias)
GRAD_REL_FULL_WIDTH = 5e-4
# (registry name, shipped weights): the SSF forms trained here
MODELS = {"SSF-TPU-TINY": "tiny_ssftpu_l2", "SSF-TINY": "tiny_ssf_l2"}
SSF_NAMES = ("SSF-Official", "SSF-TPU", "SSF-TINY", "SSF-TPU-TINY", "MCVC-Original")
MCVC_VIEWS, MCVC_GOP = 3, 3


def seeded_tree(shapes, seed: int):
    """Numpy-seeded values in the shapes of a flax params tree: kernels
    ~ N(0, 1/fan_in), GroupNorm ``scale`` and LayerNorm ``g`` 1 + N(0, 0.1),
    every other leaf ~ N(0, 0.05)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            value = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name in ("scale", "g"):
            value = 1 + rng.normal(0, 0.1, shape)
        else:
            value = rng.normal(0, 0.05, shape)
        return jnp.asarray(value.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


# ---------------------------------------------------------------------------
# QReLU
# ---------------------------------------------------------------------------


def test_qrelu_gradient_is_jax():
    x = np.asarray([-300.0, -1.0, -1e-3, 0.0, 1e-3, 100.0, 254.999, 255.0, 255.001, 300.0,
                    1000.0], np.float32)
    g = np.random.default_rng(0).normal(0, 1, x.shape).astype(np.float32)
    (want,) = _qrelu_bwd(8, 100, jnp.asarray(x), jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_()
    out = qrelu(t)
    (got,) = torch.autograd.grad(out, [t], torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.clip(x, 0, 255))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    # the bounds and the inside pass g itself; outside, the surrogate's
    # factor exp(a*(|2x/255 - 1| - 1)) exceeds 1
    inside = (x >= 0) & (x <= 255)
    np.testing.assert_array_equal(got.numpy()[inside], g[inside])
    assert bool((np.abs(got.numpy()[~inside]) > np.abs(g[~inside])).all())


# ---------------------------------------------------------------------------
# The entropy models' training forwards, alone
# ---------------------------------------------------------------------------


def jax_value_and_grads(fn, params, x, rec):
    """(outputs, grads wrt (params, x), draws) of jitted fn(params, x) ->
    (scalar, outputs)."""
    (_, outs), grads = jax.jit(jax.value_and_grad(fn, argnums=(0, 1), has_aux=True))(params, x)
    jax.block_until_ready(grads)
    return outs, grads, rec.take()


def port_grads_of(module, x: torch.Tensor, loss: torch.Tensor):
    """Gradients of loss with respect to x and every parameter of module."""
    names, ps = zip(*module.named_parameters())
    got = torch.autograd.grad(loss, [x, *ps], allow_unused=True)
    return got[0], {n: g if g is not None else torch.zeros_like(p)
                    for n, g, p in zip(names, got[1:], ps)}


def rates(*liks):
    """A scalar of likelihoods: their estimated bits."""
    return sum(jax_bits(lik) for lik in liks)


def test_entropy_bottleneck_training_forward():
    """x + u on x itself (the medians take no part), the likelihood of that
    x_hat, and the gradients of its bits and of x_hat."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 5, 6, 8)) * 4).astype(np.float32)
    c = rng.standard_normal(x.shape).astype(np.float32)
    jmod = jfact.EntropyBottleneck(8)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), training=False)
    rec = JaxDraws()

    def fn(p, a):
        x_hat, lik = jmod.apply(p, a, training=True, rng=jax.random.PRNGKey(5))
        return rates(lik) + jnp.sum(x_hat * c), (x_hat, lik)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", rec)
        (jx_hat, jlik), (gp, gx), draws = jax_value_and_grads(fn, params, jnp.asarray(x), rec)
    assert [d.shape for d in draws] == [x.shape]
    tmod = load_params(tfact.EntropyBottleneck(8), params).requires_grad_(True)
    xt = nchw(x).requires_grad_()
    x_hat, lik = tmod(xt, training=True, noise=Replay(draws))
    np.testing.assert_allclose(nhwc(x_hat), np.asarray(jx_hat), rtol=0, atol=1e-6)
    np.testing.assert_allclose(nhwc(lik), np.asarray(jlik), rtol=1e-5, atol=1e-9)
    loss = bits_estimate(lik) + torch.sum(x_hat * nchw(c))
    got_x, got = port_grads_of(tmod, xt, loss)
    assert_close_to_scale(got_x, nchw(gx), GRAD_REL, "x")
    assert_grads_close(got, in_port_layout(tmod, flatten_params(gp)))
    assert float(got["quantiles"].abs().max()) == 0.0


def test_gaussian_conditional_training_forward():
    """x_hat = x + u (not x - means + u) and its likelihood under
    N(means, scales); gradients to x, the scales and the means."""
    rng = np.random.default_rng(2)
    shape = (2, 6, 5, 4)
    x, means = ((rng.standard_normal(shape) * 5).astype(np.float32) for _ in range(2))
    scales = np.abs(rng.standard_normal(shape) * 3).astype(np.float32)
    c = rng.standard_normal(shape).astype(np.float32)
    rec = JaxDraws()

    def fn(p, a):
        s, m = p
        x_hat, lik = jgauss.GaussianConditional()(a, s, means=m, training=True,
                                                  rng=jax.random.PRNGKey(6))
        return rates(lik) + jnp.sum(x_hat * c), (x_hat, lik)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", rec)
        (jx_hat, jlik), ((gs, gm), gx), draws = jax_value_and_grads(
            fn, (jnp.asarray(scales), jnp.asarray(means)), jnp.asarray(x), rec)
    ts, tm, tx = (nchw(a).requires_grad_() for a in (scales, means, x))
    x_hat, lik = tgauss.GaussianConditional()(tx, ts, tm, True, Replay(draws))
    np.testing.assert_allclose(nhwc(x_hat), np.asarray(jx_hat), rtol=0, atol=1e-6)
    np.testing.assert_allclose(nhwc(lik), np.asarray(jlik), rtol=1e-5, atol=1e-9)
    got = torch.autograd.grad(bits_estimate(lik) + torch.sum(x_hat * nchw(c)), [tx, ts, tm])
    for t, w, what in zip(got, (gx, gs, gm), ("x", "scales", "means")):
        assert_close_to_scale(t, nchw(w), GRAD_REL, what)


@pytest.mark.parametrize("super_prec, sp", [(False, False), (True, False), (True, True)])
def test_ssf_hyperprior_training_forward(super_prec, sp):
    """z's draw, then y's; y_hat = quantize_ste(y - means) + means (or the
    SPnet's prediction, detached, with ``sp``); Q_err_y and pred_err_y;
    every output's values and the gradients of a scalar of all of them."""
    rng = np.random.default_rng(3)
    planes, sp_dim = 16, 8
    y = (rng.standard_normal((1, 8, 8, planes)) * 6).astype(np.float32)
    prior = np.round(rng.standard_normal(y.shape) * 2).astype(np.float32)
    cot = {k: rng.standard_normal(y.shape).astype(np.float32)
           for k in ("y_hat", "Q_err_y", "pred_err_y")}
    jmod = jhyper.SSFHyperprior(planes=planes, mid_planes=planes, super_prec=super_prec,
                                sp=sp, sp_dim=sp_dim)
    shapes = jax.eval_shape(lambda k, a: jmod.init(k, a, training=False, q_y_prior=prior),
                            jax.random.PRNGKey(0), jnp.asarray(y))
    params = seeded_tree(shapes, 4)
    rec = JaxDraws()

    def fn(p, a):
        y_hat, lik, _ = jmod.apply(p, a, training=True, rng=jax.random.PRNGKey(7),
                                   q_y_prior=jnp.asarray(prior))
        loss = rates(lik["y"], lik["z"]) + jnp.sum(y_hat * cot["y_hat"]) + jnp.sum(
            lik["Q_err_y"] * cot["Q_err_y"])
        if super_prec:
            loss = loss + jnp.sum(lik["pred_err_y"] * cot["pred_err_y"])
        return loss, (y_hat, lik)

    with jax.default_matmul_precision("highest"), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", rec)
        (jy_hat, jlik), (gp, gy), draws = jax_value_and_grads(fn, params, jnp.asarray(y), rec)
    assert [d.shape for d in draws] == [(1, 1, 1, planes), y.shape]
    tmod = load_params(thyper.SSFHyperprior(planes, super_prec, sp, sp_dim=sp_dim), params)
    tmod.requires_grad_(True)
    yt = nchw(y).requires_grad_()
    noise = Replay(draws)
    y_hat, lik, new_prior = tmod.forward_with_prior(yt, nchw(prior), True, noise)
    assert noise.used == 2
    outs = {"y_hat": (y_hat, jy_hat), "Q_err_y": (lik["Q_err_y"], jlik["Q_err_y"])}
    if super_prec:
        outs["pred_err_y"] = (lik["pred_err_y"], jlik["pred_err_y"])
    for key, (got, want) in outs.items():
        assert_close_to_scale(got.detach(), nchw(want), METRIC_REL, key)
    for key in ("y", "z"):
        np.testing.assert_allclose(nhwc(lik[key]), np.asarray(jlik[key]), rtol=1e-5, atol=1e-9)
    loss = bits_estimate(lik["y"]) + bits_estimate(lik["z"]) + sum(
        torch.sum(got * nchw(cot[key])) for key, (got, _) in outs.items())
    got_y, got = port_grads_of(tmod, yt, loss)
    assert_close_to_scale(got_y, nchw(gy), GRAD_REL, "y")
    assert_grads_close(got, in_port_layout(tmod, flatten_params(gp)))
    if super_prec:  # the SPnet learns from its error (with sp, alone)
        assert any(float(g.abs().max()) > 0 for n, g in got.items()
                   if n.startswith("y_predictor"))


# ---------------------------------------------------------------------------
# The pixel warps' plain vjps against JAX's custom_vjp backwards
# ---------------------------------------------------------------------------

# name: (JAX backward, full-res image [B, C, H, W]); odd H and W, and odd
# H/2 and W/2 for the s2d forms
VJP_CASES = {
    "pixel_warp": (jwk._ppw_bwd, (2, 5, 13, 21)),
    "pixel_warp_s2d": (jwk._ppws_bwd, (2, 3, 14, 22)),
    "pixel_warp_s2d_sflow": (jwk._ppwss_bwd, (2, 3, 14, 22)),
}


@pytest.mark.parametrize("name", list(VJP_CASES))
def test_plain_warp_vjps_are_jax(name):
    bwd, (B, C, H, W) = VJP_CASES[name]
    rng = np.random.default_rng(8)
    img = rng.random((B, C, H, W), dtype=np.float32)
    flow = (rng.normal(0, 3, (B, 2, H, W)) + rng.uniform(-40, 40, (B, 2, H, W))).astype(
        np.float32)
    img_t, flow_t = torch.from_numpy(img), torch.from_numpy(flow)
    if name != "pixel_warp":
        img_t = twarp.space_to_depth(img_t)
    if name == "pixel_warp_s2d_sflow":
        flow_t = torch.cat([twarp.space_to_depth(flow_t[:, :1]),
                            twarp.space_to_depth(flow_t[:, 1:])], dim=1)
    g = torch.from_numpy(rng.normal(0, 1, tuple(img_t.shape)).astype(np.float32))
    want = bwd(56, (jnp.asarray(nhwc(img_t)), jnp.asarray(nhwc(flow_t))), jnp.asarray(nhwc(g)))
    got = twarp.PLAIN_BACKWARD[name](img_t, flow_t, g)
    for t, w, what in zip(got, want, ("image", "flow")):
        assert t.shape == nchw(w).shape
        assert_close_to_scale(t, nchw(w), 1e-5, what)
    assert float(got[1].abs().max()) > 0


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------


def jax_steps(name, asset, gop, sp_stage=1):
    """JAX's make_train_step from the shipped weights for two steps: each
    step's draws, gradients, parameters and metrics."""
    cfg = jax_trainer.TrainConfig(learning_rate=LR)
    params = {"params": asset_params(asset)["params"]}
    rec = JaxDraws()
    steps = []
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"):
        mp.setattr(jax.random, "uniform", rec)
        spec = jax_get_codec_model(name, sp_stage=sp_stage)
        tx = optax.chain(grab_grads(), jax_trainer.make_optimizer(cfg))
        init_fn, step_fn = jax_trainer.make_train_step(spec, cfg, optimizer=tx)
        opt_state = init_fn(params)
        step = jax.jit(step_fn)
        for seed in (1, 2):
            params, opt_state, metrics = step(params, opt_state, gop, jax.random.PRNGKey(seed))
            jax.block_until_ready(params)
            steps.append({"draws": rec.take(), "grads": flatten_params(opt_state[0]["g"]),
                          "params": flatten_params(params),
                          "metrics": {k: float(v) for k, v in metrics.items()}})
    return steps


@pytest.fixture(scope="module")
def reference():
    gop = jnp.asarray(clip())
    return {name: jax_steps(name, asset, gop) for name, asset in MODELS.items()}


def port_model(name, asset=None, **kw):
    spec = ft.get_codec_model(name, device="cpu", **kw)
    if asset is None:
        load_flat(spec.module, ft.seeded_flat(name, 0))
    else:
        ft.load_asset(spec.module, asset)
    return spec


@pytest.mark.parametrize("name", list(MODELS))
def test_port_draws_in_jax_order(reference, name):
    """Each P-frame draws the motion hyperprior's z and y, then the
    residual's (the tiny latent grid: 4x4, z 1x1, 48 channels)."""
    shapes = [d.shape for d in reference[name][0]["draws"]]
    assert shapes == [(1, 1, 1, 48), (1, 4, 4, 48)] * 2 * (GOP - 1)
    spec = port_model(name, MODELS[name])
    noise = Replay(reference[name][0]["draws"])
    with torch.no_grad():
        ft.rollout(spec, nchw(clip()), training=True, noise=noise)
    assert noise.used == len(reference[name][0]["draws"])


@pytest.mark.parametrize("name", list(MODELS))
def test_loss_metrics_and_gradients_match_jax(reference, name):
    ref = reference[name][0]
    spec = port_model(name, MODELS[name])
    params = ready_for_training(spec)
    noise = Replay(ref["draws"])
    loss, metrics = gop_loss(spec, nchw(clip()), True, noise, TrainConfig(learning_rate=LR))
    loss.backward()
    assert noise.used == len(ref["draws"])
    assert_metrics_close(metrics, ref["metrics"])
    assert_grads_close(port_grads(params), in_port_layout(spec.module, ref["grads"]))


@pytest.mark.parametrize("name", list(MODELS))
def test_two_train_steps_match_jax(reference, name):
    spec = port_model(name, MODELS[name])
    params = ready_for_training(spec)
    init_fn, step_fn = make_train_step(spec, TrainConfig(learning_rate=LR))
    opt_state = init_fn(params)
    gop = nchw(clip())
    seen = []
    for ref in reference[name]:
        params, opt_state, metrics = step_fn(params, opt_state, gop, Replay(ref["draws"]))
        assert_metrics_close(metrics, ref["metrics"], (*METRICS, "grad_norm"))
        seen.append(in_port_layout(spec.module, ref["grads"]))
        assert_params_close(params, in_port_layout(spec.module, ref["params"]), seen)


def test_mcvc_original_training_step_matches_jax():
    """Stock SSF at full width with 3 views as the batch: gop_loss's value,
    metrics and gradients under JAX's draws."""
    frames = synth_mv_gop(np.random.default_rng(0), views=MCVC_VIEWS, size=SIZE, gop=MCVC_GOP)
    jparams = {}  # {"params": {...}} from the flat "params/a/b/leaf" names
    for key, value in ft.seeded_flat("MCVC-Original", 0).items():
        node = jparams
        for part in key.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[key.split("/")[-1]] = jnp.asarray(value)
    cfg = jax_trainer.TrainConfig(learning_rate=LR)
    jspec = jax_get_codec_model("MCVC-Original", num_views=MCVC_VIEWS)
    rec = JaxDraws()
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"):
        mp.setattr(jax.random, "uniform", rec)
        (_, jm), jgrads = jax.jit(jax.value_and_grad(
            lambda p: jax_trainer.gop_loss(jspec, p, jnp.asarray(frames), True,
                                           jax.random.PRNGKey(3), cfg), has_aux=True))(jparams)
        jax.block_until_ready(jgrads)
    draws = rec.take()
    assert [d.shape[0] for d in draws] == [MCVC_VIEWS] * 4 * (MCVC_GOP - 1)
    spec = port_model("MCVC-Original")
    params = ready_for_training(spec)
    noise = Replay(draws)
    gop = torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 1, 4, 2, 3)))
    loss, metrics = gop_loss(spec, gop, True, noise, TrainConfig(learning_rate=LR))
    loss.backward()
    assert noise.used == len(draws)
    assert_metrics_close(metrics, {k: float(v) for k, v in jm.items()})
    assert_grads_close(port_grads(params), in_port_layout(
        spec.module, flatten_params(jgrads)), GRAD_REL_FULL_WIDTH)


@pytest.mark.parametrize("name", SSF_NAMES)
def test_every_ssf_name_trains(name):
    """rollout(training=True) on seeded weights, 64x64, GOP 3: finite
    metrics, and a backward that reaches the transforms."""
    spec = port_model(name)
    params = ready_for_training(spec)
    gop = nchw(synth_gop(np.random.default_rng(0), size=SIZE, gop=3))
    if name == "MCVC-Original":
        gop = gop[:, None].expand(-1, 2, -1, -1, -1)
    recon, m = ft.rollout(spec, gop, training=True, noise=UniformNoise(0))
    assert recon.shape == gop[1:].shape and recon.requires_grad
    assert all(bool(torch.isfinite(v).all()) for v in m.values())
    loss, _ = gop_loss(spec, gop, True, UniformNoise(0), TrainConfig())
    loss.backward()
    assert torch.isfinite(loss)
    assert any(p.grad is not None and float(p.grad.abs().max()) > 0
               for n, p in params.items() if n.startswith("res_decoder"))


@pytest.mark.parametrize("name, item", [("Base-EC-TINY", "7.3"), ("DVC-TINY", "7.3"),
                                        ("RLVC-TINY", "7.3"), ("Base-ER-TINY", "7.3")])
def test_untrained_families_still_raise(name, item):
    """The families of ROADMAP.md item ``item``, which raised in training
    until their port, train: a finite loss and a gradient that reaches the
    mv encoder (RLVC's mv codec's)."""
    spec = ft.get_codec_model(name, device="cpu")
    params = ready_for_training(spec)
    gop = nchw(synth_gop(np.random.default_rng(0), size=SIZE, gop=3))
    loss, _ = gop_loss(spec, gop, True, UniformNoise(0), TrainConfig())
    loss.backward()
    assert torch.isfinite(loss)
    assert any(p.grad is not None and float(p.grad.abs().max()) > 0
               for n, p in params.items() if n.startswith(("mv_encoder", "mv_codec.enc")))
