"""RLVC, RLVC2 and RLVC-HP training in the port against the JAX package, on
the CPU, in float32, under the same quantization noise: JAX's draws
recorded and replayed, and the bars, as tests/test_torch_train_common.py
sets them out. The JAX functions run under ``jax.jit``, once each.

Forms, on a synth_gop clip (numpy seed 0) of 64x64, GOP 4:
- RLVC-TINY on tiny_rlvc_l2, through JAX's ``make_train_step`` for two
  steps: the draws, the loss and metrics, every gradient and the
  parameters after each step. JAX's RecProbModel runs both of its
  branches with one key, so it records two equal draws a latent; the port
  draws once, for the selected branch;
- RLVC2-TINY and RLVC-HP-TINY (tiny_rlvc_l2 where its tensors fit,
  seeded_flat(name, 0) elsewhere), through JAX's ``gop_loss``: the draws
  (RLVC-HP's z, then the latent's, in each codec), the loss, metrics and
  every gradient.
The gradients run through the RPMs' hidden states across the P-frames
(not detached) and not through the autoencoders' (detached). And
``rollout(training=True)`` and ``gop_loss`` run for every RLVC name of the
registry, at full width on seeded weights.
"""

import numpy as np
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.data.synthetic import synth_gop
from fastvideocodec_torch.ops.math import UniformNoise
from fastvideocodec_torch.train import TrainConfig, gop_loss, make_train_step, ready_for_training
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model
from fastvideocodec_tpu.train import trainer as jax_trainer
from test_torch_train_common import (  # noqa: F401 (one_torch_thread: autouse here)
    GOP,
    LR,
    METRICS,
    SIZE,
    Replay,
    asset_flat,
    assert_grads_close,
    assert_metrics_close,
    assert_params_close,
    clip,
    in_port_layout,
    jax_loss_grads,
    jax_train_steps,
    nchw,
    one_torch_thread,
    port_grads,
    port_spec,
    seeded_with_asset,
)

TRAINED = "tiny_rlvc_l2"  # RLVC-TINY
FORMS = ("RLVC2-TINY", "RLVC-HP-TINY")
RLVC_NAMES = ("RLVC", "RLVC2", "RLVC-HP", "RLVC-TINY", "RLVC2-TINY", "RLVC-HP-TINY")
LATENT = (1, 4, 4, 32)  # either codec's latent at 64x64 (RLVC-HP's z too)


def rlvc_flat(name: str) -> dict:
    """seeded_flat(name, 0) with tiny_rlvc_l2's tensors where they fit:
    RLVC's RPM (``entropy/rpm``) is RLVC2's ``rpm``, whose seeded form
    leaves the float32 gradient ill-conditioned (ROADMAP.md section 3)."""
    if name.startswith("RLVC2"):
        return seeded_with_asset(name, TRAINED, lambda key: key.replace("/entropy/rpm/", "/rpm/"))
    return seeded_with_asset(name, TRAINED)


def one_draw_a_latent(draws: list) -> list:
    """JAX's RecProbModel draws twice a latent, equal values (one key for
    both branches): one of each pair."""
    assert len(draws) % 2 == 0
    for a, b in zip(draws[::2], draws[1::2]):
        np.testing.assert_array_equal(a, b)
    return draws[::2]


@pytest.fixture(scope="module")
def rlvc_steps():
    steps = jax_train_steps(jax_trainer, jax_get_codec_model("RLVC-TINY"), asset_flat(TRAINED),
                            clip())
    for step in steps:
        step["jax_draws"], step["draws"] = step["draws"], one_draw_a_latent(step["draws"])
    return steps


@pytest.fixture(scope="module")
def reference():
    cases = [(jax_get_codec_model(name), rlvc_flat(name), clip(),
              jax_trainer.TrainConfig(learning_rate=LR)) for name in FORMS]
    return dict(zip(FORMS, jax_loss_grads(jax_trainer.gop_loss, cases)))


def test_rlvc_draws_in_jax_order(rlvc_steps):
    """Each P-frame: the mv codec's latent (JAX twice, the port once), then
    the residual codec's."""
    assert [d.shape for d in rlvc_steps[0]["jax_draws"]] == [LATENT] * 4 * (GOP - 1)
    spec = port_spec("RLVC-TINY", asset_flat(TRAINED))
    noise = Replay(rlvc_steps[0]["draws"])
    with torch.no_grad():
        ft.rollout(spec, nchw(clip()), training=True, noise=noise)
    assert noise.used == 2 * (GOP - 1)


def test_rlvc_loss_metrics_and_gradients_match_jax(rlvc_steps):
    ref = rlvc_steps[0]
    spec = port_spec("RLVC-TINY", asset_flat(TRAINED))
    params = ready_for_training(spec)
    noise = Replay(ref["draws"])
    loss, metrics = gop_loss(spec, nchw(clip()), True, noise, TrainConfig(learning_rate=LR))
    loss.backward()
    assert noise.used == len(ref["draws"])
    assert_metrics_close(metrics, ref["metrics"])
    assert_grads_close(port_grads(params), in_port_layout(spec.module, ref["grads"]))


def test_rlvc_two_train_steps_match_jax(rlvc_steps):
    spec = port_spec("RLVC-TINY", asset_flat(TRAINED))
    params = ready_for_training(spec)
    init_fn, step_fn = make_train_step(spec, TrainConfig(learning_rate=LR))
    opt_state = init_fn(params)
    gop = nchw(clip())
    seen = []
    for ref in rlvc_steps:
        params, opt_state, metrics = step_fn(params, opt_state, gop, Replay(ref["draws"]))
        assert_metrics_close(metrics, ref["metrics"], (*METRICS, "grad_norm"))
        seen.append(in_port_layout(spec.module, ref["grads"]))
        assert_params_close(params, in_port_layout(spec.module, ref["params"]), seen)


@pytest.mark.parametrize("name", FORMS)
def test_draws_loss_metrics_and_gradients_match_jax(reference, name):
    """RLVC2 draws one latent a codec; RLVC-HP's hyperprior z's, then the
    latent's."""
    jm, jgrads, draws = reference[name]
    per_frame = 4 if name.startswith("RLVC-HP") else 2
    assert [d.shape for d in draws] == [LATENT] * per_frame * (GOP - 1)
    spec = port_spec(name, rlvc_flat(name))
    params = ready_for_training(spec)
    noise = Replay(draws)
    loss, metrics = gop_loss(spec, nchw(clip()), True, noise, TrainConfig(learning_rate=LR))
    loss.backward()
    assert noise.used == len(draws)
    assert_metrics_close(metrics, jm)
    assert_grads_close(port_grads(params), in_port_layout(spec.module, jgrads))


@pytest.mark.parametrize("name", ("RLVC-TINY", "RLVC2-TINY"))
def test_rpm_state_carries_the_gradient_and_the_autoencoders_do_not(name):
    """After two P-frames in training the RPMs' hidden states hold the
    graph (the gradient runs through them to the next frame), the
    autoencoders' and the priors are detached."""
    spec = port_spec(name, rlvc_flat(name))
    ready_for_training(spec)
    module, gop = spec.module, nchw(clip())
    hidden = module.init_hidden(1, SIZE, SIZE, gop.device)
    noise = UniformNoise(0)
    for t in (1, 2):
        _, hidden, _ = module(gop[t - 1:t], gop[t:t + 1], hidden, t > 1, True, noise)
    assert hidden.rpm_mv.requires_grad and hidden.rpm_res.requires_grad
    assert not any(h.requires_grad for h in (hidden.rae_mv, hidden.rae_res, hidden.mv_prior,
                                             hidden.res_prior))


@pytest.mark.parametrize("name", RLVC_NAMES)
def test_every_rlvc_name_trains(name):
    """rollout(training=True) and gop_loss on seeded weights, 64x64, GOP 3:
    finite metrics, and a backward that reaches the mv codec's encoder."""
    spec = port_spec(name, ft.seeded_flat(name, 0))
    params = ready_for_training(spec)
    gop = nchw(synth_gop(np.random.default_rng(0), size=SIZE, gop=3))
    recon, m = ft.rollout(spec, gop, training=True, noise=UniformNoise(0))
    assert recon.shape == gop[1:].shape and recon.requires_grad
    assert all(bool(torch.isfinite(v).all()) for v in m.values())
    loss, _ = gop_loss(spec, gop, True, UniformNoise(0), TrainConfig())
    loss.backward()
    assert torch.isfinite(loss)
    assert any(p.grad is not None and float(p.grad.abs().max()) > 0
               for n, p in params.items() if n.startswith("mv_codec.enc"))


def test_card_branches_replay_rlvc_clip():
    """tools/train_parity.py's CardBranches pins RLVC's clip of the recon
    (models.rlvc.clip_recon) as it pins the ReLUs: a replaying run takes
    the recording run's side of [0, 1], value and gradient, where its own
    input falls on the other, and counts those elements."""
    from fastvideocodec_torch.models import rlvc
    from fastvideocodec_torch.tools.train_parity import CardBranches

    clip_fn = rlvc.clip_recon
    card_x = torch.tensor([0.5, 1.0 + 1e-7, -1e-7, 1.0, 0.0, 2.0])
    with CardBranches() as card:
        rlvc.clip_recon(card_x)
    assert rlvc.clip_recon is clip_fn and len(card.masks) == 1
    x = torch.tensor([0.5, 1.0 - 1e-7, 1e-7, 1.0 + 1e-7, -1e-7, 2.0], requires_grad=True)
    with CardBranches(card.masks) as cpu:
        out = rlvc.clip_recon(x)
    assert cpu.flips == 4  # elements 1 to 4
    (g,) = torch.autograd.grad(out.sum(), [x])
    torch.testing.assert_close(g, torch.tensor([1.0, 0.0, 0.0, 1.0, 1.0, 0.0]), rtol=0, atol=0)
    torch.testing.assert_close(out.detach(), torch.tensor([0.5, 1.0 - 1e-7, 1e-7, 1.0 + 1e-7,
                                                           -1e-7, 1.0]), rtol=0, atol=0)
