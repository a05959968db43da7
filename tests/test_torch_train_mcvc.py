"""MCVC training in the port against the JAX package, on the CPU, in
float32, under the same quantization noise. JAX's draws are recorded and
replayed, and the bars set, as tests/test_torch_train_common.py sets them
out; the JAX functions run under ``jax.jit``.

What is held to JAX, for MCVC-IA-TINY on the shipped tiny_mcvc_l3 and
MCVC-TINY (no cross-view attention) on seeded_flat("MCVC-TINY", 0), 3
views of 64x64 (synth_mv_gop, numpy seed 0), GOP 4, view 2 failed:
- the draws: the keyframe's hyperprior's z and y, then each P-frame the
  motion hyperprior's z and y before the residual's;
- MCVC-IA-TINY's training rollout's per-frame ``img_loss`` (the mean of the enhanced
  recon's and the plain references' alive-view MSE), ``psnr``,
  ``bpp_est`` and ``completeness`` against JAX's ``mcvc_gop``;
- two steps of JAX's ``gop_loss`` value_and_grad with the view mask and
  JAX's optimizer (JAX's ``make_train_step``, its loss compiled once for
  all the steps and clips here): the loss (sum(r * img_loss + bpp_est)
  plus the aux loss) and metrics, every gradient, and the parameters
  after each step against the port's ``make_train_step``, the port on
  JAX's ReLU branches (``OnJaxBranches``: MCVC's failed views feed the
  decoders constant fields that sit at pre-activations within float32
  noise of 0, and one or two elements of another branch part a decoder's
  gradient by up to 1.5e-2 of its max; on JAX's branches the worst gap is
  3.3e-5; the tests print how many elements took the other branch); the
  motion decoder's gradients at the flow path's bar. The
  gradients hold only if the port detaches each P-frame's reference as
  JAX does (the keyframe's recon and every plain recon before it becomes
  the next reference, the outputs attached);
- the batched step (two clips, each with its own view mask): the loss,
  metrics and parameters after its step, the means over the clips of
  JAX's, as JAX's vmapped step.
And MCVC-IA-OLFT-TINY's ``gop_loss`` drops the rate term (``spec.olft``),
as JAX's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.data.synthetic import synth_mv_gop
from fastvideocodec_torch.ops.math import UniformNoise
from fastvideocodec_torch.train import TrainConfig, gop_loss, make_train_step, ready_for_training
from fastvideocodec_torch.weights import flatten_params, load_flat
from fastvideocodec_tpu.gop import rollout as jax_rollout
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model
from fastvideocodec_tpu.train import trainer as jax_trainer
from fastvideocodec_tpu.train.checkpoint import asset_params
from test_torch_train_common import (  # noqa: F401 (one_torch_thread: autouse here)
    LR,
    METRIC_REL,
    METRICS,
    JaxBranches,
    JaxDraws,
    OnJaxBranches,
    Replay,
    assert_grads_close,
    assert_metrics_close,
    assert_params_close,
    in_port_layout,
    one_torch_thread,
    port_grads,
)

VIEWS, SIZE, GOP = 3, 64, 4
MASK = np.array([1, 1, 0], np.float32)  # view 2 failed
# (registry name, weights): shipped, or "seeded" for seeded_flat(name, 0)
MODELS = {"MCVC-IA-TINY": "tiny_mcvc_l3", "MCVC-TINY": "seeded"}
# the parameters whose gradient comes only through the volume warp's flow
# gradient, held at FLOW_GRAD_REL (tests/test_torch_train_common.py)
FLOW_PATH = ("motion_decoder.",)


def mv_clip(seed: int = 0) -> np.ndarray:
    """[T, V, H, W, 3]: JAX's gop [T, B*V, H, W, 3] with B = 1."""
    return synth_mv_gop(np.random.default_rng(seed), views=VIEWS, size=SIZE, gop=GOP)


def nchw5(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 1, 4, 2, 3)))


def jax_params(name: str, weights: str) -> dict:
    """{"params": ...} of JAX's module: the shipped tree, or seeded_flat's
    flat names nested."""
    if weights != "seeded":
        return {"params": asset_params(weights)["params"]}
    tree = {}
    for key, value in ft.seeded_flat(name, 0).items():
        node = tree
        for part in key.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[key.split("/")[-1]] = jnp.asarray(value)
    return tree


def port_model(name: str, weights: str):
    spec = ft.get_codec_model(name, device="cpu", num_views=VIEWS)
    if weights == "seeded":
        load_flat(spec.module, ft.seeded_flat(name, 0))
    else:
        ft.load_asset(spec.module, weights)
    return spec


# name: JAX's jitted gop_loss value_and_grad, its draws recorded in DRAWS
# and its ReLU branches in BRANCHES
COMPILED = {}
DRAWS, BRANCHES = JaxDraws(), JaxBranches()


def jax_steps(name: str, weights: str, clips) -> list:
    """Two Adam steps of JAX's gop_loss value_and_grad (jitted once, the clip
    and its view mask arguments) and optimizer from the model's weights:
    for each step a list over ``clips`` ((clip, mask) pairs) of each
    clip's draws, ReLU branches, gradients and metrics, and the parameters after the
    step, which takes the mean of the clips' gradients (JAX's batched
    step vmaps gop_loss and takes the mean)."""
    cfg = jax_trainer.TrainConfig(learning_rate=LR)
    params = jax_params(name, weights)
    steps = []
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"):
        mp.setattr(jax.random, "uniform", DRAWS)
        mp.setattr(jax.nn, "relu", BRANCHES)
        if name not in COMPILED:
            spec = jax_get_codec_model(name, num_views=VIEWS)
            COMPILED[name] = jax.jit(jax.value_and_grad(
                lambda p, g, m, r: jax_trainer.gop_loss(spec, p, g, True, r, cfg, m),
                has_aux=True))
        value_and_grad = COMPILED[name]
        tx = jax_trainer.make_optimizer(cfg)
        opt_state = tx.init(params)
        for seed in (1, 2):
            per_clip = []
            for b, (gop, mask) in enumerate(clips):
                (_, metrics), grads = value_and_grad(params, jnp.asarray(gop), jnp.asarray(mask),
                                                     jax.random.PRNGKey(10 * seed + b))
                per_clip.append({"draws": DRAWS.take(), "branches": BRANCHES.take(), "grads": grads,
                                 "metrics": {k: float(v) for k, v in metrics.items()}})
            grads = jax.tree.map(lambda *g: sum(g) / len(g), *(c["grads"] for c in per_clip))
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            for c in per_clip:
                c["metrics"]["grad_norm"] = float(optax.global_norm(c["grads"]))
                c["grads"] = flatten_params(c["grads"])
            steps.append({"clips": per_clip, "grads": flatten_params(grads),
                          "grad_norm": float(optax.global_norm(grads)),
                          "params": flatten_params(params)})
    return steps


@pytest.fixture(scope="module")
def reference():
    return {name: jax_steps(name, weights, [(mv_clip(), MASK)])
            for name, weights in MODELS.items()}


@pytest.fixture(scope="module")
def rollout_reference():
    """JAX's training rollout of MCVC-IA-TINY: its draws and per-frame
    metrics (a ReLU branch that parts the packages moves these values by
    far less than their bar)."""
    rec = JaxDraws()
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"):
        mp.setattr(jax.random, "uniform", rec)
        spec = jax_get_codec_model("MCVC-IA-TINY", num_views=VIEWS)
        _, m = jax.jit(lambda p, r: jax_rollout(
            spec, p, jnp.asarray(mv_clip()), training=True, rng=r, mask=jnp.asarray(MASK)))(
                jax_params("MCVC-IA-TINY", MODELS["MCVC-IA-TINY"]), jax.random.PRNGKey(1))
    return rec.take(), {k: np.asarray(v) for k, v in m.items()}


@pytest.mark.parametrize("name", list(MODELS))
def test_port_draws_in_jax_order(reference, name):
    """The keyframe's z and y, then each P-frame's motion z and y before
    the residual's (the tiny latent grid of 64x64: 4x4, z 1x1, 48
    channels, over the 3 views)."""
    draws = reference[name][0]["clips"][0]["draws"]
    shapes = [d.shape for d in draws]
    assert shapes == [(VIEWS, 1, 1, 48), (VIEWS, 4, 4, 48)] * (1 + 2 * (GOP - 1))
    spec = port_model(name, MODELS[name])
    noise = Replay(draws)
    with torch.no_grad():
        ft.rollout(spec, nchw5(mv_clip()), MASK, training=True, noise=noise)
    assert noise.used == len(draws)


def test_training_rollout_metrics_match_jax(rollout_reference):
    """mcvc_gop in training, MCVC-IA-TINY: per frame, img_loss is 0.5 x
    (enhanced + references' alive-view MSE), psnr the enhanced recon's."""
    draws, want = rollout_reference
    spec = port_model("MCVC-IA-TINY", MODELS["MCVC-IA-TINY"])
    ready_for_training(spec)
    recon, m = ft.rollout(spec, nchw5(mv_clip()), MASK, training=True, noise=Replay(draws))
    assert recon.requires_grad and recon.shape == (GOP, VIEWS, 3, SIZE, SIZE)
    assert set(m) == set(want)
    for key, value in want.items():
        got = m[key].detach().numpy()
        print(f"{key}: port {got} jax {value}")
        np.testing.assert_allclose(got, value, rtol=METRIC_REL, atol=0)


@pytest.mark.parametrize("name", list(MODELS))
def test_loss_metrics_and_gradients_match_jax(reference, name):
    ref = reference[name][0]["clips"][0]
    spec = port_model(name, MODELS[name])
    params = ready_for_training(spec)
    noise = Replay(ref["draws"])
    with OnJaxBranches(ref["branches"]) as branches:
        loss, metrics = gop_loss(spec, nchw5(mv_clip()), True, noise,
                                 TrainConfig(learning_rate=LR), MASK)
        loss.backward()
    assert noise.used == len(ref["draws"])
    print(f"{name}: loss port {float(loss.detach()):.6f} jax {ref['metrics']['loss']:.6f}; "
          f"{branches.flips} ReLU elements took JAX's other branch")
    assert_metrics_close(metrics, ref["metrics"])
    assert_grads_close(port_grads(params), in_port_layout(spec.module, ref["grads"]),
                       flow_path=FLOW_PATH)


@pytest.mark.parametrize("name", list(MODELS))
def test_two_train_steps_match_jax(reference, name):
    spec = port_model(name, MODELS[name])
    params = ready_for_training(spec)
    init_fn, step_fn = make_train_step(spec, TrainConfig(learning_rate=LR))
    opt_state = init_fn(params)
    gop = nchw5(mv_clip())
    seen = []
    for ref in reference[name]:
        clip = ref["clips"][0]
        with OnJaxBranches(clip["branches"]) as branches:
            params, opt_state, metrics = step_fn(params, opt_state, gop, Replay(clip["draws"]),
                                                 MASK)
        print(f"{branches.flips} ReLU elements took JAX's other branch")
        assert_metrics_close(metrics, clip["metrics"], (*METRICS, "grad_norm"))
        seen.append(in_port_layout(spec.module, ref["grads"]))
        assert_params_close(params, in_port_layout(spec.module, ref["params"]), seen, FLOW_PATH)


def test_batched_step_with_masks_matches_jax():
    """Two clips, view 2 failed in the first and view 0 in the second, each
    through JAX's gop_loss with its own mask: the port's batched step takes
    mask[b] with clip b, and its loss, metrics and the parameters after its
    Adam step are the clips' means, as JAX's vmapped step."""
    name, weights = "MCVC-IA-TINY", MODELS["MCVC-IA-TINY"]
    clips = [(mv_clip(0), MASK), (mv_clip(1), np.array([0, 1, 1], np.float32))]
    ref = jax_steps(name, weights, clips)[0]
    spec = port_model(name, weights)
    params = ready_for_training(spec)
    init_fn, step_fn = make_train_step(spec, TrainConfig(learning_rate=LR), batched=True)
    with OnJaxBranches([b for c in ref["clips"] for b in c["branches"]]) as branches:
        params, _, metrics = step_fn(
            params, init_fn(params), torch.stack([nchw5(g) for g, _ in clips]),
            Replay([d for c in ref["clips"] for d in c["draws"]]),
            torch.from_numpy(np.stack([m for _, m in clips])))
    print(f"{branches.flips} ReLU elements took JAX's other branch")
    want = {k: np.mean([c["metrics"][k] for c in ref["clips"]]) for k in METRICS}
    assert_metrics_close(metrics, {**want, "grad_norm": ref["grad_norm"]},
                         (*METRICS, "grad_norm"))
    assert_params_close(params, in_port_layout(spec.module, ref["params"]),
                        [in_port_layout(spec.module, ref["grads"])], FLOW_PATH)


def test_olft_gop_loss_drops_the_rate_term():
    """MCVC-IA-OLFT-TINY: gop_loss is sum(r * img_loss) plus the aux loss,
    no bpp_est (JAX's extras["olft"]); MCVC-IA-TINY on the same draws adds
    sum(bpp_est)."""
    gop = nchw5(mv_clip())
    out = {}
    for name in ("MCVC-IA-OLFT-TINY", "MCVC-IA-TINY"):
        spec = ft.get_codec_model(name, device="cpu", num_views=VIEWS)
        ft.load_asset(spec.module, "tiny_mcvc_l3")
        with torch.no_grad():
            loss, _ = gop_loss(spec, gop, True, UniformNoise(0), TrainConfig(), MASK)
            _, m = ft.rollout(spec, gop, MASK, training=True, noise=UniformNoise(0))
        out[name] = (spec.olft, float(loss), m, float(spec.module.aux_loss()), spec.r)
    olft, loss, m, aux, r = out["MCVC-IA-OLFT-TINY"]
    assert olft and not out["MCVC-IA-TINY"][0]
    assert loss == pytest.approx(float(torch.sum(r * m["img_loss"])) + aux, rel=1e-6)
    assert out["MCVC-IA-TINY"][1] == pytest.approx(loss + float(torch.sum(m["bpp_est"])),
                                                   rel=1e-6)
