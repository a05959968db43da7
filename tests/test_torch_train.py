"""LSVC-TPU training in the port against the JAX package, on the CPU, in
float32, under the same quantization noise.

The JAX side's ``fastvideocodec_tpu.models.lsvc.quantize`` is wrapped with
pytest's MonkeyPatch (nothing in the JAX package changes): in training it
draws u = jax.random.uniform(rng, x.shape, x.dtype, -0.5, 0.5) itself and
returns x + u, and a ``jax.debug.callback`` records each draw by the order
in which the trace met it. The JAX functions run under ``jax.jit`` (run
eagerly, one step compiled each primitive anew: about 200 s a step on a
CPU); the draws are jax.random's either way. The port replays the
recorded draws in that order through its noise source (NHWC to NCHW).

Reference values are computed once per module (a module fixture):
LSVC-TPU-TINY on tiny_lsvctpu_l2 and a synth_gop clip (numpy seed 0,
64x64, GOP 4) through JAX's own ``make_train_step`` step function for two
steps (the gradients of each step read from a pass-through optax stage
chained before JAX's ``make_optimizer``), and ``jax.value_and_grad`` of
``gop_loss`` for the chain graph (LSVC-TPU-TINY-L) and for the tiny module
with ``detach_tree`` and with ``per_layer_mv`` (both registries ignore -D
in a -TINY name, so those are built from their fields: flax's
``module.clone`` in JAX, the same attributes in the port).

Tolerances (float32 conv stacks summed in another order; measured on
the CPU in brackets):
- the loss and gop_loss's metrics: 1e-5 relative [5.1e-6, the chain];
- each parameter's gradient, carried into the port's layout by
  ``weights.load_flat`` (a transpose: linear): max abs within GRAD_REL =
  3e-5 of that parameter's max |grad| [8.0e-6, per_layer_mv];
- the parameters after each of two steps: PARAM_ABS = 2e-5 absolute
  [6.3e-6], grad_norm 1e-5 relative [2.2e-6]. Adam's first step moves a
  parameter by about lr * sign(g), so a gradient that differed in sign
  between the packages (one near 0) would put that parameter 2 lr = 2e-4
  apart, ten times the bar: at these inputs none does, and such a flip
  would fail here.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fastvideocodec_torch as ft
import fastvideocodec_tpu.models.lsvc as jax_lsvc
from fastvideocodec_torch.data.synthetic import synth_gop
from fastvideocodec_torch.train import (
    TrainConfig,
    gop_loss,
    make_train_step,
    ready_for_training,
)
from fastvideocodec_torch.weights import flatten_params, load_flat
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model
from fastvideocodec_tpu.train import trainer as jax_trainer
from fastvideocodec_tpu.train.checkpoint import asset_params

GOP, SIZE = 4, 64
ASSET = "tiny_lsvctpu_l2"
LR = 1e-4
GRAD_REL = 3e-5
PARAM_ABS = 2e-5
METRICS = ("loss", "psnr", "bpp", "img_loss", "aux")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port runs as fast on one thread at these sizes, and the suite's
    parallel workers share the host's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def clip() -> np.ndarray:
    return synth_gop(np.random.default_rng(0), size=SIZE, gop=GOP)


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))


class JaxDraws:
    """The wrapper of JAX's LSVC quantize: training draws by jax.random,
    recorded by trace order."""

    def __init__(self):
        self.draws = {}
        self.traced = 0
        self.orig = jax_lsvc.quantize

    def __call__(self, x, training, rng=None):
        if not training:
            return self.orig(x, training, rng)
        u = jax.random.uniform(rng, x.shape, x.dtype, -0.5, 0.5)
        index = self.traced
        self.traced += 1
        jax.debug.callback(lambda v, i=index: self.draws.__setitem__(i, np.asarray(v)), u)
        return x + u

    def take(self) -> list:
        """The draws of the last run, in order; resets the record."""
        out = [self.draws[i] for i in range(len(self.draws))]
        self.draws, self.traced = {}, 0
        return out


class Replay:
    """The port's noise source: the recorded NHWC draws, in order, as NCHW."""

    def __init__(self, draws):
        self.draws = list(draws)
        self.used = 0

    def __call__(self, x):
        u = nchw(self.draws[self.used]).to(x.device, x.dtype)
        self.used += 1
        assert u.shape == x.shape, (u.shape, x.shape)
        return u


def grab_grads():
    """A pass-through optax stage that keeps the incoming gradients in its
    state."""
    return optax.GradientTransformation(
        lambda params: {"g": jax.tree.map(jnp.zeros_like, params)},
        lambda updates, state, params=None: (updates, {"g": updates}),
    )


def jax_module(fields):
    spec = jax_get_codec_model("LSVC-TPU-TINY-L" if fields == "chain" else "LSVC-TPU-TINY")
    if fields in ("detach_tree", "per_layer_mv"):
        spec = dataclasses.replace(spec, module=spec.module.clone(**{fields: True}))
    return spec


def port_module(fields):
    spec = ft.get_codec_model("LSVC-TPU-TINY-L" if fields == "chain" else "LSVC-TPU-TINY",
                              device="cpu")
    ft.load_asset(spec.module, ASSET)
    if fields in ("detach_tree", "per_layer_mv"):
        setattr(spec.module, fields, True)
    return spec


@pytest.fixture(scope="module")
def reference():
    """JAX's values: two make_train_step steps of the tree module, and the
    value_and_grad of gop_loss for each of the other forms."""
    cfg = jax_trainer.TrainConfig(learning_rate=LR)
    gop = jnp.asarray(clip())
    params = {"params": asset_params(ASSET)["params"]}
    rec = JaxDraws()
    out = {}
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"):
        mp.setattr(jax_lsvc, "quantize", rec)
        spec = jax_module("tree")
        tx = optax.chain(grab_grads(), jax_trainer.make_optimizer(cfg))
        init_fn, step_fn = jax_trainer.make_train_step(spec, cfg, optimizer=tx)
        opt_state = init_fn(params)
        step = jax.jit(step_fn)
        steps = []
        for seed in (1, 2):
            params, opt_state, metrics = step(params, opt_state, gop, jax.random.PRNGKey(seed))
            jax.block_until_ready(params)
            steps.append({"draws": rec.take(), "grads": flatten_params(opt_state[0]["g"]),
                          "params": flatten_params(params),
                          "metrics": {k: float(v) for k, v in metrics.items()}})
        out["steps"] = steps
        for fields in ("chain", "detach_tree", "per_layer_mv"):
            spec = jax_module(fields)
            p0 = {"params": asset_params(ASSET)["params"]}
            (_, metrics), grads = jax.jit(jax.value_and_grad(
                lambda p, spec=spec: jax_trainer.gop_loss(spec, p, gop, True,
                                                          jax.random.PRNGKey(3), cfg),
                has_aux=True))(p0)
            jax.block_until_ready(grads)
            out[fields] = {"draws": rec.take(), "grads": flatten_params(grads),
                           "metrics": {k: float(v) for k, v in metrics.items()}}
    return out


def grads_in_port_layout(module, flat_grads) -> dict:
    """JAX's gradients carried onto a clone of ``module`` by load_flat."""
    clone = copy.deepcopy(module)
    load_flat(clone, flat_grads)
    return {k: v.detach() for k, v in clone.state_dict().items()}


def assert_grads_close(port_grads: dict, jax_grads: dict):
    for name, want in jax_grads.items():
        scale = float(want.abs().max())
        err = float((port_grads[name] - want).abs().max())
        assert err <= GRAD_REL * max(scale, 1e-12), (name, err, scale)


def assert_metrics_close(got: dict, want: dict):
    for k in METRICS:
        value = float(got[k].detach())
        assert abs(value - want[k]) <= 1e-5 * max(abs(want[k]), 1e-6), (k, value, want[k])


def test_port_draws_in_jax_order(reference):
    """The JAX forward draws the mv latent, then per layer z before the
    feature (LSVC-TPU-TINY, GOP 4: a 3-frame mv batch, layers of 1 and 2
    frames); per_layer_mv draws each layer's mv latent inside it."""
    shapes = [d.shape for d in reference["steps"][0]["draws"]]
    assert shapes == [(3, 4, 4, 48), (1, 1, 1, 64), (1, 4, 4, 96), (2, 1, 1, 64),
                      (2, 4, 4, 96)]
    shapes = [d.shape for d in reference["per_layer_mv"]["draws"]]
    assert shapes == [(1, 4, 4, 48), (1, 1, 1, 64), (1, 4, 4, 96), (2, 4, 4, 48),
                      (2, 1, 1, 64), (2, 4, 4, 96)]


@pytest.mark.parametrize("fields", ["tree", "chain", "detach_tree", "per_layer_mv"])
def test_loss_metrics_and_gradients_match_jax(reference, fields):
    ref = reference["steps"][0] if fields == "tree" else reference[fields]
    spec = port_module(fields)
    params = ready_for_training(spec)
    noise = Replay(ref["draws"])
    loss, metrics = gop_loss(spec, nchw(clip()), True, noise, TrainConfig(learning_rate=LR))
    loss.backward()
    assert noise.used == len(ref["draws"])
    assert_metrics_close(metrics, ref["metrics"])
    want = grads_in_port_layout(spec.module, ref["grads"])
    got = {name: p.grad if p.grad is not None else torch.zeros_like(p)
           for name, p in params.items()}
    assert set(got) == set(want)
    assert_grads_close(got, want)


def test_two_train_steps_match_jax(reference):
    spec = port_module("tree")
    params = ready_for_training(spec)
    init_fn, step_fn = make_train_step(spec, TrainConfig(learning_rate=LR))
    opt_state = init_fn(params)
    gop = nchw(clip())
    for ref in reference["steps"]:
        params, opt_state, metrics = step_fn(params, opt_state, gop, Replay(ref["draws"]))
        assert_metrics_close(metrics, ref["metrics"])
        g = ref["metrics"]["grad_norm"]
        assert abs(float(metrics["grad_norm"]) - g) <= 1e-5 * g
        want = grads_in_port_layout(spec.module, ref["params"])
        for name, p in params.items():
            err = float((p.detach() - want[name]).abs().max())
            assert err <= PARAM_ABS, (name, err)
