"""What tests/test_torch_train_ssf.py and tests/test_torch_train_elfvc.py
share: the tiny clip, the recording of JAX's draws and their replay in the
port, the carrying of JAX's flat tensors onto the port's parameter names,
and the bars that hold the port's training to JAX's (one copy of each).
It holds no test of its own.

JAX draws its training noise inline with ``jax.random.uniform``. For each
traced call that function is replaced by a ``JaxDraws`` (with pytest's
MonkeyPatch: nothing in the JAX package changes), whose ordered
``jax.debug.callback`` records every draw in the order the run makes it
(the SSF rollouts draw inside ``lax.scan``, where a trace meets each draw
once but the run makes it once a frame). The port replays them in that
order through ``Replay`` (NHWC to NCHW).

The bars:
- loss and metrics within METRIC_REL = 1e-5 relative;
- each gradient within GRAD_REL = 1e-4 of its parameter's max |grad|, that
  scale floored at NOISE_FLOOR = 1e-5 of the largest gradient of all:
  below it a gradient is float32 noise in both packages (the SPnets' last
  blocks' biases before their GroupNorm: 1e-11 of the largest);
- the parameters after Adam's steps (``assert_params_close``). Adam's
  first step is lr * g / (|g| + 1e-8): it turns on g's sign, and near
  1e-8 on g's size; a later step also turns on the ratio of the steps'
  gradients, so its error is about lr times their relative error. Where
  JAX's gradient in every step is 0 or at least SETTLED = 3 GRAD_REL of
  its parameter's max |grad| (its sign is then the port's), an element is
  held within PARAM_ABS = 1e-6, or one float32 ulp of the parameter where
  larger (the optimizer's rounding against optax on XLA:CPU, ROADMAP.md
  section 3), after one step, and after more within that plus 2 lr times
  GRAD_REL over its smallest share of the max (the gradient bar's
  relative error at that element); elsewhere within 2 lr a step (a
  gradient within float32 noise of 0 may take either sign, and Adam moves
  it about lr either way). Measured on the four models' two steps and
  stage steps: after one step, at SETTLED = GRAD_REL 1 to 3 elements a
  model moved 1.3 to 3.0 times the bar (gradients 1.0e-4 to 2.7e-4 of
  their max, in the motion decoders), at 3 GRAD_REL the worst held at
  0.84 of it; after two, at the plain 1e-6 bar an element at 8.6e-3 of its
  max (SSF-TPU-TINY's motion_encoder.Conv_2.weight) moved 1.2e-6.
  ``assert_params_close`` prints how many elements it holds to 2 lr a
  step.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastvideocodec_torch.data.synthetic import synth_gop
from fastvideocodec_torch.weights import load_flat

GOP, SIZE = 4, 64
LR = 1e-4
GRAD_REL = 1e-4
NOISE_FLOOR = 1e-5  # of the largest gradient: a smaller gradient scale is float32 noise
METRIC_REL = 1e-5
PARAM_ABS = 1e-6
SETTLED = 3 * GRAD_REL  # from this share of the max up a gradient's sign is JAX's
METRICS = ("loss", "psnr", "bpp", "img_loss", "aux")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port runs as fast on one thread at these sizes, and the suite's
    parallel workers share the host's cores (autouse in each module that
    imports it)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t) -> np.ndarray:
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def clip() -> np.ndarray:
    return synth_gop(np.random.default_rng(0), size=SIZE, gop=GOP)


class JaxDraws:
    """``jax.random.uniform`` wrapped to record each draw's values, in the
    order the run makes them (an ordered debug callback)."""

    def __init__(self):
        self.orig = jax.random.uniform
        self.draws = []

    def __call__(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        u = self.orig(key, shape, dtype, minval, maxval)
        jax.debug.callback(lambda v: self.draws.append(np.asarray(v)), u, ordered=True)
        return u

    def take(self) -> list:
        out, self.draws = self.draws, []
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


def in_port_layout(module, flat) -> dict:
    """JAX's flat tensors (parameters or gradients) carried onto a clone of
    ``module`` by load_flat (a transpose of each kernel: linear)."""
    clone = copy.deepcopy(module)
    load_flat(clone, flat)
    return {k: v.detach() for k, v in clone.state_dict().items()}


def port_grads(params: dict) -> dict:
    return {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in params.items()}


def assert_close_to_scale(got: torch.Tensor, want: torch.Tensor, rel: float, what):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * max(scale, 1e-12), (what, err, scale)


def assert_grads_close(port: dict, jax_grads: dict, rel: float = GRAD_REL):
    """Each parameter's gradient within ``rel`` of its max |grad|, that
    scale floored at NOISE_FLOOR of the largest gradient of all."""
    assert set(port) == set(jax_grads)
    floor = NOISE_FLOOR * max(float(w.abs().max()) for w in jax_grads.values())
    for name, want in jax_grads.items():
        scale = max(float(want.abs().max()), floor)
        err = float((port[name] - want).abs().max())
        assert err <= rel * scale, (name, err, scale)


def assert_metrics_close(got: dict, want: dict, keys=METRICS):
    for k in keys:
        value = float(got[k].detach())
        assert abs(value - want[k]) <= METRIC_REL * max(abs(want[k]), 1e-6), (k, value, want[k])


def assert_params_close(params: dict, want: dict, jax_grads: list):
    """The parameters after len(jax_grads) steps against JAX's, at each
    element whose gradient in every step (JAX's, ``jax_grads``) is 0 or at
    least SETTLED of its parameter's max |grad|: within PARAM_ABS, or one
    float32 ulp of the parameter where larger, plus after more than one
    step 2 lr GRAD_REL over the element's smallest share of its max;
    within 2 lr a step elsewhere. Prints how many elements that leaves at
    2 lr a step."""
    steps = len(jax_grads)
    loose = 2 * LR * steps + PARAM_ABS
    exempt = total = 0
    for name, p in params.items():
        w = want[name]
        a = w.abs()
        ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
        share = torch.full_like(w, float("inf"))  # the smallest nonzero share of the max
        for g in jax_grads:
            mag = g[name].abs()
            share = torch.where(mag > 0, torch.minimum(share, mag / mag.max()), share)
        signed = share >= SETTLED
        bar = torch.clamp(ulp, min=PARAM_ABS)
        if steps > 1:
            bar = bar + 2 * LR * GRAD_REL / share
        bar = torch.where(signed, torch.clamp(bar, max=loose), torch.full_like(w, loose))
        exempt += int((~signed).sum())
        total += w.numel()
        gap = (p.detach() - w).abs()
        assert bool((gap <= bar).all()), (name, float(torch.where(signed, gap, 0.0).max()),
                                          float((gap / bar).max()))
    print(f"parameters after {steps} step(s): {exempt} of {total} elements "
          f"({exempt / total:.3%}) have a gradient under SETTLED = {SETTLED:.0e} of their "
          f"parameter's max in some step and are held to 2 lr a step")
