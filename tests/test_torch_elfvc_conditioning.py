"""ELFVC-SP's flow-predictor gradient is ill-conditioned in float32 in both
packages, on the CPU: the card's 1.6e-3 gap from the CPU there
(ROADMAP.md section 3) is float32 conditioning, not a fault of the port.

ELFVC-SP at full width on seeded_flat("ELFVC-SP", 0), sp_stage 1 (as
cli/train.py builds it), one backward of gop_loss on the top-left 64x128
of a 4-frame synth_gop_multi clip (seed 0): chip_smoke.py phase 46's step.
JAX's float32 step runs first under ``jax.jit``, its draws and ReLU
branches recorded; the port replays both in float32 and in float64 (the
rate paths' ``Tensor.float()`` kept in float64,
``tools/fault_probe.py:float64_rates``). A gap is a parameter's max abs
difference over the reference gradient's max |grad|, the worst of the
submodule taken. At ``flow_predictor`` the bars are:

- the port's float32 stands from its float64 more than 1e-4 (a
  conditioning gap, not float32 rounding of a well-conditioned gradient),
  and within a factor of 2 of where JAX's float32 stands from it;
- the two packages' float32 steps stand less than a tenth of that gap
  apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.data.synthetic import synth_gop_multi
from fastvideocodec_torch.tools.fault_probe import by_submodule, float64_rates
from fastvideocodec_torch.tools.train_parity import own_gaps
from fastvideocodec_torch.train import TrainConfig, gop_loss
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model
from fastvideocodec_tpu.train import trainer as jax_trainer
from test_torch_train_common import (  # noqa: F401 (one_torch_thread: autouse here)
    JaxBranches,
    JaxDraws,
    OnJaxBranches,
    Replay,
    in_port_layout,
    jax_tree,
    one_torch_thread,
)

CODEC, H, W, GOP = "ELFVC-SP", 64, 128, 4
SUB = "flow_predictor"
MIN_GAP = 1e-4  # the port's float32 from its float64 at SUB
RATIO = 2.0  # the port's float32 gap against JAX's, both ways
APART = 0.1  # the two float32 steps' distance, a fraction of the gap


@pytest.fixture(scope="module")
def gaps():
    frames = synth_gop_multi(np.random.default_rng(0), size=max(H, W), gop=GOP)[:, :H, :W]
    flat = ft.seeded_flat(CODEC, 0)
    jspec = jax_get_codec_model(CODEC, sp_stage=1)
    draws, branches = JaxDraws(), JaxBranches()
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"):
        mp.setattr(jax.random, "uniform", draws)
        mp.setattr(jax.nn, "relu", branches)

        def loss(p):
            return jax_trainer.gop_loss(jspec, p, jnp.asarray(frames), True,
                                        jax.random.PRNGKey(3), jax_trainer.TrainConfig())

        _, jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jax_tree(flat))
        jax.block_until_ready(jgrads)
        jax.effects_barrier()
    draws, masks = draws.take(), branches.take()

    def port_step(dtype):
        spec = ft.get_codec_model(CODEC, device="cpu", sp_stage=1)
        ft.weights.load_flat(spec.module, flat)
        spec.module.to(dtype).train().requires_grad_(True)
        clip = torch.from_numpy(np.ascontiguousarray(frames)).permute(0, 3, 1, 2).to(dtype)
        noise = Replay(draws)
        with OnJaxBranches(masks):
            loss_value, _ = gop_loss(spec, clip.contiguous(), True, noise,
                                     TrainConfig(learning_rate=1e-4))
            loss_value.backward()
        assert noise.used == len(draws)
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().double()
                 for n, p in spec.module.named_parameters()}
        return spec, grads

    spec, f32 = port_step(torch.float32)
    with float64_rates():
        _, f64 = port_step(torch.float64)
    jax32 = {n: t.double() for n, t in
             in_port_layout(spec.module, ft.weights.flatten_params(jgrads)).items()}
    out = {"port_f32_vs_f64": by_submodule(own_gaps(f32, f64)),
           "jax_f32_vs_port_f64": by_submodule(own_gaps(jax32, f64)),
           "port_f32_vs_jax_f32": by_submodule(own_gaps(f32, jax32))}
    for key, subs in out.items():
        print(f"{key}: " + "; ".join(f"{s} {g:.3e} ({n})" for s, (g, n) in subs.items()))
    return {key: subs[SUB][0] for key, subs in out.items()}


def test_float32_flow_predictor_gradient_is_ill_conditioned_in_both_packages(gaps):
    port, ref = gaps["port_f32_vs_f64"], gaps["jax_f32_vs_port_f64"]
    assert port > MIN_GAP, gaps
    assert 1 / RATIO < port / ref < RATIO, gaps


def test_float32_flow_predictor_gradient_matches_jax(gaps):
    assert gaps["port_f32_vs_jax_f32"] < APART * gaps["port_f32_vs_f64"], gaps
