"""bf16 training of the port's MCVC and chain codecs against JAX's, on the
CPU at tiny widths, and the bf16 checkpoints and OLFT step.

One bf16 ``gop_loss`` with its gradient under JAX's draws replayed, held
by tests/test_torch_train_common.py's ``bf16_drift_failures`` (the port's
bf16 step no farther from its float32 step than JAX's bf16 step is), with
a control that zeroes the warps' flow gradient and must miss the gradient
bar (MCVC's scales it by a hundred: its docstring says why), for:
- MCVC-IA-TINY on tiny_mcvc_l3, 3 views of 64x64 (synth_mv_gop, numpy
  seed 0), GOP 4, view 2 failed;
- DVC-TINY on tiny_dvc_l2, RLVC-TINY on tiny_rlvc_l2 (JAX's RPM draws twice
  a latent, the port once) and Base-ER-TINY on tiny_base_l2 with the
  soft2hard three passes (JAX draws each pass's anew from one key, the
  port replays pass 0's), on a synth_gop clip of 64x64, GOP 4.
Besides: a bf16 run checkpoints its float32 masters, and --resume of a
bf16 checkpoint into a bf16 run and of a float32 checkpoint into a bf16 run
restore every bit; MCVC-IA-OLFT-TINY's OLFT step runs in bf16 (JAX's
``make_olft_step`` traces with a bf16 spec too) on float32 masters.
"""

import numpy as np
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.data.synthetic import synth_mv_gop
from fastvideocodec_torch.ops.math import UniformNoise
from fastvideocodec_torch.train import (
    TrainConfig,
    load_checkpoint,
    make_olft_step,
    make_train_step,
    ready_for_training,
    save_checkpoint,
)
from fastvideocodec_torch.weights import load_flat
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model
from fastvideocodec_tpu.train import trainer as jax_trainer
from test_torch_train_common import (  # noqa: F401 (one_torch_thread: autouse here)
    GOP,
    LR,
    SIZE,
    ZeroFlowGradient,
    bf16_drift_failures,
    bf16_spec,
    clip,
    in_port_layout,
    jax_loss_grads,
    nchw,
    one_torch_thread,
    port_step_grads,
    seeded_with_asset,
)

VIEWS = 3
MCVC_CONTROL_SCALE = 100.0
MASK = np.array([1, 1, 0], np.float32)  # view 2 failed
# case: (registry name, weights, get_codec_model's keywords, soft2hard)
CASES = {
    "MCVC-IA-TINY": ("MCVC-IA-TINY", "tiny_mcvc_l3", {"num_views": VIEWS}, False),
    "DVC-TINY": ("DVC-TINY", "tiny_dvc_l2", {}, False),
    "RLVC-TINY": ("RLVC-TINY", "tiny_rlvc_l2", {}, False),
    "Base-ER-TINY soft2hard": ("Base-ER-TINY", "tiny_base_l2", {}, True),
}


def flat_of(case: str) -> dict:
    name, weights, _, _ = CASES[case]
    return seeded_with_asset(name, weights)


def mv_clip() -> np.ndarray:
    """[T, V, H, W, 3]: JAX's gop [T, B*V, H, W, 3] with B = 1."""
    return synth_mv_gop(np.random.default_rng(0), views=VIEWS, size=SIZE, gop=GOP)


def inputs(case: str):
    """(JAX's gop, the port's gop, the view mask or None)."""
    if case.startswith("MCVC"):
        frames = mv_clip()
        return frames, torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 1, 4, 2, 3))), MASK
    return clip(), nchw(clip()), None


def cfg_of(case: str) -> TrainConfig:
    return TrainConfig(learning_rate=LR, soft2hard=CASES[case][3])


@pytest.fixture(scope="module")
def reference():
    """JAX's bf16 gop_loss and gradient for each case, on float32 frames,
    the draws as the port replays them."""
    import jax.numpy as jnp

    cases = []
    for case, (name, _, kw, s2h) in CASES.items():
        gop, _, mask = inputs(case)
        cases.append((jax_get_codec_model(name, dtype=jnp.bfloat16, **kw), flat_of(case), gop,
                      jax_trainer.TrainConfig(learning_rate=LR, soft2hard=s2h),
                      *([] if mask is None else [mask])))
    out = {}
    for case, (jm, jg, draws) in zip(CASES, jax_loss_grads(jax_trainer.gop_loss, cases)):
        if case.startswith("RLVC"):  # one key for both RPM branches: equal pairs
            for a, b in zip(draws[::2], draws[1::2]):
                np.testing.assert_array_equal(a, b)
            draws = draws[::2]
        if CASES[case][3]:  # soft2hard: three passes of one key's draws
            per_pass = len(draws) // 3
            for k in (1, 2):
                for a, b in zip(draws[:per_pass], draws[k * per_pass:(k + 1) * per_pass]):
                    np.testing.assert_array_equal(a, b)
            draws = draws[:per_pass]
        out[case] = (jm, jg, draws)
    return out


def f32_spec(case: str):
    name, _, kw, _ = CASES[case]
    spec = ft.get_codec_model(name, device="cpu", **kw)
    load_flat(spec.module, flat_of(case))
    return spec


def port_runs(case: str, draws: list):
    """The port's float32 and bf16 steps of ``case`` under ``draws``."""
    name, _, kw, _ = CASES[case]
    _, gop, mask = inputs(case)
    f32 = port_step_grads(f32_spec(case), gop, draws, cfg_of(case), mask)
    bf16 = port_step_grads(bf16_spec(name, flat_of(case), **kw), gop, draws, cfg_of(case), mask)
    return f32, bf16


def jax_in_port_layout(case: str, reference) -> tuple:
    jm, jg, _ = reference[case]
    return jm, in_port_layout(f32_spec(case).module, jg)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_step_within_jax_drift(reference, case):
    f32, bf16 = port_runs(case, reference[case][2])
    misses = bf16_drift_failures(bf16, jax_in_port_layout(case, reference), f32)
    assert misses == {"metrics": {}, "grads": {}}, misses


@pytest.mark.parametrize("case", list(CASES))
def test_zeroed_flow_gradient_misses_the_bar(reference, case):
    """The control: with the warps' flow gradient zeroed the bf16 step
    misses the gradient bar. MCVC-IA-TINY's motion decoder gradient
    cancels to float32 noise (1e-5 of the largest gradient), and a bf16
    step stands 96 to 97 times its float32 norm from it in both packages,
    most of that through the volume's scale weights, not the warp: the
    flow gradient zeroed moves it by less than that noise, and ten times
    the flow gradient to 118 times its norm, still under the bar (2 x 96).
    MCVC's control scales the flow gradient by MCVC_CONTROL_SCALE
    instead: on this path the bar sees a flow gradient off by a factor of
    a hundred, not of ten."""
    name, _, kw, _ = CASES[case]
    draws = reference[case][2]
    _, gop, mask = inputs(case)
    f32 = port_step_grads(f32_spec(case), gop, draws, cfg_of(case), mask)
    with ZeroFlowGradient(MCVC_CONTROL_SCALE if case.startswith("MCVC") else 0.0):
        control = port_step_grads(bf16_spec(name, flat_of(case), **kw), gop, draws,
                                  cfg_of(case), mask)
    assert bf16_drift_failures(control, jax_in_port_layout(case, reference), f32)["grads"]


def two_steps(spec, seeds=(1, 2), opt_state=None):
    """Steps of make_train_step on the DVC clip: (params, opt_state)."""
    params = ready_for_training(spec)
    init_fn, step_fn = make_train_step(spec, TrainConfig(learning_rate=LR))
    opt_state = init_fn(params) if opt_state is None else opt_state
    for seed in seeds:
        params, opt_state, _ = step_fn(params, opt_state, nchw(clip()), UniformNoise(seed))
    return params, opt_state


def restore(spec, state: dict) -> None:
    """cli/train.py's --resume: the checkpoint's parameters copied in."""
    with torch.no_grad():
        for name, p in ready_for_training(spec).items():
            p.copy_(state["params"][name])


def test_bf16_checkpoints_float32_masters_and_resumes_bit_for_bit(tmp_path):
    """A bf16 run saves float32 masters; resuming it in bf16, or a float32
    run's checkpoint in bf16, restores every bit, and the next bf16 step
    from a resumed run equals the uninterrupted run's."""
    flat = flat_of("DVC-TINY")
    spec = bf16_spec("DVC-TINY", flat)
    params, opt_state = two_steps(spec, seeds=(1,))
    state = {"params": {n: p.detach() for n, p in params.items()}, "opt_state": opt_state,
             "epoch": 0, "score": 1.0}
    save_checkpoint(str(tmp_path / "bf16"), state)
    loaded = load_checkpoint(str(tmp_path / "bf16"))
    assert {t.dtype for t in loaded["params"].values()} == {torch.float32}
    resumed = bf16_spec("DVC-TINY", ft.seeded_flat("DVC-TINY", 1))
    restore(resumed, loaded)
    for n, p in resumed.module.named_parameters():
        assert torch.equal(p, params[n]), n
    after, _ = two_steps(resumed, seeds=(2,), opt_state=loaded["opt_state"])
    uninterrupted, _ = two_steps(bf16_spec("DVC-TINY", flat), seeds=(1, 2))
    for n, p in after.items():
        assert torch.equal(p, uninterrupted[n]), n
    f32_params, f32_state = two_steps(f32_spec("DVC-TINY"), seeds=(1,))
    save_checkpoint(str(tmp_path / "f32"), {"params": {n: p.detach() for n, p in
                                                      f32_params.items()},
                                            "opt_state": f32_state, "epoch": 0, "score": 1.0})
    into_bf16 = bf16_spec("DVC-TINY", flat)
    restore(into_bf16, load_checkpoint(str(tmp_path / "f32")))
    for n, p in into_bf16.module.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p, f32_params[n]), n


def test_olft_step_runs_in_bf16():
    """MCVC-IA-OLFT-TINY's OLFT step in bf16 on tiny_mcvc_l3, view 2 failed:
    two steps, finite metrics, float32 masters and Adam moments, the
    touch-up labels float32 beside the bf16 plain references (JAX's
    jnp.where promotes them)."""
    spec = bf16_spec("MCVC-IA-OLFT-TINY", flat_of("MCVC-IA-TINY"), num_views=VIEWS)
    params = ready_for_training(spec)
    init_fn, step_fn = make_olft_step(spec, TrainConfig(learning_rate=LR), ratio=0.1)
    opt_state = init_fn(params)
    _, gop, mask = inputs("MCVC-IA-TINY")
    start = {n: p.detach().clone() for n, p in params.items()}
    for seed in (1, 2):
        params, opt_state, m = step_fn(params, opt_state, gop, UniformNoise(seed), mask)
        assert m["touch_refs"].dtype == torch.bfloat16
        assert m["touch_labels"].dtype == torch.float32
        assert all(np.isfinite(float(v)) for k, v in m.items() if not k.startswith("touch_"))
    moments = [t for k in ("mu", "nu") for t in opt_state["main"][k].values()]
    assert {p.dtype for p in params.values()} | {t.dtype for t in moments} == {torch.float32}
    # the keyframe's and backup decoders' transforms take part too; the
    # motion path alone moves little: more than a quarter of the tensors
    assert sum(not torch.equal(p, start[n]) for n, p in params.items()) > len(params) // 4
