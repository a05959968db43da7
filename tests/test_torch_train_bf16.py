"""bf16 training in the port (JAX's ``--bf16``: flax's mixed precision,
float32 parameters and bfloat16 compute), on the CPU at tiny widths.

The port alone, on the shipped tiny weights and a synth_gop clip (numpy
seed 0) of 64x64, GOP 4, for each family's tiny name:
- the bf16 training build in eval mode, without noise, rolls out bit for
  bit as the bf16 inference build (``get_codec_model(name,
  dtype=torch.bfloat16)``) loaded with the same weights;
- after two bf16 steps of make_train_step every parameter and Adam moment
  is float32, the masters were loaded bit for bit and keep bits below
  bfloat16's mantissa, the quantiles train in the aux group, and
  ELFVC's frozen stage groups stay bit for bit;
- loss type M trains in bf16 (LSVC-TPU-TINY at 192 px).
Against JAX (tests/test_torch_train_common.py's ``bf16_drift_failures``):
one bf16 ``gop_loss`` with its gradient under JAX's draws replayed, for
LSVC-TPU-TINY, SSF-TPU-TINY and ELFVC-SP-TPU-TINY (MCVC-IA-TINY, DVC-TINY,
RLVC-TINY and Base-ER-TINY with soft2hard are
tests/test_torch_train_bf16_chain.py's), its metrics and gradient no
farther from the port's float32 step than JAX's bf16 step is, and a
control with the warps' flow gradient zeroed that misses the gradient bar.

JAX's ELFVC bf16 step fails on float32 frames as it stands: its rollout's
``lax.scan`` starts the state's ``x_ref_ref`` as bfloat16 zeros and gets a
float32 one back. The reference here runs with that zero state made
float32 (patched in the test, nothing in the JAX package changes), which
equals JAX's numbers wherever JAX runs (the zeros are exact either way).
"""

import numpy as np
import pytest
import torch

import fastvideocodec_torch as ft
import fastvideocodec_torch.ops.warp as ow
from fastvideocodec_torch.data.synthetic import synth_gop
from fastvideocodec_torch.layers.blocks import at_use, cast_once
from fastvideocodec_torch.ops.math import UniformNoise
from fastvideocodec_torch.weights import load_flat
from fastvideocodec_torch.train import (
    TrainConfig,
    elfvc_stage_trainable,
    gop_loss,
    make_elfvc_stage_optimizer,
    make_optimizer,
    make_train_step,
    ready_for_training,
)
from fastvideocodec_tpu.models import elfvc as jax_elfvc
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model
from fastvideocodec_tpu.train import trainer as jax_trainer
from test_torch_train_common import (  # noqa: F401 (one_torch_thread: autouse here)
    GOP,
    LR,
    SIZE,
    ZeroFlowGradient,
    asset_flat,
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

BF16 = torch.bfloat16
# each family's tiny name: (weights, get_codec_model's keywords); Base-EC-ER-TINY
# takes tiny_base_l2 (Base-ER-TINY's) where its tensors fit
TINY = {
    "LSVC-TPU-TINY": ("tiny_lsvctpu_l2", {}),
    "LSVC-TINY": ("tiny_lsvc_l2", {}),
    "SSF-TPU-TINY": ("tiny_ssftpu_l2", {}),
    "ELFVC-SP-TPU-TINY": ("tiny_elfvctpu_l3", {"sp_stage": 2}),
    "MCVC-IA-TINY": ("tiny_mcvc_l3", {"num_views": 3}),
    "DVC-TINY": ("tiny_dvc_l2", {}),
    "RLVC-TINY": ("tiny_rlvc_l2", {}),
    "Base-EC-ER-TINY": ("tiny_base_l2", {}),
}
MASK = np.array([1, 1, 0], np.float32)  # MCVC's view 2 failed
JAX_CASES = ("LSVC-TPU-TINY", "SSF-TPU-TINY", "ELFVC-SP-TPU-TINY")


def flat_of(name: str) -> dict:
    weights, _ = TINY[name]
    return seeded_with_asset(name, weights)


def gop_of(name: str):
    """(gop, mask) of the family's clip: MCVC's 3 views [T, V, 3, H, W]
    with view 2 failed, the others' [T, 3, H, W]."""
    if name.startswith("MCVC"):
        views = [synth_gop(np.random.default_rng(v), size=SIZE, gop=GOP) for v in range(3)]
        frames = np.stack(views, 1).transpose(0, 1, 4, 2, 3)
        return torch.from_numpy(np.ascontiguousarray(frames)), MASK
    return nchw(clip()), None


@pytest.mark.parametrize("name", list(TINY))
def test_training_build_evals_as_the_bf16_rollout(name):
    """Eval mode, no noise: the float32 masters cast at each conv's call
    give the bf16 build's numbers bit for bit."""
    flat = flat_of(name)
    kw = TINY[name][1]
    inference = ft.get_codec_model(name, dtype=BF16, device="cpu", **kw)
    load_flat(inference.module, flat)
    spec = bf16_spec(name, flat, **kw)
    params = ready_for_training(spec)
    assert {p.dtype for p in params.values()} == {torch.float32}
    spec.module.eval()
    gop, mask = gop_of(name)
    want = ft.rollout(inference, gop, mask)
    got = ft.rollout(spec, gop, mask)
    assert got[0].dtype == want[0].dtype == BF16
    assert torch.equal(got[0], want[0])
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k


@pytest.mark.parametrize("name", list(TINY))
def test_two_bf16_steps_keep_float32_masters(name):
    """Two steps of make_train_step (ELFVC's under its stage-2 optimizer):
    parameters and Adam moments float32, the loaded weights kept bit for
    bit until the first update, bits below bfloat16's mantissa after it,
    the quantiles in the aux group, ELFVC's frozen groups unchanged."""
    flat = flat_of(name)
    spec = bf16_spec(name, flat, **TINY[name][1])
    params = ready_for_training(spec)
    loaded = {n: p.detach().clone() for n, p in params.items()}
    widened = ft.get_codec_model(name, device="cpu", **TINY[name][1])
    load_flat(widened.module, flat)
    for n, p in widened.module.named_parameters():
        assert torch.equal(loaded[n], p), n  # every bit of the float32 weights
    cfg = TrainConfig(learning_rate=LR, soft2hard="-ER" in name)
    elfvc = spec.family == "elfvc"
    tx = make_elfvc_stage_optimizer(cfg, 2) if elfvc else make_optimizer(cfg)
    init_fn, step_fn = make_train_step(spec, cfg, optimizer=tx)
    opt_state = init_fn(params)
    gop, mask = gop_of(name)
    for seed in (1, 2):
        params, opt_state, m = step_fn(params, opt_state, gop, UniformNoise(seed), mask)
        assert all(np.isfinite(float(v)) for v in m.values()), m
    moments = [t for g in ("main", "aux") for k in ("mu", "nu") for t in opt_state[g][k].values()]
    assert {p.dtype for p in params.values()} | {t.dtype for t in moments} == {torch.float32}
    quantiles = {n for n in params if "quantile" in n}
    aux = {n for n in quantiles if tx.label(n) != "frozen"}  # ELFVC's stage freezes some
    assert set(opt_state["aux"]["mu"]) == aux and (elfvc or aux == quantiles)
    assert not quantiles & set(opt_state["main"]["mu"])
    if elfvc:
        trainable = elfvc_stage_trainable(2)
        frozen = [n for n in params if not trainable(tuple(n.split(".")))]
        assert frozen and all(torch.equal(params[n], loaded[n]) for n in frozen)
    moved = [n for n in opt_state["main"]["mu"] if not torch.equal(params[n], loaded[n])]
    assert len(moved) > 0.3 * len(opt_state["main"]["mu"])
    # an Adam step of lr 1e-4 lands off bfloat16's grid: float32 bits below
    # its mantissa in nearly every element that moved
    below = sum(int((p != p.to(BF16).float()).sum()) for p in (params[n] for n in moved))
    assert below > 0.9 * sum(params[n].numel() for n in moved)


def test_msssim_loss_trains_in_bf16():
    """Loss type M in bf16 on LSVC-TPU-TINY at 192 px (MS-SSIM needs frames
    above 160 px): two steps, finite, the recon widened for the metric."""
    spec = bf16_spec("LSVC-TPU-TINY", flat_of("LSVC-TPU-TINY"))
    spec.loss_type = "M"
    params = ready_for_training(spec)
    big = synth_gop(np.random.default_rng(0), size=192, gop=3)
    gop = torch.from_numpy(np.ascontiguousarray(big.transpose(0, 3, 1, 2)))
    init_fn, step_fn = make_train_step(spec, TrainConfig(learning_rate=LR))
    opt_state = init_fn(params)
    start = {n: p.detach().clone() for n, p in params.items()}
    for seed in (1, 2):
        params, opt_state, m = step_fn(params, opt_state, gop, UniformNoise(seed))
        assert all(np.isfinite(float(v)) for v in m.values()), m
        assert 0.0 < float(m["img_loss"]) < 1.0  # 1 - MS-SSIM
    assert any(not torch.equal(p, start[n]) for n, p in params.items()
               if n.startswith("mv_encoder"))


def test_cast_once_casts_each_master_once():
    """Inside cast_once a master's bf16 copy is made once and serves every
    use (with and without a gradient); each use's bf16 cotangent widens to
    float32 before the uses add up, so the master's gradient is bit for
    bit that of a cast at each call (flax's), not a bf16 sum widened once.
    Outside it each use casts anew."""
    torch.manual_seed(0)
    w = torch.randn(8, 4, requires_grad=True)
    xs = [torch.randn(3, 4).to(BF16) for _ in range(3)]

    def loss(ws):
        return sum(torch.sum((x @ c.t()).float() ** 2) for x, c in zip(xs, ws))

    with cast_once():
        copies = [at_use(w, BF16) for _ in xs]
        with torch.no_grad():
            detached = at_use(w, BF16)
        loss(copies).backward()
    assert len({c.data_ptr() for c in copies + [detached]}) == 1  # one cast
    assert all(c.dtype == BF16 and c.requires_grad for c in copies)
    assert not detached.requires_grad
    per_call = w.detach().clone().requires_grad_(True)
    loss([per_call.to(BF16) for _ in xs]).backward()
    assert w.grad.dtype == torch.float32 and torch.equal(w.grad, per_call.grad)
    summed = w.detach().to(BF16).requires_grad_(True)  # one cast as a leaf: a bf16 sum
    loss([summed] * len(xs)).backward()
    assert not torch.equal(w.grad, summed.grad.float())
    assert at_use(w, BF16) is not at_use(w, BF16)


def test_flow_warp_of_float32_frames_by_a_bf16_flow():
    """A bf16 training step warps its float32 frames by a bf16 flow: the
    warp takes the flow's coordinates in float32 (as JAX's warp does), and
    the flow's gradient comes back bfloat16, rounded once."""
    gen = torch.Generator().manual_seed(0)
    img = torch.rand(1, 3, 16, 16, generator=gen)
    flow = (torch.randn(1, 2, 16, 16, generator=gen) * 3).to(BF16).requires_grad_(True)
    out = ow.flow_warp(img, flow)
    assert out.dtype == torch.float32
    assert torch.equal(out, ow.plain_flow_warp(img, flow.detach().float()))
    g = torch.randn(out.shape, generator=gen)
    out.backward(g)
    want = ow.plain_warp_vjp("flow_warp", img, flow.detach().float(), g, need_img=False)[1]
    assert flow.grad.dtype == BF16 and torch.equal(flow.grad, want.to(BF16))


def test_ready_for_training_refuses_the_bf16_inference_build():
    """The inference build's conv weights were rounded to bfloat16: no
    float32 master is left to train."""
    with pytest.raises(ValueError, match="float32 master"):
        ready_for_training(ft.get_codec_model("DVC-TINY", dtype=BF16, device="cpu"))


def float32_zero_state(monkeypatch):
    """JAX's ELFVC state with its x_ref_ref zeros in float32 (the test
    module's docstring says why)."""
    init_state = jax_elfvc.ELFVC.init_state

    def patched(self, *shape):
        state = init_state(self, *shape)
        return state._replace(x_ref_ref=state.x_ref_ref.astype(np.float32))

    monkeypatch.setattr(jax_elfvc.ELFVC, "init_state", patched)


@pytest.fixture(scope="module")
def reference():
    """JAX's bf16 gop_loss and gradient for each case, on float32 frames."""
    import jax.numpy as jnp

    cases = [(jax_get_codec_model(name, dtype=jnp.bfloat16, **TINY[name][1]), flat_of(name),
              clip(), jax_trainer.TrainConfig(learning_rate=LR)) for name in JAX_CASES]
    with pytest.MonkeyPatch.context() as mp:
        float32_zero_state(mp)
        return dict(zip(JAX_CASES, jax_loss_grads(jax_trainer.gop_loss, cases)))


def test_jax_elfvc_bf16_fails_on_float32_frames():
    """The defect the reference works around: JAX's own ELFVC bf16 step on
    float32 frames does not trace."""
    import jax
    import jax.numpy as jnp

    from test_torch_train_common import jax_tree

    spec = jax_get_codec_model("ELFVC-SP-TPU-TINY", dtype=jnp.bfloat16, sp_stage=2)
    params = jax_tree(flat_of("ELFVC-SP-TPU-TINY"))
    with pytest.raises(TypeError, match="x_ref_ref"):
        jax.eval_shape(lambda p: jax_trainer.gop_loss(
            spec, p, jnp.asarray(clip()), True, jax.random.PRNGKey(3),
            jax_trainer.TrainConfig()), params)


def port_runs(name: str, draws: list, control: bool = False):
    """The port's float32 and bf16 steps of ``name`` under ``draws`` (with
    ``control``, the bf16 step alone with the warps' flow gradient
    zeroed)."""
    flat, kw = flat_of(name), TINY[name][1]
    cfg = TrainConfig(learning_rate=LR)
    if control:
        with ZeroFlowGradient():
            return port_step_grads(bf16_spec(name, flat, **kw), nchw(clip()), draws, cfg)
    f32 = port_step_grads(f32_spec(name), nchw(clip()), draws, cfg)
    return f32, port_step_grads(bf16_spec(name, flat, **kw), nchw(clip()), draws, cfg)


def f32_spec(name: str):
    spec = ft.get_codec_model(name, device="cpu", **TINY[name][1])
    load_flat(spec.module, flat_of(name))
    return spec


def jax_in_port_layout(name: str, reference) -> tuple:
    jm, jg, _ = reference[name]
    return jm, in_port_layout(f32_spec(name).module, jg)


@pytest.mark.parametrize("name", JAX_CASES)
def test_bf16_step_within_jax_drift(reference, name):
    f32, bf16 = port_runs(name, reference[name][2])
    misses = bf16_drift_failures(bf16, jax_in_port_layout(name, reference), f32)
    assert misses == {"metrics": {}, "grads": {}}, misses


@pytest.mark.parametrize("name", JAX_CASES)
def test_zeroed_flow_gradient_misses_the_bar(reference, name):
    """The control: with the warps' flow gradient zeroed the bf16 step
    misses the gradient bar."""
    draws = reference[name][2]
    f32, _ = port_runs(name, draws)
    control = port_runs(name, draws, control=True)
    assert bf16_drift_failures(control, jax_in_port_layout(name, reference), f32)["grads"]
