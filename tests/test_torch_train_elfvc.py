"""ELFVC-SP ("Vesper") training in the port against the JAX package, on
the CPU, in float32, under the same quantization noise, and the training
CLI on its default codec. JAX's draws are recorded and replayed, and the
bars set, as tests/test_torch_train_common.py sets them out.

What is held to JAX, for ELFVC-SP-TPU-TINY on tiny_elfvctpu_l3 and
ELFVC-SP-TINY on tiny_elfvc_l3, both at sp_stage 2, a synth_gop clip
(numpy seed 0) of 64x64, GOP 4:
- the draws: each P-frame the motion hyperprior's z and y, then the
  residual's;
- JAX's ``make_train_step`` for two steps (the first step's gradients read
  from a pass-through optax stage chained before the optimizer): the loss
  and metrics (ELFVC-SP's loss adds alpha * sum(pred_err_norm)), every
  gradient and the parameters after each step at the shared bars;
- one step of each ``make_elfvc_stage_optimizer`` stage 0, 1 and 2 from
  the shipped weights under the first step's draws, against JAX's stage
  optimizer on JAX's gradients: the parameters as above, every parameter
  outside the stage's groups exactly unchanged in both packages, and the
  groups found on the port's parameter names (``motion_hyperprior.
  y_predictor.*``) as on JAX's paths.
And ``rollout(training=True)`` builds and runs for every ELFVC name; and
``python -m fastvideocodec_torch.cli.train`` with its default codec
(ELFVC-SP, full width, seeded) takes a step on a directory of PNGs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.cli import train as cli
from fastvideocodec_torch.data.synthetic import synth_gop
from fastvideocodec_torch.ops.math import UniformNoise
from fastvideocodec_torch.train import (
    TrainConfig,
    gop_loss,
    load_checkpoint,
    make_elfvc_stage_optimizer,
    make_train_step,
    ready_for_training,
)
from fastvideocodec_torch.weights import flatten_params, load_flat
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model
from fastvideocodec_tpu.train import trainer as jax_trainer
from fastvideocodec_tpu.train.checkpoint import asset_params
from test_torch_train_common import (  # noqa: F401 (one_torch_thread: autouse here)
    GOP,
    LR,
    METRICS,
    SIZE,
    JaxDraws,
    Replay,
    assert_grads_close,
    assert_metrics_close,
    assert_params_close,
    clip,
    grab_grads,
    in_port_layout,
    nchw,
    one_torch_thread,
    port_grads,
)

SP_STAGE = 2
MODELS = {"ELFVC-SP-TPU-TINY": "tiny_elfvctpu_l3", "ELFVC-SP-TINY": "tiny_elfvc_l3"}
ELFVC_NAMES = ("ELFVC", "ELFVC-SP", "ELFVC-TPU", "ELFVC-SP-TPU", "ELFVC-TINY", "ELFVC-SP-TINY",
               "ELFVC-TPU-TINY", "ELFVC-SP-TPU-TINY")
STAGES = (0, 1, 2)


def jax_reference(name, asset, gop):
    """Two make_train_step steps from the shipped weights (draws, gradients,
    parameters, metrics), and one update of each stage optimizer on the
    first step's gradients."""
    cfg = jax_trainer.TrainConfig(learning_rate=LR)
    params0 = {"params": asset_params(asset)["params"]}
    rec = JaxDraws()
    steps = []
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"):
        mp.setattr(jax.random, "uniform", rec)
        spec = jax_get_codec_model(name, sp_stage=SP_STAGE)
        tx = optax.chain(grab_grads(), jax_trainer.make_optimizer(cfg))
        init_fn, step_fn = jax_trainer.make_train_step(spec, cfg, optimizer=tx)
        params, opt_state = params0, init_fn(params0)
        step = jax.jit(step_fn)
        for seed in (1, 2):
            params, opt_state, metrics = step(params, opt_state, gop, jax.random.PRNGKey(seed))
            jax.block_until_ready(params)
            if seed == 1:
                grads0 = opt_state[0]["g"]
            steps.append({"draws": rec.take(), "grads": flatten_params(opt_state[0]["g"]),
                          "params": flatten_params(params),
                          "metrics": {k: float(v) for k, v in metrics.items()}})
    stages = {}
    for stage in STAGES:
        stx = jax_trainer.make_elfvc_stage_optimizer(cfg, stage)
        updates, _ = jax.jit(stx.update)(grads0, stx.init(params0), params0)
        stages[stage] = flatten_params(optax.apply_updates(params0, updates))
    return {"steps": steps, "stages": stages, "start": flatten_params(params0)}


@pytest.fixture(scope="module")
def reference():
    gop = jnp.asarray(clip())
    return {name: jax_reference(name, asset, gop) for name, asset in MODELS.items()}


def port_model(name, asset=None, sp_stage=SP_STAGE):
    spec = ft.get_codec_model(name, device="cpu", sp_stage=sp_stage)
    if asset is None:
        load_flat(spec.module, ft.seeded_flat(name, 0))
    else:
        ft.load_asset(spec.module, asset)
    return spec


@pytest.mark.parametrize("name", list(MODELS))
def test_port_draws_in_jax_order(reference, name):
    shapes = [d.shape for d in reference[name]["steps"][0]["draws"]]
    assert shapes == [(1, 1, 1, 48), (1, 4, 4, 48)] * 2 * (GOP - 1)
    noise = Replay(reference[name]["steps"][0]["draws"])
    with torch.no_grad():
        ft.rollout(port_model(name, MODELS[name]), nchw(clip()), training=True, noise=noise)
    assert noise.used == len(shapes)


@pytest.mark.parametrize("name", list(MODELS))
def test_loss_metrics_and_gradients_match_jax(reference, name):
    ref = reference[name]["steps"][0]
    spec = port_model(name, MODELS[name])
    params = ready_for_training(spec)
    noise = Replay(ref["draws"])
    loss, metrics = gop_loss(spec, nchw(clip()), True, noise, TrainConfig(learning_rate=LR))
    loss.backward()
    assert noise.used == len(ref["draws"])
    assert_metrics_close(metrics, ref["metrics"])
    got = port_grads(params)
    assert_grads_close(got, in_port_layout(spec.module, ref["grads"]))
    # the SPnets learn (from their errors alone: the decoders take their
    # prediction detached)
    assert any(float(g.abs().max()) > 0 for n, g in got.items() if ".y_predictor." in n)


@pytest.mark.parametrize("name", list(MODELS))
def test_two_train_steps_match_jax(reference, name):
    spec = port_model(name, MODELS[name])
    params = ready_for_training(spec)
    init_fn, step_fn = make_train_step(spec, TrainConfig(learning_rate=LR))
    opt_state = init_fn(params)
    seen = []
    for ref in reference[name]["steps"]:
        params, opt_state, metrics = step_fn(params, opt_state, nchw(clip()), Replay(ref["draws"]))
        assert_metrics_close(metrics, ref["metrics"], (*METRICS, "grad_norm"))
        seen.append(in_port_layout(spec.module, ref["grads"]))
        assert_params_close(params, in_port_layout(spec.module, ref["params"]), seen)


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("name", list(MODELS))
def test_stage_optimizer_step_matches_jax(reference, name, stage):
    ref = reference[name]
    spec = port_model(name, MODELS[name])
    params = ready_for_training(spec)
    start = {n: p.detach().clone() for n, p in params.items()}
    cfg = TrainConfig(learning_rate=LR)
    tx = make_elfvc_stage_optimizer(cfg, stage)
    init_fn, step_fn = make_train_step(spec, cfg, optimizer=tx)
    params, _, _ = step_fn(params, init_fn(params), nchw(clip()),
                           Replay(ref["steps"][0]["draws"]))
    want = in_port_layout(spec.module, ref["stages"][stage])
    jax_start = in_port_layout(spec.module, ref["start"])
    frozen = {n for n in params if tx.label(n) == "frozen"}
    assert 0 < len(frozen) < len(params)
    # JAX's stage filter on the flax paths, carried onto the port's names
    jax_trainable = jax_trainer.elfvc_stage_trainable(stage)
    marks = in_port_layout(spec.module, {
        k: np.full(v.shape, float(not jax_trainable(tuple(k.split("/")))), np.float32)
        for k, v in ref["start"].items()})
    assert frozen == {n for n, m in marks.items() if bool((m == 1).all())}
    for n in frozen:
        assert torch.equal(params[n].detach(), start[n]), n
        assert torch.equal(want[n], jax_start[n]), n
    assert_params_close(params, want, [in_port_layout(spec.module, ref["steps"][0]["grads"])])
    assert any(".y_predictor." in n for n in set(params) - frozen)


@pytest.mark.parametrize("name", ELFVC_NAMES)
def test_every_elfvc_name_trains(name):
    """rollout(training=True) on seeded weights at 64x64, GOP 3: finite
    metrics (the SP norms among them with -SP), and a backward that reaches
    the transforms."""
    spec = port_model(name, sp_stage=2 if "-SP" in name else 1)
    params = ready_for_training(spec)
    gop = nchw(synth_gop(np.random.default_rng(0), size=SIZE, gop=3))
    recon, m = ft.rollout(spec, gop, training=True, noise=UniformNoise(0))
    assert recon.shape == gop[1:].shape and recon.requires_grad
    assert ("pred_err_norm" in m) == ("-SP" in name)
    assert all(bool(torch.isfinite(v).all()) for v in m.values())
    loss, _ = gop_loss(spec, gop, True, UniformNoise(0), TrainConfig())
    loss.backward()
    assert torch.isfinite(loss)
    assert any(p.grad is not None and float(p.grad.abs().max()) > 0
               for n, p in params.items() if n.startswith("res_decoder"))


@pytest.fixture(scope="module")
def septuplets(tmp_path_factory):
    """A Vimeo-90k-style directory: 2 septuplets of 7 PNGs of 48x40."""
    image = pytest.importorskip("PIL.Image")
    root = tmp_path_factory.mktemp("vimeo")
    rng = np.random.default_rng(0)
    names = []
    for s in range(2):
        seq = root / "sequences" / f"{s:05d}" / "0001"
        seq.mkdir(parents=True)
        frames = synth_gop(rng, size=48, gop=7)[:, :40]
        for i, frame in enumerate(frames, start=1):
            image.fromarray((frame * 255).astype(np.uint8)).save(seq / f"im{i}.png")
        names.append(f"{s:05d}/0001")
    (root / "sep_trainlist.txt").write_text("\n".join(names) + "\n")
    return root


def test_cli_default_codec_trains(septuplets, tmp_path, capsys):
    """No --codec: ELFVC-SP at full width from seeded weights, one step of
    2 clips of 7 frames of 32x32 on the CPU, a checkpoint written."""
    assert cli.parse_args(["--dataset-dir", "d"]).codec == "ELFVC-SP"
    cli.main(["--dataset-dir", str(septuplets), "--epochs", "1", "--steps-per-epoch", "1",
              "--batch-size", "2", "--frame-size", "32", "--device", "cpu",
              "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "epoch 0 step 0/1" in out and "epoch 0 done" in out and "nan" not in out
    state = load_checkpoint(str(tmp_path / "ELFVC-SP-2P"), prefer_best=False)
    assert state["opt_state"]["main"]["count"] == 1 and np.isfinite(state["score"])
    assert any(k.startswith("motion_hyperprior.y_predictor.") for k in state["params"])


def test_card_branches_replay_another_runs_relu_branches():
    """tools/train_parity.py's CardBranches (chip_smoke.py phases 42 and 46
    put the CPU on the card's branches with it): a recording run keeps each
    activation's positive set; a replaying run takes those branches, value
    and gradient, where its own inputs fall on the other side of 0, and
    counts those elements; elsewhere it is F.relu and F.leaky_relu exactly."""
    import torch.nn.functional as F

    from fastvideocodec_torch.tools.train_parity import CardBranches

    card_x = torch.tensor([2.0, -3.0, 1e-8, -1e-8, 0.0])
    relu_fn = F.relu
    with CardBranches() as card:
        F.relu(card_x)
        F.leaky_relu(card_x, 0.1)
    assert F.relu is relu_fn and len(card.masks) == 2  # restored on exit
    x = torch.tensor([2.0, -3.0, -1e-8, 1e-8, 0.0], requires_grad=True)
    with CardBranches(card.masks) as cpu:
        relu, leaky = F.relu(x), F.leaky_relu(x, 0.1)
    assert cpu.flips == 4  # elements 2 and 3 of each call
    (g_relu,) = torch.autograd.grad(relu.sum(), [x])
    (g_leaky,) = torch.autograd.grad(leaky.sum(), [x])
    torch.testing.assert_close(g_relu, torch.tensor([1.0, 0.0, 1.0, 0.0, 0.0]), rtol=0, atol=0)
    torch.testing.assert_close(g_leaky, torch.tensor([1.0, 0.1, 1.0, 0.1, 0.1]), rtol=0, atol=0)
    torch.testing.assert_close(relu.detach(), torch.tensor([2.0, 0.0, -1e-8, 0.0, 0.0]),
                               rtol=0, atol=0)
    with CardBranches(card.masks) as same:
        out = F.relu(card_x), F.leaky_relu(card_x, 0.1)
    assert same.flips == 0
    torch.testing.assert_close(out[0], torch.relu(card_x), rtol=0, atol=0)
    torch.testing.assert_close(out[1], torch.nn.functional.leaky_relu(card_x, 0.1), rtol=0,
                               atol=0)
