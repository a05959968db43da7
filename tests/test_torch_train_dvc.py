"""DVC and Base training in the port against the JAX package, on the CPU,
in float32, under the same quantization noise: JAX's draws recorded and
replayed, and the bars, as tests/test_torch_train_common.py sets them out.
The JAX functions run under ``jax.jit``, once each.

Forms, on a synth_gop clip (numpy seed 0) of 64x64, GOP 4:
- DVC-TINY on tiny_dvc_l2, through JAX's ``make_train_step`` for two
  steps: the draws (mv, z, then the feature, each P-frame), the loss and
  metrics, every gradient and the parameters after each step;
- Base-TINY, Base-EC-TINY, Base-ER-TINY and Base-EC-ER-TINY (the shipped
  tiny_base_l2 where its tensors fit, seeded_flat(name, 0) elsewhere),
  through JAX's ``gop_loss``: the draws (mv, the feature, then z), the
  loss, metrics and every gradient; Base-ER-TINY also with soft2hard (the
  three passes of one set of draws: JAX draws each pass's anew from the
  same key, the port records pass 0's and replays them) and with
  ``detach_mode=()`` against JAX's ``Base(detach_mode=())``.
And ``rollout(training=True)`` and ``gop_loss`` run for every DVC and Base
name of the registry, at full width on seeded weights.
"""

import dataclasses

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

TRAINED_BASE = "tiny_base_l2"  # Base-ER-TINY
# form: (registry name, the module's fields, soft2hard)
BASE_FORMS = {
    "Base-TINY": ("Base-TINY", {}, False),
    "Base-EC-TINY": ("Base-EC-TINY", {}, False),
    "Base-ER-TINY": ("Base-ER-TINY", {}, False),
    "Base-EC-ER-TINY": ("Base-EC-ER-TINY", {}, False),
    "Base-ER-TINY soft2hard": ("Base-ER-TINY", {}, True),
    "Base-ER-TINY detach_mode=()": ("Base-ER-TINY", {"detach_mode": ()}, False),
}
DVC_NAMES = ("DVC", "DVC-pretrained", "DVC-TINY")
BASE_NAMES = ("Base", "Base-EC", "Base-ER", "Base-EC-ER", "Base-TINY", "Base-EC-TINY",
              "Base-ER-TINY", "Base-EC-ER-TINY")
# the tiny latents at 64x64: mv [1, 4, 4, 32], z [1, 1, 1, 32], feature [1, 4, 4, 48]
MV, Z, FEATURE = (1, 4, 4, 32), (1, 1, 1, 32), (1, 4, 4, 48)


def base_flat(name: str) -> dict:
    return seeded_with_asset(name, TRAINED_BASE)


def jax_spec(name: str, fields: dict):
    spec = jax_get_codec_model(name)
    if fields:
        spec = dataclasses.replace(spec, module=spec.module.clone(**fields))
    return spec


@pytest.fixture(scope="module")
def dvc_steps():
    return jax_train_steps(jax_trainer, jax_get_codec_model("DVC-TINY"),
                           asset_flat("tiny_dvc_l2"), clip())


@pytest.fixture(scope="module")
def base_reference():
    cases = [(jax_spec(name, fields), base_flat(name), clip(),
              jax_trainer.TrainConfig(learning_rate=LR, soft2hard=s2h))
             for name, fields, s2h in BASE_FORMS.values()]
    return dict(zip(BASE_FORMS, jax_loss_grads(jax_trainer.gop_loss, cases)))


def test_dvc_draws_in_jax_order(dvc_steps):
    """Each P-frame draws the mv latent's noise, then z's, then the
    feature's."""
    draws = dvc_steps[0]["draws"]
    assert [d.shape for d in draws] == [MV, Z, FEATURE] * (GOP - 1)
    spec = port_spec("DVC-TINY", asset_flat("tiny_dvc_l2"))
    noise = Replay(draws)
    with torch.no_grad():
        ft.rollout(spec, nchw(clip()), training=True, noise=noise)
    assert noise.used == len(draws)


def test_dvc_loss_metrics_and_gradients_match_jax(dvc_steps):
    ref = dvc_steps[0]
    spec = port_spec("DVC-TINY", asset_flat("tiny_dvc_l2"))
    params = ready_for_training(spec)
    noise = Replay(ref["draws"])
    loss, metrics = gop_loss(spec, nchw(clip()), True, noise, TrainConfig(learning_rate=LR))
    loss.backward()
    assert noise.used == len(ref["draws"])
    assert_metrics_close(metrics, ref["metrics"])
    assert_grads_close(port_grads(params), in_port_layout(spec.module, ref["grads"]))


def test_dvc_two_train_steps_match_jax(dvc_steps):
    spec = port_spec("DVC-TINY", asset_flat("tiny_dvc_l2"))
    params = ready_for_training(spec)
    init_fn, step_fn = make_train_step(spec, TrainConfig(learning_rate=LR))
    opt_state = init_fn(params)
    gop = nchw(clip())
    seen = []
    for ref in dvc_steps:
        params, opt_state, metrics = step_fn(params, opt_state, gop, Replay(ref["draws"]))
        assert_metrics_close(metrics, ref["metrics"], (*METRICS, "grad_norm"))
        seen.append(in_port_layout(spec.module, ref["grads"]))
        assert_params_close(params, in_port_layout(spec.module, ref["params"]), seen)


@pytest.mark.parametrize("form", list(BASE_FORMS))
def test_base_draws_loss_metrics_and_gradients_match_jax(base_reference, form):
    """Base draws mv, then the feature, then z (DVC's order differs). With
    soft2hard JAX's three passes draw the same values from one key: the
    port draws pass 0's alone and replays them."""
    name, fields, s2h = BASE_FORMS[form]
    jm, jgrads, draws = base_reference[form]
    passes = 3 if s2h else 1
    per_pass = len(draws) // passes
    assert [d.shape for d in draws[:per_pass]] == [MV, FEATURE, Z] * (GOP - 1)
    for k in range(1, passes):
        for a, b in zip(draws[:per_pass], draws[k * per_pass:(k + 1) * per_pass]):
            np.testing.assert_array_equal(a, b)
    spec = port_spec(name, base_flat(name), fields)
    params = ready_for_training(spec)
    noise = Replay(draws[:per_pass])
    loss, metrics = gop_loss(spec, nchw(clip()), True, noise,
                             TrainConfig(learning_rate=LR, soft2hard=s2h))
    loss.backward()
    assert noise.used == per_pass
    assert spec.module.s2h_stage == 0
    assert_metrics_close(metrics, jm)
    assert_grads_close(port_grads(params), in_port_layout(spec.module, jgrads))


def test_soft2hard_changes_the_loss_and_reaches_the_generators(base_reference):
    """The three passes move the loss off the single pass's, and ER's
    generators learn from pred_err under both."""
    single = base_reference["Base-ER-TINY"][0]["loss"]
    assert base_reference["Base-ER-TINY soft2hard"][0]["loss"] != single
    for form in ("Base-ER-TINY", "Base-ER-TINY soft2hard"):
        grads = base_reference[form][1]
        assert any(np.abs(v).max() > 0 for k, v in grads.items() if "/mv_gen/" in k)


@pytest.mark.parametrize("name", DVC_NAMES + BASE_NAMES)
def test_every_dvc_and_base_name_trains(name):
    """rollout(training=True) and gop_loss on seeded weights, 64x64, GOP 3
    (Base-ER's forms with soft2hard): finite metrics, and a backward that
    reaches the mv encoder."""
    spec = port_spec(name, ft.seeded_flat(name, 0))
    params = ready_for_training(spec)
    gop = nchw(synth_gop(np.random.default_rng(0), size=SIZE, gop=3))
    recon, m = ft.rollout(spec, gop, training=True, noise=UniformNoise(0))
    assert recon.shape == gop[1:].shape and recon.requires_grad
    assert all(bool(torch.isfinite(v).all()) for v in m.values())
    loss, _ = gop_loss(spec, gop, True, UniformNoise(0),
                       TrainConfig(soft2hard="-ER" in name))
    loss.backward()
    assert torch.isfinite(loss)
    assert any(p.grad is not None and float(p.grad.abs().max()) > 0
               for n, p in params.items() if n.startswith("mv_encoder"))


def test_cli_trains_dvc_under_msssim(tmp_path, capsys):
    """cli.train.main with --codec DVC-TINY --loss-type M on a Vimeo-style
    tree of 7-frame clips of 200x200 PNGs written here, 192 px crops, 1
    epoch of 2 steps on the CPU: a finite loss and a checkpoint under the
    M tag."""
    from fastvideocodec_torch.cli import train as cli
    from fastvideocodec_torch.train import load_checkpoint

    image = pytest.importorskip("PIL.Image")
    root = tmp_path / "vimeo"
    rng = np.random.default_rng(0)
    names = []
    for s in range(2):
        seq = root / "sequences" / f"{s:05d}" / "0001"
        seq.mkdir(parents=True)
        for i, frame in enumerate(synth_gop(rng, size=200, gop=7), start=1):
            image.fromarray((frame * 255).astype(np.uint8)).save(seq / f"im{i}.png")
        names.append(f"{s:05d}/0001")
    (root / "sep_trainlist.txt").write_text("\n".join(names) + "\n")
    cli.main(["--codec", "DVC-TINY", "--loss-type", "M", "--dataset-dir", str(root),
              "--epochs", "1", "--steps-per-epoch", "2", "--batch-size", "1",
              "--frame-size", "192", "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt")])
    assert "epoch 0 done" in capsys.readouterr().out
    state = load_checkpoint(str(tmp_path / "ckpt" / "DVC-TINY-2M"), prefer_best=False)
    assert state["opt_state"]["main"]["count"] == 2 and np.isfinite(state["score"])
