"""The port's optimizer, aux losses and eval step against the JAX package,
on the CPU, in float32.

- The optimizer alone: the same numpy-seeded gradients go through JAX's
  ``make_elfvc_stage_optimizer`` (optax) and the port's for 3 steps on
  ELFVC-SP-TPU-TINY's seeded parameters at sp_stage 1, with gradients
  whose norm crosses ``grad_clip`` (clipped, unclipped, clipped), an
  exponential-decay staircase of 2 steps and AdamW's weight decay: all
  three groups (main, the aux quantiles, frozen) in one run, the
  parameters within 1e-7 absolute after each step, or one float32 ulp of
  the parameter where that is larger (above |p| = 0.84): XLA on the CPU
  contracts Adam's b1*mu + (1 - b1)*g and the weight decay's g + wd*p
  into fused multiply-adds and divides mu once by bc1 * (sqrt(nu_hat) +
  eps), where PyTorch rounds each product, so the updates differ in their
  last bits and a parameter near 1.45 lands one ulp (1.19e-7) away.
- Which group a parameter lands in: SSF-TINY's quantiles go to the aux
  group; ELFVC-SP-TPU-TINY's trainable set at sp_stage 0, 1 and 2 is
  JAX's ``elfvc_stage_trainable`` on the flax names
  (``weights.flax_shapes``).
- ``EntropyBottleneck.aux_loss`` on tiny_ssf_l2 and every model's
  ``aux_loss``: JAX's values to 1e-6 relative, and the gradient reaches
  the quantiles alone.
- ``make_eval_step`` for each family's tiny trained model against JAX's
  (jitted): loss, psnr, bpp, img_loss and aux to 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.data.synthetic import synth_gop, synth_mv_gop
from fastvideocodec_torch.train import (
    TrainConfig,
    apply_updates,
    elfvc_stage_trainable,
    exponential_decay,
    make_elfvc_stage_optimizer,
    make_eval_step,
    make_optimizer,
)
from fastvideocodec_torch.weights import flatten_params, flax_shapes, load_flat, seeded_flat
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model
from fastvideocodec_tpu.train import trainer as jax_trainer
from fastvideocodec_tpu.train.checkpoint import asset_params

METRICS = ("loss", "psnr", "bpp", "img_loss", "aux")
# (name, asset, registry keywords): each family's tiny trained model
EVAL_CASES = [
    ("LSVC-TPU-TINY", "tiny_lsvctpu_l2", {}),
    ("SSF-TINY", "tiny_ssf_l2", {}),
    ("SSF-TPU-TINY", "tiny_ssftpu_l2", {}),
    ("ELFVC-SP-TPU-TINY", "tiny_elfvctpu_l3", {"sp_stage": 2}),
    ("MCVC-IA-TINY", "tiny_mcvc_l3", {"num_views": 3}),
    ("DVC-TINY", "tiny_dvc_l2", {}),
    ("RLVC-TINY", "tiny_rlvc_l2", {}),
    ("Base-ER-TINY", "tiny_base_l2", {}),
]
AUX_CASES = EVAL_CASES + [("RLVC-HP-TINY", None, {}), ("RLVC2-TINY", None, {})]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port runs as fast on one thread at these sizes, and the suite's
    parallel workers share the host's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def nest(flat: dict) -> dict:
    """{'params/a/b': array} -> the nested flax params pytree."""
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return tree


def port_names(module) -> dict:
    """The port's parameter name of each flax path."""
    return dict(zip(flax_shapes(module), (n for n, _ in module.named_parameters())))


def port_state(module, flat: dict) -> dict:
    """A flax-layout flat dict in the port's layout, by the port's names."""
    load_flat(module, flat)
    return {n: p.detach().clone() for n, p in module.named_parameters()}


def ulp(x: torch.Tensor) -> torch.Tensor:
    """The float32 spacing at each |x|."""
    a = x.abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def test_optimizer_matches_optax():
    name, stage = "ELFVC-SP-TPU-TINY", 1
    spec = ft.get_codec_model(name, device="cpu", sp_stage=stage)
    flat = seeded_flat(name, 0)
    rng = np.random.default_rng(7)
    # the gradients' global norm over the main group: ~30 (clipped), ~0.3
    # (not), ~30 (clipped)
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32) for k, v in flat.items()}
             for s in (0.1, 1e-3, 0.1)]
    cfg = TrainConfig(learning_rate=1e-3, aux_learning_rate=2e-3, weight_decay=1e-2,
                      grad_clip=1.0)
    schedule = exponential_decay(1e-3, 2, 0.5, staircase=True)
    jcfg = jax_trainer.TrainConfig(learning_rate=1e-3, aux_learning_rate=2e-3,
                                   weight_decay=1e-2, grad_clip=1.0)
    jtx = jax_trainer.make_elfvc_stage_optimizer(
        jcfg, stage, learning_rate=optax.exponential_decay(1e-3, 2, 0.5, staircase=True))
    jparams = nest(flat)
    jstate = jtx.init(jparams)
    jupdate = jax.jit(jtx.update)

    params = port_state(spec.module, flat)
    tx = make_elfvc_stage_optimizer(cfg, stage, learning_rate=schedule)
    state = tx.init(params)
    labels = {n: tx.label(n) for n in params}
    assert set(labels.values()) == {"main", "aux", "frozen"}
    start = {n: p.clone() for n, p in params.items()}
    for g in grads:
        updates, jstate = jupdate(nest(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        updates, state = tx.update(port_state(spec.module, g), state, params)
        apply_updates(params, updates)
        want = port_state(spec.module, flatten_params(jparams))
        for n, p in params.items():
            bar = torch.clamp(ulp(want[n]), min=1e-7)
            assert bool(((p - want[n]).abs() <= bar).all()), n
    for n, p in params.items():
        moved = not torch.equal(p, start[n])
        assert moved == (labels[n] != "frozen"), n
    assert state["main"]["count"] == state["aux"]["count"] == 3


def test_quantiles_go_to_the_aux_group():
    spec = ft.get_codec_model("SSF-TINY", device="cpu")
    tx = make_optimizer(TrainConfig())
    labels = {n: tx.label(n) for n, _ in spec.module.named_parameters()}
    aux = sorted(n for n, g in labels.items() if g == "aux")
    assert aux == [f"{h}.bottleneck.quantiles"
                   for h in ("img_hyperprior", "motion_hyperprior", "res_hyperprior")]
    assert set(labels.values()) == {"main", "aux"}


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_elfvc_stage_trainable_is_jaxs(stage):
    spec = ft.get_codec_model("ELFVC-SP-TPU-TINY", device="cpu", sp_stage=stage)
    names = port_names(spec.module)
    port = elfvc_stage_trainable(stage)
    jax_filter = jax_trainer.elfvc_stage_trainable(stage)
    want = {path for path in names if jax_filter(tuple(path.split("/")))}
    got = {path for path, n in names.items() if port(tuple(n.split(".")))}
    assert got == want and 0 < len(got) < len(names)
    assert elfvc_stage_trainable(3) is None and jax_trainer.elfvc_stage_trainable(3) is None


def jax_aux(name, kw, flat, method="aux_loss"):
    return float(jax_get_codec_model(name, **kw).module.apply(nest(flat), method=method))


def weights_of(name, asset) -> dict:
    """The flax-layout flat weights: the shipped asset, else seeded."""
    return seeded_flat(name, 0) if asset is None else flatten_params(asset_params(asset))


def port_model(name, asset, kw):
    spec = ft.get_codec_model(name, device="cpu", **kw)
    load_flat(spec.module, weights_of(name, asset))
    return spec


def test_bottleneck_aux_loss_matches_jax_and_reaches_the_quantiles_alone():
    flat = weights_of("SSF-TINY", "tiny_ssf_l2")
    spec = port_model("SSF-TINY", "tiny_ssf_l2", {})
    want = jax_aux("SSF-TINY", {}, flat, lambda m: m.img_hyperprior.bottleneck.aux_loss())
    bottleneck = spec.module.img_hyperprior.bottleneck.requires_grad_(True)
    loss = bottleneck.aux_loss()
    assert abs(float(loss) - want) <= 1e-6 * abs(want)
    loss.backward()
    for n, p in bottleneck.named_parameters():
        assert (p.grad is not None and float(p.grad.abs().max()) > 0) == (n == "quantiles"), n


@pytest.mark.parametrize("name, asset, kw", AUX_CASES, ids=[c[0] for c in AUX_CASES])
def test_model_aux_loss_matches_jax(name, asset, kw):
    spec = port_model(name, asset, kw)
    want = jax_aux(name, kw, weights_of(name, asset))
    spec.module.requires_grad_(True)
    loss = spec.module.aux_loss()
    assert abs(float(loss) - want) <= 1e-6 * max(abs(want), 1e-6), (float(loss), want)
    if loss.requires_grad:
        loss.backward()
    for n, p in spec.module.named_parameters():
        reached = p.grad is not None and float(p.grad.abs().max()) > 0
        assert reached == (n.endswith("quantiles") and want > 0), n


def eval_inputs(name, kw):
    """(JAX gop, port gop, mask): a synth_gop clip (numpy seed 0) of 64x64,
    GOP 4; MCVC's 3 views of 64x64 with view 2 failed."""
    if name.startswith("MCVC"):
        clip = synth_mv_gop(np.random.default_rng(0), views=kw["num_views"], size=64, gop=4)
        mask = np.asarray([1, 1, 0], np.float32)
        return (jnp.asarray(clip), torch.from_numpy(np.array(clip.transpose(0, 1, 4, 2, 3))),
                mask)
    clip = synth_gop(np.random.default_rng(0), size=64, gop=4)
    return jnp.asarray(clip), torch.from_numpy(np.array(clip.transpose(0, 3, 1, 2))), None


@pytest.mark.parametrize("name, asset, kw", EVAL_CASES, ids=[c[0] for c in EVAL_CASES])
def test_eval_step_matches_jax(name, asset, kw):
    jgop, gop, mask = eval_inputs(name, kw)
    jspec = jax_get_codec_model(name, **kw)
    params = {"params": asset_params(asset)["params"]}
    args = (params, jgop) if mask is None else (params, jgop, jnp.asarray(mask))
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax_trainer.make_eval_step(jspec))(*args)
    spec = port_model(name, asset, kw)
    got = make_eval_step(spec)(gop, mask)
    for k in METRICS:
        w = float(want[k])
        assert abs(float(got[k]) - w) <= 1e-5 * max(abs(w), 1e-6), (k, float(got[k]), w)
