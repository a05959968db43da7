"""The port's tools/train_tiny.py (fastvideocodec_torch/tools/train_tiny.py)
against the JAX package's root tools/train_tiny.py, on the CPU, float32,
at the tiny rung (64x64, GOP 4).

- ``FAMILIES``: the same families, each with the same codec name, levels
  and steps, and a clip generator that gives the same clips from the same
  numpy seed.
- ``flatten_f16``: for every shipped asset a family writes, the port's
  model of that family gives exactly the asset's keys, shapes and float16
  dtype (and loads the asset back bit for bit).
- Each recipe, one step (ELFVC's: one step of the default stage and one of
  each sp_stage 0/1/2), against JAX's recipe run as it is: JAX's initial
  tree (recorded where the recipe makes it), JAX's draws (``JaxDraws``)
  replayed in the port, and JAX's gradients (an ordered debug callback in
  an optax stage chained before each of the recipe's optimizers). The
  final parameters are held at the Adam bars of
  tests/test_torch_train_common.py. The numpy clips are the port's own
  draws from the same seed: a recipe that drew in another order would
  train on other clips and miss.
- The recipes' numpy draw order: the initial clip, then each chunk's clips,
  then (MCVC) each chunk's masks.

JAX's recipes are compiled once each, the four at once on threads (a
module fixture). ELFVC's four stages differ only in their optimizer, so
its loss gradient is compiled once and shared by the stages (the recipe's
``jax`` is a proxy whose ``value_and_grad`` is cached under ``jax.jit``
and whose ``jit`` runs the step's optimizer update eagerly).
"""

import importlib.util
import sys
import threading
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastvideocodec_torch.tools import train_tiny as tt
from fastvideocodec_torch.weights import asset_path, flatten_params, load_flat
from fastvideocodec_tpu.cli import train as jax_cli_train
from test_torch_train_common import (  # noqa: F401 (one_torch_thread: autouse here)
    JaxDraws,
    Replay,
    assert_params_close,
    in_port_layout,
    one_torch_thread,
)

REPO = Path(__file__).resolve().parents[1]


def load_jax_tool():
    """The root tools/train_tiny.py as a module (it puts the repo and tests/
    on sys.path itself)."""
    spec = importlib.util.spec_from_file_location("jax_train_tiny",
                                                  REPO / "tools" / "train_tiny.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules["jax_train_tiny"] = module
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jtt():
    return load_jax_tool()


class GradRecorder:
    """An optax stage that passes the gradients on and records each
    update's (an ordered debug callback), flattened to '/'-joined names."""

    def __init__(self):
        self.grads = []

    def stage(self):
        def update(updates, state, params=None):
            jax.debug.callback(lambda g: self.grads.append(flatten_params(g)), updates,
                               ordered=True)
            return updates, state

        return optax.GradientTransformation(lambda params: optax.EmptyState(), update)


def strong(tree):
    """The tree with every leaf strongly typed (a weakly typed initial leaf
    would make the step's jit compile again after the first update)."""
    return jax.tree.map(lambda a: jnp.asarray(a, a.dtype), tree)


class JaxProxy(types.SimpleNamespace):
    """The tool's ``jax``: every attribute is jax's but ``jit``, which
    records the flax inits' variables (the recipes' lambdas; ``draws`` is
    emptied after each, as the initialisers draw uniforms too), and with
    ``share_grads`` runs the step (``jstep``) eagerly and ``value_and_grad``
    under one cached ``jax.jit`` a loss function."""

    def __init__(self, share_grads: bool, draws):
        super().__init__()
        self.share_grads, self.draws, self.inits, self.cache = share_grads, draws, [], {}

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        if fn.__name__ == "<lambda>":
            jitted = jax.jit(fn, **kw)

            def init(*args):
                out = strong(jitted(*args))
                jax.effects_barrier()
                self.draws.take()
                self.inits.append(out)
                return out
            return init
        if self.share_grads and fn.__name__ == "jstep":
            return fn
        return jax.jit(fn, **kw)

    def value_and_grad(self, fn, **kw):
        if not self.share_grads:
            return jax.value_and_grad(fn, **kw)
        if fn not in self.cache:
            self.cache[fn] = jax.jit(jax.value_and_grad(fn, **kw))
        return self.cache[fn]


class PerThread(threading.local):
    """What a recipe running in this thread records into: its draws, its
    gradients, its initial trees and the proxy that stands for the tool's
    ``jax``."""


HERE = PerThread()
UNIFORM = jax.random.uniform


def run_jax_recipe(jtt, family, level, steps=1):
    """JAX's recipe for one family, in this thread (the patches installed
    by ``jax_recipes`` route to this thread's recorders): (its initial flat
    tree, its final flat params, its gradients a step, its draws in
    order)."""
    make_spec, _, _, gen = jtt.FAMILIES[family]
    spec = make_spec(level)
    HERE.draws, HERE.rec, HERE.inits = JaxDraws(), GradRecorder(), []
    HERE.draws.orig = UNIFORM  # jax.random.uniform is the dispatcher here
    HERE.proxy = JaxProxy(spec.family == "elfvc", HERE.draws)
    with jax.default_matmul_precision("highest"):
        if family == "mcvc":
            params = jtt.train_mcvc(spec, steps)
        elif spec.family == "elfvc":
            params = jtt.train_elfvc(spec, steps, gen=gen)
        elif spec.family == "ssf":
            params = jtt.train_ssf(spec, steps, gen=gen)
        else:
            params = jtt.train_single_view(spec, steps, gen=gen, decay=True, r_bpp=8.0)
        jax.effects_barrier()
    initial = (HERE.inits or HERE.proxy.inits)[0]
    return (flatten_params(initial), flatten_params(params), HERE.rec.grads,
            [np.asarray(d) for d in HERE.draws.take()])


def jax_recipes(jtt, cases: dict) -> dict:
    """Each family's JAX recipe ({family: level}), all at once, one thread
    each (XLA's compiles release the GIL; the traces do not). The draws,
    the optimizer's gradient recorder, the tool's ``jax`` and JAX's
    ``init_params`` are patched once with dispatchers to the calling
    thread's recorders: a trace binds its callbacks to its own thread's
    lists, wherever the computation then runs."""
    uniform, multi, init_params = jax.random.uniform, optax.multi_transform, \
        jax_cli_train.init_params

    class ToolJax:
        def __getattr__(self, name):
            return getattr(HERE.proxy, name)

    def recorded_init(*args):
        out = strong(init_params(*args))
        jax.effects_barrier()
        HERE.draws.take()  # the initialisers' uniforms
        HERE.inits.append(out)
        return out

    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(len(cases)) as pool:
        mp.setattr(jax.random, "uniform", lambda *a, **k: HERE.draws(*a, **k))
        mp.setattr(optax, "multi_transform",
                   lambda *a, **k: optax.chain(HERE.rec.stage(), multi(*a, **k)))
        mp.setattr(jtt, "jax", ToolJax())
        mp.setattr(jax_cli_train, "init_params", recorded_init)
        futures = {fam: pool.submit(run_jax_recipe, jtt, fam, lvl) for fam, lvl in cases.items()}
        out = {fam: f.result() for fam, f in futures.items()}
    assert jax.random.uniform is uniform
    return out


# family -> level: DVC-TINY with decay and r_bpp 8 (train_single_view with
# its knobs), SSF-TINY (the low-rate rung's train_ssf), ELFVC-SP-TPU-TINY
# (train_elfvc, all four stages) and MCVC-IA-TINY (train_mcvc)
RECIPES = {"dvc": 2, "ssf_lr": 2, "elfvctpu": 3, "mcvc": 3}


@pytest.fixture(scope="module")
def jax_runs(jtt):
    return jax_recipes(jtt, RECIPES)


@pytest.mark.parametrize("family", sorted(RECIPES))
def test_recipe_step_matches_jax(jax_runs, family):
    level = RECIPES[family]
    initial, final, grads, draws = jax_runs[family]
    noise = Replay(draws)
    kw = dict(decay=True, r_bpp=8.0) if family == "dvc" else {}
    spec, trained = tt.train_family(family, level, steps=1, device="cpu", initial=initial,
                                    noise=noise, out=None, **kw)
    assert noise.used == len(draws), (noise.used, len(draws))
    want_steps = 4 if family == "elfvctpu" else 1
    assert trained.steps == want_steps and len(grads) == want_steps, (trained.steps, len(grads))
    module = spec.module
    assert_params_close(dict(module.named_parameters()), in_port_layout(module, final),
                        [in_port_layout(module, g) for g in grads])
    assert all(np.isfinite(r["loss"]) for r in trained.history)


def test_families_match_jax(jtt):
    assert list(tt.FAMILIES) == list(jtt.FAMILIES)
    for fam, recipe in tt.FAMILIES.items():
        make_spec, levels, steps, gen = jtt.FAMILIES[fam]
        jspec = make_spec(levels[0])
        assert (recipe.codec, recipe.levels, recipe.steps) == (jspec.name, levels, steps), fam
        assert recipe.spec(levels[0], "meta").name == jspec.name
        if gen is None:  # JAX's MCVC recipe takes TestGoldenRDMCVC's generator
            from test_rd import TestGoldenRDMCVC

            gen = TestGoldenRDMCVC._synth_mv_gop
            assert recipe.options["num_views"] == jspec.extras["num_views"]
        want = gen(np.random.default_rng(5))
        got = recipe.gen(np.random.default_rng(5))
        assert got.shape == want.shape and np.array_equal(got, want), fam


def shipped_assets():
    out = []
    for fam, recipe in tt.FAMILIES.items():
        for level in recipe.levels:
            name = tt.asset_name(fam, level)
            if asset_path(name).exists():
                out.append((fam, level, name))
    return out


def test_every_shipped_asset_has_a_family():
    names = {name for _, _, name in shipped_assets()}
    stems = {p.stem for p in asset_path("x").parent.glob("*.npz")}
    # the shipped assets no family of JAX's table writes (their recipes are
    # documented in assets/TINY_RD.md): the tiny stock LSVC, SSF and ELFVC
    others = {s for s in stems - names if not s.startswith(("tiny_lsvc_", "tiny_ssf_",
                                                            "tiny_elfvc_"))}
    assert others == {"spynet"}, others
    assert len(names) == 54, len(names)


@pytest.mark.parametrize("fam,level,name", shipped_assets())
def test_flatten_f16_is_the_shipped_layout(fam, level, name):
    spec = tt.FAMILIES[fam].spec(level, "cpu")
    with np.load(asset_path(name)) as data:
        shipped = {k: data[k] for k in data.files}
    load_flat(spec.module, shipped)
    flat = tt.flatten_f16(spec.module)
    assert set(flat) == set(shipped)
    for k, v in shipped.items():
        assert flat[k].dtype == np.float16 and v.dtype == np.float16, k
        assert flat[k].shape == v.shape and np.array_equal(flat[k], v), k


def test_save_writes_the_asset_and_refuses_the_jax_package(tmp_path):
    spec = tt.FAMILIES["lsvctpu"].spec(2, "cpu")
    load_flat(spec.module, tt.seeded_params(spec.module, 0))
    path = tt.save_f16(spec, tmp_path, "lsvctpu", 2)
    assert path.name == "tiny_lsvctpu_l2.npz"
    with np.load(path) as data:
        assert set(data.files) == set(np.load(asset_path("tiny_lsvctpu_l2")).files)
    with pytest.raises(ValueError):
        tt.save_f16(spec, REPO / "fastvideocodec_tpu" / "assets", "lsvctpu", 2)
    assert tt.OUT == REPO / "build" / "assets"
    assert [tt.asset_name(f, 2) for f in ("lsvctpuf2_hd", "lsvc128_192", "ssf_lr", "dvc")] == [
        "hd_lsvctpuf2_l2", "hd192_lsvc128_l2", "lr_ssf_l2", "tiny_dvc_l2"]


def test_mcvc_recipe_draws_chunk_clips_then_chunk_masks(monkeypatch):
    """JAX's train_mcvc draws each chunk's 25 clips and then its 25 masks
    from the one generator (:449-452); the port keeps that order with no
    chunked scan."""
    calls = []
    gen = tt.FAMILIES["mcvc"].gen

    def clip(rng):
        calls.append("clip")
        return gen(rng)

    orig = tt.sample_view_mask

    def mask(*args, **kwargs):
        calls.append("mask")
        return orig(*args, **kwargs)

    monkeypatch.setattr(tt, "sample_view_mask", mask)
    monkeypatch.setattr(tt, "_descend_on", lambda params, tx, st, fn, *a: (st, {
        "loss": torch.zeros(()), "mse": torch.ones(()), "bpp": torch.zeros(())}))
    spec = tt.FAMILIES["mcvc"].spec(3, "cpu")
    tt.train_mcvc(spec, 27, gen=clip, device="cpu", out=None)
    assert calls == ["clip"] + ["clip"] * 25 + ["mask"] * 25 + ["clip"] * 2 + ["mask"] * 2
