"""The port's multi-device layer (fastvideocodec_torch/parallel/) on the CPU,
against its own single-process step and against the JAX package.

- The mesh layout (``mesh_layout``) against JAX's ``global_mesh`` on the 8
  virtual devices of tests/conftest.py: the same (data, view, frame) shape
  and rank order, and ValueError on the same bad factorizations
  (tests/test_parallel.py:TestGlobalMesh); ``make_mesh`` raises for a mesh
  larger than the world; ``frame_sharded_spec`` rejects DVC-TINY, as
  JAX's does, and shares the module's parameters.
- One spawn of 4 gloo ranks for the module (tools/dryrun_multichip.py's
  launcher, its timeout SPAWN_TIMEOUT) runs every sharded case once, and
  each test reads its own case's outcome:
  - ``lsvc_dp``: LSVC-TPU-TINY (tiny_lsvctpu_l2), 4 clips of GOP 4 at 64x64
    over 'data' 4;
  - ``lsvc_frame``: the same clips over (data 2 x frame 2): a clip's 3
    P-frames are a tree of layers (1) and (2, 3), so the one-frame layer
    leaves frame rank 1 empty;
  - ``lsvc_attn_frame``: the tiny flagship with -A and -S at attn_depth 2
    (seeded), GOP 8, over frame 4: its layers of 1, 2 and 4 frames leave
    ranks empty in the first two, and its time attention mixes the frames
    of a layer gathered from the four ranks;
  - ``mcvc``: MCVC-IA-TINY (tiny_mcvc_l3) over (data 2 x view 2), two items
    of 4 views of 64x64, GOP 2, view 2 failed: a rank holds 2 views of an
    item, and the cross-view attention gathers the item's keys and values;
  - ``ssf_dp``: SSF-TPU-TINY (tiny_ssftpu_l2), 4 clips of GOP 3 over
    'data' 4.
- Each case against the port's single-process step, run here while the
  ranks run: the metrics within METRIC_REL, every gradient within GRAD_REL
  of its parameter's max (``assert_grads_close``; MCVC's motion decoder at
  the flow path's bar), the parameters after the step as
  ``assert_params_close`` holds them, and the ranks' parameters equal bit
  for bit (each rank compares its own with rank 0's); the single-process
  step (``make_train_step`` without a mesh) leaves no process group.
- Against JAX, two compiles: LSVC-TPU-TINY's gop_loss value_and_grad a
  clip, run on each clip under its key of jax.random.split (JAX's batched
  step vmaps it and takes the means), and MCVC-IA-TINY's step's. JAX's
  single-device step stands in for its sharded one
  (tests/test_parallel.py:TestShardedParity and MULTICHIP_r05.json show
  them equal). The LSVC halves and the MCVC half run under JAX's draws
  (recorded, replayed by rank-sliced sources) and are held to JAX's loss,
  metrics and gradients at the same bars.
- A case built to fail (a mesh of 8 on 4 ranks) fails the launch within
  its timeout, every rank ended.
"""

import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import fastvideocodec_torch as ft
from fastvideocodec_torch.data.synthetic import synth_gop, synth_mv_gop
from fastvideocodec_torch.models.lsvc import LSVC
from fastvideocodec_torch.parallel import frame_sharded_spec, make_mesh, mesh_layout
from fastvideocodec_torch.parallel.collectives import split_rows
from fastvideocodec_torch.tools import dryrun_multichip as dm
from fastvideocodec_torch.weights import flatten_params, seeded_params
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model
from fastvideocodec_tpu.parallel import distributed as jax_distributed
from fastvideocodec_tpu.parallel.frame import frame_sharded_spec as jax_frame_sharded_spec
from fastvideocodec_tpu.train import trainer as jax_trainer
from test_torch_train_common import (  # noqa: F401 (one_torch_thread: autouse here)
    LR,
    METRICS,
    JaxBranches,
    JaxDraws,
    asset_flat,
    assert_grads_close,
    assert_metrics_close,
    assert_params_close,
    in_port_layout,
    jax_tree,
    one_torch_thread,
)

WORLD = 4
SPAWN_TIMEOUT = 120
SIZE = 64
LSVC_CLIPS, LSVC_GOP = 4, 4
MCVC_ITEMS, MCVC_VIEWS, MCVC_GOP = 2, 4, 2  # __graft_entry__.py's GOP
MCVC_MASK = np.tile(np.array([1, 1, 0, 1], np.float32), MCVC_ITEMS)  # view 2 failed
SSF_CLIPS, SSF_GOP = 4, 3
ATTN_GOP = 8
TINY_TPU = dict(channels=48, conv_channels=32, s2d=2, spynet_widths=(8, 16, 8, 4),
                spynet_kernel=5, spynet_s2d_levels=2, mv_polyphase_out=True, warp_width=32,
                full_res_warp=True, mv_full_res_out=True)
ATTN_ARGS = dict(TINY_TPU, use_attn=True, use_syn_attn=True, attn_depth=2)
JAX_SEED = 7
FLOW_PATH = {"mcvc": ("motion_decoder.",)}


def nchw(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def lsvc_clips(seed: int, n: int, gop: int) -> np.ndarray:
    """[n, T, H, W, 3] synth_gop clips."""
    rng = np.random.default_rng(seed)
    return np.stack([synth_gop(rng, size=SIZE, gop=gop) for _ in range(n)])


def mcvc_clip() -> np.ndarray:
    """[T, B*V, H, W, 3]: MCVC_ITEMS items of MCVC_VIEWS views."""
    rng = np.random.default_rng(3)
    return np.concatenate([synth_mv_gop(rng, views=MCVC_VIEWS, size=SIZE, gop=MCVC_GOP)
                           for _ in range(MCVC_ITEMS)], axis=1)


# ---------------------------------------------------------------------------
# the layout and the spec, against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [dict(), dict(view=2, frame=2), dict(data=2, view=4),
                                   dict(frame=8), dict(view=2)])
def test_mesh_layout_matches_jax_global_mesh(shape):
    """The port's ranks in JAX's (data, view, frame) device order: data
    fills what view x frame leaves, host-major (one host of 8 here)."""
    jmesh = jax_distributed.global_mesh(**shape)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    ranks = mesh_layout(8, 8, **shape)
    assert jmesh.axis_names == ("data", "view", "frame")
    assert ranks.shape == ids.shape
    np.testing.assert_array_equal(ranks, ids)


@pytest.mark.parametrize("shape", [dict(view=3), dict(data=8, view=2)])
def test_bad_factorizations_raise_as_jax(shape):
    with pytest.raises(ValueError):
        jax_distributed.global_mesh(**shape)
    with pytest.raises(ValueError):
        mesh_layout(8, 8, **shape)


def test_view_frame_beyond_a_host_raises():
    """Several hosts: the activation axes stay on one host's ranks (JAX's
    check, with 2 hosts of 4 ranks)."""
    assert mesh_layout(8, 4, view=4).shape == (2, 4, 1)
    with pytest.raises(ValueError):
        mesh_layout(8, 4, view=2, frame=4)


def test_make_mesh_raises_for_a_mesh_larger_than_the_world():
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{dm.free_port()}",
                            world_size=1, rank=0)
    try:
        assert tuple(make_mesh(1, 1, 1, device_type="cpu").mesh.shape) == (1, 1, 1)
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            make_mesh(2, 1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_frame_sharded_spec_rejects_dvc_tiny_as_jax():
    with pytest.raises(ValueError):
        jax_frame_sharded_spec(jax_get_codec_model("DVC-TINY"))
    with pytest.raises(ValueError):
        frame_sharded_spec(ft.get_codec_model("DVC-TINY", device="cpu"))


def test_frame_sharded_spec_shares_the_parameters():
    spec = ft.get_codec_model("LSVC-TPU-TINY", device="cpu")
    sharded = frame_sharded_spec(spec)
    assert sharded.module.frame_axis == "frame" and spec.module.frame_axis == ""
    mine, theirs = dict(spec.module.named_parameters()), dict(sharded.module.named_parameters())
    assert mine.keys() == theirs.keys()
    assert all(mine[n] is theirs[n] for n in mine)


def test_split_rows_pads_as_gspmd():
    """ceil(n / parts) a rank, the last short or empty."""
    assert split_rows(1, 2) == [1, 0]
    assert split_rows(3, 2) == [2, 1]
    assert split_rows(7, 4) == [2, 2, 2, 1]
    assert split_rows(2, 4) == [1, 1, 0, 0]


# ---------------------------------------------------------------------------
# JAX's references (two compiles) and the cases
# ---------------------------------------------------------------------------


def jax_references(clips: np.ndarray, mv_clip: np.ndarray) -> dict:
    """JAX's steps, each gop_loss value_and_grad under one ``jax.jit``,
    traced in turn (each with its draws' recorder) and compiled on two
    threads at once: "lsvc", JAX's batched LSVC-TPU-TINY step on ``clips``
    ([B, T, H, W, 3]) from tiny_lsvctpu_l2, the compiled loss run a clip
    under jax.random.split(PRNGKey(JAX_SEED), B)[b] and the means taken
    over the clips; "mcvc", MCVC-IA-TINY's step (4 views) on ``mv_clip``
    with MCVC_MASK from tiny_mcvc_l3 under PRNGKey(JAX_SEED). Each with the
    clips' draws, NCHW."""
    cfg = jax_trainer.TrainConfig(learning_rate=LR)
    flats = {"lsvc": asset_flat("tiny_lsvctpu_l2"), "mcvc": asset_flat("tiny_mcvc_l3")}
    lsvc = jax_get_codec_model("LSVC-TPU-TINY")
    mcvc = jax_get_codec_model("MCVC-IA-TINY", num_views=MCVC_VIEWS)
    keys = jax.random.split(jax.random.PRNGKey(JAX_SEED), clips.shape[0])
    mask = jnp.asarray(MCVC_MASK)
    # MCVC's first: its compile is the longer, and LSVC's trace runs beside it
    fns = {"mcvc": lambda p, g, k: jax_trainer.gop_loss(mcvc, p, g, True, k, cfg, mask),
           "lsvc": lambda p, g, k: jax_trainer.gop_loss(lsvc, p, g, True, k, cfg, None)}
    inputs = {"lsvc": [(jnp.asarray(c), k) for c, k in zip(clips, keys)],
              "mcvc": [(jnp.asarray(mv_clip), jax.random.PRNGKey(JAX_SEED))]}
    lowered = {}
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"), \
            ThreadPoolExecutor(max_workers=2) as pool:
        for name, fn in fns.items():
            rec = JaxDraws(), JaxBranches()
            mp.setattr(jax.random, "uniform", rec[0])
            mp.setattr(jax.nn, "relu", rec[1])
            params = jax_tree(flats[name])
            traced = jax.jit(jax.value_and_grad(fn, has_aux=True)).lower(params,
                                                                        *inputs[name][0])
            lowered[name] = (pool.submit(traced.compile), params, rec)
    out = {}
    for name, (compiled, params, rec) in lowered.items():
        runs = []
        for args in inputs[name]:
            (_, m), g = compiled.result()(params, *args)
            jax.block_until_ready(g)
            runs.append(({k: float(v) for k, v in m.items()}, flatten_params(g), rec[0].take(),
                         rec[1].take()))
        out[name] = mean_of(runs, flats[name])
    return out


def mean_of(runs: list, flat: dict) -> dict:
    return {"metrics": {k: float(np.mean([r[0][k] for r in runs])) for k in METRICS},
            "grads": {k: np.mean([r[1][k] for r in runs], axis=0) for k in runs[0][1]},
            "draws": [[nchw(d) for d in r[2]] for r in runs], "branches": [r[3] for r in runs],
            "flat": flat}


def cases(jax_refs: dict) -> list:
    lsvc, mcvc = jax_refs["lsvc"], jax_refs["mcvc"]
    clips = np.stack([nchw(c) for c in lsvc_clips(0, LSVC_CLIPS, LSVC_GOP)])
    mv = mcvc_clip()
    return [
        dm.Case("lsvc_dp", "LSVC-TPU-TINY", (WORLD, 1, 1), clips, lsvc["flat"],
                draws=lsvc["draws"], branches=lsvc["branches"]),
        dm.Case("lsvc_frame", "LSVC-TPU-TINY", (WORLD // 2, 1, 2), clips, lsvc["flat"],
                frame_sharded=True, draws=lsvc["draws"], branches=lsvc["branches"]),
        dm.Case("lsvc_attn_frame", "LSVC-TPU-TINY -A -S", (1, 1, WORLD),
                nchw(lsvc_clips(1, 1, ATTN_GOP)[0]),
                seeded_params(LSVC(**ATTN_ARGS), 0), batched=False, frame_sharded=True, seed=11,
                module_args=ATTN_ARGS),
        dm.Case("mcvc", "MCVC-IA-TINY", (2, 2, 1),
                np.ascontiguousarray(mv.transpose(0, 1, 4, 2, 3)), mcvc["flat"], batched=False,
                mask=MCVC_MASK, num_views=MCVC_VIEWS, draws=mcvc["draws"],
                branches=mcvc["branches"]),
        dm.Case("ssf_dp", "SSF-TPU-TINY", (WORLD, 1, 1),
                np.stack([nchw(c) for c in lsvc_clips(2, SSF_CLIPS, SSF_GOP)]),
                "tiny_ssftpu_l2", seed=21),
    ]


def single_process(case: dm.Case) -> dict:
    """The case's step in this process, as rank 0 of the dry run runs it:
    metrics, gradients and parameters after the step, and whether a
    process group exists after it (a step without a mesh makes none)."""
    spec, params = dm.build(case, "cpu")
    init_fn, step_fn = dm.make_step(spec, case, None)
    gop = torch.from_numpy(case.gop)
    mask = None if case.mask is None else torch.from_numpy(case.mask)
    clips = range(gop.shape[0] if case.batched else 1)
    out = dm.run_steps(step_fn, params, init_fn(params), gop, lambda: dm.sources(case, "cpu"),
                       mask, 1, "cpu", dm.case_branches(case, clips))
    out["process_group"] = dist.is_initialized()
    return out


@pytest.fixture(scope="module")
def outcome(tmp_path_factory):
    """JAX's references, then the spawn of every case while the
    single-process steps run here: {case: (rank results, single, JAX)}."""
    t0 = time.perf_counter()
    refs = jax_references(lsvc_clips(0, LSVC_CLIPS, LSVC_GOP), mcvc_clip())
    t_jax = time.perf_counter() - t0
    made = cases(refs)
    d = tmp_path_factory.mktemp("parallel")
    dm.save_cases(made, d / "cases.pt")
    launch = dm.Launch(WORLD, ["--device", "cpu", "--cases", str(d / "cases.pt"), "--out", str(d),
                               "--no-reference"], SPAWN_TIMEOUT)
    single = {c.name: single_process(c) for c in made}
    launch.wait()
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    print(f"JAX {t_jax:.1f} s; the spawn and the single-process steps "
          f"{time.perf_counter() - t0 - t_jax:.1f} s")
    jax_of = {"lsvc_dp": refs["lsvc"], "lsvc_frame": refs["lsvc"], "mcvc": refs["mcvc"]}
    return {c.name: ([r[c.name]["sharded"] for r in ranks], single[c.name], jax_of.get(c.name))
            for c in made}


CASES = ("lsvc_dp", "lsvc_frame", "lsvc_attn_frame", "mcvc", "ssf_dp")


@pytest.mark.parametrize("name", CASES)
def test_sharded_step_matches_the_single_process_step(outcome, name):
    ranks, single, _ = outcome[name]
    got = ranks[0]
    flow = FLOW_PATH.get(name, ())
    assert not single["process_group"]
    assert_metrics_close({k: torch.tensor(v) for k, v in got["metrics"].items()},
                         single["metrics"], (*METRICS, "grad_norm"))
    assert_grads_close(got["grads"], single["grads"], flow_path=flow)
    assert_params_close(got["params"], single["params"], [sign_reference(single, got)], flow)


def sign_reference(single: dict, sharded: dict) -> dict:
    """The single-process gradients as ``assert_params_close``'s settled
    signs, but for an element that is exactly 0 there and not in the
    sharded step: a sum that cancels to 0.0 by chance, not a parameter the
    loss does not reach (-A/-S's res_decoder time attention's output
    Dense_1.weight[59, 63] is 0.0 on one torch thread, -9.3e-10 on two and
    -3.3e-8 on four, of a max of 0.69), takes the sharded value, so that
    its Adam step is held as float32 noise around 0, not as a zero."""
    return {n: torch.where((g == 0) & (sharded["grads"][n] != 0), sharded["grads"][n], g)
            for n, g in single["grads"].items()}


@pytest.mark.parametrize("name", CASES)
def test_ranks_hold_equal_parameters(outcome, name):
    ranks, _, _ = outcome[name]
    assert [r["identical"] for r in ranks] == [True] * WORLD


@pytest.mark.parametrize("name", ("lsvc_dp", "lsvc_frame", "mcvc"))
def test_sharded_step_matches_jax(outcome, name):
    """Under JAX's draws, rank-sliced: JAX's loss, metrics and gradients."""
    ranks, _, ref = outcome[name]
    got = ranks[0]
    module = (ft.get_codec_model("MCVC-IA-TINY", device="cpu", num_views=MCVC_VIEWS)
              if name == "mcvc" else ft.get_codec_model("LSVC-TPU-TINY", device="cpu")).module
    print(f"{name}: {[r['flips'] for r in ranks]} ReLU elements took JAX's other branch, "
          "by rank")
    assert_metrics_close({k: torch.tensor(v) for k, v in got["metrics"].items()}, ref["metrics"])
    assert_grads_close(got["grads"], in_port_layout(module, ref["grads"]),
                       flow_path=FLOW_PATH.get(name, ()))


def test_ranks_import_no_jax(outcome):
    blocked = {m for ranks, _, _ in outcome.values() for r in ranks for m in r["blocked_modules"]}
    assert not blocked, blocked


def test_a_failing_rank_fails_the_launch(tmp_path):
    """A mesh of 8 on 4 ranks: every rank raises make_mesh's ValueError, and
    the launch raises with a rank's traceback well within its timeout."""
    case = dm.Case("too_large", "LSVC-TPU-TINY", (8, 1, 1),
                   np.zeros((8, 2, 3, SIZE, SIZE), np.float32), "tiny_lsvctpu_l2")
    dm.save_cases([case], tmp_path / "cases.pt")
    t0 = time.perf_counter()
    launch = dm.Launch(WORLD, ["--device", "cpu", "--cases", str(tmp_path / "cases.pt"),
                               "--out", str(tmp_path)], SPAWN_TIMEOUT)
    with pytest.raises(RuntimeError, match="needs 8 devices, have 4"):
        launch.wait()
    assert time.perf_counter() - t0 < SPAWN_TIMEOUT
    assert all(p.poll() is not None for p in launch.procs)
