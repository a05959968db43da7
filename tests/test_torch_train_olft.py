"""MCVC-IA-OLFT's online fine-tuning and the multi-view trainer in the port
against the JAX package, on the CPU, in float32. JAX's draws and ReLU
branches are recorded and replayed, and the bars set, as
tests/test_torch_train_common.py sets them out; the JAX functions run
under ``jax.jit``.

What is held to JAX:
- ``make_olft_step`` on MCVC-IA-OLFT-TINY (tiny_mcvc_l3), 3 views of 64x64
  (synth_mv_gop, numpy seed 0), GOP 4, view 2 failed, ratio 0.1, two
  steps against JAX's ``make_olft_step`` (the first step's gradients read
  from a pass-through optax stage chained before the optimizer): the
  loss (sum(r x alive-view MSE against the touch-up labels), no rate
  term) and metrics (``psnr`` against the raw frames, ``bpp`` over every
  likelihood), every gradient (the motion decoder's at the flow path's
  bar), the parameters after each step, and ``touch_labels`` and
  ``touch_mask`` exactly: the labels are built from the detached
  references, so the port's refs (within 1e-5 of JAX's) must pick the
  same top 10% of each frame's errors;
- ``touchup_labels``: ratio 0 gives the recon and an all-false mask;
  ties at the threshold all join the mask; labels and masks equal JAX's
  on the same arrays;
- ``touchup_bits``: the same byte count as JAX's on the same arrays (and
  ``touchup_bytes`` of the port's NCHW tensors that of JAX's NHWC ones);
- ``probe_sample_interval``: the same interval from the same numpy
  generator, left in the same state (MCVC-IA-TINY on tiny_mcvc_l3);
- ``MultiViewVideoDataset`` on a JPEG tree the test writes (lobby_0, 4
  views): the same arrays (NCHW here), lengths and ``sample()`` growth;
- ``write_eval_log``/``read_eval_log``: the same bytes, the same records;
- ``cli/train_multiview.py --task train --device cpu --debug`` on that
  tree, MCVC-IA-OLFT-TINY (with the bandwidth probe, ``--resume`` and
  ``--log-key``) and MCVC-IA-TINY: the clip indices and view masks it
  draws are those of JAX's CLI for the same ``--seed`` (JAX's steps
  stubbed: only its host draws are compared), and its logs and
  checkpoints are written; ``--task speed``, ``eval --real-bits`` and
  ``x26x`` (JAX's error without ffmpeg) run.
"""

import os
import shutil
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.cli import train_multiview as cli
from fastvideocodec_torch.data import MultiViewVideoDataset
from fastvideocodec_torch.data.synthetic import synth_mv_gop
from fastvideocodec_torch.ops.math import UniformNoise, bits_estimate
from fastvideocodec_torch.train import (
    TrainConfig,
    load_checkpoint,
    make_olft_step,
    probe_sample_interval,
    ready_for_training,
    touchup_bits,
    touchup_labels,
)
from fastvideocodec_torch.train.olft import touchup_bytes
from fastvideocodec_torch.utils import read_eval_log, write_eval_log
from fastvideocodec_torch.weights import flatten_params
from fastvideocodec_tpu.cli import train_multiview as jax_cli
from fastvideocodec_tpu.data import multiview as jax_multiview
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model
from fastvideocodec_tpu.train import olft as jax_olft
from fastvideocodec_tpu.train import trainer as jax_trainer
from fastvideocodec_tpu.train.checkpoint import asset_params
from fastvideocodec_tpu.utils import logs as jax_logs
from test_torch_train_common import (  # noqa: F401 (one_torch_thread: autouse here)
    LR,
    METRIC_REL,
    JaxBranches,
    JaxDraws,
    OnJaxBranches,
    Replay,
    assert_grads_close,
    assert_metrics_close,
    assert_params_close,
    grab_grads,
    in_port_layout,
    one_torch_thread,
    port_grads,
)

VIEWS, SIZE, GOP = 3, 64, 4
MASK = np.array([1, 1, 0], np.float32)  # view 2 failed
RATIO = 0.1
NAME, ASSET = "MCVC-IA-OLFT-TINY", "tiny_mcvc_l3"
FLOW_PATH = ("motion_decoder.",)  # as tests/test_torch_train_mcvc.py
OLFT_METRICS = ("loss", "psnr", "bpp", "img_loss", "grad_norm")
TOUCH = ("touch_refs", "touch_labels", "touch_mask")


def mv_clip(seed: int = 0) -> np.ndarray:
    return synth_mv_gop(np.random.default_rng(seed), views=VIEWS, size=SIZE, gop=GOP)


def nchw5(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 1, 4, 2, 3)))


def nhwc5(t) -> np.ndarray:
    return t.detach().numpy().transpose(0, 1, 3, 4, 2)


def port_model(name: str = NAME, views: int = VIEWS):
    spec = ft.get_codec_model(name, device="cpu", num_views=views)
    ft.load_asset(spec.module, ASSET)
    return spec


# ---------------------------------------------------------------------------
# make_olft_step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def olft_reference():
    """JAX's make_olft_step for two steps: each step's draws, ReLU
    branches, gradients, parameters, metrics and touch-up arrays."""
    cfg = jax_trainer.TrainConfig(learning_rate=LR)
    params = {"params": asset_params(ASSET)["params"]}
    draws, branches = JaxDraws(), JaxBranches()
    steps = []
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"):
        mp.setattr(jax.random, "uniform", draws)
        mp.setattr(jax.nn, "relu", branches)
        spec = jax_get_codec_model(NAME, num_views=VIEWS)
        tx = optax.chain(grab_grads(), jax_trainer.make_optimizer(cfg))
        init_fn, step_fn = jax_olft.make_olft_step(spec, cfg, RATIO, optimizer=tx)
        opt_state = init_fn(params)
        step = jax.jit(step_fn)
        for seed in (1, 2):
            params, opt_state, metrics = step(params, opt_state, jnp.asarray(mv_clip()),
                                              jax.random.PRNGKey(seed), jnp.asarray(MASK))
            jax.block_until_ready(params)
            steps.append({
                "draws": draws.take(), "branches": branches.take(),
                "grads": flatten_params(opt_state[0]["g"]), "params": flatten_params(params),
                "metrics": {k: float(v) for k, v in metrics.items() if k not in TOUCH},
                **{k: np.asarray(metrics[k]) for k in TOUCH}})
    return steps


def test_olft_step_matches_jax(olft_reference):
    """Two OLFT steps: the draws in JAX's order, the loss and metrics, every
    gradient, the touch-up labels and masks exactly, and the parameters
    after each step."""
    spec = port_model()
    params = ready_for_training(spec)
    init_fn, step_fn = make_olft_step(spec, TrainConfig(learning_rate=LR), RATIO)
    opt_state = init_fn(params)
    gop = nchw5(mv_clip())
    seen = []
    for ref in olft_reference:
        noise = Replay(ref["draws"])
        grads = {}

        def keep(name):
            return lambda g: grads.__setitem__(name, g.detach().clone())

        hooks = [p.register_hook(keep(n)) for n, p in params.items()]
        with OnJaxBranches(ref["branches"]) as branches:
            params, opt_state, metrics = step_fn(params, opt_state, gop, noise, MASK)
        for h in hooks:
            h.remove()
        assert noise.used == len(ref["draws"])
        print(f"loss port {float(metrics['loss']):.6f} jax {ref['metrics']['loss']:.6f}; "
              f"{branches.flips} ReLU elements took JAX's other branch")
        assert_metrics_close(metrics, ref["metrics"], OLFT_METRICS)
        want_grads = in_port_layout(spec.module, ref["grads"])
        assert_grads_close({n: grads.get(n, torch.zeros_like(p)) for n, p in params.items()},
                           want_grads, flow_path=FLOW_PATH)
        np.testing.assert_allclose(nhwc5(metrics["touch_refs"]), ref["touch_refs"], rtol=0,
                                   atol=1e-5)
        mask = nhwc5(metrics["touch_mask"])
        print(f"touch mask: {int(mask.sum())} of {mask.size} elements, "
              f"{int((mask != ref['touch_mask']).sum())} apart from JAX's")
        assert np.array_equal(mask, ref["touch_mask"])
        labels = nhwc5(metrics["touch_labels"])
        # the labels are raw where the mask is set, the detached refs elsewhere
        np.testing.assert_array_equal(labels[mask], np.asarray(mv_clip())[mask])
        np.testing.assert_allclose(labels, ref["touch_labels"], rtol=0, atol=1e-5)
        seen.append(want_grads)
        assert_params_close(params, in_port_layout(spec.module, ref["params"]), seen, FLOW_PATH)


def test_olft_loss_has_no_rate_term():
    """The OLFT loss is sum(r x img_loss) over the frames, with no rate or
    aux term, and bpp counts every likelihood over T x B*V*H*W pixels."""
    spec = port_model()
    params = ready_for_training(spec)
    init_fn, step_fn = make_olft_step(spec, TrainConfig(learning_rate=0.0), RATIO)
    gop = nchw5(mv_clip())
    noise = UniformNoise(3)
    _, _, m = step_fn(params, init_fn(params), gop, noise, MASK)
    with torch.no_grad():
        recons, liks, refs = spec.module(gop, torch.from_numpy(MASK), True,
                                         UniformNoise(3))
    bits = sum(bits_estimate(p[k]) for lik in liks for p in lik.values() for k in ("y", "z"))
    assert float(m["bpp"]) == pytest.approx(float(bits) / (GOP * VIEWS * SIZE * SIZE), rel=1e-6)
    assert float(m["loss"]) == pytest.approx(GOP * spec.r * float(m["img_loss"]), rel=1e-5)
    assert torch.equal(m["touch_refs"], refs)


# ---------------------------------------------------------------------------
# touch-up labels, bits and the bandwidth probe
# ---------------------------------------------------------------------------


def test_touchup_labels_ratio_zero_and_ties():
    """ratio <= 0: the recon and an all-false mask. Ties: every element
    equal to the k-th largest error joins the mask (k = 6 of 192, and 10
    errors tie at the threshold: 12 elements set), in both packages."""
    rng = np.random.default_rng(3)
    raw = rng.random((1, 8, 8, 3)).astype(np.float32)
    recon = raw.copy()
    recon.reshape(-1)[[5, 17]] += np.float32(0.5)
    recon.reshape(-1)[[40, 41, 60, 61, 80, 81, 100, 101, 120, 121]] = 0.0
    raw.reshape(-1)[[40, 41, 60, 61, 80, 81, 100, 101, 120, 121]] = 0.25
    for ratio in (0.0, -1.0, 6 / 192, 0.1):
        label, mask = touchup_labels(torch.from_numpy(recon), torch.from_numpy(raw), ratio)
        jlabel, jmask = jax_olft.touchup_labels(jnp.asarray(recon), jnp.asarray(raw), ratio)
        assert mask.dtype == torch.bool
        assert np.array_equal(mask.numpy(), np.asarray(jmask)), ratio
        assert np.array_equal(label.numpy(), np.asarray(jlabel)), ratio
        if ratio <= 0:
            assert not mask.any() and torch.equal(label, torch.from_numpy(recon))
    _, mask = touchup_labels(torch.from_numpy(recon), torch.from_numpy(raw), 6 / 192)
    assert int(mask.sum()) == 12


def test_touchup_bits_is_jax():
    """The zlib byte count of JAX's numpy on the same arrays, with and
    without compression, none for an empty mask; ``touchup_bytes`` of the
    NCHW tensors gives JAX's count of the NHWC arrays."""
    rng = np.random.default_rng(4)
    raw = rng.random((GOP, VIEWS, 16, 24, 3)).astype(np.float32)
    recon = np.clip(raw + rng.normal(0, 0.05, raw.shape).astype(np.float32), 0, 1)
    label, mask = (np.asarray(a) for a in jax_olft.touchup_labels(
        jnp.asarray(recon), jnp.asarray(raw), 0.1))
    for compress in (True, False):
        want = jax_olft.touchup_bits(recon, label, mask, use_compression=compress)
        assert touchup_bits(recon, label, mask, use_compression=compress) == want > 0
    assert touchup_bits(recon, label, np.zeros_like(mask)) == 0
    got = touchup_bytes(nchw5(recon.reshape(GOP, VIEWS, 16, 24, 3)), nchw5(label),
                        nchw5(mask))
    assert got == jax_olft.touchup_bits(recon, label, mask)
    deltas = ((label - recon) * 255.0).astype(np.uint8)[mask]
    assert got == len(zlib.compress(deltas.tobytes() + np.packbits(mask).tobytes()))


class GopList:
    """A dataset of fixed GOPs, in either package's layout."""

    def __init__(self, gops):
        self.gops = gops

    def __len__(self):
        return len(self.gops)

    def __getitem__(self, i):
        return self.gops[i]


def test_probe_sample_interval_is_jax():
    """MCVC-IA-TINY on tiny_mcvc_l3 over 3 GOPs of 3 views of 64x64: the
    same interval as JAX's probe for two budgets under the measured rate,
    the generator left in the same state."""
    gops = [synth_mv_gop(np.random.default_rng(s), views=VIEWS, size=SIZE, gop=3)
            for s in range(3)]
    spec = port_model("MCVC-IA-TINY")
    jspec = jax_get_codec_model("MCVC-IA-TINY", num_views=VIEWS)
    jparams = {"params": asset_params(ASSET)["params"]}
    port_ds = GopList([np.ascontiguousarray(g.transpose(0, 1, 4, 2, 3)) for g in gops])
    seen = []
    for budget in (5e5, 1e5):
        rng, jrng = np.random.default_rng(9), np.random.default_rng(9)
        got = probe_sample_interval(spec, port_ds, RATIO, budget, rng=rng)
        with jax.default_matmul_precision("highest"):
            want = jax_olft.probe_sample_interval(jspec, jparams, GopList(gops), RATIO, budget,
                                                  rng=jrng)
        seen.append((budget, got, want))
        assert got == want, seen
        assert rng.integers(0, 2**31) == jrng.integers(0, 2**31)
    print(f"(budget, port interval, JAX interval): {seen}")
    assert 1 < seen[0][1] < seen[-1][1]


# ---------------------------------------------------------------------------
# the MMPTracking dataset, the logs and the CLI
# ---------------------------------------------------------------------------

FRAMES = 20  # the tree's frame ids: 16 train, 4 test
CATEGORY = 1  # lobby_0, 4 views


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A JPEG tree of the multiview layout: lobby_0/rgb_{frame:05d}_{view}.jpg,
    72 x 80 smooth frames that drift, every view its own crop."""
    from PIL import Image

    root = tmp_path_factory.mktemp("mmptracking")
    d = root / "lobby_0"
    d.mkdir()
    rng = np.random.default_rng(11)
    base = synth_mv_gop(rng, views=4, size=80, gop=FRAMES)  # [T, V, 80, 80, 3]
    for t in range(FRAMES):
        for v in range(4):
            img = (base[t, v, :72] * 255).astype(np.uint8)
            Image.fromarray(img).save(d / f"rgb_{t:05d}_{v + 1}.jpg", quality=90)
    (d / "notes.txt").write_text("not a frame")
    return str(root)


@pytest.mark.parametrize("split", ["train", "test"])
def test_multiview_dataset_is_jax(tree, split):
    kw = dict(category_id=CATEGORY, gop_size=3, frame_size=32, split=split, c2s_ratio=0.5,
              sample_interval=2, max_pool_size=12)
    port, jax_ds = MultiViewVideoDataset(tree, **kw), jax_multiview.MultiViewVideoDataset(
        tree, **kw)
    assert port.category == jax_ds.category == "lobby_0" and port.num_views == 4
    assert len(port) == len(jax_ds)
    for idx in range(len(port) + 2):
        got, want = port[idx], jax_ds[idx]
        assert got.shape == (3, 4, 3, 32, 32) and got.dtype == np.float32
        assert np.array_equal(got, want.transpose(0, 1, 4, 2, 3)), idx
    growth = [(port.sample(s), jax_ds.sample(s), len(port), len(jax_ds)) for s in range(20)]
    assert all(a == b and c == d for a, b, c, d in growth), growth
    if split == "train":
        assert growth[0][0] == 3 and growth[-1][0] == 12


def test_eval_log_is_jax(tmp_path):
    """The same two-line records, byte for byte, and read back the same."""
    records = [(2, 0.0123456, 1.5, 0.25, [31.2, 30.9876], ()),
               (3, 0.5, 0.0, 0.0, [28.0], (0.1234567, 2.0))]
    for i, (package, write) in enumerate((("port", write_eval_log),
                                          ("jax", jax_logs.write_eval_log))):
        path = tmp_path / package / "sub" / "x.log"
        for level, bpp, enc, dec, psnrs, aux in records:
            write(str(path), level, bpp, enc, dec, psnrs, aux=aux)
    port, jax_path = tmp_path / "port/sub/x.log", tmp_path / "jax/sub/x.log"
    assert port.read_bytes() == jax_path.read_bytes()
    assert read_eval_log(str(port)) == jax_logs.read_eval_log(str(jax_path))
    assert read_eval_log(str(port))[1][0]["aux"] == [0.1235, 2.0]


def draws_of(monkeypatch, module, dataset_cls, record):
    """Record in ``record`` the clip indices read through ``module``'s
    dataset class and the view masks drawn by its ``sample_view_mask``."""
    draw_mask = module.sample_view_mask

    class Recorded(dataset_cls):
        def __getitem__(self, idx):
            record["clips"].append(int(idx))
            return super().__getitem__(idx)

    def mask(*args, **kwargs):
        m = draw_mask(*args, **kwargs)
        record["masks"].append(np.asarray(m).tolist())
        return m

    monkeypatch.setattr(module, "MultiViewVideoDataset", Recorded)
    monkeypatch.setattr(module, "sample_view_mask", mask)


def jax_cli_draws(monkeypatch, args, cwd) -> dict:
    """JAX's CLI on ``args`` in ``cwd`` with its steps and checkpoints
    stubbed: the clip indices and masks it draws (its first read, clip 0,
    initialises its parameters and is dropped)."""
    record = {"clips": [], "masks": []}
    with monkeypatch.context() as mp:
        mp.chdir(cwd)  # its logs apart from the port's
        draws_of(mp, jax_cli, jax_multiview.MultiViewVideoDataset, record)

        def stub_step(*a, **k):
            def step(params, opt_state, gop, rng, mask):
                z = np.zeros(gop.shape, np.float32)
                return params, opt_state, {"psnr": 0.0, "bpp": 0.0, "touch_refs": z,
                                           "touch_labels": z, "touch_mask": z > 0}
            return (lambda params: {}), step

        mp.setattr(jax_cli, "make_train_step", stub_step)
        mp.setattr(jax_olft, "make_olft_step", stub_step)
        mp.setattr(jax_cli, "save_checkpoint", lambda *a, **k: None)
        jax_cli.main(args)
    assert record["clips"][0] == 0
    return {"clips": record["clips"][1:], "masks": record["masks"]}


def test_cli_train_draws_jax_clips_and_masks(tree, tmp_path, monkeypatch):
    """MCVC-IA-OLFT-TINY with the bandwidth probe (a budget far above the
    rate: interval 1), one view allowed to fail, and MCVC-IA-TINY with one
    view forced to fail: the clips and masks of JAX's CLI; then an OLFT
    run resumed from the first's checkpoint takes 10 more steps."""
    monkeypatch.chdir(tmp_path)
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    common = ["--dataset-dir", tree, "--category", str(CATEGORY), "--gop", "3",
              "--frame-size", "64", "--debug", "--seed", "5", "--sample-interval", "3",
              "--c2s-ratio", "0.5", "--ckpt-dir", str(tmp_path / "ckpt")]
    runs = {"MCVC-IA-OLFT-TINY": ["--resilience", "1", "--probe-bw-limit", "1e12",
                                  "--log-key", "sr", "--log-key-value", "0.1"],
            "MCVC-IA-TINY": ["--force-resilience", "1"]}
    for codec, extra in runs.items():
        args = ["--codec", codec, *common, *extra]
        record = {"clips": [], "masks": []}
        with monkeypatch.context() as mp:
            draws_of(mp, cli, MultiViewVideoDataset, record)
            cli.main([*args, "--device", "cpu"])
        want = jax_cli_draws(monkeypatch, args, jax_dir)
        print(f"{codec}: clips {record['clips']}, masks {record['masks']}")
        assert record == want, (record, want)
        assert len(record["masks"]) == 10
        log = read_eval_log(str(tmp_path / f"{codec}.lobby_0.log"))
        assert len(log) == 1 and np.isfinite(log[0][1][0])
        state = load_checkpoint(str(tmp_path / f"ckpt/{codec}-2P-lobby_0"))
        assert state["opt_state"]["main"]["count"] == 10
    olft = runs["MCVC-IA-OLFT-TINY"]
    assert (tmp_path / "MCVC-IA-OLFT-TINY.sr.log").read_text().startswith("0.1,2,")
    row = read_eval_log(str(tmp_path / "MCVC-IA-OLFT-TINY.lobby_0.log"))[0][0]
    assert row["aux"][0] > 0  # the touch-up bandwidth, bits a pixel
    cli.main(["--codec", "MCVC-IA-OLFT-TINY", *common, *olft, "--resume", "--device", "cpu"])
    state = load_checkpoint(str(tmp_path / "ckpt/MCVC-IA-OLFT-TINY-2P-lobby_0"))
    assert state["opt_state"]["main"]["count"] == 20


@pytest.mark.parametrize("task", ["speed", "eval", "x26x"])
def test_cli_tasks_not_ported_name_their_item(task, tree, tmp_path, monkeypatch):
    """The tasks that waited for a later slice now run: speed (one view of
    MCVC-IA-TINY, GOP 2, on the CPU), eval with real bits (level 3 on the
    test split, no checkpoint: a row flagged untrained) and x26x, which
    without ffmpeg raises JAX's error."""
    monkeypatch.chdir(tmp_path)
    common = ["--codec", "MCVC-IA-TINY", "--device", "cpu"]
    if task == "speed":
        rows = cli.main(["--task", task, *common, "--max-views", "1", "--gop", "2"])
        assert len(rows) == 1 and rows[0][0] == 1 and rows[0][1] > 0
        assert (tmp_path / "MCVC-IA-TINY.speed.log").read_text().startswith("1,")
    elif task == "eval":
        cli.main(["--task", task, *common, "--dataset-dir", tree, "--category", str(CATEGORY),
                  "--gop", "3", "--frame-size", "32", "--level-range", "3", "4", "--real-bits"])
        row = (tmp_path / "MCVC-IA-TINY.avg.log").read_text().strip().split(",")
        assert row[:2] == ["1", "3"] and len(row) == 9 and row[-1] == "untrained"
        assert float(row[2]) > 0 and float(row[3]) > 0 and float(row[4]) == 1.0
    elif shutil.which("ffmpeg") is None:
        with pytest.raises(SystemExit, match="ffmpeg not available"):
            cli.main(["--task", task, *common, "--dataset-dir", tree, "--category",
                      str(CATEGORY), "--gop", "3", "--frame-size", "32"])
    else:
        cli.main(["--task", task, "--codec", "x264", "--dataset-dir", tree, "--category",
                  str(CATEGORY), "--gop", "3", "--frame-size", "32"])
        assert (tmp_path / "x264.avg.log").read_text().startswith(f"{CATEGORY},")
    if task != "speed":  # JAX's speed task needs no dataset; the others do
        with pytest.raises(SystemExit, match="--dataset-dir is required"):
            cli.main(["--task", task])
    assert cli.parse_args([]).device == "cuda"
