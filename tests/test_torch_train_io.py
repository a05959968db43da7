"""The port's training around the loss, on the CPU: an eval rollout then a
training step in one process; the batched step; what raises; checkpoints;
the data pipeline against the JAX package's; the CLI end to end.

- Cached tensors: an eval rollout (``torch.inference_mode``) fills
  ops/warp.py's caches; the training step after it must not meet an
  inference tensor saved for backward (it did before the caches were
  built outside inference mode).
- The batched step's loss, metrics and gradients are the means of the
  per-clip ones under the same noise (float32 sums in another order:
  1e-6 relative; gradients within 1e-6 of each parameter's max |grad|).
- Checkpoints round-trip bit for bit, ``best`` is read before ``ckpt``;
  ``load_whatever`` and ``load_with_copy`` give the JAX package's results
  on the same leaves.
- ``FrameDataset`` on a septuplet directory of PNGs written here gives the
  JAX package's arrays (in one process: the crop follows Python's salted
  hash of the sample); ``prefetch_batches`` yields the JAX package's
  batches.
- ``cli.train.main`` on that directory with LSVC-TPU-TINY, 1 epoch of 2
  steps of 2 clips at 64x64 on the CPU writes ``ckpt``; ``--resume``
  carries on from it.
"""

import numpy as np
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.cli import train as cli
from fastvideocodec_torch.data import FrameDataset, prefetch_batches
from fastvideocodec_torch.data.synthetic import synth_gop
from fastvideocodec_torch.ops.math import UniformNoise, quantize, quantize_ste
from fastvideocodec_torch.ops.warp import bilinear_upsample_x2, flow_warp
from fastvideocodec_torch.train import (
    TrainConfig,
    gop_loss,
    load_checkpoint,
    load_whatever,
    load_with_copy,
    make_train_step,
    ready_for_training,
    save_checkpoint,
)

GOP, SIZE = 4, 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port runs as fast on one thread at these sizes, and the suite's
    parallel workers share the host's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def clip(seed=0) -> torch.Tensor:
    c = synth_gop(np.random.default_rng(seed), size=SIZE, gop=GOP)
    return torch.from_numpy(np.array(c.transpose(0, 3, 1, 2)))


def tiny_lsvc(name="LSVC-TPU-TINY"):
    spec = ft.get_codec_model(name, device="cpu")
    ft.load_asset(spec.module, "tiny_lsvctpu_l2")
    return spec


def test_quantizers():
    """quantize_ste: round's value, the identity's gradient. UniformNoise:
    U(-0.5, 0.5) draws of a tensor's shape and dtype, the same for the same
    seed. quantize: the round in eval, x plus the source's draw in
    training."""
    x = torch.tensor([-1.5, -0.4, 0.5, 1.6, 2.5], requires_grad=True)
    y = quantize_ste(x)
    assert torch.equal(y.detach(), torch.round(x.detach()))
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones(5))
    u = UniformNoise(3)(torch.zeros(4096, dtype=torch.float64))
    assert u.dtype == torch.float64 and -0.5 <= float(u.min()) and float(u.max()) < 0.5
    assert float(u.std()) == pytest.approx(12 ** -0.5, rel=0.05)
    assert torch.equal(u, UniformNoise(3)(torch.zeros(4096, dtype=torch.float64)))
    want = x.detach() + UniformNoise(4)(x)
    assert torch.equal(quantize(x.detach(), True, UniformNoise(4)), want)
    assert torch.equal(quantize(x.detach()), torch.round(x.detach()))


def test_eval_rollout_then_training_step():
    spec = tiny_lsvc()
    gop = clip()
    ft.rollout(spec, gop)  # fills the caches under inference mode
    # the cached resize weights and warp grid, met by tensors that need grad
    flow = torch.randn(2, 2, 8, 8, requires_grad=True)
    img = torch.rand(2, 3, 16, 16, requires_grad=True)
    (bilinear_upsample_x2(flow).sum() + flow_warp(img, bilinear_upsample_x2(flow)).sum()
     ).backward()
    assert flow.grad is not None and img.grad is not None
    params = ready_for_training(spec)
    init_fn, step_fn = make_train_step(spec, TrainConfig())
    before = {n: p.detach().clone() for n, p in params.items()}
    _, _, metrics = step_fn(params, init_fn(params), gop, UniformNoise(0))
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert any(not torch.equal(p, before[n]) for n, p in params.items())
    com, _ = ft.rollout(spec, gop)  # and eval again after training
    assert bool(torch.isfinite(com).all())


def test_batched_step_is_the_mean_of_the_clips():
    spec = tiny_lsvc()
    params = ready_for_training(spec)
    cfg = TrainConfig()
    clips = torch.stack([clip(0), clip(1)])
    draws = UniformNoise(5)
    noise = []

    def recorded(x):
        noise.append(draws(x))
        return noise[-1]

    def replay():
        it = iter(noise)
        return lambda x: next(it)

    # per clip: each loss and gradient alone, the noise recorded in order
    losses, metrics, grads = [], [], []
    for b in range(2):
        loss, m = gop_loss(spec, clips[b], True, recorded, cfg)
        loss.backward()
        losses.append(float(loss))
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append({n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                      for n, p in params.items()})
        for p in params.values():
            p.grad = None
    mean_grad = {n: (grads[0][n] + grads[1][n]) / 2 for n in params}

    # the batched step's gradient, read by an optimizer that keeps it
    class Keep:
        def init(self, params):
            return {}

        def update(self, grads, state, params):
            state["grads"] = grads
            return {}, state

    init_fn, step_fn = make_train_step(spec, cfg, optimizer=Keep(), batched=True)
    _, state, m = step_fn(params, init_fn(params), clips, replay())
    assert abs(float(m["loss"]) - np.mean(losses)) <= 1e-6 * abs(np.mean(losses))
    for k in metrics[0]:
        want = (metrics[0][k] + metrics[1][k]) / 2
        assert abs(float(m[k]) - want) <= 1e-6 * max(abs(want), 1e-6), k
    for n, g in state["grads"].items():
        scale = float(mean_grad[n].abs().max())
        assert float((g - mean_grad[n]).abs().max()) <= 1e-6 * max(scale, 1e-12), n


def trains(spec, gop, prefix=("mv_encoder", "mv_codec.enc")) -> None:
    """One gop_loss backward in training on ``spec``'s shipped or
    registry-initialised weights: a finite loss and a gradient that
    reaches the mv encoder."""
    params = ready_for_training(spec)
    loss, _ = gop_loss(spec, gop, True, UniformNoise(0), TrainConfig())
    loss.backward()
    assert torch.isfinite(loss)
    assert any(p.grad is not None and float(p.grad.abs().max()) > 0
               for n, p in params.items() if n.startswith(prefix))


@pytest.mark.parametrize("name, kw", [("RLVC-TINY", {}), ("DVC-TINY", {}),
                                      ("Base-ER-TINY", {})])
def test_training_other_families_raises(name, kw):
    """DVC, RLVC and Base train now (they raised before their port)."""
    trains(ft.get_codec_model(name, device="cpu", **kw), clip())


def test_msssim_loss_and_bf16_training_raise():
    """Loss type M trains (it raised before ops/msssim.py was ported; MS-SSIM
    needs frames above 160 px). bfloat16 training raised before its port:
    a bf16 spec now readies float32 masters, and the bf16 inference build,
    its weights rounded, is refused."""
    spec = ft.get_codec_model("LSVC-TPU-TINY", device="cpu", loss_type="M")
    assert spec.r == 32.0
    big = synth_gop(np.random.default_rng(0), size=192, gop=3)
    trains(spec, torch.from_numpy(np.array(big.transpose(0, 3, 1, 2))))
    spec = ft.get_codec_model("LSVC-TPU-TINY", device="cpu")
    params = ready_for_training(spec, torch.bfloat16)
    assert params and {p.dtype for p in params.values()} == {torch.float32}
    assert spec.module.dtype == torch.bfloat16
    spec = ft.get_codec_model("LSVC-TPU-TINY", device="cpu", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32 master"):
        ready_for_training(spec)
    with pytest.raises(ValueError, match="noise"):
        ft.ops.quantize(torch.zeros(2), training=True)


def test_checkpoint_round_trip_and_best_first(tmp_path):
    spec = tiny_lsvc()
    params = ready_for_training(spec)
    init_fn, step_fn = make_train_step(spec, TrainConfig())
    params, opt_state, _ = step_fn(params, init_fn(params), clip(), UniformNoise(0))
    state = {"params": {n: p.detach() for n, p in params.items()}, "opt_state": opt_state,
             "epoch": 3, "score": 0.125}
    save_checkpoint(str(tmp_path), state)
    loaded = load_checkpoint(str(tmp_path))
    assert loaded["epoch"] == 3 and loaded["score"] == 0.125
    for n, p in params.items():
        assert torch.equal(loaded["params"][n], p.detach())
    for group in ("main", "aux"):
        got, want = loaded["opt_state"][group], opt_state[group]
        assert got["count"] == want["count"] == 1
        for key in ("mu", "nu"):
            assert got[key].keys() == want[key].keys()
            assert all(torch.equal(got[key][n], want[key][n]) for n in want[key])
    # best before ckpt; prefer_best=False the other way round
    save_checkpoint(str(tmp_path), {**state, "epoch": 4}, best=True)
    save_checkpoint(str(tmp_path), {**state, "epoch": 5})
    assert load_checkpoint(str(tmp_path))["epoch"] == 4
    assert load_checkpoint(str(tmp_path), prefer_best=False)["epoch"] == 5
    assert sorted(p.name for p in tmp_path.iterdir()) == ["best", "ckpt"]
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"))


def jax_and_port_trees():
    """Leaves by dotted name, two of them under backup_* modules."""
    rng = np.random.default_rng(0)

    def leaf(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    flat = {"enc.Conv_0.kernel": leaf(3, 2), "enc.Conv_0.bias": leaf(2),
            "dec.Dense_0.kernel": leaf(4, 4), "backup_dec.Dense_0.kernel": leaf(4, 4),
            "backup_dec.extra.bias": leaf(3), "head.backup_x.w": leaf(2)}
    return flat


def nested(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def flattened(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(flattened(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def test_tolerant_loaders_match_jax():
    from fastvideocodec_tpu.train.checkpoint import load_whatever as jax_load_whatever
    from fastvideocodec_tpu.train.checkpoint import load_with_copy as jax_load_with_copy

    params = jax_and_port_trees()
    rng = np.random.default_rng(1)
    source = {"enc.Conv_0.kernel": rng.standard_normal((3, 2)).astype(np.float32),
              "enc.Conv_0.bias": rng.standard_normal(5).astype(np.float32),  # shape differs
              "dec.Dense_0.kernel": rng.standard_normal((4, 4)).astype(np.float32),
              "other.w": rng.standard_normal(2).astype(np.float32)}  # no such leaf
    port_params = {k: torch.from_numpy(v) for k, v in params.items()}
    port_source = {k: torch.from_numpy(v) for k, v in source.items()}
    for jfn, fn in ((jax_load_whatever, load_whatever), (jax_load_with_copy, load_with_copy)):
        want = flattened(jfn(nested(params), nested(source)))
        got = fn(port_params, port_source)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    got = load_with_copy(port_params, port_source)
    assert torch.equal(got["backup_dec.Dense_0.kernel"], port_source["dec.Dense_0.kernel"])
    assert torch.equal(got["enc.Conv_0.bias"], port_params["enc.Conv_0.bias"])


@pytest.fixture(scope="module")
def septuplets(tmp_path_factory):
    """A Vimeo-90k-style directory: 4 septuplets of 7 PNGs of 48x40."""
    image = pytest.importorskip("PIL.Image")
    root = tmp_path_factory.mktemp("vimeo")
    rng = np.random.default_rng(0)
    names = []
    for s in range(4):
        seq = root / "sequences" / f"{s:05d}" / "0001"
        seq.mkdir(parents=True)
        clip = synth_gop(rng, size=48, gop=7)[:, :40]
        for i, frame in enumerate(clip, start=1):
            image.fromarray((frame * 255).astype(np.uint8)).save(seq / f"im{i}.png")
        names.append(f"{s:05d}/0001")
    (root / "sep_trainlist.txt").write_text("\n".join(names) + "\n")
    return root


def test_frame_dataset_matches_jax(septuplets):
    from fastvideocodec_tpu.data.vimeo import FrameDataset as JaxFrameDataset

    ds, jds = FrameDataset(str(septuplets), 32), JaxFrameDataset(str(septuplets), 32)
    assert len(ds) == len(jds) == 4
    for i in range(4):
        got = ds[i]
        assert got.shape == (7, 32, 32, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jds[i])


def test_prefetch_batches_match_jax(septuplets):
    from fastvideocodec_tpu.data.loader import prefetch_batches as jax_prefetch

    ds = FrameDataset(str(septuplets), 32)
    order = [3, 1, 0]
    got = [b.numpy() for b in prefetch_batches(ds, order, batch_size=2, device="cpu")]
    want = [np.asarray(b) for b in jax_prefetch(ds, order, batch_size=2)]
    assert [g.shape for g in got] == [w.shape for w in want] == [(2, 7, 32, 32, 3),
                                                                (1, 7, 32, 32, 3)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # a consumer that stops early leaves no thread behind
    it = prefetch_batches(ds, order, batch_size=1, device="cpu")
    next(it)
    it.close()


def test_cli_trains_writes_ckpt_and_resumes(septuplets, tmp_path, capsys):
    args = ["--codec", "LSVC-TPU-TINY", "--dataset-dir", str(septuplets), "--epochs", "1",
            "--steps-per-epoch", "2", "--batch-size", "2", "--frame-size", "64",
            "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    cli.main(args)
    ckpt_dir = tmp_path / "LSVC-TPU-TINY-2P"
    assert (ckpt_dir / "ckpt").exists()
    first = load_checkpoint(str(ckpt_dir), prefer_best=False)
    assert first["epoch"] == 0 and np.isfinite(first["score"])
    assert first["opt_state"]["main"]["count"] == 2
    cli.main([*args[:5], "2", *args[6:], "--resume"])
    out = capsys.readouterr().out
    assert "resumed from epoch 0" in out and "epoch 1 done" in out
    second = load_checkpoint(str(ckpt_dir), prefer_best=False)
    assert second["epoch"] == 1 and second["opt_state"]["main"]["count"] == 4
    with pytest.raises(SystemExit, match="item 7"):
        cli.main([*args, "--evaluate"])
    # --bf16 raised before bf16 training was ported: it trains 2 steps and
    # checkpoints float32 parameters
    bf16_dir = tmp_path / "bf16"
    cli.main([*args[:-1], str(bf16_dir), "--bf16"])
    state = load_checkpoint(str(bf16_dir / "LSVC-TPU-TINY-2P"), prefer_best=False)
    assert state["opt_state"]["main"]["count"] == 2 and np.isfinite(state["score"])
    assert {t.dtype for t in state["params"].values()} == {torch.float32}
