"""The port's evaluation path against the JAX package's, on the CPU, in
float32: ``train/evaluate.py:evaluate_video`` (estimated and real bits,
the log it writes), ``train/evolve.py`` (the encoder mask and
``evolve_on_video`` under JAX's draws), and that every parameter the mask
selects is sender-side: an evolved encoder's stream decodes bit for bit
on the un-evolved receiver, ELFVC's with its flow predictor evolved too.

The clips are numpy-seeded (``synth_gop``) and served by
``data/video.py:ClipDataset``, which keeps ``VideoDataset``'s
stateful (frame, eof) contract in memory:
a 64x64 clip and a 48x56 one (padded to 64x64 for the codecs, so the bpp
is rescaled to the unpadded pixels; one padded shape, so that each JAX
graph compiles once). The bars:

- bpp, bpp_est and psnr (the means ``evaluate_video`` returns) within
  1e-5 relative of JAX's; the real bits' bpp is the same bytes, so equal;
- each frame's PSNR in the log within 1e-4 dB of JAX's, the log's level
  and bpp fields equal, its time fields present;
- MS-SSIM (frames above 160 px, loss type "M"): msssim_db within 1e-4 dB
  and the log's MS-SSIM quality list within 1e-4 dB;
- evolve: the parameters after 3 Adam steps at the Adam bars of
  tests/test_torch_train_common.py (``assert_params_close``), the
  parameters outside ``encoder_mask`` bit for bit unchanged, and ``best``
  within 1e-5 relative.

Each JAX reference runs once a module, in a fixture the cases share.
"""

import functools
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.coder import video as cv
from fastvideocodec_torch.data import ClipDataset
from fastvideocodec_torch.data.synthetic import synth_gop
from fastvideocodec_torch.train.evaluate import evaluate_video, pad_to_multiple
from fastvideocodec_torch.train.evolve import ENCODER_KEYS, encoder_mask, evolve_on_video
from fastvideocodec_torch.utils.logs import read_eval_log
from fastvideocodec_torch.weights import flatten_params
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model
from fastvideocodec_tpu.train import evaluate as jax_evaluate
from fastvideocodec_tpu.train import evolve as jax_evolve
from fastvideocodec_tpu.train.checkpoint import asset_params
from test_torch_train_common import (  # noqa: F401 (one_torch_thread: autouse here)
    LR,
    JaxDraws,
    Replay,
    assert_params_close,
    in_port_layout,
    one_torch_thread,
)

REL = 1e-5  # the returned means, relative
PSNR_DB = 1e-4  # each frame's PSNR (and MS-SSIM quality) in the log, dB
GOP = 3
# (name, asset, real_bits, loss type)
EVAL_CASES = [
    ("LSVC-TPU-TINY", "tiny_lsvctpu_l2", False, "P"),
    ("LSVC-TPU-TINY", "tiny_lsvctpu_l2", True, "P"),
    ("SSF-TPU-TINY", "tiny_ssftpu_l2", True, "P"),
    ("DVC-TINY", "tiny_dvc_l2", False, "P"),
]
MSSSIM_CASE = ("LSVC-TPU-TINY", "tiny_lsvctpu_l2", False, "M")
EVOLVE_STEPS = 3


def clips(size=(64, 64), second=(48, 56), frames=GOP):
    rng = np.random.default_rng(5)
    out = [synth_gop(rng, size=max(size), gop=frames)[:, :size[0], :size[1]]]
    if second:
        out.append(synth_gop(rng, size=max(second), gop=frames)[:, :second[0], :second[1]])
    return out


def port_spec(name, asset, loss_type="P", **kw):
    spec = ft.get_codec_model(name, device="cpu", loss_type=loss_type, **kw)
    ft.load_asset(spec.module, asset)
    return spec


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's evaluate_video on each case: (returned dict, log records), and
    on clips that end in a one-frame tail: (returned dict, whether a log
    was written). One JAX spec a (name, loss type), its jitted rollout
    shared by the calls that run it (JAX's evaluate_video jits a new
    partial each call); the cases run on threads, so that one compiles
    while another traces (XLA's compile releases the GIL)."""
    d = tmp_path_factory.mktemp("jax_eval")
    specs = {key: jax_get_codec_model(key[0], loss_type=key[1])
             for key in {(c[0], c[3]) for c in EVAL_CASES + [MSSSIM_CASE]}}
    jitted, lock = {}, threading.Lock()
    jit = jax.jit

    def shared_jit(fn, *args, **kw):
        if isinstance(fn, functools.partial) and fn.func is jax_evaluate.rollout:
            key = (id(fn.args[0]), tuple(sorted(fn.keywords.items())))
            with lock:
                if key not in jitted:
                    jitted[key] = jit(fn, *args, **kw)
                return jitted[key]
        return jit(fn, *args, **kw)

    def run(case, data, log):
        name, asset, real_bits, loss_type = case
        return jax_evaluate.evaluate_video(specs[(name, loss_type)], asset_params(asset),
                                           ClipDataset(data), gop_size=GOP, log_path=log,
                                           level=2, real_bits=real_bits)

    jobs = {case: (case, clips((176, 176), None, 2) if case is MSSSIM_CASE else clips(),
                   str(d / f"{i}.log")) for i, case in enumerate(EVAL_CASES + [MSSSIM_CASE])}
    jobs["tail"] = (EVAL_CASES[0], clips(frames=GOP + 1), str(d / "tail.log"))
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"), \
            ThreadPoolExecutor(max_workers=3) as pool:
        mp.setattr(jax_evaluate.jax, "jit", shared_jit)
        futures = {key: pool.submit(run, *job) for key, job in jobs.items()}
        out = {key: f.result() for key, f in futures.items()}
    for key, (_, _, log) in jobs.items():
        out[key] = (out[key], os.path.exists(log) if key == "tail" else read_eval_log(log))
    return out


def assert_same_eval(got, got_log, want, want_log):
    for key in ("bpp", "bpp_est", "psnr"):
        assert abs(got[key] - want[key]) <= REL * abs(want[key]), (key, got[key], want[key])
    assert set(got) == set(want)
    assert len(got_log) == len(want_log) == 2  # one record a clip
    for (gh, gq), (wh, wq) in zip(got_log, want_log):
        assert (gh["level"], gh["bpp"]) == (wh["level"], wh["bpp"])
        assert len(gh["aux"]) == len(wh["aux"]) and gh["enc_t"] >= 0 and gh["dec_t"] >= 0
        assert len(gq) == len(wq)
        assert np.max(np.abs(np.subtract(gq, wq))) <= PSNR_DB, (gq, wq)


@pytest.mark.parametrize("case", EVAL_CASES, ids=lambda c: f"{c[0]}-{'real' if c[2] else 'est'}")
def test_evaluate_video_is_jax(case, jax_runs, tmp_path):
    name, asset, real_bits, loss_type = case
    log = str(tmp_path / "port.log")
    got = evaluate_video(port_spec(name, asset), ClipDataset(clips()), gop_size=GOP,
                         log_path=log, level=2, real_bits=real_bits)
    want, want_log = jax_runs[case]
    if real_bits:  # the same streams
        assert got["bpp"] == pytest.approx(want["bpp"], rel=1e-12)
        assert got["enc_ac_sec_per_frame"] > 0 and got["dec_ac_sec_per_frame"] > 0
    assert_same_eval(got, read_eval_log(log), want, want_log)
    # no BPG here: the I-frame is passed through at 24 bpp and 120 dB,
    # except where the codec codes its own keyframe (SSF real bits)
    first = read_eval_log(log)[0][1][0]
    assert (first == 120.0) == (name != "SSF-TPU-TINY" or not real_bits)


def test_evaluate_video_msssim_and_loss_type_m(jax_runs, tmp_path):
    """176x176 frames: MS-SSIM beside PSNR, and with loss type M the log
    carries the MS-SSIM quality list."""
    name, asset, _, loss_type = MSSSIM_CASE
    log = str(tmp_path / "port.log")
    got = evaluate_video(port_spec(name, asset, loss_type), ClipDataset(clips((176, 176), None, 2)),
                         gop_size=GOP, log_path=log, level=2)
    want, want_log = jax_runs[MSSSIM_CASE]
    # the pass-through I-frame's inf is in both means (JAX's too)
    assert got["msssim_db"] == want["msssim_db"] == float("inf")
    got_log = read_eval_log(log)
    assert len(got_log) == len(want_log) == 1
    (gh, gq), (wh, wq) = got_log[0], want_log[0]
    assert (gh["level"], gh["bpp"]) == (wh["level"], wh["bpp"])
    assert np.max(np.abs(np.subtract(gq[1:], wq[1:]))) <= PSNR_DB
    # the quality list is MS-SSIM's: the pass-through I-frame is 120 dB in
    # PSNR and inf in MS-SSIM quality (which JAX's own log reader cannot
    # parse, ROADMAP.md section 3); the mean rides the aux field
    assert gq[0] == wq[0] == float("inf")
    assert gh["aux"][0] == wh["aux"][0] == float("inf")


def test_one_frame_tail_keeps_its_record(jax_runs, tmp_path):
    """Clips of GOP + 1 frames: the tail is skipped in both packages (the
    same means), and JAX's loop skips each clip's record with it, where
    the port writes both records (ROADMAP.md section 3)."""
    want, jax_logged = jax_runs["tail"]
    log = str(tmp_path / "port.log")
    got = evaluate_video(port_spec("LSVC-TPU-TINY", "tiny_lsvctpu_l2"),
                         ClipDataset(clips(frames=GOP + 1)), gop_size=GOP, log_path=log, level=2)
    for key in ("bpp", "bpp_est", "psnr"):
        assert abs(got[key] - want[key]) <= REL * abs(want[key]), key
    assert not jax_logged
    records = read_eval_log(log)
    assert len(records) == 2 and all(len(q) == GOP for _, q in records)


def test_pad_to_multiple_is_jax():
    x = np.random.default_rng(0).random((2, 72, 80, 3), dtype=np.float32)
    got, hw = pad_to_multiple(x, 64)
    want, jhw = jax_evaluate.pad_to_multiple(x, 64)
    assert hw == jhw == (72, 80) and np.array_equal(got, want) and got.shape == (2, 128, 128, 3)


# --- evolve ------------------------------------------------------------------

MASK_CASES = [("LSVC-TPU-TINY", {}), ("SSF-TPU-TINY", {}), ("ELFVC-SP-TPU-TINY", {}),
              ("DVC-TINY", {}), ("RLVC-TINY", {}), ("Base-ER-TINY", {}),
              ("MCVC-IA-TINY", {"num_views": 3})]


def jax_flat_mask(name, kw):
    """JAX's encoder_mask of ``name``'s variables (a tree of zeros in
    flax's layout) as {flax path without its params root and leaf: bool}."""
    shapes = ft.weights.flax_shapes(ft.get_codec_model(name, device="cpu", **kw).module)
    tree = {}
    for key, shape in shapes.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.zeros(shape, np.float32)
    mask = flatten_params(jax_evolve.encoder_mask(tree))
    return {"/".join(k.split("/")[1:-1]): bool(v) for k, v in mask.items()}


@pytest.mark.parametrize("name,kw", MASK_CASES, ids=[c[0] for c in MASK_CASES])
def test_encoder_mask_is_jax(name, kw):
    module = ft.get_codec_model(name, device="cpu", **kw).module
    got = {}
    for pname, selected in encoder_mask(module).items():
        got.setdefault("/".join(pname.split(".")[:-1]), set()).add(selected)
    want = jax_flat_mask(name, kw)
    assert set(got) == set(want)
    for path, sel in got.items():
        assert sel == {want[path]}, path
    assert any(want.values()) and not all(want.values())


@pytest.fixture(scope="module")
def jax_evolved():
    """JAX's evolve_on_video: 3 steps of LSVC-TPU-TINY on tiny_lsvctpu_l2
    at lr 1e-4 over two GOPs, its draws and each step's gradients
    recorded (ordered debug callbacks in its jitted step): (params, best,
    draws, gradients)."""
    jspec = jax_get_codec_model("LSVC-TPU-TINY")
    rec = JaxDraws()
    grads = []
    multi_transform = optax.multi_transform

    def recording_multi_transform(transforms, labels):
        tx = multi_transform(transforms, labels)

        def update(updates, state, params=None):
            jax.debug.callback(lambda g: grads.append(flatten_params(g)), updates, ordered=True)
            return tx.update(updates, state, params)

        return optax.GradientTransformation(tx.init, update)

    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"):
        mp.setattr(jax.random, "uniform", rec)
        mp.setattr(jax_evolve.optax, "multi_transform", recording_multi_transform)
        params, best = jax_evolve.evolve_on_video(
            jspec, asset_params("tiny_lsvctpu_l2"), [jnp.asarray(g) for g in evolve_gops()],
            steps=EVOLVE_STEPS, learning_rate=LR)
        jax.block_until_ready(params)
        jax.effects_barrier()
    assert len(grads) == EVOLVE_STEPS
    return flatten_params(params), best, rec.take(), grads


def evolve_gops():
    rng = np.random.default_rng(9)
    return [synth_gop(rng, size=64, gop=3) for _ in range(2)]


def test_evolve_on_video_is_jax(jax_evolved):
    jparams, jbest, draws, jgrads = jax_evolved
    spec = port_spec("LSVC-TPU-TINY", "tiny_lsvctpu_l2")
    before = {k: v.clone() for k, v in spec.module.state_dict().items()}
    noise = Replay(draws)
    params, best = evolve_on_video(spec, evolve_gops(), steps=EVOLVE_STEPS, learning_rate=LR,
                                   noise=noise)
    assert noise.used == len(draws)
    assert abs(best - jbest) <= REL * abs(jbest), (best, jbest)
    mask = encoder_mask(spec.module)
    want = in_port_layout(spec.module, jparams)
    # JAX's gradients reach the frozen parameters too; the bars read the
    # trained ones'
    steps = [in_port_layout(spec.module, g) for g in jgrads]
    trained = {n: p for n, p in params.items() if mask[n]}
    assert_params_close(trained, want, [{n: g[n] for n in trained} for g in steps])
    for n, p in params.items():
        if not mask[n]:
            assert torch.equal(p, before[n]), n  # bit for bit
            assert torch.equal(want[n], before[n]), n  # JAX's set_to_zero too
        else:
            assert not torch.equal(p, before[n]), n
    assert not spec.module.training and not any(p.requires_grad for p in params.values())
    assert "flow_predictor" in ENCODER_KEYS


# (name, registry keywords, asset or None for seeded_flat(name, 0)): the
# seeded ELFVC-SP-TPU-TINY, whose flow predictor takes a gradient (the
# trained tiny_elfvctpu_l3's P-frame symbols are all 0 and it takes none)
STREAM_CASES = [("LSVC-TPU-TINY", {}, "tiny_lsvctpu_l2"),
                ("ELFVC-SP-TPU-TINY", {"sp_stage": 2}, None),
                ("SSF-TPU-TINY", {}, "tiny_ssftpu_l2"),
                ("DVC-TINY", {}, "tiny_dvc_l2"),
                ("RLVC-TINY", {}, "tiny_rlvc_l2")]


@pytest.mark.parametrize("name,kw,asset", STREAM_CASES, ids=[c[0] for c in STREAM_CASES])
def test_evolved_stream_decodes_on_an_unchanged_receiver(name, kw, asset):
    """Every parameter JAX's mask selects is sender-side in the real
    coder: ELFVC's flow predictor runs on decoded context, but only to
    build the motion encoder's input (JAX coder/video.py:700-704; its
    decoder runs none), the hyperpriors' ``hyper_encoder`` makes z and
    RLVC's ``enc*`` the latent. So a stream written by an evolved encoder
    (2 steps at lr 1e-3) decodes bit for bit on the un-evolved receiver
    (ROADMAP.md section 3)."""
    flat = ft.seeded_flat(name, 0) if asset is None else None

    def build():
        spec = ft.get_codec_model(name, device="cpu", **kw)
        ft.load_asset(spec.module, asset) if asset else ft.weights.load_flat(spec.module, flat)
        return spec

    spec, receiver = build(), build()
    before = {k: v.clone() for k, v in spec.module.state_dict().items()}
    gops = evolve_gops()
    evolve_on_video(spec, gops, steps=2, learning_rate=1e-3)
    moved = {k.split(".")[0] for k, v in spec.module.state_dict().items()
             if not torch.equal(v, before[k])}
    if spec.family == "elfvc":
        assert "flow_predictor" in moved
    x = torch.from_numpy(gops[0]).permute(0, 3, 1, 2).contiguous()
    if spec.family == "lsvc":
        streams, recon, _ = cv.lsvc_compress(spec, x)
        dec = cv.lsvc_decompress(receiver, x[0], streams, x.shape[0] - 1)
    elif spec.family in ("ssf", "elfvc"):
        compress = cv.elfvc_compress_gop if spec.family == "elfvc" else cv.ssf_compress_gop
        decompress = cv.elfvc_decompress_gop if spec.family == "elfvc" else cv.ssf_decompress_gop
        streams, recon, _ = compress(spec, x[:, None])
        dec = decompress(receiver, streams)
    else:
        compress = cv.rlvc_compress_gop if spec.family == "rlvc" else cv.dvc_compress_gop
        decompress = cv.rlvc_decompress_gop if spec.family == "rlvc" else cv.dvc_decompress_gop
        streams, recon, _ = compress(spec, x)
        dec = decompress(receiver, x[0], streams)
    assert moved and torch.equal(recon, dec)
