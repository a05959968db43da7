"""The stock (``s2d=1``) scale-space codecs of the port against the JAX
package, on the CPU, in float32: SSF-Official, SSF-TINY, MCVC-Original,
ELFVC, ELFVC-SP and their -TINY forms.

- The full-resolution FlowPredictor (four 5x5 stride-1 convs, 9 -> m ->
  m -> m -> 3) against its flax module on the same numpy-seeded weights
  (carried by ``load_params``): 1e-5 absolute.
- The rollouts over the synth_gop_multi clip (numpy seed 0) at 64x128:
  SSF-TINY on the shipped tiny_ssf_l2 (GOP 4); ELFVC-SP-TINY on
  tiny_elfvc_l3 at sp_stage 2 (GOP 4) and 1 (GOP 3); ELFVC-TINY, which
  ships no weights, on ``seeded_flat("ELFVC-TINY", 0)`` (GOP 3); and the
  full widths on ``seeded_flat(name, 0)``, GOP 3: SSF-Official and
  ELFVC-SP (sp_stage 2). MCVC-Original codes 3 views of 64x64
  (synth_mv_gop, seed 0, GOP 3) as a batch of 3.
- The keyframe-coded forwards of SSF-TINY and ELFVC-SP-TINY (GOP 3).
- The port's ``synth_gop`` and ``synth_gop_lowrate`` (the golden RD
  tests' generators, tests/test_torch_rd.py) give JAX's arrays at seeds 0
  and 123, and leave the generator in the same state.

Bars, the existing slices': recon 1e-4 absolute (pixels in [0, 1]),
bpp_est, bpp_res_est and img_loss 1e-5 relative, PSNR 1e-3 dB, the SP
norms 1e-5 relative; each frame's rate per likelihood term 1e-5 relative.
And on meta tensors (not the CPU), each stock path sends every warp to
the pixel_warp launcher, once a P-frame for SSF and twice for ELFVC's
encoder, and none to a plain version.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.data import synthetic as tsynth
from fastvideocodec_torch.data.synthetic import synth_gop_multi, synth_mv_gop
from fastvideocodec_torch.layers import transforms as ttf
from fastvideocodec_torch.ops.kernels import warp as kw
from fastvideocodec_torch.weights import load_flat, load_params
from fastvideocodec_tpu.data import synthetic as jsynth
from fastvideocodec_tpu.gop import rollout as jax_rollout
from fastvideocodec_tpu.layers import transforms as jtf
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model

H, W = 64, 128
# case: (registry name, weights, sp_stage, GOP)
ROLLOUTS = {
    "SSF-TINY": ("SSF-TINY", "tiny_ssf_l2", 1, 4),
    "ELFVC-SP-TINY": ("ELFVC-SP-TINY", "tiny_elfvc_l3", 2, 4),
    "ELFVC-SP-TINY-sp1": ("ELFVC-SP-TINY", "tiny_elfvc_l3", 1, 3),
    "ELFVC-TINY": ("ELFVC-TINY", "seeded 0", 1, 3),
    "SSF-Official": ("SSF-Official", "seeded 0", 1, 3),
    "ELFVC-SP": ("ELFVC-SP", "seeded 0", 2, 3),
}
FORWARDS = ["SSF-TINY", "ELFVC-SP-TINY"]
MCVC_VIEWS, MCVC_SIZE = 3, 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's convs at these sizes run as fast on one thread as on
    eight, and the suite's parallel workers share the host's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def clip(gop) -> np.ndarray:
    return synth_gop_multi(np.random.default_rng(0), size=128, gop=gop)[:, :H, :W]


@functools.lru_cache(maxsize=4)
def flat_params(name: str, weights: str) -> dict:
    if weights == "seeded 0":
        return ft.seeded_flat(name, 0)
    with np.load(ft.weights.asset_path(weights)) as data:
        return {k: data[k].astype(np.float32) for k in data.files}


def jax_params(name, weights) -> dict:
    tree: dict = {}
    for key, value in flat_params(name, weights).items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(value)
    return tree


def port_model(name, weights, sp_stage=1, dtype=torch.float32):
    spec = ft.get_codec_model(name, dtype=dtype, device="cpu", sp_stage=sp_stage)
    load_flat(spec.module, flat_params(name, weights))
    return spec


def bits(lik) -> float:
    """The rate of a likelihood array, summed in float64."""
    p = np.asarray(lik, np.float64)
    return float(np.sum(np.clip(-np.log(p + 1e-5) / np.log(2.0), 0.0, 50.0)))


@pytest.mark.parametrize("seed", [0, 123])
@pytest.mark.parametrize("gen, kwargs", [("synth_gop", {}), ("synth_gop", dict(size=32, gop=3)),
                                         ("synth_gop_lowrate", dict(size=64, gop=4))])
def test_synthetic_clips_are_jax(gen, kwargs, seed):
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    got = getattr(tsynth, gen)(rng, **kwargs)
    want = getattr(jsynth, gen)(jrng, **kwargs)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert rng.random() == jrng.random()


def test_flow_predictor_full_resolution():
    """cat(x_ref, x_ref_ref, motion prior) at full resolution (9 channels)
    -> motion_info (3 channels), mid 16, on numpy-seeded weights."""
    jmod = jtf.FlowPredictor(mid_planes=16, s2d=1)
    tmod = ttf.FlowPredictor(9, 16, s2d=1)
    x = np.random.default_rng(1).normal(0, 1, (2, 24, 40, 9)).astype(np.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda leaf: rng.normal(0, 1 / np.sqrt(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1
                                else 0.05, leaf.shape).astype(np.float32), shapes)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x)))
    load_params(tmod, params)
    assert [n for n, _ in tmod.named_children()] == ["Conv_0", "Conv_1", "Conv_2", "Conv_3"]
    assert tuple(tmod.Conv_3.weight.shape) == (3, 16, 5, 5)
    with torch.no_grad():
        got = nhwc(tmod(nchw(x)))
    assert got.shape == want.shape == (2, 24, 40, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", sorted(ROLLOUTS))
def test_rollout_matches_jax(case):
    name, weights, sp_stage, gop = ROLLOUTS[case]
    frames = clip(gop)
    spec = jax_get_codec_model(name, sp_stage=sp_stage)
    with jax.default_matmul_precision("highest"):
        com, m = jax.jit(lambda p, g: jax_rollout(spec, p, g, training=False))(
            jax_params(name, weights), jnp.asarray(frames))
    tspec = port_model(name, weights, sp_stage)
    assert tspec.module.s2d == 1
    kw.reset_launches()
    tcom, tm = ft.rollout(tspec, nchw(frames))
    assert set(kw.LAUNCHES.values()) == {0}  # the CPU takes the plain warp
    assert tcom.shape == (gop - 1, 3, H, W)
    assert sorted(tm) == sorted(m)
    np.testing.assert_allclose(nhwc(tcom), np.asarray(com)[:, 0], rtol=0, atol=1e-4)
    for key in sorted(set(tm) - {"psnr"}):
        np.testing.assert_allclose(tm[key].numpy(), np.asarray(m[key]), rtol=1e-5, atol=0)
    np.testing.assert_allclose(tm["psnr"].numpy(), np.asarray(m["psnr"]), rtol=0, atol=1e-3)


@pytest.mark.parametrize("case", FORWARDS)
def test_forward_matches_jax(case):
    """Keyframe coded, then the chain, over the first three frames: recon,
    each frame's rate by likelihood term, and the SP norms."""
    name, weights, sp_stage, _ = ROLLOUTS[case]
    frames = clip(3)[:, None]
    spec = jax_get_codec_model(name, sp_stage=sp_stage)
    with jax.default_matmul_precision("highest"):
        out, liks = jax.jit(lambda p, f: spec.module.apply(p, f, training=False))(
            jax_params(name, weights), jnp.asarray(frames))
    with torch.inference_mode():
        tout, tliks = port_model(name, weights, sp_stage).module(nchw(frames[:, 0])[:, None])
    assert tout.shape == (3, 1, 3, H, W)
    np.testing.assert_allclose(nhwc(tout[:, 0]), np.asarray(out)[:, 0], rtol=0, atol=1e-4)
    assert [sorted(t) for t in tliks] == [sorted(j) for j in liks]
    for tlik, jlik in zip(tliks, liks):
        for part in set(tlik) - {"pred_err", "Q_err"}:
            for key in ("y", "z"):
                got, want = bits(tlik[part][key]), bits(jlik[part][key])
                assert abs(got - want) <= 1e-5 * want, (part, key, got, want)
        for key in ("pred_err", "Q_err"):
            assert len(tlik.get(key, [])) == len(jlik.get(key, []))
            for t, j in zip(tlik.get(key, []), jlik.get(key, [])):
                got, want = float(torch.linalg.vector_norm(t)), float(jnp.linalg.norm(j))
                assert abs(got - want) <= 1e-5 * want, (key, got, want)


def test_mcvc_original_views_as_batch_match_jax():
    """MCVC-Original is stock SSF in family ssf: 3 views of 64x64 go
    through ``rollout`` as a batch of 3 ([T, B, 3, H, W]), at full widths
    on seeded weights; the recon keeps the batch, and bpp is per pixel
    over all views."""
    frames = synth_mv_gop(np.random.default_rng(0), views=MCVC_VIEWS, size=MCVC_SIZE, gop=3)
    spec = jax_get_codec_model("MCVC-Original", num_views=MCVC_VIEWS)
    with jax.default_matmul_precision("highest"):
        com, m = jax.jit(lambda p, g: jax_rollout(spec, p, g, training=False))(
            jax_params("MCVC-Original", "seeded 0"), jnp.asarray(frames))
    tspec = port_model("MCVC-Original", "seeded 0")
    assert tspec.family == "ssf"
    x = torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 1, 4, 2, 3)))
    tcom, tm = ft.rollout(tspec, x)
    assert tcom.shape == (2, MCVC_VIEWS, 3, MCVC_SIZE, MCVC_SIZE)
    np.testing.assert_allclose(tcom.permute(0, 1, 3, 4, 2).numpy(), np.asarray(com),
                               rtol=0, atol=1e-4)
    for key in ("bpp_est", "bpp_res_est", "img_loss"):
        np.testing.assert_allclose(tm[key].numpy(), np.asarray(m[key]), rtol=1e-5, atol=0)
    np.testing.assert_allclose(tm["psnr"].numpy(), np.asarray(m["psnr"]), rtol=0, atol=1e-3)
    # one view of the batch alone codes to that view's recon
    one, _ = ft.rollout(tspec, x[:, 1])
    torch.testing.assert_close(one, tcom[:, 1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name, per_frame", [("SSF-Official", 1), ("SSF-TINY", 1),
                                             ("ELFVC-SP", 2), ("ELFVC-TINY", 2)])
def test_stock_path_off_cpu_launches_pixel_warp(monkeypatch, name, per_frame):
    """One P-frame on meta tensors (not the CPU), 2 items: each volume warp
    goes to pixel_warp's launcher with all 18 channels at full resolution
    (once for SSF, twice for ELFVC's local prediction and decoded motion),
    and no warp reaches a plain version. The launchers are stood in for by
    ones that count and return empty outputs, since there is no card
    here."""
    from fastvideocodec_torch.ops import warp as twarp

    calls, reached = [], []
    for kname in twarp.PLAIN:
        monkeypatch.setitem(twarp.PLAIN, kname, lambda *a, n=kname: reached.append(n))
        monkeypatch.setattr(kw, f"launch_{kname}",
                            lambda img, flow, n=kname: calls.append((n, tuple(img.shape)))
                            or torch.empty_like(img))
    spec = ft.get_codec_model(name, device="meta", sp_stage=2)
    m = spec.module
    x = torch.empty(2, 3, 32, 64, device="meta")
    with torch.inference_mode():
        if spec.family == "elfvc":
            state = m.init_state(2, 32, 64)
            assert state.motion_info_prior.shape == x.shape
            assert state.q_y_prior_res.shape == (2, m.planes, 2, 4)
            rec, _, state = m.forward_inter(x, x, state)
        else:
            rec, _ = m.forward_inter(x, x)
    assert rec.shape == x.shape
    assert calls == [("pixel_warp", (2, 18, 32, 64))] * per_frame
    assert not reached
