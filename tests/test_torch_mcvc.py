"""The MCVC slice of the port against the JAX package, on the CPU, in
float32.

- ``synth_mv_gop`` and ``sample_view_mask`` give the JAX package's arrays
  from the same numpy seeds (the mask with a forced number of failures,
  with the binomial and the uniform draws, tiled over a batch of 2), and
  leave the generator in the same state.
- ``gaussian_volume`` at full resolution with 5 levels: 1e-6 absolute;
  ``warp_volume`` through ``plain_pixel_warp`` on its 18-channel volume
  against JAX's ``exact_warp()`` gather path: 1e-5 absolute, the pixel
  warps' bar in tests/test_torch_ops.py (measured 1.8e-6: the two sum the
  four taps in different orders).
- The ``s2d=1`` SSFEncoder and SSFDecoder, the cross-view ConvAttention
  (b = 2 items of V = 3 views, one view zeroed) and the AttnDecoder
  against their flax modules on the same numpy-seeded weights (carried by
  ``load_params``): 1e-5 absolute (measured at most a few 1e-7).
- The rollout: MCVC-IA-TINY on the shipped tiny_mcvc_l3 (V = 3, 64x64,
  GOP 4, masks [1,1,1] and [1,0,1]), and MCVC-IA and MCVC at their full
  widths on ``seeded_flat(name, 0)`` (V = 3, a 64x128 clip, GOP 3, view 1
  failed). Recon 1e-5 absolute (pixels in [0, 1]), bpp_est and img_loss
  1e-6 relative, PSNR 1e-4 dB, completeness exact (measured: recon under
  1e-6, bpp_est 2e-7 relative).
- bfloat16: the tiny model's bf16 forward against JAX's bf16 forward
  within the gaps stated in the test, and the one bfloat16 latent flip
  that parts their rates counted.

The JAX side of each rollout is computed once, in a module-scoped fixture.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.data.synthetic import synth_mv_gop
from fastvideocodec_torch.layers import blocks as tblocks
from fastvideocodec_torch.layers import transforms as ttf
from fastvideocodec_torch.models import mcvc as tmcvc
from fastvideocodec_torch.ops import warp as twarp
from fastvideocodec_torch.ops.kernels import warp as kw
from fastvideocodec_torch.weights import load_flat, load_params
from fastvideocodec_tpu.data.synthetic import synth_mv_gop as jax_synth_mv_gop
from fastvideocodec_tpu.gop import rollout as jax_rollout
from fastvideocodec_tpu.layers import blocks as jblocks
from fastvideocodec_tpu.layers import transforms as jtf
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model
from fastvideocodec_tpu.models import mcvc as jmcvc
from fastvideocodec_tpu.ops import warp as jwarp

ATOL = 1e-5
V = 3
# case: (registry name, weights, views' size (h, w), GOP, masks)
ROLLOUTS = {
    "MCVC-IA-TINY": ("MCVC-IA-TINY", "tiny_mcvc_l3", (64, 64), 4, ((1, 1, 1), (1, 0, 1))),
    "MCVC-IA": ("MCVC-IA", "seeded 0", (64, 128), 3, ((1, 0, 1),)),
    "MCVC": ("MCVC", "seeded 0", (64, 128), 3, ((1, 0, 1),)),
}


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def rand(shape, seed=1, scale=1.0):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)


def seeded_params(shapes, seed=0):
    """Numpy-seeded values in the shapes of a flax params tree: kernels
    ~ N(0, 1/fan_in), every other leaf ~ N(0, 0.05)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        shape = leaf.shape
        if path[-1].key == "kernel":
            return rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape).astype(np.float32)
        return rng.normal(0, 0.05, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def check_block(jmod, tmod, x):
    """Both modules on the NHWC input x, the same weights: 1e-5 absolute."""
    params = seeded_params(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x)))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x)))
    load_params(tmod, params)
    with torch.no_grad():
        got = nhwc(tmod(nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# views 5 and 6 crop a full frame width or height off the base texture and
# run past its edge when the drawn motion is positive in that axis, in both
# packages: seed 5 draws a motion that keeps 6 views of 256 px inside
@pytest.mark.parametrize("seed, views, size, gop", [(7, 3, 64, 4), (5, 6, 256, 2),
                                                    (7, 1, 48, 3)])
def test_synth_mv_gop_is_jax(seed, views, size, gop):
    got = synth_mv_gop(np.random.default_rng(seed), views=views, size=size, gop=gop)
    want = jax_synth_mv_gop(np.random.default_rng(seed), views=views, size=size, gop=gop)
    assert got.shape == (gop, views, size, size, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kwargs", [
    dict(batch=1, num_views=4, max_failed=2),  # binomial draw
    dict(batch=2, num_views=3, max_failed=1, training=False),  # uniform, tiled
    dict(batch=2, num_views=4, max_failed=3, force_resilience=2),
    dict(batch=3, num_views=6, max_failed=0),  # none may fail
])
def test_sample_view_mask_is_jax(kwargs):
    """Ten draws from one generator each side: equal masks, and equal
    generator states after them."""
    rng, jrng = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(10):
        got = tmcvc.sample_view_mask(rng, **kwargs)
        want = jmcvc.sample_view_mask(jrng, **kwargs)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        views = got.reshape(kwargs["batch"], kwargs["num_views"])
        assert (views == views[0]).all()  # the same views fail in every item
    assert rng.random() == jrng.random()


def test_mask_views_zeroes_the_failed_views():
    x = torch.ones(6, 2, 3, 4)
    out = tmcvc.mask_views(x, torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0, 1.0]))
    assert out[[1, 4]].abs().sum() == 0 and torch.equal(out[[0, 2, 3, 5]], x[[0, 2, 3, 5]])


def test_gaussian_volume_full_resolution_is_jax():
    """Five levels at full resolution (MCVC's and stock SSF's), batch 2."""
    x = np.random.default_rng(3).random((2, 64, 96, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jwarp.gaussian_volume(a, 1.5, 5))(jnp.asarray(x)))
    got = nhwc(twarp.gaussian_volume(nchw(x), 1.5, 5))
    assert got.shape == (2, 64, 96, 18)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_warp_volume_c18_is_jax():
    """The 18-channel volume of two frames, flows of up to 1.5 frame widths
    in normalized units (samples far off the frame), scales past [-1, 1]:
    through plain_pixel_warp here, JAX's exact gather path there."""
    rng = np.random.default_rng(4)
    vol = rng.random((2, 40, 56, 18)).astype(np.float32)
    flow = rng.uniform(-1.5, 1.5, (2, 40, 56, 2)).astype(np.float32)
    flow[0, :20] *= 0.02  # small motion on half of one frame
    scale = rng.uniform(-1.3, 1.3, (2, 40, 56, 1)).astype(np.float32)
    with jwarp.exact_warp():
        want = np.asarray(jwarp.warp_volume(jnp.asarray(vol), jnp.asarray(flow),
                                            jnp.asarray(scale), num_levels=5))
    kw.reset_launches()
    got = nhwc(twarp.warp_volume(nchw(vol), nchw(flow), nchw(scale), 5))
    assert got.shape == (2, 40, 56, 3) and set(kw.LAUNCHES.values()) == {0}
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_ssf_encoder_s2d1():
    check_block(jtf.SSFEncoder(16, 24, s2d=1), ttf.SSFEncoder(6, 16, 24, s2d=1),
                rand((2, 64, 48, 6)))


def test_ssf_decoder_s2d1():
    check_block(jtf.SSFDecoder(16, out_planes=3, s2d=1), ttf.SSFDecoder(24, 16, 3, s2d=1),
                rand((2, 4, 3, 24)))


def test_transforms_keep_their_s2d2_form():
    assert [n for n, _ in ttf.SSFEncoder(12, 8, 8).named_children()] == [
        "Conv_0", "Conv_1", "Conv_2"]
    assert [n for n, _ in ttf.SSFDecoder(8, 8, 3).named_children()] == [
        "PolyphaseDeconv_0", "PolyphaseDeconv_1", "PolyphaseDeconv_2", "Conv_0"]
    with pytest.raises(ValueError, match="s2d"):
        ttf.SSFEncoder(3, 8, 8, s2d=4)


def views_input(b=2, h=3, w=5, c=32, failed=1):
    """[b*V, h, w, c] with view ``failed`` of every item zeroed."""
    x = rand((b * V, h, w, c), seed=5)
    x[failed::V] = 0.0
    return x


def test_cross_view_attention_is_jax():
    """atype=2 over b = 2 items of V = 3 views, view 1 failed (zero tokens)."""
    check_block(jblocks.ConvAttention(32, heads=4, dim_head=8, atype=2, num_views=V),
                tblocks.ConvAttention(32, 4, 8, num_views=V), views_input())


def test_cross_view_attention_couples_views_within_items_only():
    """Changing view 0 of item 0 moves every view of item 0 and no view of
    item 1; with one view per item the layer is the per-item form."""
    torch.manual_seed(0)
    att = tblocks.ConvAttention(32, 4, 8, num_views=V)
    x = nchw(views_input())
    y = x.clone()
    y[0] += 1.0
    with torch.no_grad():
        d = (att(x) - att(y)).abs().amax(dim=(1, 2, 3))
    assert (d[:V] > 0).all() and (d[V:] == 0).all()
    one = tblocks.ConvAttention(32, 4, 8)
    one.load_state_dict(att.state_dict())
    with torch.no_grad():
        per_item = torch.cat([one(x[i:i + 1]) for i in range(2 * V)])
        torch.testing.assert_close(one(x), per_item, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="views"):
        att(x[:4])


def test_attn_decoder_is_jax():
    """The backup residual decoder at the tiny widths: 96 channels in,
    4 heads of 12, mid 32, two items of 3 views with one failed."""
    jmod = jmcvc.AttnDecoder(3, V, mid_planes=32, attn_heads=4, attn_dim_head=12)
    tmod = tmcvc.AttnDecoder(96, V, 32, 4, 12)
    check_block(jmod, tmod, views_input(h=4, w=4, c=96))


@functools.lru_cache(maxsize=4)
def flat_params(name: str, weights: str) -> dict:
    if weights == "seeded 0":
        return ft.seeded_flat(name, 0)
    with np.load(ft.weights.asset_path(weights)) as data:
        return {k: data[k].astype(np.float32) for k in data.files}


def jax_params(name: str, weights: str) -> dict:
    tree: dict = {}
    for key, value in flat_params(name, weights).items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(value)
    return tree


def mv_clip(size, gop) -> np.ndarray:
    """[T, V, h, w, 3]: synth_mv_gop (numpy seed 0) at max(h, w), cropped."""
    h, w = size
    return synth_mv_gop(np.random.default_rng(0), views=V, size=max(h, w), gop=gop)[:, :, :h, :w]


@pytest.fixture(scope="module")
def rollouts():
    """{(case, mask): (gop [T, V, h, w, 3], JAX recon, JAX metrics)}, each
    computed once."""
    out = {}
    for case, (name, weights, size, gop, masks) in ROLLOUTS.items():
        frames = mv_clip(size, gop)
        spec = jax_get_codec_model(name, num_views=V)
        params = jax_params(name, weights)
        run = jax.jit(lambda p, g, m, spec=spec: jax_rollout(spec, p, g, training=False, mask=m))
        for mask in masks:
            with jax.default_matmul_precision("highest"):
                recon, m = run(params, jnp.asarray(frames), jnp.asarray(mask, jnp.float32))
            out[case, mask] = (frames, np.asarray(recon), {k: np.asarray(v) for k, v in m.items()})
    return out


@pytest.mark.parametrize("case, mask", [(c, m) for c, r in ROLLOUTS.items() for m in r[4]])
def test_rollout_matches_jax(rollouts, case, mask):
    frames, jrecon, jm = rollouts[case, mask]
    name, weights = ROLLOUTS[case][:2]
    spec = ft.get_codec_model(name, device="cpu", num_views=V)
    load_flat(spec.module, flat_params(name, weights))
    kw.reset_launches()
    recon, m = ft.rollout(spec, torch.from_numpy(np.ascontiguousarray(
        frames.transpose(0, 1, 4, 2, 3))), np.asarray(mask, np.float32))
    assert set(kw.LAUNCHES.values()) == {0}  # the CPU takes the plain warp
    T, _, h, w, _ = frames.shape
    assert recon.shape == (T, V, 3, h, w) and recon.dtype == torch.float32
    np.testing.assert_allclose(recon.permute(0, 1, 3, 4, 2).numpy(), jrecon, rtol=0, atol=ATOL)
    for key in ("bpp_est", "img_loss"):
        np.testing.assert_allclose(m[key].numpy(), jm[key], rtol=1e-6, atol=0)
    np.testing.assert_allclose(m["psnr"].numpy(), jm["psnr"], rtol=0, atol=1e-4)
    assert float(m["completeness"]) == float(jm["completeness"])
    assert float(m["completeness"]) == pytest.approx(sum(mask) / V, rel=1e-7)


def rate(lik: dict) -> float:
    """A frame's rate, every y and z likelihood summed in float64."""
    total = 0.0
    for part in lik.values():
        for key in ("y", "z"):
            p = np.asarray(np.asarray(part[key], np.float32), np.float64)
            total += float(np.sum(np.clip(-np.log(p + 1e-5) / np.log(2.0), 0.0, 50.0)))
    return total


def test_bf16_rollout_close_to_jax_bf16():
    """MCVC-IA-TINY (tiny_mcvc_l3, 3 views of 64x64, GOP 4, every view
    alive) with bfloat16 activations in both packages, at the SSF and
    ELFVC tests' bars: recon mean abs diff 0.01 (measured 1.6e-3), and
    each frame's rate (the likelihoods summed in float64) within 0.5% of
    JAX's when the port codes the frame from JAX's bfloat16 reference
    (measured at most 0.47%).

    Left to its own chain, the port's rate parts from JAX's by up to 0.70%
    a frame (+0.05, -0.20, +0.65, +0.70%, the keyframe first), all of it
    in the residual y,
    which is 4-36 bits of a frame's 1430. Two causes, both deliberate
    differences (ROADMAP section 3): JAX rounds each likelihood to
    bfloat16 (near 1 its steps are 0.004, a few thousandths of a bit a
    symbol over 2304 symbols), the port keeps it in float32; and bfloat16
    latents flip their rounding. Even from JAX's own reference, frame 3
    holds one residual latent with y - means = -0.4985 in the port, an ulp
    from -0.5, which JAX rounds to -1 and the port to 0: 7 bits of 1421.
    So the free chain is held per frame to 1% and over the GOP to 0.5%
    (measured 0.34%), and the flip is counted here."""
    name, weights, (h, w), gop, _ = ROLLOUTS["MCVC-IA-TINY"]
    frames = mv_clip((h, w), gop)
    mask = np.ones(V, np.float32)
    spec = jax_get_codec_model(name, num_views=V, dtype=jnp.bfloat16)
    params = jax_params(name, weights)
    with jax.default_matmul_precision("highest"):
        jrec, jliks, jrefs = jax.jit(lambda p, g, m: spec.module.apply(p, g, m, training=False))(
            params, jnp.asarray(frames, jnp.bfloat16), jnp.asarray(mask))
    tspec = ft.get_codec_model(name, dtype=torch.bfloat16, device="cpu", num_views=V)
    load_flat(tspec.module, flat_params(name, weights))
    x = torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 1, 4, 2, 3))).bfloat16()
    alive = torch.from_numpy(mask)
    with torch.inference_mode():
        trec, tliks, _ = tspec.module(x, alive)
    assert trec.dtype == torch.bfloat16
    got = trec.float().permute(0, 1, 3, 4, 2).numpy()
    assert np.abs(got - np.asarray(jrec.astype(jnp.float32))).mean() <= 0.01
    free = [rate(t) / rate(j) - 1 for t, j in zip(tliks, jliks)]
    assert max(map(abs, free)) <= 0.01, free
    assert abs(sum(map(rate, tliks)) / sum(map(rate, jliks)) - 1) <= 5e-3, free

    step = jax.jit(lambda p, cur, ref, m: spec.module.apply(
        p, cur, ref, m, training=False, method=spec.module.forward_inter))
    hp = tspec.module.res_hyperprior
    seen = {}
    shipped = hp.gaussian

    def record(y, scales, means):
        seen.update(y=y, means=means)
        return shipped(y, scales, means)

    hp.gaussian = record
    flips = []
    for t in range(1, gop):
        with jax.default_matmul_precision("highest"):
            _, _, jlik = step(params, jnp.asarray(frames[t], jnp.bfloat16), jrefs[t - 1],
                              jnp.asarray(mask))
        ref = torch.from_numpy(np.ascontiguousarray(
            np.asarray(jrefs[t - 1].astype(jnp.float32)).transpose(0, 3, 1, 2))).bfloat16()
        with torch.inference_mode():
            _, _, tlik = tspec.module.forward_inter(x[t], ref, alive)
        assert abs(rate(tlik) / rate(jlik) - 1) <= 5e-3, (t, rate(tlik), rate(jlik))
        # a residual symbol the two round apart costs bits where its
        # likelihood is far from 1 in one package and near it in the other
        far = np.abs(np.asarray(jlik["residual"]["y"], np.float32)
                     - tlik["residual"]["y"].permute(0, 2, 3, 1).numpy()) > 0.5
        centred = (seen["y"].float() - seen["means"].float()).permute(0, 2, 3, 1).numpy()
        flips += [(t, float(v)) for v in centred[far]]
    hp.gaussian = shipped
    assert len(flips) == 1 and flips[0][0] == 3, flips
    assert abs(abs(flips[0][1]) - 0.5) < 4e-3, flips  # within a bfloat16 ulp of x.5


def test_mcvc_without_ia_returns_the_plain_recon():
    """Without -IA the output is the plain chain: equal to the references."""
    spec = ft.get_codec_model("MCVC-TINY", device="cpu", num_views=V)
    load_flat(spec.module, ft.seeded_flat("MCVC-TINY", 0))
    frames = torch.from_numpy(np.ascontiguousarray(mv_clip((32, 32), 2).transpose(0, 1, 4, 2, 3)))
    with torch.inference_mode():
        recon, liks, refs = spec.module(frames, torch.tensor([1.0, 1.0, 0.0]))
    assert torch.equal(recon, refs) and not hasattr(spec.module, "backup_img_decoder")
    assert [sorted(lik) for lik in liks] == [["keyframe"], ["motion", "residual"]]


def test_registry_names_and_views():
    """MCVC-IA-OLFT serves as MCVC-IA: the same modules and parameter names."""
    spec = ft.get_codec_model("MCVC-IA-OLFT-TINY", device="meta", num_views=4)
    assert spec.family == "mcvc"
    assert spec.module.backup_res_decoder.ConvAttention_0.num_views == 4
    ia = ft.get_codec_model("MCVC-IA-TINY", device="meta", num_views=4).module
    assert {k: v.shape for k, v in spec.module.state_dict().items()} == {
        k: v.shape for k, v in ia.state_dict().items()}
    with pytest.raises(ValueError, match="num_views"):
        ft.get_codec_model("MCVC-IA", device="meta")
    for name in ("MCVC-Original", "SSF-Official", "SSF-TINY"):  # stock SSF, the views a batch
        stock = ft.get_codec_model(name, device="meta", num_views=2)
        assert stock.family == "ssf" and stock.module.s2d == 1
    with pytest.raises(ValueError, match="view mask"):
        ft.rollout(ft.get_codec_model("SSF-TPU-TINY", device="cpu"), torch.zeros(2, 3, 32, 32),
                   np.ones(1, np.float32))


def test_row_views_spread_over_the_clip():
    """chip_smoke.py's 4 x 1024x2048 views start at rows 0, 320, 640 and
    1024 of the 2048-row clip; one view is the clip's first rows."""
    from fastvideocodec_torch.data.synthetic import row_views

    clip = np.broadcast_to(np.arange(2048, dtype=np.float32)[None, :, None, None],
                           (2, 2048, 8, 3))
    got = row_views(clip, 4, 1024)
    assert got.shape == (2, 4, 1024, 8, 3)
    assert got[0, :, 0, 0, 0].tolist() == [0, 320, 640, 1024]
    assert row_views(clip, 1, 1024)[0, :, 0, 0, 0].tolist() == [0]
