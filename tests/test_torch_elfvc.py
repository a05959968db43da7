"""The ELFVC(-SP)-TPU slice of the port against the JAX package, on the
CPU, in float32 (and one bfloat16 case).

- The SPnet's blocks (ChannelLayerNorm, WSConvBlock, ResnetBlock,
  ConvAttention, SPnet) and the quarter-trunk FlowPredictor against their
  flax modules on the same numpy-seeded weights (carried by
  ``load_params``): 1e-5 absolute (measured at most a few 1e-7).
- The port's two attention forms (PyTorch's fused SDPA, which the card
  runs, and the plain two-matmul softmax the CPU runs) agree to 1e-6.
- The super-precision hyperprior: y_hat, likelihoods, Q_err_y, pred_err_y
  and the new prior, with ``sp`` on and off, a zero prior and a given one.
- The rollout and the keyframe-coded forward: ELFVC-SP-TPU-TINY on the
  shipped tiny_elfvctpu_l3 over the synth_gop_multi clip (numpy seed 0) at
  64x128 (rollout: sp_stage 2 at GOP 4, sp_stage 1 at GOP 3; forward:
  GOP 3), and ELFVC-SP-TPU at its full widths on
  ``seeded_flat("ELFVC-SP-TPU", 0)``, GOP 3. Recon 1e-4 absolute (pixels
  in [0, 1]), bpp_est and bpp_res_est 1e-5 relative, PSNR 1e-3 dB,
  pred_err_norm and Q_err_norm 1e-5 relative (measured: recon 4e-7, the
  rest under 5e-7 relative).
- bfloat16: the tiny model's bf16 rollout against JAX's bf16 rollout
  within the gaps stated in the test.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import fastvideocodec_torch as ft
from fastvideocodec_torch.data.synthetic import synth_gop_multi
from fastvideocodec_torch.entropy import hyperprior as thyper
from fastvideocodec_torch.layers import blocks as tblocks
from fastvideocodec_torch.layers import transforms as ttf
from fastvideocodec_torch.ops.math import bits_estimate
from fastvideocodec_torch.weights import load_flat, load_params
from fastvideocodec_tpu.entropy import hyperprior as jhyper
from fastvideocodec_tpu.gop import rollout as jax_rollout
from fastvideocodec_tpu.layers import blocks as jblocks
from fastvideocodec_tpu.layers import transforms as jtf
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model

ATOL = 1e-5
H, W = 64, 128


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def rand(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)).astype(np.float32)


def seeded_params(shapes, seed=0):
    """Numpy-seeded values in the shapes of a flax params tree: kernels
    ~ N(0, 1/fan_in), GroupNorm ``scale`` and LayerNorm ``g`` 1 + N(0, 0.1),
    every other leaf ~ N(0, 0.05)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            value = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name in ("scale", "g"):
            value = 1 + rng.normal(0, 0.1, shape)
        else:
            value = rng.normal(0, 0.05, shape)
        return value.astype(np.float32)

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


def test_channel_layer_norm():
    check_block(jblocks.ChannelLayerNorm(16), tblocks.ChannelLayerNorm(16),
                rand((2, 5, 7, 16), scale=2.0) + 0.5)


def test_ws_conv_block():
    check_block(jblocks.WSConvBlock(16), tblocks.WSConvBlock(12, 16), rand((2, 6, 8, 12)))


@pytest.mark.parametrize("cin", [16, 24])  # 24: the 1x1 skip conv
def test_resnet_block(cin):
    check_block(jblocks.ResnetBlock(16), tblocks.ResnetBlock(cin, 16), rand((2, 6, 8, cin)))


def test_conv_attention():
    check_block(jblocks.ConvAttention(32), tblocks.ConvAttention(32), rand((2, 4, 8, 32)))


def test_spnet():
    """At the tiny model's SPnet widths (dim 16, trunk 128) on a 4x8
    latent of 2 x 48 channels: round_y and the prior are integers."""
    x = np.round(rand((1, 4, 8, 96), scale=3.0))
    check_block(jblocks.SPnet(output_channels=48, dim=16), tblocks.SPnet(96, 48, 16), x)


def test_attention_forms_agree():
    """The fused SDPA and the plain form on the same q, k, v [B, heads,
    N, d], float32: 1e-6."""
    q, k, v = (torch.from_numpy(rand((2, 4, 96, 32), seed=s)) for s in (1, 2, 3))
    got = F.scaled_dot_product_attention(q, k, v)
    want = tblocks.plain_attention(q, k, v)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert torch.equal(tblocks.attention(q, k, v), want)  # the CPU takes the plain form


def test_flow_predictor_quarter_trunk():
    """cat(x_ref, x_ref_ref, motion prior) in s2d form (36 channels at /2)
    -> the /2 motion field (12 channels): the 48-channel conv's
    depth-to-space in JAX's (ry, rx, c) order."""
    jmod = jtf.FlowPredictor(mid_planes=16, s2d=2, input_s2d=True, output_s2d=True,
                             quarter_trunk=True)
    check_block(jmod, ttf.FlowPredictor(36, 16), rand((2, 8, 16, 36)))


@pytest.mark.parametrize("prior", ["zero", "given"])
@pytest.mark.parametrize("sp", [True, False])
def test_super_precision_hyperprior(sp, prior):
    """y_hat (the SPnet's prediction when ``sp``), the likelihoods,
    Q_err_y, pred_err_y and the new prior round(y - means). JAX's None
    prior is the port's zeros (its ElfvcState starts so); the given one is
    an integer latent. 1e-5 of the latents'
    scale for the tensors, 1e-4 relative for the likelihoods (the SSF
    hyperprior's bar, tests/test_torch_layers.py)."""
    y = rand((1, 4, 8, 16), scale=8.0)
    q_prior = None if prior == "zero" else np.round(rand((1, 4, 8, 16), seed=2, scale=3.0))
    jmod = jhyper.SSFHyperprior(planes=16, mid_planes=16, super_prec=True, sp=sp, sp_dim=8)
    jprior = None if q_prior is None else jnp.asarray(q_prior)
    shapes = jax.eval_shape(lambda k, a: jmod.init(k, a, training=False, q_y_prior=jprior),
                            jax.random.PRNGKey(0), jnp.asarray(y))
    params = seeded_params(shapes)
    with jax.default_matmul_precision("highest"):
        jy_hat, jlik, jnew = jax.jit(
            lambda p, a, q: jmod.apply(p, a, training=False, q_y_prior=q))(
                params, jnp.asarray(y), jprior)
    tmod = load_params(thyper.SSFHyperprior(16, super_prec=True, sp=sp, sp_dim=8), params)
    with torch.no_grad():
        y_hat, lik, new = tmod.forward_with_prior(
            nchw(y), torch.zeros_like(nchw(y)) if q_prior is None else nchw(q_prior))
    tol = ATOL * 8
    np.testing.assert_allclose(nhwc(y_hat), np.asarray(jy_hat), rtol=0, atol=tol)
    for key in ("Q_err_y", "pred_err_y"):
        np.testing.assert_allclose(nhwc(lik[key]), np.asarray(jlik[key]), rtol=0, atol=tol)
    for key in ("y", "z"):
        np.testing.assert_allclose(nhwc(lik[key]), np.asarray(jlik[key]), rtol=1e-4, atol=0)
    np.testing.assert_array_equal(nhwc(new), np.asarray(jnew))
    if not sp:  # y_hat stays the SSF call's round(y - means) + means
        with torch.no_grad():
            assert torch.equal(y_hat, tmod(nchw(y))[0])


def test_hyperprior_without_spnet_passes_the_prior_through():
    hp = thyper.SSFHyperprior(8)
    y = nchw(rand((1, 4, 8, 8), scale=4.0))
    prior = torch.ones_like(y)
    with torch.no_grad():
        y_hat, lik, new = hp.forward_with_prior(y, prior)
        want, _ = hp(y)
    assert new is prior and lik["pred_err_y"] is None and torch.equal(y_hat, want)


# (name, weights, sp_stage, GOP)
ROLLOUTS = [
    ("ELFVC-SP-TPU-TINY", "tiny_elfvctpu_l3", 2, 4),
    ("ELFVC-SP-TPU-TINY", "tiny_elfvctpu_l3", 1, 3),
    ("ELFVC-SP-TPU", "seeded 0", 2, 3),
]
FORWARDS = [("ELFVC-SP-TPU-TINY", "tiny_elfvctpu_l3", 2, 3), ROLLOUTS[2]]


def clip(gop) -> np.ndarray:
    return synth_gop_multi(np.random.default_rng(0), size=128, gop=gop)[:, :H, :W]


@functools.lru_cache(maxsize=2)
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


def port_model(name, weights, sp_stage, dtype=torch.float32):
    spec = ft.get_codec_model(name, dtype=dtype, device="cpu", sp_stage=sp_stage)
    load_flat(spec.module, flat_params(name, weights))
    return spec


def bits(lik) -> float:
    """The rate of a likelihood array, summed in float64."""
    p = np.asarray(lik, np.float64)
    return float(np.sum(np.clip(-np.log(p + 1e-5) / np.log(2.0), 0.0, 50.0)))


@pytest.mark.parametrize("name, weights, sp_stage, gop", ROLLOUTS)
def test_rollout_matches_jax(name, weights, sp_stage, gop):
    frames = clip(gop)
    spec = jax_get_codec_model(name, sp_stage=sp_stage)
    with jax.default_matmul_precision("highest"):
        com, m = jax.jit(lambda p, g: jax_rollout(spec, p, g, training=False))(
            jax_params(name, weights), jnp.asarray(frames))
    tcom, tm = ft.rollout(port_model(name, weights, sp_stage), nchw(frames))
    assert tcom.shape == (gop - 1, 3, H, W)
    assert sorted(tm) == sorted(m)
    np.testing.assert_allclose(nhwc(tcom), np.asarray(com)[:, 0], rtol=0, atol=1e-4)
    for key in ("bpp_est", "bpp_res_est", "img_loss", "pred_err_norm", "Q_err_norm"):
        np.testing.assert_allclose(tm[key].numpy(), np.asarray(m[key]), rtol=1e-5, atol=0)
    np.testing.assert_allclose(tm["psnr"].numpy(), np.asarray(m["psnr"]), rtol=0, atol=1e-3)


@pytest.mark.parametrize("name, weights, sp_stage, gop", FORWARDS)
def test_forward_matches_jax(name, weights, sp_stage, gop):
    """Keyframe coded, then the chain: recon, each frame's rate by
    likelihood term (1e-5 relative), and the norms of pred_err and Q_err."""
    frames = clip(gop)[:, None]
    spec = jax_get_codec_model(name, sp_stage=sp_stage)
    with jax.default_matmul_precision("highest"):
        out, liks = jax.jit(lambda p, f: spec.module.apply(p, f, training=False))(
            jax_params(name, weights), jnp.asarray(frames))
    tspec = port_model(name, weights, sp_stage)
    with torch.inference_mode():
        tout, tliks = tspec.module(nchw(frames[:, 0])[:, None])
    assert tout.shape == (gop, 1, 3, H, W)
    np.testing.assert_allclose(tout[:, 0].permute(0, 2, 3, 1).numpy(), np.asarray(out)[:, 0],
                               rtol=0, atol=1e-4)
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
    est = ft.gop.engine.estimated_bits(tliks)
    want = sum(bits(j[part][key]) for j in liks for part in ("keyframe", "motion", "residual")
               if part in j for key in ("y", "z"))
    assert abs(est - want) <= 1e-5 * want


def test_bf16_rollout_close_to_jax_bf16():
    """ELFVC-SP-TPU-TINY (tiny_elfvctpu_l3, sp_stage 2) with bfloat16
    activations in both packages: recon mean abs diff 0.01, per-frame PSNR
    (both recons in float32) 0.25 dB and bpp_est 0.5% relative, LSVC's
    bfloat16 bars; pred_err_norm and Q_err_norm 1%, since JAX sums those
    norms in bfloat16 (8 bits of mantissa: steps of 0.4%). Measured: recon
    2e-4, PSNR 7e-4 dB, bpp 1e-7, the norms 0.3%. The port computes its
    rates and norms in float32 and lerps its warps in float32."""
    name, weights, sp_stage, gop = ROLLOUTS[0]
    frames = clip(gop)
    spec = jax_get_codec_model(name, sp_stage=sp_stage, dtype=jnp.bfloat16)
    with jax.default_matmul_precision("highest"):
        com, m = jax.jit(lambda p, g: jax_rollout(spec, p, g, training=False))(
            jax_params(name, weights), jnp.asarray(frames, jnp.bfloat16))
    tcom, tm = ft.rollout(port_model(name, weights, sp_stage, torch.bfloat16),
                          nchw(frames).to(torch.bfloat16))
    assert tcom.dtype == torch.bfloat16
    got, want = nhwc(tcom), np.asarray(com.astype(jnp.float32))[:, 0]
    target = frames[1:].astype(np.float32)

    def psnr(r):
        return 10 * np.log10(1.0 / np.mean((r - target) ** 2, axis=(1, 2, 3)))

    assert np.abs(got - want).mean() <= 0.01
    np.testing.assert_allclose(psnr(got), psnr(want), rtol=0, atol=0.25)
    for key, rel in (("bpp_est", 5e-3), ("pred_err_norm", 1e-2), ("Q_err_norm", 1e-2)):
        np.testing.assert_allclose(tm[key].numpy(), np.asarray(m[key].astype(jnp.float32)),
                                   rtol=rel, atol=0)


def test_launch_counts_stay_zero_on_cpu():
    """On CPU tensors the warp wrappers run the plain versions and count
    nothing."""
    from fastvideocodec_torch.ops.kernels import warp as kw

    kw.reset_launches()
    ft.rollout(port_model(*ROLLOUTS[0][:3]), nchw(clip(3)))
    assert set(kw.LAUNCHES.values()) == {0}


def test_ws_biases_are_uniform_within_the_fan_in_bound():
    """seeded_flat draws each WSConvBlock bias from U(-b, b), b = (9 *
    cin)^-1/2 (the JAX module's torch-parity init), its GroupNorm scale as
    ones and bias as zeros, and each ChannelLayerNorm g as ones."""
    flat = ft.seeded_flat("ELFVC-SP-TPU", 0)
    biases = [k for k in flat if k.rsplit("/", 2)[1].startswith("WSConvBlock_")
              and k.endswith("/bias")]
    assert len(biases) == 2 * 6  # two SPnets of three ResnetBlocks
    for key in biases:
        bound = np.prod(flat[key[: -len("bias")] + "kernel"].shape[:-1]) ** -0.5
        b = flat[key]
        assert np.abs(b).max() <= bound and np.abs(b).max() > 0.9 * bound, key
        assert abs(b.mean()) < 0.1 * bound, key
    for key, value in flat.items():
        if key.endswith("GroupNorm_0/scale") or key.endswith("/g"):
            assert (value == 1).all(), key
        if key.endswith("GroupNorm_0/bias"):
            assert not value.any(), key


def test_estimated_bits_counts_only_likelihoods():
    """estimated_bits sums the y and z likelihoods of every frame, and
    nothing of the pred_err and Q_err lists."""
    spec = port_model(*ROLLOUTS[0][:3])
    with torch.inference_mode():
        _, liks = spec.module(nchw(clip(3))[:, None])
    want = sum(float(bits_estimate(lik[p][k])) for lik in liks for p in lik
               if p in ("keyframe", "motion", "residual") for k in ("y", "z"))
    assert ft.gop.engine.estimated_bits(liks) == want > 0
