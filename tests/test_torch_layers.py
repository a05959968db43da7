"""Each ported layer against its JAX module, on the CPU, in float32.

Parameters are seeded random values in the shapes of the JAX module's
``init`` (biases, GDN and BitEstimator parameters away from their trivial
initial values) and are carried onto the port's module by
``weights.load_params``, the
same mapping that loads the shipped checkpoints. Tolerance: 1e-4 of the
output's scale (max |output|, at least 1), for float32 conv stacks summed
in different orders by XLA and PyTorch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideocodec_torch.entropy import bit_estimator as tbe
from fastvideocodec_torch.entropy import hyperprior as thyper
from fastvideocodec_torch.layers import blocks as tblocks
from fastvideocodec_torch.layers import spynet as tspynet
from fastvideocodec_torch.layers import transforms as ttf
from fastvideocodec_torch.weights import load_params
from fastvideocodec_tpu.entropy import bit_estimator as jbe
from fastvideocodec_tpu.entropy import hyperprior as jhyper
from fastvideocodec_tpu.layers import blocks as jblocks
from fastvideocodec_tpu.layers import spynet as jspynet
from fastvideocodec_tpu.layers import transforms as jtf

TOL = 1e-4


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def random_params(jmod, *inputs, seed=0):
    """Seeded numpy values in the shapes of the JAX module's params (traced
    with eval_shape, which compiles nothing): kernels ~ N(0, 1/fan_in),
    GDN beta in [1, 1.5] and gamma ~ |N(0.1, 0.05)|, every other leaf
    ~ N(0, 0.05)."""
    return random_params_like(jax.eval_shape(jmod.init, jax.random.PRNGKey(seed), *inputs),
                              seed)


def random_params_like(shapes, seed=0):
    """random_params for a tree of shapes."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            value = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name == "beta":
            value = 1 + rng.uniform(0, 0.5, shape)
        elif name == "gamma":
            value = np.abs(rng.normal(0.1, 0.05, shape))
        else:
            value = rng.normal(0, 0.05, shape)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def check_layer(jmod, tmod, *inputs, method=None):
    """Run both on NHWC numpy inputs; compare the NCHW port output."""
    jin = [jnp.asarray(x) for x in inputs]
    params = random_params(jmod, *jin)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda p, *a: jmod.apply(p, *a, method=method))(params, *jin))
    load_params(tmod, params)
    with torch.no_grad():
        fn = tmod if method is None else getattr(tmod, method.__name__)
        got = fn(*[nchw(x) for x in inputs]).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def rand(shape, seed=1):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("k, cin, cout", [(3, 4, 6), (5, 6, 4)])
def test_polyphase_deconv(k, cin, cout):
    check_layer(jtf.PolyphaseDeconv(cout, kernel_size=k), ttf.polyphase_deconv(cin, cout, k),
                rand((2, 5, 6, cin)))


def test_analysis_net():
    check_layer(jtf.AnalysisNet(conv_channels=16, out_channels=24, stages=3),
                ttf.AnalysisNet(12, 16, 24), rand((2, 16, 24, 12)))


def test_synthesis_net():
    check_layer(jtf.SynthesisNet(conv_channels=16, out_channels=12, stages=3),
                ttf.SynthesisNet(24, 16, 12), rand((2, 3, 4, 24)))


def test_analysis_mv_net():
    check_layer(jtf.AnalysisMVNet(conv_channels=16, out_channels=16, stages=3),
                ttf.AnalysisMVNet(2, 16, 16), rand((2, 16, 24, 2)))


@pytest.mark.parametrize("width, hw", [(16, (2, 3)), (8, (3, 2))])
def test_synthesis_mv_net_polyphase(width, hw):
    check_layer(
        jtf.SynthesisMVNet(conv_channels=width, stages=3, polyphase_out=True,
                           polyphase_factor=4),
        ttf.SynthesisMVNet(width, width, 2),
        rand((2, *hw, width)),
    )


def test_analysis_prior_net():
    check_layer(jtf.AnalysisPriorNet(conv_channels=8), ttf.AnalysisPriorNet(12, 8),
                rand((2, 8, 8, 12)) - 0.5)


def test_synthesis_prior_net():
    check_layer(jtf.SynthesisPriorNet(conv_channels=8, out_channels=12),
                ttf.SynthesisPriorNet(8, 12), rand((2, 2, 3, 8)))


@pytest.mark.parametrize("cin, cout", [(8, 8), (6, 8)])
def test_res_block(cin, cout):
    check_layer(jblocks.ResBlock(cout), tblocks.ResBlock(cin, cout), rand((2, 8, 8, cin)))


def test_warp_net():
    check_layer(jblocks.WarpNet(out_channels=12, width=8), tblocks.WarpNet(24, 12, 8),
                rand((2, 8, 12, 24)))


def test_me_basic():
    check_layer(jblocks.MEBasic(widths=(4, 8, 4, 4), kernel=5, out_channels=8),
                tblocks.MEBasic(32, (4, 8, 4, 4), 5, 8), rand((2, 8, 8, 32)))


@pytest.mark.parametrize("kernels", [(5, 5, 3, 3), (5, 5, 5, 5)])  # LSVC-TPU, -TINY
def test_spynet(kernels):
    im1, im2 = rand((2, 32, 48, 3), 1), rand((2, 32, 48, 3), 2)
    check_layer(
        jspynet.SpyNet(widths=(4, 8, 4, 4), kernels=kernels, s2d_levels=2),
        tspynet.SpyNet(widths=(4, 8, 4, 4), kernels=kernels),
        im1, im2,
    )


def test_bit_estimator_likelihood():
    x = np.round(np.random.default_rng(3).normal(0, 3, (2, 3, 4, 6))).astype(np.float32)
    check_layer(jbe.BitEstimator(6), tbe.BitEstimator(6), x, method=jbe.BitEstimator.likelihood)


# SSF-TPU transforms: the s2d=2 branches with the input and output in s2d form


def test_ssf_encoder():
    check_layer(jtf.SSFEncoder(mid_planes=8, out_planes=12, s2d=2, input_s2d=True),
                ttf.SSFEncoder(24, 8, 12), rand((2, 16, 24, 24)))


def test_ssf_decoder_s2d_output():
    check_layer(jtf.SSFDecoder(mid_planes=16, out_planes=3, s2d=2, output_s2d=True),
                ttf.SSFDecoder(12, 16, 3), rand((2, 2, 3, 12)))


def test_ssf_hyper_encoder():
    check_layer(jtf.SSFHyperEncoder(mid_planes=8, out_planes=12),
                ttf.SSFEncoder(12, 8, 12), rand((2, 8, 12, 12)) - 0.5)


def test_ssf_hyper_decoder():
    check_layer(jtf.SSFHyperDecoder(mid_planes=12, out_planes=12),
                ttf.SSFHyperDecoder(12), rand((2, 1, 2, 12)) - 0.5)


def test_ssf_hyper_decoder_qrelu_clamps_like_jax():
    """Kernels scaled up 30x drive every stage past both ends of [0, 255]."""
    x = rand((2, 1, 2, 12)) - 0.5
    jmod = jtf.SSFHyperDecoderQReLU(mid_planes=12, out_planes=12)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v * 30 if path[-1].key == "kernel" else v,
        random_params(jmod, jnp.asarray(x)),
    )
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    assert (want == 0.0).any() and (want == 255.0).any()
    tmod = load_params(ttf.SSFHyperDecoderQReLU(12), params)
    with torch.no_grad():
        got = tmod(nchw(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * 255)


@pytest.mark.parametrize("h, w", [(4, 8), (3, 5)])
def test_ssf_hyperprior(h, w):
    """y_hat and both likelihoods, including the crop of the hyper
    decoders' 8*ceil(y/8) output to y's size (z is 1x1 at 4x8)."""
    y = (rand((2, h, w, 12)) - 0.5) * 8
    jmod = jhyper.SSFHyperprior(planes=12, mid_planes=12)
    shapes = jax.eval_shape(lambda k, a: jmod.init(k, a, training=False),
                            jax.random.PRNGKey(0), jnp.asarray(y))
    params = random_params_like(shapes)
    with jax.default_matmul_precision("highest"):
        jy_hat, jlik, _ = jax.jit(lambda p, a: jmod.apply(p, a, training=False))(
            params, jnp.asarray(y))
    tmod = load_params(thyper.SSFHyperprior(12), params)
    with torch.no_grad():
        ty_hat, tlik = tmod(nchw(y))
    nhwc = lambda t: t.numpy().transpose(0, 2, 3, 1)  # noqa: E731
    np.testing.assert_allclose(nhwc(ty_hat), np.asarray(jy_hat), rtol=0, atol=TOL * 8)
    for key in ("y", "z"):
        np.testing.assert_allclose(nhwc(tlik[key]), np.asarray(jlik[key]), rtol=1e-4, atol=0)
