"""DVC and Base of the port against the JAX package, on the CPU, in
float32, with the layers they add.

- flax's ``ConvTranspose(padding="SAME")`` (``SameConvTranspose``) at
  k = 3 and 5 and strides 1-3, and ``polyphase_deconv``'s distance from it;
- every CodecNet code the JAX package accepts (0, 1 at strides 2 and 1,
  2, 3, 4, 5, 7, 8, 10, 11, 13) and the ER generator stack;
- the stock transforms at ``stages=4``, the mv decoder without a
  polyphase output;
- SpyNet with ``s2d_levels=0`` at 7x7 on seeded weights, and on the
  pretrained ``spynet.npz`` loaded by each package's
  ``load_pretrained_spynet``;
- one DVC step (DVC-TINY, tiny_dvc_l2) and one Base step of each form
  (Base-TINY, Base-EC-TINY, Base-ER-TINY, seeded), recon and every metric;
- ``sequential_gop`` rollouts over the synth_gop_multi clip (numpy seed
  0): DVC-TINY on tiny_dvc_l2 and Base-ER-TINY on tiny_base_l2 at 64x64,
  GOP 4; full-width DVC and Base-EC-ER on ``seeded_flat(name, 0)`` at
  64x128, GOP 4.

Layer parameters are numpy-seeded (N(0, 1/fan_in) kernels, GDN beta in
[1, 1.5], gamma |N(0.1, 0.05)|, other leaves N(0, 0.05)) and carried by
``load_params``; layers are held to 1e-4 of the output's scale (max
|output|, at least 1). Steps and rollouts: on the trained tiny weights
recon 1e-5 absolute (pixels in [0, 1]) and every metric 1e-6 relative; on
seeded weights, whose motion compensation runs far outside [0, 1] before
the clip, recon 1e-4 absolute and metrics 1e-5 relative; PSNR 1e-3 dB.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.data.synthetic import synth_gop_multi
from fastvideocodec_torch.layers import blocks as tblocks
from fastvideocodec_torch.layers import codecnet as tcodecnet
from fastvideocodec_torch.layers import spynet as tspynet
from fastvideocodec_torch.layers import transforms as ttf
from fastvideocodec_torch.ops.kernels import warp as kw
from fastvideocodec_torch.weights import flax_shapes, load_flat, load_params
from fastvideocodec_tpu.gop import rollout as jax_rollout
from fastvideocodec_tpu.layers import codecnet as jcodecnet
from fastvideocodec_tpu.layers import spynet as jspynet
from fastvideocodec_tpu.layers import transforms as jtf
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model

LAYER_TOL = 1e-4
# (recon absolute, metrics relative): trained tiny weights, seeded weights
TRAINED_TOL, SEEDED_TOL = (1e-5, 1e-6), (1e-4, 1e-5)
ROLLOUTS = {  # case: (registry name, weights, H, W, GOP)
    "DVC-TINY": ("DVC-TINY", "tiny_dvc_l2", 64, 64, 4),
    "Base-ER-TINY": ("Base-ER-TINY", "tiny_base_l2", 64, 64, 4),
    "DVC": ("DVC", "seeded 0", 64, 128, 4),
    "Base-EC-ER": ("Base-EC-ER", "seeded 0", 64, 128, 4),
}
STEPS = {  # case: (registry name, weights)
    "DVC-TINY": ("DVC-TINY", "tiny_dvc_l2"),
    "Base-TINY": ("Base-TINY", "seeded 0"),
    "Base-EC-TINY": ("Base-EC-TINY", "seeded 0"),
    "Base-ER-TINY": ("Base-ER-TINY", "seeded 0"),
}


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


def rand(shape, seed=1):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def random_params(jmod, *inputs, seed=0):
    """Seeded values in the shapes of the JAX module's params (eval_shape
    compiles nothing)."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(seed), *inputs)
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


def check_layer(jmod, tmod, *inputs, params=None):
    """Both modules on NHWC numpy inputs; the port's NCHW output against
    JAX's at LAYER_TOL of its scale. Returns the JAX output."""
    jin = [jnp.asarray(x) for x in inputs]
    params = params or random_params(jmod, *jin)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jmod.apply)(params, *jin))
    load_params(tmod, params)
    with torch.no_grad():
        got = nhwc(tmod(*[nchw(x) for x in inputs]))
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=LAYER_TOL * scale)
    return want


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("stride", [1, 2, 3])
def test_same_conv_transpose_is_flax(k, stride):
    """The flax-SAME transposed conv against flax's own; at stride 2 the
    port's polyphase_deconv (torch's padding k//2, output_padding 1) is
    another map, far from it on unit-normal inputs."""
    from flax import linen as nn

    jmod = nn.ConvTranspose(6, (k, k), strides=(stride, stride), padding="SAME")
    tmod = tblocks.SameConvTranspose(5, 6, k, stride)
    x = rand((2, 7, 9, 5))
    params = random_params(jmod, jnp.asarray(x))
    want = check_layer(jmod, tmod, x, params=params)
    assert want.shape == (2, 7 * stride, 9 * stride, 6)
    if stride == 2:
        other = ttf.polyphase_deconv(5, 6, k)
        load_params(other, params)
        with torch.no_grad():
            got = nhwc(other(nchw(x)))
        assert np.abs(got - want).max() > 0.5


CODECNET_CASES = {
    "conv": ((0, 3, 2, 4, 6),),
    "deconv_s2": ((1, 3, 2, 4, 6),),
    "deconv_s1": ((1, 5, 1, 4, 6), 2),
    "relu": ((0, 3, 1, 4, 4), 2),
    "leaky": ((0, 3, 1, 4, 4), 3),
    "gdn": ((0, 3, 1, 4, 4), 4),
    "igdn": ((0, 3, 1, 4, 4), 5),
    "tanh": ((0, 3, 1, 4, 4), 7),
    "basic_s2": ((8, 3, 2, 4, 6),),
    "basic_s1": ((8, 3, 1, 4, 4),),
    "avg_pool": ((10, 2, 2, 4, 4), (0, 1, 1, 4, 4)),
    "attention": ((0, 1, 1, 4, 8), (11, 1, 1, 8, 8)),
    "res": ((13, 3, 1, 4, 6),),
    "er_gen": jcodecnet.er_gen_config(4, 6),
}


@pytest.mark.parametrize("case", sorted(CODECNET_CASES))
def test_codecnet_code_matches_jax(case):
    cfgs = CODECNET_CASES[case]
    jmod = jcodecnet.CodecNet(cfgs)
    tmod = tcodecnet.CodecNet(cfgs, 4)
    x = rand((2, 8, 12, 4))
    params = random_params(jmod, jnp.asarray(x))
    want_keys = {"/".join(p.key for p in path): leaf.shape
                 for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    assert flax_shapes(tmod) == want_keys
    check_layer(jmod, tmod, x, params=params)


def test_er_gen_config_is_jax():
    assert tcodecnet.er_gen_config(128, 192) == jcodecnet.er_gen_config(128, 192)


def test_codecnet_rejects_unported_codes():
    for code in (6, 9, 12):
        with pytest.raises(ValueError, match="not supported"):
            tcodecnet.CodecNet(((0, 3, 1, 4, 4), code), 4)


def test_stock_transforms_stages4():
    x = rand((2, 32, 48, 3))
    check_layer(jtf.AnalysisNet(conv_channels=8, out_channels=12),
                ttf.AnalysisNet(3, 8, 12, stages=4), x)
    check_layer(jtf.SynthesisNet(conv_channels=8), ttf.SynthesisNet(12, 8, 3, stages=4),
                rand((2, 2, 3, 12)))
    check_layer(jtf.AnalysisMVNet(conv_channels=8, out_channels=8),
                ttf.AnalysisMVNet(2, 8, 8, stages=4), rand((2, 32, 48, 2)))
    tmod = ttf.SynthesisMVNet(8, 8, 2, stages=4, polyphase_factor=None)
    assert [n for n, _ in tmod.named_children()][-2:] == ["PolyphaseDeconv_3", "Conv_3"]
    want = check_layer(jtf.SynthesisMVNet(conv_channels=8), tmod, rand((2, 2, 3, 8)))
    assert want.shape == (2, 32, 48, 2)


def test_spynet_without_s2d_levels():
    jmod = jspynet.SpyNet(widths=(4, 8, 4, 4), kernel=7)
    tmod = tspynet.SpyNet(widths=(4, 8, 4, 4), kernels=(7,) * 4, s2d_levels=0)
    a, b = (np.random.default_rng(s).random((2, 32, 48, 3), dtype=np.float32) for s in (1, 2))
    check_layer(jmod, tmod, a, b)


def test_pretrained_spynet_matches_jax():
    """Both packages' load_pretrained_spynet over spynet.npz, then the
    flow of two frames of the clip at 64x128."""
    jmod = jspynet.SpyNet()
    frames = synth_gop_multi(np.random.default_rng(0), size=128, gop=2)[:, :64, :128]
    a, b = jnp.asarray(frames[1:2]), jnp.asarray(frames[0:1])
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), a, b)
    params = {"params": jspynet.load_pretrained_spynet(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)["params"])}
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jmod.apply)(params, a, b))
    tmod = tspynet.load_pretrained_spynet(
        tspynet.SpyNet(kernels=(7,) * 4, s2d_levels=0))
    with torch.no_grad():
        got = nhwc(tmod(nchw(frames[1:2]), nchw(frames[0:1])))
        np.testing.assert_array_equal(tmod.level3.Conv_2.weight.numpy(),
                                      np.load(tspynet.PRETRAINED)["L3_F3_weight"])
    assert float(np.abs(want).max()) > 0.1  # a real flow, not zeros
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LAYER_TOL * max(1.0, float(np.abs(want).max())))


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


def port_model(name, weights, dtype=torch.float32):
    spec = ft.get_codec_model(name, dtype=dtype, device="cpu")
    load_flat(spec.module, flat_params(name, weights))
    return spec


def clip(h, w, gop) -> np.ndarray:
    return synth_gop_multi(np.random.default_rng(0), size=max(h, w), gop=gop)[:, :h, :w]


def assert_metrics(got: dict, want: dict, rel: float):
    assert sorted(got) == sorted(want)
    for key in sorted(set(got) - {"psnr"}):
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]), rtol=rel,
                                   atol=0, err_msg=key)
    if "psnr" in got:
        np.testing.assert_allclose(np.asarray(got["psnr"]), np.asarray(want["psnr"]), rtol=0,
                                   atol=1e-3)


@pytest.mark.parametrize("case", sorted(STEPS))
def test_step_matches_jax(case):
    """One P-frame step (frame 1 against frame 0) at 64x64: recon and
    every metric (Base's Q_err and pred_err included)."""
    name, weights = STEPS[case]
    frames = clip(64, 64, 2)
    spec = jax_get_codec_model(name)
    with jax.default_matmul_precision("highest"):
        out, m = jax.jit(lambda p, c, r: spec.module.apply(p, c, r, training=False))(
            jax_params(name, weights), jnp.asarray(frames[1:2]), jnp.asarray(frames[0:1]))
    with torch.inference_mode():
        tout, tm = port_model(name, weights).module(nchw(frames[1:2]), nchw(frames[0:1]))
    atol, rel = TRAINED_TOL if weights != "seeded 0" else SEEDED_TOL
    np.testing.assert_allclose(nhwc(tout), np.asarray(out), rtol=0, atol=atol)
    assert_metrics({k: v.numpy() for k, v in tm.items()}, m, rel)
    if name.startswith("Base-ER"):
        assert float(tm["pred_err"]) > 0
    else:
        assert float(tm.get("pred_err", 0.0)) == 0.0


@pytest.mark.parametrize("case", sorted(ROLLOUTS))
def test_rollout_matches_jax(case):
    name, weights, h, w, gop = ROLLOUTS[case]
    frames = clip(h, w, gop)
    spec = jax_get_codec_model(name)
    with jax.default_matmul_precision("highest"):
        com, m = jax.jit(lambda p, g: jax_rollout(spec, p, g, training=False))(
            jax_params(name, weights), jnp.asarray(frames))
    tspec = port_model(name, weights)
    assert tspec.family == spec.family
    kw.reset_launches()
    tcom, tm = ft.rollout(tspec, nchw(frames))
    assert set(kw.LAUNCHES.values()) == {0}  # the CPU takes the plain warp
    assert tcom.shape == (gop - 1, 3, h, w)
    atol, rel = TRAINED_TOL if weights != "seeded 0" else SEEDED_TOL
    np.testing.assert_allclose(nhwc(tcom), np.asarray(com)[:, 0], rtol=0, atol=atol)
    assert_metrics({k: v.numpy() for k, v in tm.items()}, m, rel)


def test_rollout_over_a_batch_codes_each_item():
    """[T, B, 3, H, W]: the recon keeps the batch, and an item coded alone
    gives that item's recon."""
    spec = port_model("DVC-TINY", "tiny_dvc_l2")
    frames = np.stack([clip(64, 64, 3), clip(64, 128, 3)[:, :, 64:]], axis=1)
    x = torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 1, 4, 2, 3)))
    both, m = ft.rollout(spec, x)
    one, _ = ft.rollout(spec, x[:, 1])
    assert both.shape == (2, 2, 3, 64, 64) and m["bpp_est"].shape == (2,)
    torch.testing.assert_close(one, both[:, 1], rtol=0, atol=1e-6)
