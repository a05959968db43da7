"""The rest of LSVC in the port against the JAX package, on the CPU, in
float32: the reference-structure s2d=1 form (LSVC, LSVC-128, LSVC-TINY),
the LSVC-TPU warp ablations (-RW, -HF, -WT, -HU, -QU), the -A/-S
space-time attention and the -L/-O graphs.

- Every name the JAX registry's LSVC branch accepts builds in the port
  with the keys and shapes of the JAX module's init (traced with
  eval_shape, nothing computed).
- WarpNetTPU at stem strides 2 and 4; LayerNorm, GEGLUFeedForward,
  TokenAttention and SpaceTimeAttention; each attention-bearing
  transform at ``attn_depth`` 1. Each trap of the attention port is
  caught by a case that fails when the trap is sprung (flax LayerNorm's
  eps 1e-6, jax.nn.gelu's tanh approximation, q scaled by
  dim_head^-1/2, the qkv Dense without bias, the flax Dense kernel
  [in, out]). Parameters: ``seeded_params`` (the JAX initialisers), the
  norms' scale and bias moved off 1 and 0 by N(0, 0.2); inputs
  numpy-seeded. Held to LAYER_TOL = 1e-5 of the output's scale (max
  |output|, at least 1).
- Rollouts at 64x64, GOP 4, on the synth_gop_multi clip (numpy seed 0):
  LSVC-TINY (tiny_lsvc_l2), LSVC-128 (hd_lsvc128_l2), LSVC-TPU-RW
  (hd_lsvctpu_l2), -HF (hd_lsvctpuf_l2), -WT (hd_lsvctpuwt_l2), -QU
  (hd_lsvctpuqu_l2), -L and -O (LSVC-TPU-TINY-L/-O on tiny_lsvctpu_l2:
  a chain of 3 layers, one layer of 3); on seeded weights LSVC-TPU-HU at its full
  widths, the tiny -RW and -HF forms, and the -A and -S forms at the
  tiny widths with attn_depth 2 (the registry's -TINY branch takes no
  -A/-S, so these are built from the module's arguments in both
  packages). Trained weights: recon within 1e-5 absolute (pixels in
  [0, 1]), bpp within 1e-6 relative; seeded weights, whose prediction runs
  far outside [0, 1] before the clip: recon 1e-4, bpp 1e-5 (measured:
  3.2e-6 and 3.5e-7 at most trained, 1.6e-5 and 1.3e-6 seeded).
- ``per_layer_mv`` and ``layer_chunk``: on a conv-only form the same
  result as the plain forward (1e-5, 1e-6); on the -A form, where the
  batches attend across frames, JAX's result with the same knobs.
- The decode graph at s2d=1 (LSVC-TINY) and with chunks on the -S form,
  on the same numpy latents in both packages: recon mean 1e-5 absolute,
  sigma sum 1e-5 relative.
- Real bits of the -A and -S forms: decode equals encode bit for bit,
  and the streams are JAX's bytes.
- The one-hop graph reaches 14 P-frames: a GOP of 16 raises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

import fastvideocodec_torch as ft
from fastvideocodec_torch.coder import video as tv
from fastvideocodec_torch.data.synthetic import synth_gop_multi
from fastvideocodec_torch.layers import blocks as tblocks
from fastvideocodec_torch.layers import transforms as ttf
from fastvideocodec_torch.models.lsvc import LSVC as TorchLSVC
from fastvideocodec_torch.models.registry import CodecSpec
from fastvideocodec_torch.weights import flax_shapes, load_flat, seeded_params
from fastvideocodec_tpu.coder import video as jv
from fastvideocodec_tpu.gop.decode_graph import build_lsvc_decode as jax_build_decode
from fastvideocodec_tpu.layers import blocks as jblocks
from fastvideocodec_tpu.layers import transforms as jtf
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model
from fastvideocodec_tpu.models.lsvc import LSVC as JaxLSVC
from fastvideocodec_tpu.models.registry import CodecSpec as JaxCodecSpec

LAYER_TOL = 1e-5
# (recon absolute, bpp relative): trained weights, seeded weights
TRAINED_TOL, SEEDED_TOL = (1e-5, 1e-6), (1e-4, 1e-5)
DECODE_TOL = 1e-5
NAMES = ["LSVC", "LSVC-128", "LSVC-TINY", "LSVC-L", "LSVC-128-A", "LSVC-128-S-O",
         "LSVC-TINY-L", "LSVC-TPU", "LSVC-TPU-F", "LSVC-TPU-F2", "LSVC-TPU-HF", "LSVC-TPU-RW",
         "LSVC-TPU-WT", "LSVC-TPU-HU", "LSVC-TPU-QU", "LSVC-TPU-A", "LSVC-TPU-S",
         "LSVC-TPU-L", "LSVC-TPU-O", "LSVC-TPU-D", "LSVC-TPU-TINY", "LSVC-TPU-RW-TINY",
         "LSVC-TPU-HF-TINY", "LSVC-TPU-F2-TINY", "LSVC-TPU-TINY-L"]
# the tiny widths of the flagship's architecture, as the -TINY branch builds them
TINY_TPU = dict(channels=48, conv_channels=32, s2d=2, spynet_widths=(8, 16, 8, 4),
                spynet_kernel=5, spynet_s2d_levels=2, mv_polyphase_out=True, warp_width=32,
                full_res_warp=True, mv_full_res_out=True)
# case: (registry name or module arguments, weights, GOP)
ROLLOUTS = {
    "s2d1-LSVC-TINY": ("LSVC-TINY", "tiny_lsvc_l2", 4),
    "s2d1-LSVC-128": ("LSVC-128", "hd_lsvc128_l2", 4),
    "RW": ("LSVC-TPU-RW", "hd_lsvctpu_l2", 4),
    "HF": ("LSVC-TPU-HF", "hd_lsvctpuf_l2", 4),
    "WT": ("LSVC-TPU-WT", "hd_lsvctpuwt_l2", 4),
    "QU": ("LSVC-TPU-QU", "hd_lsvctpuqu_l2", 4),
    "HU": ("LSVC-TPU-HU", "seeded", 4),
    "L": ("LSVC-TPU-TINY-L", "tiny_lsvctpu_l2", 4),
    "O": ("LSVC-TPU-TINY-O", "tiny_lsvctpu_l2", 4),
    "RW-TINY": ("LSVC-TPU-RW-TINY", "seeded", 4),
    "HF-TINY": ("LSVC-TPU-HF-TINY", "seeded", 4),
    "A": (dict(TINY_TPU, use_attn=True, attn_depth=2), "seeded", 4),
    "S": (dict(TINY_TPU, use_syn_attn=True, attn_depth=2), "seeded", 4),
}
# the tiny -RW form from the module's arguments, for the per-layer knobs
RIGID_TINY = dict(TINY_TPU, full_res_warp=False, mv_full_res_out=False)
SIZE = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port runs as fast on one thread at these sizes, and the suite's
    parallel workers share the host's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().numpy(), 1, -1)


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(value)
    return tree


def clip(gop: int) -> np.ndarray:
    return synth_gop_multi(np.random.default_rng(0), size=SIZE, gop=gop)


def layer_params(module, seed: int = 0) -> dict:
    """seeded_params of a port layer, its norms' scale and bias moved off
    1 and 0 so that a LayerNorm is more than a standardisation."""
    flat = seeded_params(module, seed)
    rng = np.random.default_rng(seed + 1)
    for key, value in flat.items():
        if key.rsplit("/", 1)[1] in ("scale", "bias") and "LayerNorm" in key:
            flat[key] = (value + rng.normal(0, 0.2, value.shape)).astype(np.float32)
    load_flat(module.eval().requires_grad_(False), flat)
    return flat


def layer_outputs(jmod, tmod, x: np.ndarray, seed: int = 0):
    """(port output, JAX output) of a layer on x (channels last), with the
    same parameters; a 4-D x goes to the port as NCHW."""
    flat = layer_params(tmod, seed)
    want = np.asarray(jmod.apply(unflatten(flat), jnp.asarray(x)))
    with torch.inference_mode():
        if x.ndim == 4:
            got = nhwc(tmod(nchw(x)))
        else:
            got = tmod(torch.from_numpy(x)).numpy()
    return got, want


def assert_layer_close(got, want, tol=LAYER_TOL):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def is_close(got, want, tol=LAYER_TOL) -> bool:
    return float(np.abs(got - want).max()) <= tol * max(1.0, float(np.abs(want).max()))


def paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from paths(v, (*prefix, k))
        else:
            yield (*prefix, k), v


@pytest.mark.parametrize("name", NAMES)
def test_every_lsvc_name_builds_with_the_jax_keys_and_shapes(name):
    module = jax_get_codec_model(name).module
    shapes = jax.eval_shape(lambda k: module.init(k, jnp.zeros((3, 64, 64, 3)), training=False),
                            jax.random.PRNGKey(0))
    want = {"/".join(path): tuple(leaf.shape) for path, leaf in paths(shapes)}
    spec = ft.get_codec_model(name, device="meta")
    assert spec.family == "lsvc"
    assert flax_shapes(spec.module) == want


@pytest.mark.parametrize("stride", [2, 4])
def test_warpnet_tpu_matches_jax(stride):
    x = np.random.default_rng(stride).random((2, 16, 24, 8), dtype=np.float32)
    got, want = layer_outputs(jblocks.WarpNetTPU(out_channels=4, width=16, stem_stride=stride),
                              tblocks.WarpNetTPU(8, 4, 16, stem_stride=stride), x)
    assert got.shape == want.shape == (2, 16, 24, 4)
    assert_layer_close(got, want)


def attention_case(case: str):
    """(JAX module, port module, input) of one attention trap case."""
    rng = np.random.default_rng(7)
    if case == "layernorm_eps":  # features of variance ~1e-6, where eps is felt
        x = (1e-3 * rng.standard_normal((3, 5, 24))).astype(np.float32)
        return flax_nn.LayerNorm(), tblocks.LayerNorm(24), x
    if case == "gelu_tanh":  # gates around +-2, where tanh and erf GELU part
        x = (2.0 * rng.standard_normal((3, 5, 24))).astype(np.float32)
        return jblocks.GEGLUFeedForward(24), tblocks.GEGLUFeedForward(24), x
    # q's scale and the qkv Dense: a TokenAttention of 2 heads of 8 over
    # 16 wide tokens (its output Dense square, [16, 16]); the two scales a
    # port could take apart, 8^-1/2 and 16^-1/2
    x = rng.standard_normal((3, 6, 16)).astype(np.float32)
    return (jblocks.TokenAttention(16, heads=2, dim_head=8),
            tblocks.TokenAttention(16, heads=2, dim_head=8), x)


@pytest.mark.parametrize("case", ["layernorm_eps", "gelu_tanh", "q_scale", "dense_layout"])
def test_attention_traps_each_caught(case, monkeypatch):
    """The port matches JAX; the same case with the trap sprung does not."""
    jmod, tmod, x = attention_case(case)
    got, want = layer_outputs(jmod, tmod, x)
    assert_layer_close(got, want)
    if case == "layernorm_eps":
        monkeypatch.setattr(tblocks, "LAYER_NORM_EPS", 1e-5)  # torch's default
    elif case == "gelu_tanh":
        exact = torch.nn.functional.gelu
        monkeypatch.setattr(torch.nn.functional, "gelu",
                            lambda t, approximate="none": exact(t))
    elif case == "q_scale":  # q scaled by (heads * dim_head)^-1/2
        monkeypatch.setattr(tblocks, "plain_attention", lambda q, k, v: torch.softmax(
            (q * 16 ** -0.5) @ k.transpose(-1, -2), dim=-1) @ v)
    else:  # the kernel [in, out] taken as the weight without its transpose
        w = tmod.Dense_1.weight
        with torch.no_grad():
            w.copy_(w.T.clone())
    with torch.inference_mode():
        sprung = tmod(torch.from_numpy(x)).numpy()
    assert not is_close(sprung, want), case


def test_token_attention_qkv_dense_has_no_bias():
    flat = layer_params(tblocks.TokenAttention(16, heads=2, dim_head=8))
    assert "params/Dense_0/bias" not in flat and "params/Dense_1/bias" in flat
    assert flat["params/Dense_0/kernel"].shape == (16, 48)  # flax [in, out]


def test_space_time_attention_matches_jax():
    """Depth 2 over 3 frames of 4x6 pixels, 24 wide: time attention across
    the frames, space attention across the pixels."""
    x = np.random.default_rng(3).standard_normal((3, 4, 6, 24)).astype(np.float32)
    got, want = layer_outputs(jblocks.SpaceTimeAttention(24, depth=2),
                              tblocks.SpaceTimeAttention(24, depth=2), x)
    assert_layer_close(got, want)
    # the frames attend to each other: one frame alone gives another result
    tmod = tblocks.SpaceTimeAttention(24, depth=2)
    layer_params(tmod)
    with torch.inference_mode():
        alone = nhwc(tmod(nchw(x[:1])))
    assert not is_close(alone, want[:1])


TRANSFORMS = {  # name: (JAX module, port module, input shape NHWC)
    "AnalysisNet": (lambda: jtf.AnalysisNet(16, 24, stages=3, use_attn=True, attn_depth=1),
                    lambda: ttf.AnalysisNet(12, 16, 24, stages=3, attn_depth=1), (3, 32, 32, 12)),
    "SynthesisNet": (lambda: jtf.SynthesisNet(16, 12, stages=3, use_attn=True, attn_depth=1),
                     lambda: ttf.SynthesisNet(24, 16, 12, stages=3, attn_depth=1), (3, 4, 4, 24)),
    "AnalysisMVNet": (lambda: jtf.AnalysisMVNet(16, 16, stages=3, use_attn=True, attn_depth=1),
                      lambda: ttf.AnalysisMVNet(2, 16, 16, stages=3, attn_depth=1),
                      (3, 32, 32, 2)),
    "SynthesisMVNet": (lambda: jtf.SynthesisMVNet(16, stages=3, use_attn=True, attn_depth=1,
                                                  polyphase_out=True, polyphase_factor=4),
                       lambda: ttf.SynthesisMVNet(16, 16, 2, stages=3, polyphase_factor=4,
                                                  attn_depth=1), (3, 4, 4, 16)),
    "AnalysisPriorNet": (lambda: jtf.AnalysisPriorNet(16, use_attn=True, attn_depth=1),
                         lambda: ttf.AnalysisPriorNet(24, 16, attn_depth=1), (3, 8, 8, 24)),
    "SynthesisPriorNet": (lambda: jtf.SynthesisPriorNet(16, 24, use_attn=True, attn_depth=1),
                          lambda: ttf.SynthesisPriorNet(16, 24, attn_depth=1), (3, 2, 2, 16)),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_attention_transform_matches_jax(name):
    jmake, tmake, shape = TRANSFORMS[name]
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    tmod = tmake()
    assert isinstance(tmod.SpaceTimeAttention_0, tblocks.SpaceTimeAttention)
    got, want = layer_outputs(jmake(), tmod, x)
    assert got.shape == want.shape
    assert_layer_close(got, want)


def models(what, weights: str, **knobs):
    """(port spec, JAX spec, flat params, tolerances) of a registry name or
    of the module's arguments (with ``knobs``, per_layer_mv and
    layer_chunk, given to both modules), on shipped or seeded weights."""
    if isinstance(what, dict):
        tmod, jmod = TorchLSVC(**what, **knobs), JaxLSVC(**what, **knobs)
    else:
        tmod, jmod = ft.get_codec_model(what, device="cpu").module, jax_get_codec_model(what).module
    if weights == "seeded":
        flat, tol = seeded_params(tmod, 0), SEEDED_TOL
    else:
        with np.load(ft.weights.asset_path(weights)) as data:
            flat = {k: data[k].astype(np.float32) for k in data.files}
        tol = TRAINED_TOL
    load_flat(tmod.eval().requires_grad_(False), flat)
    return (CodecSpec("lsvc", "lsvc", tmod), JaxCodecSpec("lsvc", "lsvc", jmod), flat, tol)


def case_models(case: str, **knobs):
    what, weights, _ = ROLLOUTS[case]
    return models(what, weights, **knobs)


@functools.lru_cache(maxsize=None)
def jax_forward(case: str, **knobs):
    _, jspec, flat, _ = case_models(case, **knobs)
    gop = clip(ROLLOUTS[case][2])
    with jax.default_matmul_precision("highest"):
        com, _, _, m = jax.jit(lambda p, g: jspec.module.apply(p, g, training=False))(
            unflatten(flat), jnp.asarray(gop))
    return np.asarray(com), float(m["bpp"])


def port_forward(spec, gop: np.ndarray):
    with torch.inference_mode():
        com, _, _, m = spec.module(nchw(gop))
    return nhwc(com), float(m["bpp"])


@pytest.mark.parametrize("case", sorted(ROLLOUTS))
def test_rollout_matches_jax(case):
    spec, _, _, (atol, rel) = case_models(case)
    gop = clip(ROLLOUTS[case][2])
    com, bpp = jax_forward(case)
    tcom, tm = ft.rollout(spec, nchw(gop))
    assert tcom.shape == (gop.shape[0] - 1, 3, SIZE, SIZE)
    np.testing.assert_allclose(nhwc(tcom), com, rtol=0, atol=atol)
    assert abs(float(tm["bpp"]) - bpp) <= rel * bpp, (float(tm["bpp"]), bpp)


@pytest.mark.parametrize("knobs", [dict(per_layer_mv=True), dict(layer_chunk=1),
                                   dict(per_layer_mv=True, layer_chunk=1)],
                         ids=["per_layer_mv", "layer_chunk", "both"])
def test_per_layer_mv_and_layer_chunk(knobs):
    """Conv-only (the tiny -RW form): the plain forward's result. -A: JAX's
    with the same knobs, and not the plain forward's (its attention sees
    other batches)."""
    atol, rel = SEEDED_TOL
    gop = clip(4)
    want, bpp = port_forward(models(RIGID_TINY, "seeded")[0], gop)
    got, tbpp = port_forward(models(RIGID_TINY, "seeded", **knobs)[0], gop)
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAINED_TOL[0])
    assert abs(tbpp - bpp) <= TRAINED_TOL[1] * bpp, (tbpp, bpp)
    want, bpp = jax_forward("A", **knobs)
    got, tbpp = port_forward(case_models("A", **knobs)[0], gop)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert abs(tbpp - bpp) <= rel * bpp, (tbpp, bpp)
    plain, _ = port_forward(case_models("A")[0], gop)
    assert np.abs(got - plain).max() > atol


def latents(shapes, seed=1):
    rng = np.random.default_rng(seed)
    return [np.round(rng.normal(0, 2, s)).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("case, knobs", [("s2d1-LSVC-TINY", {}), ("S", dict(layer_chunk=2))],
                         ids=["s2d1", "S-chunked"])
def test_decode_graph_matches_jax(case, knobs):
    spec, jspec, flat, _ = case_models(case, **knobs)
    gop = 8 if knobs else 4
    decode, (mv_q, z_qs, feat_qs) = jax_build_decode(jspec.module, gop, SIZE, SIZE)
    mv_q, *rest = latents([mv_q.shape] + [z.shape for z in z_qs] + [f.shape for f in feat_qs])
    z_qs, feat_qs = rest[:len(z_qs)], rest[len(z_qs):]
    s2d = spec.module.s2d
    iframe = np.random.default_rng(2).random((SIZE // s2d, SIZE // s2d, 3 * s2d * s2d),
                                             dtype=np.float32)
    with jax.default_matmul_precision("highest"):
        mean, sigma = jax.jit(decode)(unflatten(flat), jnp.asarray(iframe), jnp.asarray(mv_q),
                                      [jnp.asarray(z) for z in z_qs],
                                      [jnp.asarray(f) for f in feat_qs])
    tdecode, (tmv, tz, tf) = ft.build_lsvc_decode(spec.module, gop, SIZE, SIZE)
    assert tmv.shape == nchw(mv_q).shape and [t.shape for t in tf] == [nchw(f).shape
                                                                       for f in feat_qs]
    tmean, tsigma, out = tdecode(nchw(iframe[None])[0], nchw(mv_q), [nchw(z) for z in z_qs],
                                 [nchw(f) for f in feat_qs])
    assert out.shape == (gop - 1, 3, SIZE, SIZE)
    assert abs(float(tmean) - float(mean)) <= DECODE_TOL
    assert abs(float(tsigma) - float(sigma)) <= DECODE_TOL * abs(float(sigma))


@functools.lru_cache(maxsize=None)
def coded(case: str):
    spec, jspec, flat, _ = case_models(case)
    gop = clip(ROLLOUTS[case][2])
    x = nchw(gop)
    streams, recon, bits = tv.lsvc_compress(spec, x)
    decoded = tv.lsvc_decompress(spec, x[0], streams, gop.shape[0] - 1)
    jstreams, _, jbits = jv.lsvc_compress(jspec, unflatten(flat), jnp.asarray(gop))
    return streams, recon, bits, decoded, jstreams, jbits


@pytest.mark.parametrize("case", ["A", "S"])
def test_attention_real_bits(case):
    streams, recon, bits, decoded, jstreams, jbits = coded(case)
    assert torch.equal(decoded, recon)
    assert streams == jstreams and bits == jbits


def test_onehop_graph_reaches_14_p_frames():
    spec = ft.get_codec_model("LSVC-TPU-TINY-O", device="cpu")
    assert [len(layer) for layer in spec.module.schedule(14).layers] == [14]
    with pytest.raises(ValueError, match="does not reach"):
        spec.module.schedule(15)
    chain = ft.get_codec_model("LSVC-TPU-L", device="meta").module.schedule(15)
    assert [len(layer) for layer in chain.layers] == [1] * 15
