"""RLVC, RLVC2 and RLVC-HP of the port against the JAX package, on the CPU,
in float32, with the entropy models and layers they add.

- ``ConvLSTM``, ``RPM``, ``RecProbModel`` with both flags (factorized on
  the first P-frame; the RPM-conditioned Gaussian after, the RPM state
  advanced only then) and ``MeanScaleHyperPriors``, on numpy-seeded
  parameters carried by ``load_params``: outputs and states within 1e-4 of
  their scale, likelihoods 1e-5 relative;
- ``Coder2D`` for the three entropy types: the latent, its decoded
  counterpart, the recon, the new hidden and prior states and the bits;
- one RLVC step (RLVC-TINY, tiny_rlvc_l2) with each flag;
- ``rlvc_gop`` rollouts over the synth_gop_multi clip (numpy seed 0):
  RLVC-TINY on tiny_rlvc_l2 at 64x64, GOP 4; full-width RLVC, RLVC-HP and
  RLVC2 on ``seeded_flat(name, 0)`` at 64x128, GOP 4.

Bars: on the trained tiny weights recon 1e-5 absolute (pixels in [0, 1])
and every metric 1e-6 relative; on seeded weights, whose motion
compensation runs far outside [0, 1] before the clip, recon 1e-4 absolute
and metrics 1e-5 relative; PSNR 1e-3 dB.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.data.synthetic import synth_gop_multi
from fastvideocodec_torch.entropy import hyperprior as thyper
from fastvideocodec_torch.entropy import rpm as trpm
from fastvideocodec_torch.layers import blocks as tblocks
from fastvideocodec_torch.models import rlvc as trlvc
from fastvideocodec_torch.ops.kernels import warp as kw
from fastvideocodec_torch.weights import load_flat, load_params
from fastvideocodec_tpu.entropy import hyperprior as jhyper
from fastvideocodec_tpu.entropy import rpm as jrpm
from fastvideocodec_tpu.gop import rollout as jax_rollout
from fastvideocodec_tpu.layers import blocks as jblocks
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model
from fastvideocodec_tpu.models import rlvc as jrlvc

TOL = 1e-4
TRAINED_TOL, SEEDED_TOL = (1e-5, 1e-6), (1e-4, 1e-5)
ROLLOUTS = {  # case: (registry name, weights, H, W, GOP)
    "RLVC-TINY": ("RLVC-TINY", "tiny_rlvc_l2", 64, 64, 4),
    "RLVC": ("RLVC", "seeded 0", 64, 128, 4),
    "RLVC-HP": ("RLVC-HP", "seeded 0", 64, 128, 4),
    "RLVC2": ("RLVC2", "seeded 0", 64, 128, 4),
}
C = 8  # the layers' width


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


def rand(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)).astype(np.float32)


def seeded_like(shapes, seed=0):
    """Kernels N(0, 1/fan_in), GDN beta in [1, 1.5] and gamma
    |N(0.1, 0.05)|, bottleneck quantiles (-10, 0, 10) plus noise, other
    leaves N(0, 0.05)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            value = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name == "beta":
            value = 1 + rng.uniform(0, 0.5, shape)
        elif name == "gamma":
            value = np.abs(rng.normal(0.1, 0.05, shape))
        elif name == "quantiles":
            value = np.tile([-10.0, 0.0, 10.0], (shape[0], 1, 1)) + rng.normal(0, 0.1, shape)
        else:
            value = rng.normal(0, 0.05, shape)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def apply(jmod, params, *args, **kw_):
    with jax.default_matmul_precision("highest"):
        return jax.jit(lambda p, *a: jmod.apply(p, *a, **kw_))(params, *args)


def close(got, want, tol=TOL):
    want = np.asarray(want)
    got = nhwc(got) if isinstance(got, torch.Tensor) and got.dim() == 4 else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def test_conv_lstm_matches_jax():
    jmod = jblocks.ConvLSTM(C)
    x, state = rand((2, 6, 10, C)), rand((2, 6, 10, 2 * C), seed=2)
    params = seeded_like(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x, state))
    h, new = apply(jmod, params, jnp.asarray(x), jnp.asarray(state))
    tmod = tblocks.ConvLSTM(C)
    load_params(tmod, params)
    with torch.no_grad():
        th, tnew = tmod(nchw(x), nchw(state))
    close(th, h)
    close(tnew, new)


def test_rpm_matches_jax():
    jmod = jrpm.RPM(C)
    x, hidden = rand((2, 4, 6, C)), rand((2, 4, 6, 2 * C), seed=2)
    params = seeded_like(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x, hidden))
    sigma, mu, new = apply(jmod, params, jnp.asarray(x), jnp.asarray(hidden))
    tmod = trpm.RPM(C)
    load_params(tmod, params)
    with torch.no_grad():
        tsigma, tmu, tnew = tmod(nchw(x), nchw(hidden))
    assert float(tmu.min()) >= 0.0  # the last ReLU: mu is never negative
    for got, want in ((tsigma, sigma), (tmu, mu), (tnew, new)):
        close(got, want)


@pytest.mark.parametrize("flag", [False, True])
def test_rec_prob_model_matches_jax(flag):
    """Both flags: the port runs only the selected branch."""
    jmod = jrpm.RecProbModel(C)
    x = rand((2, 4, 6, C), scale=4.0)
    hidden, prior = rand((2, 4, 6, 2 * C), seed=2), np.round(rand((2, 4, 6, C), seed=3, scale=3))
    shapes = jax.eval_shape(lambda k: jmod.init(k, x, hidden, True, prior, training=False),
                            jax.random.PRNGKey(0))
    params = seeded_like(shapes)
    out = apply(jmod, params, jnp.asarray(x), jnp.asarray(hidden), flag, jnp.asarray(prior),
                training=False)
    tmod = trpm.RecProbModel(C)
    load_params(tmod, params)
    with torch.no_grad():
        tout = tmod(nchw(x), nchw(hidden), flag, nchw(prior))
    x_hat, lik, new_hidden, new_prior, sigma, mu = out
    close(tout[0], x_hat)
    np.testing.assert_allclose(nhwc(tout[1]), np.asarray(lik), rtol=1e-5, atol=1e-7)
    close(tout[2], new_hidden)
    np.testing.assert_array_equal(nhwc(tout[3]), np.asarray(new_prior))
    if flag:
        close(tout[4], sigma)
        close(tout[5], mu)
    else:
        np.testing.assert_array_equal(nhwc(tout[2]), hidden)  # the state waits
        assert tout[4] is None and tout[5] is None


def test_mean_scale_hyperpriors_match_jax():
    jmod = jhyper.MeanScaleHyperPriors(C)
    x = rand((2, 4, 6, C), scale=4.0)
    params = seeded_like(jax.eval_shape(lambda k: jmod.init(k, x, training=False),
                                        jax.random.PRNGKey(0)))
    x_hat, (x_lik, z_lik), sigma, mu = apply(jmod, params, jnp.asarray(x), training=False)
    tmod = thyper.MeanScaleHyperPriors(C)
    load_params(tmod, params)
    with torch.no_grad():
        tx_hat, (tx_lik, tz_lik), tsigma, tmu = tmod(nchw(x))
    close(tx_hat, x_hat)
    close(tsigma, sigma)
    close(tmu, mu)
    for got, want in ((tx_lik, x_lik), (tz_lik, z_lik)):
        np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-7)


class _Coder2DStep(jrlvc.RLVC):
    """One mv Coder2D pass of the JAX RLVC (its ``_run_codec``) as a method."""

    def step(self, x, rae, rpm_hidden, flag, prior):
        return self._run_codec(self.mv_codec, self.mv_dec4, x, rae, rpm_hidden, flag, prior,
                               False, None)


@pytest.mark.parametrize("entropy_type", ["rpm", "rpm2", "mshyper"])
@pytest.mark.parametrize("flag", [False, True])
def test_coder2d_matches_jax(entropy_type, flag):
    """The mv Coder2D of a C-wide RLVC on a 32x48 flow: recon, states,
    bits and prior."""
    jmod = _Coder2DStep(channels=C, entropy_type=entropy_type, spynet_widths=(4, 8, 4, 4),
                        spynet_kernel=3, warp_width=4)
    x = rand((1, 32, 48, 2), scale=3.0)
    hidden = jmod.init_hidden(1, 32, 48)
    rae = rand(hidden.rae_mv.shape, seed=2)
    rpm_hidden = rand(hidden.rpm_mv.shape, seed=3)
    prior = np.round(rand(hidden.mv_prior.shape, seed=4, scale=2))
    args = [jnp.asarray(a) for a in (x, rae, rpm_hidden)] + [flag, jnp.asarray(prior)]
    frames = jnp.zeros((1, 32, 48, 3))
    shapes = jax.eval_shape(lambda k: jmod.init(k, frames, frames, hidden, True,
                                                training=False), jax.random.PRNGKey(0))
    params = seeded_like(shapes)
    hat, new_rae, new_rpm, bits, new_prior = apply(jmod, params, *args, method=jmod.step)
    tmod = trlvc.RLVC(channels=C, entropy_type=entropy_type, spynet_widths=(4, 8, 4, 4),
                      spynet_kernel=3, warp_width=4)
    load_params(tmod, params)
    with torch.no_grad():
        got = tmod._run_codec(tmod.mv_codec, tmod.mv_dec4, nchw(x), nchw(rae),
                              nchw(rpm_hidden), flag, nchw(prior))
    for t, j in zip((got[0], got[1], got[2]), (hat, new_rae, new_rpm)):
        close(t, j)
    np.testing.assert_allclose(float(got[3]), float(bits), rtol=1e-5)
    np.testing.assert_array_equal(nhwc(got[4]), np.asarray(new_prior))


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


def port_model(name, weights):
    spec = ft.get_codec_model(name, device="cpu")
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


@pytest.mark.parametrize("flag", [False, True])
def test_rlvc_step_matches_jax(flag):
    """One RLVC-TINY step (frame 1 against frame 0) from a nonzero hidden
    state: recon, every hidden tensor and every metric."""
    name, weights = "RLVC-TINY", "tiny_rlvc_l2"
    frames = clip(64, 64, 2)
    spec = jax_get_codec_model(name)
    jh = spec.module.init_hidden(1, 64, 64)
    state = [rand(t.shape, seed=10 + i, scale=0.3) for i, t in enumerate(jh)]
    state[4:] = [np.round(s * 10) for s in state[4:]]  # the priors are rounded latents
    with jax.default_matmul_precision("highest"):
        out, hid, m = jax.jit(lambda p, r, c, h: spec.module.apply(
            p, r, c, h, flag, training=False))(
            jax_params(name, weights), jnp.asarray(frames[0:1]), jnp.asarray(frames[1:2]),
            type(jh)(*[jnp.asarray(s) for s in state]))
    tm_ = port_model(name, weights).module
    with torch.inference_mode():
        tout, thid, tm = tm_(nchw(frames[0:1]), nchw(frames[1:2]),
                             trlvc.RlvcHidden(*[nchw(s) for s in state]), flag)
    atol, rel = TRAINED_TOL
    np.testing.assert_allclose(nhwc(tout), np.asarray(out), rtol=0, atol=atol)
    for t, j in zip(thid, hid):
        close(t, j, tol=1e-5)
    assert_metrics({k: v.numpy() for k, v in tm.items()}, m, rel)


def test_init_hidden_shapes():
    m = ft.get_codec_model("RLVC", device="meta").module
    h = m.init_hidden(2, 64, 128)
    assert [tuple(t.shape) for t in h] == [(2, 512, 16, 32)] * 2 + [(2, 256, 4, 8)] * 2 + [
        (2, 128, 4, 8)] * 2


@pytest.mark.parametrize("case", sorted(ROLLOUTS))
def test_rollout_matches_jax(case):
    name, weights, h, w, gop = ROLLOUTS[case]
    frames = clip(h, w, gop)
    spec = jax_get_codec_model(name)
    with jax.default_matmul_precision("highest"):
        com, m = jax.jit(lambda p, g: jax_rollout(spec, p, g, training=False))(
            jax_params(name, weights), jnp.asarray(frames))
    tspec = port_model(name, weights)
    assert tspec.family == spec.family == "rlvc"
    kw.reset_launches()
    tcom, tm = ft.rollout(tspec, nchw(frames))
    assert set(kw.LAUNCHES.values()) == {0}  # the CPU takes the plain warp
    assert tcom.shape == (gop - 1, 3, h, w)
    atol, rel = TRAINED_TOL if weights != "seeded 0" else SEEDED_TOL
    np.testing.assert_allclose(nhwc(tcom), np.asarray(com)[:, 0], rtol=0, atol=atol)
    assert_metrics({k: v.numpy() for k, v in tm.items()}, m, rel)
