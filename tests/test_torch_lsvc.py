"""The LSVC-TPU slice of the port against the JAX package, on the CPU, in
float32 (and one bfloat16 case).

Both packages code the same synth_gop_multi clip (numpy seed 0, 64x128,
GOP 4) with the same shipped weights: LSVC-TPU with hd_lsvctpuf2_l2 (the
flagship at its real channel widths) and LSVC-TPU-TINY with
tiny_lsvctpu_l2. The decode graph gets the same numpy latents in both.

Tolerances, for float32 conv stacks summed in different orders (measured
differences are about 3e-6 on the recon and 5e-7 relative on bpp, with no
latent rounding flip):
- recon: 1e-4 absolute (pixels in [0, 1]);
- bpp: 1e-5 relative; per-frame PSNR: 1e-3 dB;
- decode graph recon mean: 1e-5 absolute; sigma sum: 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_tpu.data.synthetic import synth_gop_multi as jax_pkg_synth
from fastvideocodec_tpu.gop import rollout as jax_rollout
from fastvideocodec_tpu.gop.decode_graph import build_lsvc_decode as jax_build_decode
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model
from fastvideocodec_tpu.train.checkpoint import asset_params
from fastvideocodec_torch.data.synthetic import synth_gop_multi
from test_torch_train_common import one_torch_thread  # noqa: F401 (autouse)

CONFIGS = [("LSVC-TPU", "hd_lsvctpuf2_l2"), ("LSVC-TPU-TINY", "tiny_lsvctpu_l2")]
GOP, H, W = 4, 64, 128


def clip() -> np.ndarray:
    return synth_gop_multi(np.random.default_rng(0), size=128, gop=GOP)[:, :H, :W]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def port_model(name, asset):
    spec = ft.get_codec_model(name, device="cpu")
    ft.load_asset(spec.module, asset)
    return spec


def test_synthetic_clip_is_the_jax_packages():
    np.testing.assert_array_equal(
        clip(), jax_pkg_synth(np.random.default_rng(0), size=128, gop=GOP)[:, :H, :W]
    )


@pytest.mark.parametrize("name, asset", CONFIGS)
def test_rollout_matches_jax(name, asset):
    gop = clip()
    spec = jax_get_codec_model(name)
    params = {"params": asset_params(asset)["params"]}
    with jax.default_matmul_precision("highest"):
        com, m = jax.jit(lambda p, g: jax_rollout(spec, p, g, training=False))(
            params, jnp.asarray(gop)
        )
    tcom, tm = ft.rollout(port_model(name, asset), nchw(gop))
    assert tcom.shape == (GOP - 1, 3, H, W)
    np.testing.assert_allclose(
        tcom.permute(0, 2, 3, 1).numpy(), np.asarray(com), rtol=0, atol=1e-4
    )
    bpp, tbpp = float(m["bpp"]), float(tm["bpp"])
    assert abs(tbpp - bpp) <= 1e-5 * bpp, (tbpp, bpp)
    for key in ("psnr", "mc_psnr", "warp_psnr"):
        np.testing.assert_allclose(tm[key].numpy(), np.asarray(m[key]), rtol=0, atol=1e-3)
    for key in ("bpp_mv", "bpp_res"):
        np.testing.assert_allclose(float(tm[key]), float(m[key]), rtol=1e-5)


def test_bf16_rollout_close_to_jax_bf16():
    """LSVC-TPU with bfloat16 activations in both packages. They round at
    different places (the port lerps warps and sums rates in float32; JAX
    computes PSNR and the Laplace rate in bfloat16, whose PSNR steps are
    0.125 dB near 25 dB), so the bar is bfloat16-sized: recon mean abs
    diff 0.01 (2.5 ulps at 0.5), per-frame PSNR 0.25 dB, bpp 0.5%
    relative (measured: 0.0066, 0.16 dB, 0.11%)."""
    gop = clip()
    spec = jax_get_codec_model("LSVC-TPU", dtype=jnp.bfloat16)
    params = {"params": asset_params("hd_lsvctpuf2_l2")["params"]}
    with jax.default_matmul_precision("highest"):
        com, m = jax.jit(lambda p, g: jax_rollout(spec, p, g, training=False))(
            params, jnp.asarray(gop, jnp.bfloat16)
        )
    tspec = ft.get_codec_model("LSVC-TPU", dtype=torch.bfloat16, device="cpu")
    ft.load_asset(tspec.module, "hd_lsvctpuf2_l2")
    tcom, tm = ft.rollout(tspec, nchw(gop).to(torch.bfloat16))
    diff = np.abs(tcom.float().permute(0, 2, 3, 1).numpy() - np.asarray(com, np.float32))
    assert diff.mean() <= 0.01
    np.testing.assert_allclose(tm["psnr"].numpy(), np.asarray(m["psnr"], np.float32),
                               rtol=0, atol=0.25)
    assert abs(float(tm["bpp"]) - float(m["bpp"])) <= 5e-3 * float(m["bpp"])


@pytest.mark.parametrize("name, asset", CONFIGS)
def test_decode_graph_matches_jax(name, asset):
    spec = jax_get_codec_model(name)
    params = {"params": asset_params(asset)["params"]}
    decode, (mv_q, z_qs, feat_qs) = jax_build_decode(spec.module, GOP, H, W)
    rng = np.random.default_rng(1)

    def latents(shape):
        return rng.normal(0, 2, shape).astype(np.float32)

    mv_q = latents(mv_q.shape)
    z_qs = [latents(z.shape) for z in z_qs]
    feat_qs = [latents(f.shape) for f in feat_qs]
    iframe = rng.random((H // 2, W // 2, 12), dtype=np.float32)
    with jax.default_matmul_precision("highest"):
        mean, sigma = jax.jit(decode)(params, jnp.asarray(iframe), jnp.asarray(mv_q),
                                      [jnp.asarray(z) for z in z_qs],
                                      [jnp.asarray(f) for f in feat_qs])

    tspec = port_model(name, asset)
    tdecode, (tmv, tz, tf) = ft.build_lsvc_decode(tspec.module, GOP, H, W)
    assert tmv.shape == nchw(mv_q).shape
    assert [t.shape for t in tz] == [nchw(z).shape for z in z_qs]
    assert [t.shape for t in tf] == [nchw(f).shape for f in feat_qs]
    tmean, tsigma, out = tdecode(
        nchw(iframe[None])[0], nchw(mv_q), [nchw(z) for z in z_qs], [nchw(f) for f in feat_qs]
    )
    assert out.shape == (GOP - 1, 3, H, W)
    assert abs(float(tmean) - float(mean)) <= 1e-5
    assert abs(float(tsigma) - float(sigma)) <= 1e-5 * abs(float(sigma))


def test_launch_counts_stay_zero_on_cpu():
    """On CPU tensors the wrappers run the plain versions and count nothing."""
    from fastvideocodec_torch.ops.kernels import warp as kw

    kw.reset_launches()
    ft.rollout(port_model(*CONFIGS[1]), nchw(clip()))
    assert {"flow_warp", "flow_warp_s2d"} <= set(kw.LAUNCHES)
    assert set(kw.LAUNCHES.values()) == {0}
