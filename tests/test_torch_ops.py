"""Ops of the PyTorch port against the JAX package, on the CPU, in float32.

The same numpy-seeded inputs go through both. The port is NCHW and the JAX
package NHWC; each comparison transposes the port's output. The JAX side
runs under default_matmul_precision("highest"). Tolerances:

- layout ops (s2d/d2s) are permutations: exact;
- pools, upsamples and warps: 1e-5 absolute (inputs in [0, 1]), a few
  float32 ulps of different summation and fusion order;
- GDN, Laplace likelihood and bits: 1e-5 relative to the output scale;
- the SSF volume ops (blur, volume, phase mean, s2d upsample, pyramid
  warp): 1e-5 absolute; a bfloat16 blur: one bfloat16 ulp;
- Gaussian likelihoods, EntropyBottleneck and GaussianConditional: 1e-5
  relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideocodec_torch.entropy import factorized as tfac
from fastvideocodec_torch.entropy import gaussian as tgauss
from fastvideocodec_torch.ops import gdn as tgdn
from fastvideocodec_torch.ops import math as tmath
from fastvideocodec_torch.ops import warp as twarp
from fastvideocodec_torch.ops.kernels import warp as kwarp
from fastvideocodec_torch.weights import load_params
from fastvideocodec_tpu.entropy import factorized as jfac
from fastvideocodec_tpu.entropy import gaussian as jgauss
from fastvideocodec_tpu.ops import gdn as jgdn
from fastvideocodec_tpu.ops import math as jmath
from fastvideocodec_tpu.ops import warp as jwarp
from fastvideocodec_tpu.ops.pallas import warp_kernel as jwk

WARP_ATOL = 1e-5


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def highest(fn, *args):
    with jax.default_matmul_precision("highest"):
        return np.asarray(fn(*args))


def big_flow(rng, B, H, W):
    """Small motion plus displacements far past the TPU kernel's 56 px
    bound, so many samples land outside the frame and clamp to its border."""
    flow = rng.normal(0, 3, (B, H, W, 2)) + rng.uniform(-150, 150, (B, H, W, 2))
    flow[:, : H // 2, :, 0] += 80.0  # a block moving 80 px right
    return flow.astype(np.float32)


class TestLayoutOps:
    @pytest.mark.parametrize("shape", [(2, 8, 12, 3), (1, 4, 6, 5)])
    def test_space_to_depth_matches_jax_order(self, shape):
        x = np.random.default_rng(0).random(shape, dtype=np.float32)
        got = nhwc(twarp.space_to_depth(nchw(x)))
        np.testing.assert_array_equal(got, np.asarray(jwarp.space_to_depth(jnp.asarray(x))))

    @pytest.mark.parametrize("r", [2, 4])
    def test_depth_to_space_matches_jax_and_inverts(self, r):
        x = np.random.default_rng(1).random((2, 3, 5, 2 * r * r), dtype=np.float32)
        got = twarp.depth_to_space(nchw(x), r)
        np.testing.assert_array_equal(
            nhwc(got), np.asarray(jwarp.depth_to_space(jnp.asarray(x), r))
        )
        np.testing.assert_array_equal(nhwc(twarp.space_to_depth(got, r)), x)

    def test_s2d_channel_order_is_ry_rx_c(self):
        x = torch.arange(2 * 4 * 4, dtype=torch.float32).reshape(1, 2, 4, 4)
        s = twarp.space_to_depth(x)
        C = 2
        for ry in range(2):
            for rx in range(2):
                for c in range(C):
                    torch.testing.assert_close(
                        s[0, ry * 2 * C + rx * C + c], x[0, c, ry::2, rx::2], rtol=0, atol=0
                    )


class TestResampling:
    @pytest.mark.parametrize(
        "name, shape",
        [("avg_pool2", (2, 8, 12, 3)), ("bilinear_upsample_x2", (2, 5, 7, 3)),
         ("bilinear_upsample_x2_ac", (2, 5, 7, 4)), ("bilinear_upsample_x2", (1, 1, 3, 2))],
    )
    def test_matches_jax(self, name, shape):
        x = np.random.default_rng(2).random(shape, dtype=np.float32)
        got = nhwc(getattr(twarp, name)(nchw(x)))
        want = highest(getattr(jwarp, name), jnp.asarray(x))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=WARP_ATOL)


class TestWarp:
    @pytest.mark.parametrize("B, H, W, C", [(2, 16, 24, 3), (1, 9, 33, 5), (3, 32, 32, 1)])
    def test_plain_flow_warp_matches_xla_exact_path(self, B, H, W, C):
        rng = np.random.default_rng(3)
        img = rng.random((B, H, W, C), dtype=np.float32)
        flow = big_flow(rng, B, H, W)
        got = nhwc(twarp.plain_flow_warp(nchw(img), nchw(flow)))
        want = highest(jwarp._xla_flow_warp, jnp.asarray(img), jnp.asarray(flow))
        np.testing.assert_allclose(got, want, rtol=0, atol=WARP_ATOL)

    def test_flow_warp_on_cpu_is_the_plain_version(self):
        rng = np.random.default_rng(4)
        img, flow = nchw(rng.random((2, 8, 8, 3), dtype=np.float32)), nchw(big_flow(rng, 2, 8, 8))
        torch.testing.assert_close(
            twarp.flow_warp(img, flow), twarp.plain_flow_warp(img, flow), rtol=0, atol=0
        )

    @pytest.mark.parametrize("B, H, W, C", [(2, 16, 24, 3), (1, 8, 40, 2)])
    def test_flow_warp_fullres_s2d_matches_jax(self, B, H, W, C):
        rng = np.random.default_rng(5)
        img = rng.random((B, H // 2, W // 2, 4 * C), dtype=np.float32)
        flow = big_flow(rng, B, H, W)
        got = nhwc(twarp.flow_warp_fullres_s2d(nchw(img), nchw(flow)))
        want = highest(jwarp.flow_warp_fullres_s2d, jnp.asarray(img), jnp.asarray(flow))
        np.testing.assert_allclose(got, want, rtol=0, atol=WARP_ATOL)

    def test_matches_torch_grid_sample(self):
        """An independent implementation: grid_sample(border,
        align_corners=False) on the linspace grid displaced by the flow."""
        rng = np.random.default_rng(6)
        img = nchw(rng.random((2, 6, 10, 3), dtype=np.float32))
        flow = nchw(big_flow(rng, 2, 6, 10))
        flow[1] = 0.0  # zero flow: the linspace grid is not the identity
        xs = twarp._linspace(10, "cpu")[None, None, :] + flow[:, 0] * twarp.grid_norm(10)
        ys = twarp._linspace(6, "cpu")[None, :, None] + flow[:, 1] * twarp.grid_norm(6)
        want = torch.nn.functional.grid_sample(
            img, torch.stack([xs, ys], -1), mode="bilinear", padding_mode="border",
            align_corners=False,
        )
        torch.testing.assert_close(
            twarp.plain_flow_warp(img, flow), want, rtol=0, atol=WARP_ATOL
        )

    def test_wrapper_raises_off_cpu_instead_of_falling_back(self):
        img = torch.empty(1, 3, 8, 8, device="meta")
        flow = torch.empty(1, 2, 8, 8, device="meta")
        with pytest.raises(ValueError):
            twarp.flow_warp(img, flow)
        with pytest.raises(ValueError):
            twarp.flow_warp_fullres_s2d(torch.empty(1, 12, 4, 4, device="meta"), flow)


class TestPixelWarp:
    """The pixel-convention warps (source = output + flow) against the JAX
    exact paths, with displacements far past the TPU kernel's 56 px bound
    and samples off the border."""

    @pytest.mark.parametrize("B, H, W, C", [(2, 16, 24, 3), (1, 9, 33, 15), (3, 32, 32, 1)])
    def test_plain_pixel_warp_matches_xla_exact_path(self, B, H, W, C):
        rng = np.random.default_rng(11)
        img = rng.random((B, H, W, C), dtype=np.float32)
        flow = big_flow(rng, B, H, W)
        got = nhwc(twarp.plain_pixel_warp(nchw(img), nchw(flow)))
        want = highest(jwarp._xla_pixel_warp, jnp.asarray(img), jnp.asarray(flow))
        np.testing.assert_allclose(got, want, rtol=0, atol=WARP_ATOL)

    @pytest.mark.parametrize("B, H, W, C", [(2, 16, 24, 3), (1, 8, 40, 2)])
    def test_plain_pixel_warp_s2d_matches_jax(self, B, H, W, C):
        rng = np.random.default_rng(12)
        img = rng.random((B, H // 2, W // 2, 4 * C), dtype=np.float32)
        flow = big_flow(rng, B, H, W)
        got = nhwc(twarp.plain_pixel_warp_s2d(nchw(img), nchw(flow)))
        want = highest(jwk._exact_pixel_fullres_s2d, jnp.asarray(img), jnp.asarray(flow))
        np.testing.assert_allclose(got, want, rtol=0, atol=WARP_ATOL)

    @pytest.mark.parametrize("B, H, W, C", [(2, 16, 24, 3), (1, 32, 64, 3)])
    def test_pixel_warp_s2d_sflow_matches_jax_dispatcher(self, B, H, W, C):
        """The port's dispatcher against the JAX dispatcher the SSF-TPU
        pipeline calls (on the CPU it takes the exact path)."""
        rng = np.random.default_rng(13)
        img = rng.random((B, H // 2, W // 2, 4 * C), dtype=np.float32)
        flow = np.concatenate(
            [big_flow(rng, B, H // 2, W // 2) for _ in range(4)], axis=-1
        )
        got = nhwc(twarp.pixel_warp_s2d_sflow(nchw(img), nchw(flow)))
        want = highest(
            lambda a, f: jwarp._pixel_warp_s2d_sflow_dispatch(a, f, exact=False, r=56),
            jnp.asarray(img), jnp.asarray(flow),
        )
        np.testing.assert_allclose(got, want, rtol=0, atol=WARP_ATOL)

    def test_sflow_phase_order_is_c_major(self):
        """Flow channel comp*4 + 2*ry + rx carries component comp of the
        full-resolution pixels (2i + ry, 2j + rx)."""
        rng = np.random.default_rng(14)
        img = nchw(rng.random((1, 6, 8, 12), dtype=np.float32))
        flow_s2d = nchw(big_flow(rng, 1, 6, 8).repeat(4, axis=-1))
        full = torch.empty(1, 2, 12, 16)
        for comp in range(2):
            for ry in range(2):
                for rx in range(2):
                    full[0, comp, ry::2, rx::2] = flow_s2d[0, comp * 4 + 2 * ry + rx]
        torch.testing.assert_close(
            twarp.plain_pixel_warp_s2d_sflow(img, flow_s2d),
            twarp.plain_pixel_warp_s2d(img, full), rtol=0, atol=0,
        )

    def test_matches_torch_grid_sample(self):
        """An independent implementation: grid_sample(border,
        align_corners=False) at the normalized source (2*(i + f) + 1)/n - 1."""
        rng = np.random.default_rng(15)
        img = nchw(rng.random((2, 6, 10, 3), dtype=np.float32))
        flow = nchw(big_flow(rng, 2, 6, 10))
        xs = (2 * (torch.arange(10.0)[None, None, :] + flow[:, 0]) + 1) / 10 - 1
        ys = (2 * (torch.arange(6.0)[None, :, None] + flow[:, 1]) + 1) / 6 - 1
        want = torch.nn.functional.grid_sample(
            img, torch.stack([xs, ys], -1), mode="bilinear", padding_mode="border",
            align_corners=False,
        )
        torch.testing.assert_close(
            twarp.plain_pixel_warp(img, flow), want, rtol=0, atol=WARP_ATOL
        )

    def test_dispatchers_on_cpu_are_the_plain_versions(self):
        rng = np.random.default_rng(16)
        img = nchw(rng.random((1, 8, 12, 12), dtype=np.float32))
        flow = nchw(big_flow(rng, 1, 16, 24))
        flow_s2d = nchw(big_flow(rng, 1, 8, 12).repeat(4, axis=-1))
        pairs = [
            (twarp.pixel_warp(img, flow[:, :, :8, :12]),
             twarp.plain_pixel_warp(img, flow[:, :, :8, :12])),
            (twarp.pixel_warp_s2d(img, flow), twarp.plain_pixel_warp_s2d(img, flow)),
            (twarp.pixel_warp_s2d_sflow(img, flow_s2d),
             twarp.plain_pixel_warp_s2d_sflow(img, flow_s2d)),
        ]
        for got, want in pairs:
            torch.testing.assert_close(got, want, rtol=0, atol=0)


class TestVolumeOps:
    """The SSF scale-space ops (plain PyTorch in the port)."""

    @pytest.mark.parametrize(
        "name, shape, fn",
        [
            ("gaussian_blur", (2, 16, 24, 3), lambda m, x: m.gaussian_blur(x, 1.5)),
            ("gaussian_blur_sigma08", (1, 7, 9, 2), lambda m, x: m.gaussian_blur(x, 0.8)),
            ("gaussian_volume", (2, 32, 48, 3), lambda m, x: m.gaussian_volume(x, 1.5, 4)),
            ("s2d_phase_mean", (2, 8, 12, 12), lambda m, x: m.s2d_phase_mean(x, 3)),
            ("up2_to_s2d", (2, 5, 7, 3), lambda m, x: m.up2_to_s2d(x)),
        ],
    )
    def test_matches_jax(self, name, shape, fn):
        x = np.random.default_rng(17).random(shape, dtype=np.float32)
        got = nhwc(fn(twarp, nchw(x)))
        want = highest(lambda a: fn(jwarp, a), jnp.asarray(x))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=WARP_ATOL)

    def test_bf16_blur_within_one_bf16_ulp(self):
        """Taps rounded to bfloat16 and summed left to right, as JAX does."""
        x = np.random.default_rng(18).random((2, 16, 24, 3), dtype=np.float32)
        got = nhwc(twarp.gaussian_blur(nchw(x).to(torch.bfloat16), 1.5).float())
        want = np.asarray(
            jwarp.gaussian_blur(jnp.asarray(x, jnp.bfloat16), 1.5).astype(jnp.float32)
        )
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
        assert (np.abs(got - want) <= ulp).all()

    @pytest.mark.parametrize("B, H2, W2", [(1, 16, 32), (2, 8, 12)])
    def test_warp_volume_pyramid_s2d_matches_jax(self, B, H2, W2):
        """Motion fields with flows far past the TPU's 56/28 px bounds and
        scales across all depth levels."""
        rng = np.random.default_rng(19)
        level0 = rng.random((B, H2, W2, 12), dtype=np.float32)
        vol_half = rng.random((B, H2, W2, 15), dtype=np.float32)
        motion = np.concatenate(
            [big_flow(rng, B, H2, W2)[..., :1].repeat(4, -1) / (W2 / 2),
             big_flow(rng, B, H2, W2)[..., 1:].repeat(4, -1) / (H2 / 2),
             rng.uniform(-1.5, 1.5, (B, H2, W2, 4))], axis=-1,
        ).astype(np.float32)
        motion[..., :8] += rng.normal(0, 0.05, (B, H2, W2, 8)).astype(np.float32)
        got = nhwc(twarp.warp_volume_pyramid_s2d(nchw(level0), nchw(vol_half),
                                                 nchw(motion), 5))
        want = highest(lambda *a: jwarp.warp_volume_pyramid_s2d(*a, 5),
                       jnp.asarray(level0), jnp.asarray(vol_half), jnp.asarray(motion))
        np.testing.assert_allclose(got, want, rtol=0, atol=WARP_ATOL)


def _off_ties(rng, shape):
    """A big_flow-like displacement field (small motion plus up to +-150 px,
    samples far off the frame) whose fractional parts lie in [0.05, 0.95]:
    a pixel-convention sample then sits at least 0.05 px from an integer
    coordinate and from the border. At such ties the two frameworks'
    gradients legitimately differ: floor's gradient is 0 in both, but
    jnp.clip splits a tie's gradient where torch.clamp passes it, and an
    ulp either side of an integer picks other taps."""
    f = rng.normal(0, 3, shape) + rng.uniform(-150, 150, shape)
    frac = f - np.floor(f)
    return (f + np.where(np.abs(frac - 0.5) > 0.45, 0.1, 0.0)).astype(np.float32)


class TestWarpGradients:
    """The plain versions' gradients (the backward of every kernel's
    autograd Function) against jax.vjp of the JAX package's exact paths
    (the backward of its custom_vjp entry points), on the same numpy inputs
    and cotangent, in float32. Tolerance 1e-5 relative and absolute: the
    image gradient is a scatter-add whose summation order differs.

    The flows keep their samples off integer coordinates and off the
    border (``_off_ties``); for the normalized-grid warps, whose samples
    carry the linspace grid's offset, the distance is checked in float64
    below."""

    @staticmethod
    def _grads(fn, img, flow, g):
        i = torch.from_numpy(img).requires_grad_()
        f = torch.from_numpy(flow).requires_grad_()
        out = fn(i, f)
        return torch.autograd.grad(out, [i, f], torch.from_numpy(g))

    @staticmethod
    def _jax_grads(fn, img, flow, g):
        to_nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))
        _, vjp = jax.vjp(fn, to_nhwc(img), to_nhwc(flow))
        return [np.asarray(a).transpose(0, 3, 1, 2) for a in vjp(to_nhwc(g))]

    @pytest.mark.parametrize("name, jax_fn, s2d, phase_flow", [
        ("flow_warp", jwarp._xla_flow_warp, False, False),
        ("flow_warp_s2d", jwk._exact_fullres_s2d, True, False),
        ("pixel_warp", jwarp._xla_pixel_warp, False, False),
        ("pixel_warp_s2d", jwk._exact_pixel_fullres_s2d, True, False),
        ("pixel_warp_s2d_sflow", jwk._exact_pixel_s2d_sflow, True, True),
    ])
    def test_plain_gradients_match_jax_vjp(self, name, jax_fn, s2d, phase_flow):
        rng = np.random.default_rng(30)
        B, C, H, W = 2, 3, 12, 20
        img_shape = (B, 4 * C, H // 2, W // 2) if s2d else (B, C, H, W)
        flow_shape = (B, 8, H // 2, W // 2) if phase_flow else (B, 2, H, W)
        img = rng.random(img_shape, dtype=np.float32)
        flow = _off_ties(rng, flow_shape)
        g = rng.normal(0, 1, img_shape).astype(np.float32)
        if not name.startswith("pixel"):  # the normalized grid's samples in float64
            for axis, n in ((0, W), (1, H)):
                pos = np.arange(n).reshape((1, -1) if axis == 0 else (-1, 1))
                lin = -1.0 + 2.0 * pos / (n - 1)
                u = ((lin + flow[:, axis] * 2.0 / (n - 1) + 1.0) * n - 1.0) / 2.0
                inside = (u > 0) & (u < n - 1)
                assert np.abs(u[inside] - np.round(u[inside])).min() > 1e-3
                assert np.abs(u[~inside] - np.clip(u[~inside], 0, n - 1)).min() > 1e-3
        got = self._grads(twarp.PLAIN[name], img, flow, g)
        want = self._jax_grads(jax_fn, img, flow, g)
        for t, w in zip(got, want):
            np.testing.assert_allclose(t.numpy(), w, rtol=1e-5, atol=1e-5)
        assert np.abs(want[1]).max() > 0.1  # the flow's gradient is not all zero


@pytest.mark.gpu
class TestWarpKernelsOnCard:
    """The CUDA kernels against their plain versions on the card; skipped
    without one. The kernels round like the plain versions, so the bar is a
    float32 ulp (and one bfloat16 ulp of values below 1)."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")

    @pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.bfloat16, 4e-3)])
    def test_kernels_match_plain(self, dtype, tol):
        rng = np.random.default_rng(7)
        img = nchw(rng.random((3, 18, 34, 3), dtype=np.float32)).cuda().to(dtype)
        flow = nchw(big_flow(rng, 3, 18, 34)).cuda().to(dtype)
        got = kwarp.launch_flow_warp(img, flow)
        torch.testing.assert_close(got, twarp.plain_flow_warp(img, flow), rtol=0, atol=tol)
        s2d = twarp.space_to_depth(img)
        got = kwarp.launch_flow_warp_s2d(s2d, flow)
        torch.testing.assert_close(got, twarp.plain_flow_warp_s2d(s2d, flow), rtol=0, atol=tol)

    @pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.bfloat16, 4e-3)])
    def test_pixel_kernels_match_plain(self, dtype, tol):
        """float32 flows with float32 and bfloat16 images."""
        rng = np.random.default_rng(20)
        img = nchw(rng.random((2, 18, 34, 15), dtype=np.float32)).cuda().to(dtype)
        flow = nchw(big_flow(rng, 2, 18, 34)).cuda()
        torch.testing.assert_close(kwarp.launch_pixel_warp(img, flow),
                                   twarp.plain_pixel_warp(img, flow), rtol=0, atol=tol)
        s2d = nchw(rng.random((2, 9, 17, 12), dtype=np.float32)).cuda().to(dtype)
        torch.testing.assert_close(kwarp.launch_pixel_warp_s2d(s2d, flow),
                                   twarp.plain_pixel_warp_s2d(s2d, flow), rtol=0, atol=tol)
        flow_s2d = nchw(big_flow(rng, 2, 9, 17).repeat(4, axis=-1)).cuda()
        torch.testing.assert_close(kwarp.launch_pixel_warp_s2d_sflow(s2d, flow_s2d),
                                   twarp.plain_pixel_warp_s2d_sflow(s2d, flow_s2d),
                                   rtol=0, atol=tol)


class TestGDN:
    @pytest.mark.parametrize("inverse", [False, True])
    def test_matches_jax(self, inverse):
        rng = np.random.default_rng(8)
        C = 6
        x = rng.normal(0, 1, (2, 5, 7, C)).astype(np.float32)
        beta = (1.0 + rng.uniform(0, 0.5, C)).astype(np.float32)
        gamma = np.abs(rng.normal(0.1, 0.1, (C, C))).astype(np.float32)
        params = {"params": {"beta": jnp.asarray(beta), "gamma": jnp.asarray(gamma)}}
        want = highest(
            lambda a: jgdn.GDN(C, inverse=inverse).apply(params, a), jnp.asarray(x)
        )
        mod = tgdn.GDN(C, inverse=inverse)
        with torch.no_grad():
            mod.beta.copy_(torch.from_numpy(beta))
            mod.gamma.copy_(torch.from_numpy(gamma))
        got = nhwc(mod(nchw(x)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_bf16_branch_matches_jax_within_a_bf16_ulp(self):
        """bf16 activations: squares and gamma rounded to bf16, sums in f32;
        the two frameworks may round the final quotient differently by one
        bf16 ulp (2**-8 relative)."""
        rng = np.random.default_rng(9)
        C = 8
        x = rng.normal(0, 1, (1, 4, 4, C)).astype(np.float32)
        params = jgdn.GDN(C, dtype=jnp.bfloat16).init(
            jax.random.PRNGKey(0), jnp.asarray(x, jnp.bfloat16)
        )
        want = highest(
            lambda a: jgdn.GDN(C, dtype=jnp.bfloat16).apply(params, a).astype(jnp.float32),
            jnp.asarray(x, jnp.bfloat16),
        )
        mod = tgdn.GDN(C)
        got = nhwc(mod(nchw(x).to(torch.bfloat16)).float())
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


class TestRateMath:
    def test_laplace_likelihood_and_bits(self):
        rng = np.random.default_rng(10)
        x = np.round(rng.normal(0, 4, (2, 3, 5, 7))).astype(np.float32)
        scale = np.exp(rng.normal(0, 2, x.shape)).astype(np.float32)
        scale[0, 0, 0, :3] = [0.0, 1e-7, 1e12]  # both clamps
        want = np.asarray(jmath.laplace_likelihood(jnp.asarray(x), jnp.asarray(scale)))
        got = tmath.laplace_likelihood(torch.from_numpy(x), torch.from_numpy(scale)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        bits_want = float(jmath.bits_estimate(jnp.asarray(want)))
        bits_got = float(tmath.bits_estimate(torch.from_numpy(got)))
        assert abs(bits_got - bits_want) <= 1e-5 * bits_want

    def test_gaussian_likelihood(self):
        rng = np.random.default_rng(21)
        x = rng.normal(0, 4, (2, 3, 5, 7)).astype(np.float32)
        mean = rng.normal(0, 2, x.shape).astype(np.float32)
        scale = np.exp(rng.normal(0, 1.5, x.shape)).astype(np.float32)
        scale[0, 0, 0, :2] = [0.0, 0.05]  # the scale bound
        x[0, 0, 1, :2] = [40.0, -60.0]  # the likelihood bound
        want = np.asarray(jmath.gaussian_likelihood(
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(mean)))
        got = tmath.gaussian_likelihood(
            torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(mean)).numpy()
        assert want.min() == np.float32(1e-9)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)

    def test_gaussian_conditional(self):
        rng = np.random.default_rng(22)
        x = rng.normal(0, 4, (2, 4, 6, 5)).astype(np.float32)
        mean = rng.normal(0, 2, x.shape).astype(np.float32)
        scale = np.exp(rng.normal(0, 1.5, x.shape)).astype(np.float32)
        jx_hat, jlik = jgauss.GaussianConditional()(
            jnp.asarray(x), jnp.asarray(scale), means=jnp.asarray(mean))
        tx_hat, tlik = tgauss.GaussianConditional()(nchw(x), nchw(scale), nchw(mean))
        np.testing.assert_array_equal(nhwc(tx_hat), np.asarray(jx_hat))
        np.testing.assert_allclose(nhwc(tlik), np.asarray(jlik), rtol=1e-5, atol=0)

    def test_entropy_bottleneck(self):
        """Eval forward with seeded parameters away from their initial
        values (medians off zero, non-zero factors) carried by the loader."""
        rng = np.random.default_rng(23)
        C = 6
        jmod = jfac.EntropyBottleneck(C)
        shapes = jax.eval_shape(lambda k, a: jmod.init(k, a, training=False),
                                jax.random.PRNGKey(0), jnp.zeros((1, 2, 2, C)))
        params = jax.tree_util.tree_map(
            lambda leaf: rng.normal(0, 0.7, leaf.shape).astype(np.float32), shapes)
        params["params"]["quantiles"][:, 0, 1] = rng.uniform(-0.5, 0.5, C)
        x = rng.normal(0, 3, (2, 3, 5, C)).astype(np.float32)
        jx_hat, jlik = jmod.apply(params, jnp.asarray(x), training=False)
        tmod = load_params(tfac.EntropyBottleneck(C), params)
        with torch.no_grad():
            tx_hat, tlik = tmod(nchw(x))
        np.testing.assert_allclose(nhwc(tx_hat), np.asarray(jx_hat), rtol=0, atol=1e-6)
        np.testing.assert_allclose(nhwc(tlik), np.asarray(jlik), rtol=1e-5, atol=0)

    def test_quantize_rounds_half_to_even_like_jax(self):
        """Equal to JAX's eval-time quantize and to its straight-through
        quantize_ste, which the SSF hyperprior calls."""
        x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49, -0.51, 1e6 + 0.5], np.float32)
        got = tmath.quantize(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jmath.quantize(x, False)))
        np.testing.assert_array_equal(got, np.asarray(jmath.quantize_ste(x)))

    def test_lower_bound_value_and_gradient(self):
        x = np.array([-1.0, 0.05, 0.2, 3.0], np.float32)
        g = np.array([1.0, -1.0, 1.0, 1.0], np.float32)
        _, vjp = jax.vjp(lambda a: jmath.lower_bound(a, 0.1), jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        y = tmath.lower_bound(xt, 0.1)
        y.backward(torch.from_numpy(g))
        np.testing.assert_array_equal(y.detach().numpy(), np.maximum(x, 0.1))
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
