"""Ops of the PyTorch port against the JAX package, on the CPU, in float32.

The same numpy-seeded inputs go through both. The port is NCHW and the JAX
package NHWC; each comparison transposes the port's output. The JAX side
runs under default_matmul_precision("highest"). Tolerances:

- layout ops (s2d/d2s) are permutations: exact;
- pools, upsamples and warps: 1e-5 absolute (inputs in [0, 1]), a few
  float32 ulps of different summation and fusion order;
- GDN, Laplace likelihood and bits: 1e-5 relative to the output scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideocodec_torch.ops import gdn as tgdn
from fastvideocodec_torch.ops import math as tmath
from fastvideocodec_torch.ops import warp as twarp
from fastvideocodec_torch.ops.kernels import warp as kwarp
from fastvideocodec_tpu.ops import gdn as jgdn
from fastvideocodec_tpu.ops import math as jmath
from fastvideocodec_tpu.ops import warp as jwarp

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

    def test_quantize_rounds_half_to_even_like_jax(self):
        x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49, -0.51], np.float32)
        np.testing.assert_array_equal(
            tmath.quantize(torch.from_numpy(x)).numpy(), np.asarray(jmath.quantize(x, False))
        )

    def test_lower_bound_value_and_gradient(self):
        x = np.array([-1.0, 0.05, 0.2, 3.0], np.float32)
        g = np.array([1.0, -1.0, 1.0, 1.0], np.float32)
        _, vjp = jax.vjp(lambda a: jmath.lower_bound(a, 0.1), jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        y = tmath.lower_bound(xt, 0.1)
        y.backward(torch.from_numpy(g))
        np.testing.assert_array_equal(y.detach().numpy(), np.maximum(x, 0.1))
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
