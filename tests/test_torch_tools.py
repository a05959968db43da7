"""The port's last library modules and offline tools against the JAX
package's, on the CPU, float32, at tiny sizes.

- ``utils/flowviz.py``: ``flow_to_image`` bit for bit (host numpy in both),
  ``.flo`` files read and written across the packages.
- ``ops/warp.py:warp_volume_pyramid``: the value within WARP_ATOL of JAX's
  exact gather path, and its flow gradient (through autograd of the plain
  pixel warps) within GRAD_REL of its max |grad| of JAX's.
- ``layers/contextvp.py``: ContextVP and VPCT on JAX's initial parameters
  (flax layout, carried by ``weights.load_params``) within CVP_ATOL, the
  causality of the shifted prediction, and JAX's own causality test.
- The three knobs without a registry name: ``GaussianConditional`` without
  means, ``ScaleSpaceFlow(s2d=2, pipeline_s2d=False)`` and MCVC-IA's
  ``use_attn=False``, each on JAX's parameters against JAX's module.
- ``tools/train_parity.py:CardBranches``: the clamps' sides recorded and
  replayed (a replay of a run's own record changes nothing; a replay of
  another side follows it).
- ``tools/price_hd.py``: its held-out clips are JAX's; a config whose
  checkpoints are missing prints a JSON skip line and the tool goes on.
- ``tools/speed_sweep.py`` on LSVC-TPU-TINY at 64x64, GOP 2 and 4, on the
  CPU, with JAX's keys; ``gop/graph.py``'s tree equal to JAX's at every GOP
  of the sweep; ``tools/warp_bench.py``'s cases JAX's.
The port side runs on one torch thread (``one_torch_thread``).
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.layers import ContextVP, VPCT
from fastvideocodec_torch.ops import warp as twarp
from fastvideocodec_torch.utils import flowviz as tfv
from fastvideocodec_torch.weights import flatten_params, load_params
from fastvideocodec_tpu.ops import warp as jwarp
from fastvideocodec_tpu.utils import flowviz as jfv
from test_torch_train_common import one_torch_thread  # noqa: F401 (autouse here)

REPO = Path(__file__).resolve().parents[1]
WARP_ATOL = 1e-5  # tests/test_torch_ops.py's bar for the exact warps
GRAD_REL = 1e-4  # of the flow gradient's max |grad|
CVP_ATOL = 2e-5  # ContextVP: float32 attention, its scores summed in another order
KNOB_ATOL = 1e-4  # a whole tiny model's forward, float32


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t) -> np.ndarray:
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# flowviz
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_flow", [None, 0.0, 7.5])
def test_flow_to_image_is_jax_bit_for_bit(max_flow):
    rng = np.random.default_rng(0)
    flow = (rng.normal(0, 4, (37, 53, 2)) * rng.random((37, 53, 1))).astype(np.float32)
    flow[0, 0] = 0.0
    got = tfv.flow_to_image(flow, max_flow)
    want = jfv.flow_to_image(flow, max_flow)
    assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
    assert np.array_equal(got, want)
    assert np.array_equal(tfv._color_wheel(), jfv._color_wheel())


def test_flo_round_trip_across_packages(tmp_path):
    flow = np.random.default_rng(1).normal(0, 3, (20, 31, 2)).astype(np.float32)
    tfv.write_flo(str(tmp_path / "a.flo"), flow)
    jfv.write_flo(str(tmp_path / "b.flo"), flow)
    assert (tmp_path / "a.flo").read_bytes() == (tmp_path / "b.flo").read_bytes()
    for reader in (tfv.read_flo, jfv.read_flo):
        assert np.array_equal(reader(str(tmp_path / "a.flo")), flow)
    (tmp_path / "c.flo").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError):
        tfv.read_flo(str(tmp_path / "c.flo"))


# ---------------------------------------------------------------------------
# warp_volume_pyramid
# ---------------------------------------------------------------------------


def pyramid_inputs(B=2, H=16, W=24, C=3, levels=5, seed=3):
    rng = np.random.default_rng(seed)
    level0 = rng.random((B, H, W, C), dtype=np.float32)
    vol_half = rng.random((B, H // 2, W // 2, levels * C), dtype=np.float32)
    # flows up to +-10 px (normalized: / (W/2), (H/2)), scales over every level
    flow = (rng.uniform(-10, 10, (B, H, W, 2)) / np.asarray([W / 2, H / 2])).astype(np.float32)
    scale = rng.uniform(-1.2, 1.2, (B, H, W, 1)).astype(np.float32)
    return level0, vol_half, flow, scale


def test_warp_volume_pyramid_and_its_flow_gradient_match_jax():
    level0, vol_half, flow, scale = pyramid_inputs()
    weight = np.random.default_rng(4).normal(size=level0.shape).astype(np.float32)

    def jfn(f):
        with jwarp.exact_warp():
            out = jwarp.warp_volume_pyramid(jnp.asarray(level0), jnp.asarray(vol_half), f,
                                            jnp.asarray(scale), 5)
        return jnp.sum(out * weight), out

    with jax.default_matmul_precision("highest"):
        (_, want), jgrad = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(flow))
    tflow = nchw(flow).requires_grad_(True)
    out = twarp.warp_volume_pyramid(nchw(level0), nchw(vol_half), tflow, nchw(scale), 5)
    (out * nchw(weight)).sum().backward()
    np.testing.assert_allclose(nhwc(out), np.asarray(want), rtol=0, atol=WARP_ATOL)
    g, w = nhwc(tflow.grad), np.asarray(jgrad)
    assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max(), np.abs(g - w).max()


def test_warp_volume_pyramid_launches_two_pixel_warps(monkeypatch):
    """Off the CPU every tensor goes to the kernels: two pixel_warp
    launches (level 0 and the half-res stack), no plain warp."""
    calls = []
    monkeypatch.setattr(twarp, "_dispatch", lambda name, img, flow: (
        calls.append((name, tuple(img.shape))), twarp.PLAIN[name](img, flow))[1])
    level0, vol_half, flow, scale = pyramid_inputs(B=1)
    twarp.warp_volume_pyramid(nchw(level0), nchw(vol_half), nchw(flow), nchw(scale), 5)
    assert calls == [("pixel_warp", (1, 3, 16, 24)), ("pixel_warp", (1, 15, 8, 12))]


# ---------------------------------------------------------------------------
# ContextVP / VPCT
# ---------------------------------------------------------------------------


def jax_contextvp(out_channels=8, num_views=2, width=4, height=4, C=8, B=2, seed=0):
    from fastvideocodec_tpu.layers import ContextVP as JContextVP

    m = JContextVP(out_channels=out_channels, num_views=num_views, width=width, height=height)
    x = np.random.default_rng(seed).normal(size=(B * num_views, height, width, C))
    x = x.astype(np.float32)
    params = jax.jit(m.init)(jax.random.PRNGKey(seed), jnp.asarray(x))
    return m, params, x


def test_contextvp_matches_jax_on_its_parameters():
    m, params, x = jax_contextvp()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(m.apply)(params, jnp.asarray(x)))
    port = ContextVP(in_channels=8, out_channels=8, num_views=2, width=4, height=4)
    load_params(port, params)
    got = nhwc(port(nchw(x)))
    assert got.shape == want.shape == (4, 4, 4, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=CVP_ATOL)
    assert set(flatten_params(params)) >= {"params/VPCT_0/wpe", "params/VPCT_0/param_token"}


def test_vpct_matches_jax_and_is_causal():
    from fastvideocodec_tpu.layers.contextvp import VPCT as JVPCT

    B, T, V, O = 2, 12, 6, 5
    idx = np.random.default_rng(2).normal(size=(B, T, V)).astype(np.float32)
    jm = JVPCT(vocab_size=V, block_size=16, out_size=O, n_layer=2)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(idx))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(idx)))
    port = VPCT(vocab_size=V, block_size=16, out_size=O, n_layer=2)
    load_params(port, params)
    got = port(torch.from_numpy(idx)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CVP_ATOL)
    # the prediction at token t reads tokens < t only: a change at token 7
    # leaves tokens 0..7 as they were and moves token 8
    idx2 = idx.copy()
    idx2[:, 7] += 100.0
    got2 = port(torch.from_numpy(idx2)).detach().numpy()
    np.testing.assert_array_equal(got2[:, :8], got[:, :8])
    assert np.abs(got2[:, 8] - got[:, 8]).max() > 1e-3
    np.testing.assert_array_equal(got[:, 0], np.broadcast_to(port.param_token.detach()[0, 0],
                                                             (B, O)))


def test_contextvp_causality_as_jax_tests_it():
    """JAX's tests/test_aux.py:52-67 on the port: output token 0 does not
    move when the last pixel of every view does."""
    _, params, x = jax_contextvp()
    port = ContextVP(in_channels=8, out_channels=8, num_views=2, width=4, height=4)
    load_params(port, params)
    y = port(nchw(x)).detach()
    x2 = x.copy()
    x2[:, 3, 3, :] += 100.0
    y2 = port(nchw(x2)).detach()
    first = nhwc(y).reshape(2, 32, 8)[:, 0]
    first2 = nhwc(y2).reshape(2, 32, 8)[:, 0]
    np.testing.assert_allclose(first, first2, atol=1e-5)


def test_causal_attention_cpu_form_is_sdpa():
    """The CPU's plain form against PyTorch's fused causal SDPA (the card's
    form) on the same inputs."""
    from fastvideocodec_torch.layers.contextvp import causal_attention

    q, k, v = torch.randn(3, 2, 3, 20, 16).unbind(0)
    want = torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True)
    torch.testing.assert_close(causal_attention(q, k, v), want, rtol=0, atol=CVP_ATOL)


# ---------------------------------------------------------------------------
# the three knobs without a caller
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("training", [False, True])
def test_gaussian_conditional_without_means_matches_jax(training):
    from fastvideocodec_torch.entropy.gaussian import GaussianConditional as TGC
    from fastvideocodec_tpu.entropy.gaussian import GaussianConditional as JGC

    rng = np.random.default_rng(5)
    x = (rng.normal(0, 3, (2, 6, 5, 7))).astype(np.float32)
    scales = rng.uniform(0.05, 4, x.shape).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jx, jl = JGC()(jnp.asarray(x), jnp.asarray(scales), None, training=training, rng=key)
    noise = np.asarray(jax.random.uniform(key, x.shape, minval=-0.5, maxval=0.5))
    tx, tl = TGC()(nchw(x), nchw(scales), None, training=training,
                   noise=lambda t: nchw(noise))
    np.testing.assert_allclose(nhwc(tx), np.asarray(jx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(nhwc(tl), np.asarray(jl), rtol=1e-5, atol=1e-7)
    if not training:
        assert np.array_equal(nhwc(tx), np.round(x))


def jax_init(module, *args, seed=0):
    return jax.jit(lambda k, *a: module.init({"params": k}, *a, training=False))(
        jax.random.PRNGKey(seed), *args)


def test_ssf_s2d_without_pipeline_matches_jax():
    from fastvideocodec_torch.models.ssf import ScaleSpaceFlow as TSSF
    from fastvideocodec_tpu.models.ssf import ScaleSpaceFlow as JSSF

    frames = ft.data.synthetic.synth_gop(np.random.default_rng(0), size=64, gop=2)[:, None]
    jm = JSSF(mid_planes=32, planes=48, s2d=2, pipeline_s2d=False)
    params = jax_init(jm, jnp.asarray(frames))
    with jax.default_matmul_precision("highest"), jwarp.exact_warp():
        want, jliks = jax.jit(lambda p, f: jm.apply(p, f, training=False))(
            params, jnp.asarray(frames))
    port = TSSF(mid_planes=32, planes=48, s2d=2, pipeline_s2d=False)
    assert not port.pipeline_s2d and TSSF(s2d=2).pipeline_s2d  # the registry's SSF-TPU
    load_params(port, params)
    with torch.no_grad():
        got, liks = port(torch.from_numpy(frames).permute(0, 1, 4, 2, 3))
    np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(), np.asarray(want), rtol=0,
                               atol=KNOB_ATOL)
    assert len(liks) == len(jliks) == 2
    for lik, jlik in zip(liks, jliks):
        for name in jlik:
            for part in ("y", "z"):
                np.testing.assert_allclose(nhwc(lik[name][part]), np.asarray(jlik[name][part]),
                                           rtol=1e-3, atol=1e-5)
    # the same shapes as SSF-TPU-TINY's, only the channel order differs
    tiny = ft.get_codec_model("SSF-TPU-TINY", device="meta").module
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in tiny.state_dict().items()}


def test_mcvc_ia_without_attention_matches_jax():
    from fastvideocodec_torch.data.synthetic import synth_mv_gop
    from fastvideocodec_tpu.models import get_codec_model as jget

    frames = synth_mv_gop(np.random.default_rng(0), views=3, size=64, gop=2)
    mask = np.asarray([1, 1, 0], np.float32)
    jspec = jget("MCVC-IA-TINY", num_views=3, use_attn=False)
    params = jax_init(jspec.module, jnp.asarray(frames), jnp.asarray(mask))
    with jax.default_matmul_precision("highest"), jwarp.exact_warp():
        want, _, want_refs = jax.jit(lambda p, f, m: jspec.module.apply(
            p, f, m, training=False))(params, jnp.asarray(frames), jnp.asarray(mask))
    spec = ft.get_codec_model("MCVC-IA-TINY", device="cpu", num_views=3, use_attn=False)
    assert not any("ConvAttention" in k for k in spec.module.state_dict())
    load_params(spec.module, params)
    with torch.no_grad():
        got, _, refs = spec.module(torch.from_numpy(frames).permute(0, 1, 4, 2, 3),
                                   torch.from_numpy(mask))
    np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(), np.asarray(want), rtol=0,
                               atol=KNOB_ATOL)
    np.testing.assert_allclose(refs.permute(0, 1, 3, 4, 2).numpy(), np.asarray(want_refs),
                               rtol=0, atol=KNOB_ATOL)
    with_attn = ft.get_codec_model("MCVC-IA-TINY", device="meta", num_views=3)
    assert any("ConvAttention" in k for k in with_attn.module.state_dict())


# ---------------------------------------------------------------------------
# CardBranches: the clamps' sides
# ---------------------------------------------------------------------------


def lsvc_step(replay=None, spoil=None):
    """One LSVC-TPU-TINY training step on tiny_lsvctpu_l2 under
    CardBranches: (gradients, the CardBranches)."""
    from fastvideocodec_torch.data.synthetic import synth_gop
    from fastvideocodec_torch.ops.math import UniformNoise
    from fastvideocodec_torch.tools.train_parity import CardBranches
    from fastvideocodec_torch.train import TrainConfig, gop_loss, ready_for_training

    spec = ft.get_codec_model("LSVC-TPU-TINY", device="cpu")
    ft.load_asset(spec.module, "tiny_lsvctpu_l2")
    params = ready_for_training(spec)
    clip = torch.from_numpy(synth_gop(np.random.default_rng(0), size=64, gop=4)).permute(
        0, 3, 1, 2).contiguous()
    with CardBranches(replay) as branches:
        loss, _ = gop_loss(spec, clip, True, UniformNoise(0), TrainConfig())
        loss.backward()
    return {n: p.grad.clone() for n, p in params.items() if p.grad is not None}, branches


def test_card_branches_record_and_replay_the_clamps():
    grads, card = lsvc_step()
    kinds = [m.dtype for m in card.masks]
    assert torch.int8 in kinds and torch.int32 in kinds and torch.bool in kinds
    warp_axes = [m for m in card.masks if m.dtype == torch.int32]
    assert len(warp_axes) == 2 * 6  # 4 SpyNet levels and GOP 4's 2 tree layers, x and y
    same_grads, same = lsvc_step(card.masks)
    assert same.flips == 0 and set(same.clamp_flips.values()) == {0}
    for n, g in grads.items():
        assert torch.equal(same_grads[n], g), n
    # another run's floor at one coordinate of the first warp axis, and
    # another side of the Laplace scale clamp at one element: followed and
    # counted
    spoiled = [m.clone() for m in card.masks]
    first = next(i for i, m in enumerate(spoiled) if m.dtype == torch.int32)
    spoiled[first][1].view(-1)[5] += 1
    lap = next(i for i, m in enumerate(spoiled) if m.dtype == torch.int8 and m.min() == 0
               and m.max() == 0 and m.dim() == 4)
    spoiled[lap].view(-1)[0] = -1
    moved, other = lsvc_step(spoiled)
    # each counted, and what follows from them may flip more downstream
    assert other.clamp_flips["warp_floor"] >= 1, other.clamp_flips
    assert other.clamp_flips["laplace_scale"] >= 1, other.clamp_flips
    assert any(not torch.equal(moved[n], g) for n, g in grads.items())


def test_border_taps_follow_the_recorded_side_and_floor():
    from fastvideocodec_torch.tools.train_parity import CardBranches

    u = torch.tensor([-0.5, 0.25, 2.999999, 4.5], requires_grad=True)
    with CardBranches() as card:
        twarp._border_taps(u.detach(), 4)
    side, floor = card.masks[0]
    assert side.tolist() == [-1, 0, 0, 1] and floor.tolist() == [0, 0, 2, 3]
    other = card.masks[0].clone()
    other[1, 2] = 3  # the card's coordinate crossed 3
    other[0, 0] = 0  # and the first sat inside
    with CardBranches([other]) as cpu:
        i0, i1, t = twarp._border_taps(u, 4)
    assert cpu.clamp_flips == {"laplace_scale": 0, "prior_abs": 0, "warp_floor": 1,
                               "warp_border": 1}
    assert i0.tolist() == [0, 0, 3, 3] and i1.tolist() == [1, 1, 3, 3]
    (g,) = torch.autograd.grad(t.sum(), [u])
    assert g.tolist() == [1.0, 1.0, 1.0, 0.0]  # the first now passes its gradient


# ---------------------------------------------------------------------------
# the tools
# ---------------------------------------------------------------------------


def test_price_hd_clips_are_jax_held_out_clips():
    from fastvideocodec_torch.tools import price_hd
    from fastvideocodec_tpu.data.synthetic import synth_gop_multi

    rng = np.random.default_rng(123)  # TestHDHeadToHead._clips (tests/test_rd.py:611)
    want = [synth_gop_multi(rng, size=128, gop=8) for _ in range(4)]
    got = price_hd.held_out_clips(device="cpu")
    assert len(got) == 4
    for g, w in zip(got, want):
        assert torch.equal(g, nchw(w))


def test_price_hd_skips_missing_assets_and_goes_on(monkeypatch, capsys, tmp_path):
    from fastvideocodec_torch.tools import price_hd

    seen = []

    def curve(name, family, clips, levels=price_hd.LEVELS, asset_dir=None, device="cuda",
              check=None):
        seen.append((name, family, tuple(levels), asset_dir))
        return [0.1 * (i + 1) for i in range(len(levels))], [30.0 + i for i in range(len(levels))]

    monkeypatch.setattr(price_hd, "curve", curve)
    monkeypatch.setattr(price_hd, "held_out_clips", lambda device: [])
    np.savez(tmp_path / "hd_mine_l2.npz", x=np.zeros(1))
    rows = price_hd.main(["LSVC-TPU-HU", "lsvctpuhu", "LSVC-TPU", "lsvctpuf2", "LSVC-TPU",
                          "mine", "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines == rows and len(rows) == 4
    assert rows[1]["skipped"] == "missing assets" and rows[1]["config"] == "LSVC-TPU-HU"
    assert rows[2]["config"] == "LSVC-TPU" and rows[2]["bd_rate_vs_128"] is not None
    assert rows[3]["skipped"] == "missing assets"  # hd_mine_l0 and _l4 are not shipped
    rows = price_hd.main(["LSVC-TPU", "mine", "--levels", "2", "--asset-dir", str(tmp_path),
                          "--device", "cpu"])
    assert rows[1]["bpp"] == [0.1] and rows[1]["bd_rate_vs_128"] is None
    assert seen[-1] == ("LSVC-TPU", "mine", (2,), str(tmp_path))


def test_speed_sweep_runs_on_the_cpu_with_jax_keys(capsys):
    from fastvideocodec_torch.tools import speed_sweep

    rows = speed_sweep.main(["--codec", "LSVC-TPU-TINY", "--gops", "2", "4", "--h", "64",
                             "--w", "64", "--ssf", "SSF-TINY", "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines == json.loads(json.dumps(rows)) and len(rows) == 3
    for row, gop in zip(rows, (2, 4)):
        assert row["sweep"] == "lsvc_gop" and row["gop"] == gop
        assert {"encdec_fps", "decode_fps", "decode_s_per_frame"} <= set(row)
        assert row["encdec_fps"] > 0 and row["decode_fps"] > 0
    assert rows[2]["sweep"] == "ssf_encode" and {"enc_fps", "s_per_frame"} <= set(rows[2])
    with pytest.raises(SystemExit):
        speed_sweep.main(["--codec", "SSF-TINY", "--gops", "2", "--skip-ssf", "--h", "64",
                          "--w", "64", "--device", "cpu"])


@pytest.mark.parametrize("gop", [2, 4, 8, 16, 30])
def test_tree_schedule_is_jax_at_every_swept_gop(gop):
    from fastvideocodec_torch.gop.graph import tree_schedule
    from fastvideocodec_tpu.gop.graph import tree_schedule as jax_tree_schedule

    got, want = tree_schedule(gop - 1), jax_tree_schedule(gop - 1)
    assert (got.layers, got.parents, got.ref_index) == (want.layers, want.parents,
                                                        want.ref_index)
    port = ft.get_codec_model("LSVC-TPU", device="meta").module.schedule(gop - 1)
    assert sorted(f for layer in port.layers for f in layer) == list(range(1, gop))


def test_warp_bench_cases_are_jax_cases():
    spec = importlib.util.spec_from_file_location("jax_warp_bench",
                                                  REPO / "tools" / "warp_bench.py")
    jwb = importlib.util.module_from_spec(spec)
    sys.modules["jax_warp_bench"] = jwb
    spec.loader.exec_module(jwb)
    from fastvideocodec_torch.tools import warp_bench

    assert [c[:7] for c in warp_bench.CASES] == [c[:7] for c in jwb.CASES]
    assert [str(c[7]).split(".")[-1] for c in warp_bench.CASES] == \
        [jnp.dtype(c[7]).name for c in jwb.CASES]
    img, flow = warp_bench.inputs(1, 8, 12, 3, 56, False, torch.float32, device="cpu")
    assert img.shape == (1, 3, 8, 12) and flow.shape == (1, 2, 8, 12)
    assert float(flow.abs().max()) <= 28.0
