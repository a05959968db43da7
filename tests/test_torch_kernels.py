"""The warp kernels' wrappers: their autograd Function, the dispatch rule and
the host-side tile rule on the CPU; on a CUDA card, the tiled kernels'
exactness and the Function's gradients.

The file imports nothing of JAX, so its ``gpu`` tests run on a card whose
machine has none (the suite's conftest imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels.py

Inputs are numpy-seeded. Tolerances: the Function against autograd
through the plain version on the CPU, exact (the same ops on the same
inputs); on the card, 1e-5 relative and absolute in float32 and 2e-2
of the largest value in bfloat16, since the image gradient is a
scatter-add whose atomic summation order may change from run to run; the
tiled kernels against their plain versions, exact (max abs 0).
"""

import numpy as np
import pytest
import torch

from fastvideocodec_torch.ops import warp as twarp
from fastvideocodec_torch.ops.kernels import warp as kwarp

# name: (image shape, flow shape) at a small size, s2d form where the kernel takes it
SHAPES = {
    "flow_warp": ((2, 3, 12, 20), (2, 2, 12, 20)),
    "flow_warp_s2d": ((2, 12, 6, 10), (2, 2, 12, 20)),
    "pixel_warp": ((2, 5, 12, 20), (2, 2, 12, 20)),
    "pixel_warp_s2d": ((2, 12, 6, 10), (2, 2, 12, 20)),
    "pixel_warp_s2d_sflow": ((2, 12, 6, 10), (2, 8, 6, 10)),
}
TILED = ("flow_warp", "flow_warp_s2d")


def inputs(name, rng, dtype=torch.float32, device="cpu", spread=150.0):
    """Image in [0, 1), a flow of small motion plus up to +-spread px
    (samples off the frame), float32 for the pixel warps, and a cotangent."""
    img_shape, flow_shape = SHAPES[name]
    img = torch.from_numpy(rng.random(img_shape, dtype=np.float32))
    flow = rng.normal(0, 3, flow_shape) + rng.uniform(-spread, spread, flow_shape)
    flow = torch.from_numpy(flow.astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 1, img_shape).astype(np.float32))
    flow_dtype = torch.float32 if name.startswith("pixel") else dtype
    return img.to(device, dtype), flow.to(device, flow_dtype), g.to(device, dtype)


def grads(fn, img, flow, g):
    img = img.detach().requires_grad_()
    flow = flow.detach().requires_grad_()
    return torch.autograd.grad(fn(img, flow), [img, flow], g)


@pytest.mark.parametrize("name", list(SHAPES))
def test_function_gradients_are_the_plain_versions(name, monkeypatch):
    """KernelWarp with its launcher replaced by the plain version: its
    forward and its input gradients equal autograd through the plain
    version exactly."""
    monkeypatch.setattr(kwarp, f"launch_{name}", twarp.PLAIN[name])
    img, flow, g = inputs(name, np.random.default_rng(40))
    got = grads(lambda i, f: twarp.KernelWarp.apply(name, i, f), img, flow, g)
    want = grads(twarp.PLAIN[name], img, flow, g)
    for t, w in zip(got, want):
        torch.testing.assert_close(t, w, rtol=0, atol=0)
    torch.testing.assert_close(twarp.KernelWarp.apply(name, img, flow),
                               twarp.PLAIN[name](img, flow), rtol=0, atol=0)
    # only the image's gradient asked for
    i = img.detach().requires_grad_()
    (gi,) = torch.autograd.grad(twarp.KernelWarp.apply(name, i, flow), [i], g)
    torch.testing.assert_close(gi, want[0], rtol=0, atol=0)


DISPATCHERS = {
    "flow_warp": twarp.flow_warp,
    "flow_warp_s2d": twarp.flow_warp_fullres_s2d,
    "pixel_warp": twarp.pixel_warp,
    "pixel_warp_s2d": twarp.pixel_warp_s2d,
    "pixel_warp_s2d_sflow": twarp.pixel_warp_s2d_sflow,
}


@pytest.mark.parametrize("name", list(SHAPES))
def test_dispatch_takes_the_function_only_for_a_gradient(name, monkeypatch):
    """Off the CPU (meta tensors stand in for the card's) a dispatcher calls
    the launcher through KernelWarp when grad mode is on and an input needs
    a gradient, and the bare launcher otherwise; the launch count is the
    launcher's alone."""
    calls = []

    def fake_launcher(img, flow):
        calls.append(name)
        return torch.empty_like(img)

    monkeypatch.setattr(kwarp, f"launch_{name}", fake_launcher)
    img_shape, flow_shape = SHAPES[name]
    img = torch.empty(img_shape, device="meta")
    flow = torch.empty(flow_shape, device="meta")
    fn = DISPATCHERS[name]
    assert fn(img, flow).grad_fn is None
    out = fn(img.requires_grad_(), flow)
    assert type(out.grad_fn).__name__ == "KernelWarpBackward"
    with torch.no_grad():
        assert fn(img, flow).grad_fn is None
    with torch.inference_mode():
        assert fn(img, flow).grad_fn is None
    assert calls == [name] * 4


def smooth_flow(rng, shape, amplitude=3.0):
    """A smooth field: a constant shift of up to 10 px plus a slow wave of
    the given amplitude."""
    B, _, H, W = shape
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    out = np.empty(shape, np.float32)
    for b in range(B):
        for c in range(2):
            shift = rng.uniform(-10, 10)
            phase = rng.uniform(0, 2 * np.pi)
            out[b, c] = shift + amplitude * np.sin(xx / 17.0 + phase) * np.cos(yy / 13.0)
    return out


def random_flow(rng, shape):
    return rng.uniform(-200, 200, shape).astype(np.float32)


def mixed_flow(rng, shape):
    """Smooth on the top half of the frame, +-200 px random on the bottom."""
    out = smooth_flow(rng, shape)
    H = shape[-2]
    out[..., H // 2:, :] = random_flow(rng, out[..., H // 2:, :].shape)
    return out


FLOWS = {"smooth": smooth_flow, "random": random_flow, "mixed": mixed_flow}


def tiled_case(name, shape, kind, rng, dtype, device="cpu"):
    """(img, flow) for tiled kernel ``name`` at full-res [B, C, H, W]."""
    B, C, H, W = shape
    img = torch.from_numpy(rng.random((B, C, H, W), dtype=np.float32))
    if name == "flow_warp_s2d":
        img = twarp.space_to_depth(img)
    flow = torch.from_numpy(FLOWS[kind](rng, (B, 2, H, W)))
    return img.to(device, dtype).contiguous(), flow.to(device, dtype).contiguous()


def share_of(img, flow):
    staged, tiles = twarp.staged_tiles(img, flow)
    return staged / tiles


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_staged_tile_share_follows_the_flow(dtype):
    """The host's copy of the s2d kernel's staging rule: every tile of a
    smooth field fits its budget, no tile of a +-200 px random one does,
    and a field smooth on the top half of the frame and random on the
    bottom stages the top's tiles, in either dtype (the budget is in
    elements)."""
    rng = np.random.default_rng(41)
    shape = (1, 3, 64, 512)
    share = {kind: share_of(*tiled_case("flow_warp_s2d", shape, kind, rng, dtype))
             for kind in FLOWS}
    assert share["smooth"] == 1.0
    assert share["random"] == 0.0
    assert share["mixed"] == 0.5


def test_staged_tile_share_counts_ragged_tiles_and_f32():
    """Tiles over a ragged edge count once each (8 x 128 s2d positions);
    float32 and bfloat16 share the rule (its budget is in elements)."""
    rng = np.random.default_rng(42)
    for dtype in (torch.float32, torch.bfloat16):
        img, flow = tiled_case("flow_warp_s2d", (1, 3, 38, 150), "smooth", rng, dtype)
        assert twarp.staged_tiles(img, flow) == (3, 3)
        img, flow = tiled_case("flow_warp_s2d", (2, 3, 40, 520), "smooth", rng, dtype)
        assert twarp.staged_tiles(img, flow) == (2 * 3 * 3, 2 * 3 * 3)


def test_tile_rule_reads_the_kernel_source(tmp_path, monkeypatch):
    """The host's tile and budget are warp.cu's own numbers, read from the
    source the kernels are built from: a source with other numbers gives
    another rule."""
    k = kwarp.tile_constants()
    assert (k["kAlign"], k["kS2dRows"], k["kS2dCols"]) == (8, 8, 128)
    assert k["kS2dStageElems"] * 2 <= 48 * 1024  # bf16 stage under the default limit
    source = tmp_path / "warp.cu"
    source.write_text(kwarp.build.SOURCE.read_text().replace(
        f"kS2dStageElems = {k['kS2dStageElems']};", "kS2dStageElems = 0;"))
    monkeypatch.setattr(kwarp.build, "SOURCE", source)
    kwarp.tile_constants.cache_clear()
    try:
        assert kwarp.tile_constants()["kS2dStageElems"] == 0
        img, flow = tiled_case("flow_warp_s2d", (1, 3, 64, 512), "smooth",
                               np.random.default_rng(46), torch.bfloat16)
        assert twarp.staged_tiles(img, flow) == (0, 8)
    finally:
        kwarp.tile_constants.cache_clear()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# full-res [B, C, H, W]: H and W off the tiles; rows odd (masked scalar
# edges), even but off a multiple of 8 (pair vectors, no 16-byte copies) or
# on it; the last holds whole tiles. The s2d kernel's rows are W/2 wide.
RAGGED = {
    "flow_warp": [(2, 3, 37, 141), (1, 3, 40, 268), (3, 3, 18, 34), (1, 3, 64, 512)],
    "flow_warp_s2d": [(2, 3, 38, 150), (1, 3, 40, 264), (3, 3, 18, 36), (1, 3, 64, 512)],
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", list(FLOWS))
@pytest.mark.parametrize("name", TILED)
def test_tiled_kernels_are_exact(card, name, kind, dtype):
    """The tiled kernels equal their plain versions bit for bit, on ragged
    shapes, with smooth, random and mixed flows: for flow_warp_s2d every
    tile staged (smooth), none (random) and both in one launch (mixed)."""
    rng = np.random.default_rng(43)
    launch = getattr(kwarp, f"launch_{name}")
    for shape in RAGGED[name]:
        img, flow = tiled_case(name, shape, kind, rng, dtype, "cuda")
        if name == "flow_warp_s2d" and (kind == "smooth" or shape == RAGGED[name][-1]):
            share = share_of(img, flow)  # small images fit whole
            assert share == {"smooth": 1.0, "random": 0.0, "mixed": 0.5}[kind], (shape, share)
        got = launch(img, flow)
        torch.cuda.synchronize()
        want = twarp.PLAIN[name](img, flow)
        assert torch.equal(got, want), (shape, (got.float() - want.float()).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("name", TILED)
def test_tiled_kernels_stage_around_a_nan_flow(card, name):
    """A NaN in a smooth flow: the kernel reads index 0 for it (the plain
    version gives NaN there, ROADMAP section 3, Open 1), so flow_warp_s2d's
    staged footprint must reach index 0 for that tile. Every output where
    the plain version is not NaN equals it bit for bit."""
    rng = np.random.default_rng(45)
    img, flow = tiled_case(name, (1, 3, 64, 512), "smooth", rng, torch.float32, "cuda")
    flow[0, :, 5, 7] = float("nan")
    got = getattr(kwarp, f"launch_{name}")(img, flow)
    torch.cuda.synchronize()
    want = twarp.PLAIN[name](img, flow)
    nan = want.isnan()
    assert bool(nan.any())
    assert torch.equal(got[~nan], want[~nan])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(SHAPES))
def test_gradients_on_the_card(card, name, dtype):
    """loss.backward() through each dispatcher on the card gives the image
    and the flow the gradients of autograd through the plain version, and
    the forward still went through the kernel. In bfloat16 the flows span
    +-8 px: the image gradient is a bf16 scatter-add rounded in its atomic
    order, and +-150 px flows pile hundreds of samples onto the border
    pixels, whose sums that order then moves by several ulps."""
    spread = 150.0 if dtype == torch.float32 else 8.0
    img, flow, g = inputs(name, np.random.default_rng(44), dtype, "cuda", spread)
    kwarp.reset_launches()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        got = grads(DISPATCHERS[name], img, flow, g)
        want = grads(twarp.PLAIN[name], img, flow, g)
    finally:
        torch.use_deterministic_algorithms(False)
    assert kwarp.LAUNCHES[name] == 1
    for t, w in zip(got, want):
        assert t.dtype == w.dtype and bool(torch.isfinite(t).all())
        if dtype == torch.float32:
            torch.testing.assert_close(t, w, rtol=1e-5, atol=1e-5)
        else:
            torch.testing.assert_close(t.float(), w.float(), rtol=2e-2,
                                       atol=2e-2 * float(w.float().abs().max()))
