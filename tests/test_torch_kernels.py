"""The warp kernels' wrappers: their autograd Function, the dispatch rule
(every warp's backward goes to its backward kernel off the CPU, never to
the plain vjp), the host-side tile rule, pixel_warp's and the backward
kernels' plan rules (read from warp.cu) and the launchers' checks, forward
and backward (before the library loads), on the CPU; on a CUDA card, the
tiled kernels' exactness (NaN flows included),
flow_warp's kernel and both plans of pixel_warp on ragged shapes, small
frames, NaN flows and unaligned pointers, the Function's gradients
(pixel_warp also at MCVC's 18 channels on 4 views), the five backward
kernels against the plain vjp (image and flow gradients each on and off;
at 1 to 49 channels, at the training steps' shapes, on unaligned pointers
and NaN flows at 18 channels; the flow gradient bit for bit from launch
to launch),
flow_warp at LSVC-TPU-RW's 12 channels and on LSVC-128's 15-frame SpyNet
batch, one ELFVC-SP-TPU-TINY P-frame through both pixel kernels, one
MCVC-IA-TINY P-frame through pixel_warp, and one DVC-TINY and one
RLVC-TINY P-frame through flow_warp (5 launches each).

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
TILED = tuple(SHAPES)  # every kernel is tiled, and equals its plain version bit for bit
S2D = ("flow_warp_s2d", "pixel_warp_s2d", "pixel_warp_s2d_sflow")  # s2d images, one body


def inputs(name, rng, dtype=torch.float32, device="cpu", spread=150.0, shapes=None):
    """Image in [0, 1), a flow of small motion plus up to +-spread px
    (samples off the frame), float32 for the pixel warps, and a cotangent;
    at SHAPES[name] unless ``shapes`` (image, flow) are given."""
    img_shape, flow_shape = shapes or SHAPES[name]
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
    """KernelWarp with its launchers replaced by the plain versions (its
    backward kernel's by the plain vjp): its forward and its input
    gradients equal autograd through the plain version exactly."""
    monkeypatch.setattr(kwarp, f"launch_{name}", twarp.PLAIN[name])
    monkeypatch.setattr(kwarp, f"launch_{name}_backward", twarp.PLAIN_BACKWARD[name])
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


@pytest.mark.parametrize("name", list(SHAPES))
def test_backward_off_the_cpu_is_the_backward_kernel(name, monkeypatch):
    """Every warp has a backward kernel (PLAIN_BACKWARD names all five).
    Off the CPU (meta tensors stand in for the card's) KernelWarp's
    backward launches it with exactly the gradients autograd needs, and
    never reaches the plain vjp."""
    assert set(twarp.PLAIN_BACKWARD) == set(twarp.PLAIN) == set(SHAPES)
    assert set(kwarp.LAUNCHES) == set(SHAPES) | {f"{n}_backward" for n in SHAPES}

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain vjp was taken off the CPU")

    monkeypatch.setattr(twarp, "plain_warp_vjp", no_plain)
    for n in list(twarp.PLAIN_BACKWARD):
        monkeypatch.setitem(twarp.PLAIN_BACKWARD, n, no_plain)
    monkeypatch.setattr(kwarp, f"launch_{name}", lambda img, flow: torch.empty_like(img))
    calls = []

    def fake_backward(img, flow, grad, need_img, need_flow):
        calls.append((need_img, need_flow))
        return (torch.empty_like(img) if need_img else None,
                torch.empty_like(flow) if need_flow else None)

    monkeypatch.setattr(kwarp, f"launch_{name}_backward", fake_backward)
    img_shape, flow_shape = SHAPES[name]
    wanted = [(True, True), (False, True), (True, False)]
    for need_img, need_flow in wanted:
        img = torch.empty(img_shape, device="meta", requires_grad=need_img)
        flow = torch.empty(flow_shape, device="meta", requires_grad=need_flow)
        out = DISPATCHERS[name](img, flow)
        grads = torch.autograd.grad(out, [t for t in (img, flow) if t.requires_grad],
                                    torch.empty_like(out))
        assert [g.shape for g in grads] == [t.shape for t in (img, flow) if t.requires_grad]
    assert calls == wanted


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


def phase_form(flow):
    """A full-res flow [B, 2, H, W] in c-major s2d phase form [B, 8, H/2, W/2]
    (channel comp*4 + 2*ry + rx)."""
    return torch.cat([twarp.space_to_depth(flow[:, :1]), twarp.space_to_depth(flow[:, 1:])], 1)


def tiled_case(name, shape, kind, rng, dtype, device="cpu"):
    """(img, flow) for tiled kernel ``name`` at full-res [B, C, H, W]: the
    image in s2d form for the s2d kernels; the flow float32 for the pixel
    kernels, in phase form (built from the full-res field) for the sflow."""
    B, C, H, W = shape
    img = torch.from_numpy(rng.random((B, C, H, W), dtype=np.float32))
    if name in S2D:
        img = twarp.space_to_depth(img)
    flow = torch.from_numpy(FLOWS[kind](rng, (B, 2, H, W)))
    if name == "pixel_warp_s2d_sflow":
        flow = phase_form(flow)
    flow_dtype = torch.float32 if name.startswith("pixel") else dtype
    return img.to(device, dtype).contiguous(), flow.to(device, flow_dtype).contiguous()


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


# (image shape, plan) of pixel_warp on the paths: the tiled kernel keeps the
# frames from 64K tiled threads up; the small-frame plan takes the rest
PATH_PLANS = [
    ((4, 18, 256, 256), "tiled"),  # MCVC-IA's volume, 4 views (and 2 to 6)
    ((2, 18, 256, 256), "tiled"),
    ((6, 18, 256, 256), "tiled"),
    ((4, 18, 1024, 2048), "tiled"),
    ((1, 15, 512, 1024), "tiled"),  # SSF-TPU's stack
    ((1, 18, 1024, 2048), "tiled"),  # SSF-Official's volume
    ((1, 15, 128, 128), "small"),  # SSF-TPU training's stack
    ((1, 18, 256, 256), "small"),  # ELFVC-SP training's volume, MCVC-IA's 1 view
]


@pytest.mark.parametrize("shape, plan", PATH_PLANS)
def test_plan_rule_on_the_paths(shape, plan):
    """pixel_warp's plan rule keeps the tiled kernel at the paths' frames
    from MCVC's 4 x 18 x 256x256 up and picks the small-frame plan at the
    training warps' and a single view's, in either dtype (the rule reads
    no dtype)."""
    assert kwarp.pixel_warp_plan(*shape) == plan


def test_plan_rule_reads_the_kernel_source(tmp_path):
    """The rule's threshold, block rows and channel group are warp.cu's own
    numbers, read from the source the kernels are built from: a source
    with other numbers gives other plans. The small plan needs its grid
    within CUDA's limits (B x channel groups and row tiles at most
    65535), and no other plan name is taken."""
    k = kwarp.tile_constants()
    assert (k["kTiledMinThreads"], k["kPairRows"], k["kPairFewChunk"], k["kPairManyChunk"],
            k["kGridYZ"]) == (65536, 2, 3, 6, 65535)
    assert k["kTiledMinThreads"] < 132 * 2048  # below one wave of the card's thread slots
    text = kwarp.build.SOURCE.read_text()
    variants = {"never": ("kTiledMinThreads = 65536;", "kTiledMinThreads = 0;"),
                "always": ("kTiledMinThreads = 65536;", "kTiledMinThreads = 1000000000;"),
                "c1": ("kPairManyChunk = 6;", "kPairManyChunk = 1;")}
    consts = {}
    for name, (old, new) in variants.items():
        assert text.count(old) == 1
        variant = text.replace(old, new)
        if name == "c1":  # and small wherever its grid fits
            variant = variant.replace(*variants["always"])
        source = tmp_path / f"{name}.cu"
        source.write_text(variant)
        consts[name] = kwarp.tile_constants(source)
    for shape, plan in PATH_PLANS:
        assert kwarp.pixel_warp_plan(*shape, constants=consts["never"]) == "tiled"
        assert kwarp.pixel_warp_plan(*shape, constants=consts["always"]) == "small"
    # 6,000 frames of 12 channels fit 2 groups each, not 12 of 1 channel;
    # 3 channels take the few-channel group either way
    assert kwarp.pixel_warp_plan(6000, 12, 8, 8, constants=consts["always"]) == "small"
    assert kwarp.pixel_warp_plan(6000, 12, 8, 8, constants=consts["c1"]) == "tiled"
    assert kwarp.pixel_warp_plan(6000, 3, 8, 8, constants=consts["c1"]) == "small"
    assert kwarp.pixel_warp_plan(40000, 6, 8, 8, constants=consts["always"]) == "small"
    assert kwarp.pixel_warp_plan(40000, 7, 8, 8, constants=consts["always"]) == "tiled"
    # rows past the small plan's gridDim.y, and no channels
    assert kwarp.pixel_warp_plan(1, 1, 2 * 65535 + 2, 1, constants=consts["always"]) == "tiled"
    assert kwarp.pixel_warp_plan(1, 0, 8, 8) == "tiled"
    with pytest.raises(KeyError):
        kwarp._pixel_warp(CudaLike((1, 3, 8, 8)), CudaLike((1, 2, 8, 8)), "fast")


class CudaLike:
    """Stands in for a CUDA tensor as far as the launchers' checks read it,
    so that they run without a card."""

    is_cuda = True

    def __init__(self, shape, dtype=torch.float32, contiguous=True, index=0):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.contiguous, self.index = contiguous, index
        self.device = f"cuda:{index}"

    def get_device(self):
        return self.index

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return self.contiguous


def _flow_dtype(name, dtype):
    return torch.float32 if name.startswith("pixel") else dtype


# what makes a launcher's inputs wrong, and the error it raises
BAD_INPUTS = {
    "cpu tensors": ValueError,
    "flow on another card": ValueError,
    "float16 image": TypeError,
    "flow of another dtype": TypeError,
    "flow of another shape": ValueError,
    "image not contiguous": ValueError,
    "flow not contiguous": ValueError,
}


@pytest.mark.parametrize("bad", list(BAD_INPUTS) + ["none"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_launchers_check_before_loading_the_library(name, bad, monkeypatch):
    """Each launcher raises on CPU tensors, tensors on two cards, a wrong
    dtype, a wrong flow shape or non-contiguous inputs before it loads (and
    so builds) the library; inputs that pass every check reach the load."""

    class Loaded(Exception):
        pass

    def load():
        raise Loaded

    monkeypatch.setattr(kwarp.build, "load", load)
    img_shape, flow_shape = SHAPES[name]
    dtype = torch.bfloat16
    flow_dtype = _flow_dtype(name, dtype)
    img, flow = CudaLike(img_shape, dtype), CudaLike(flow_shape, flow_dtype)
    if bad == "cpu tensors":
        img, flow = torch.zeros(img_shape, dtype=dtype), torch.zeros(flow_shape, dtype=flow_dtype)
    elif bad == "flow on another card":
        flow = CudaLike(flow_shape, flow_dtype, index=1)
    elif bad == "float16 image":
        img = CudaLike(img_shape, torch.float16)
    elif bad == "flow of another dtype":
        flow = CudaLike(flow_shape, torch.float16)
    elif bad == "flow of another shape":
        flow = CudaLike((*flow_shape[:3], flow_shape[3] + 1), flow_dtype)
    elif bad == "image not contiguous":
        img = CudaLike(img_shape, dtype, contiguous=False)
    elif bad == "flow not contiguous":
        flow = CudaLike(flow_shape, flow_dtype, contiguous=False)
    with pytest.raises(BAD_INPUTS.get(bad, Loaded)):
        getattr(kwarp, f"launch_{name}")(img, flow)


# (warp, full-res image shape) of the backward kernels on the paths: the
# training steps' (ELFVC-SP's volume, SSF-TPU's and ELFVC-SP-TPU's stack and
# level-0 sample, LSVC-TPU's SpyNet levels and MC warps at 256x256) and the
# largest frames a backward may meet (MCVC's 4 x 18 x 1024x2048 volume,
# LSVC-TPU's and SSF-TPU's warps at 1024x2048)
BACKWARD_PATHS = [
    ("pixel_warp", (1, 18, 256, 256)),
    ("pixel_warp", (4, 18, 256, 256)),  # MCVC's training step: 4 views
    ("pixel_warp", (1, 15, 128, 128)),
    ("pixel_warp_s2d_sflow", (1, 3, 256, 256)),
    ("pixel_warp_s2d", (1, 3, 256, 256)),
    ("flow_warp", (15, 3, 32, 32)),
    ("flow_warp", (15, 3, 64, 64)),
    ("flow_warp", (15, 3, 128, 128)),
    ("flow_warp_s2d", (1, 3, 256, 256)),
    ("flow_warp_s2d", (8, 3, 256, 256)),
    ("pixel_warp", (4, 18, 1024, 2048)),
    ("pixel_warp", (1, 15, 512, 1024)),
    ("pixel_warp_s2d_sflow", (1, 3, 1024, 2048)),
    ("flow_warp_s2d", (1, 3, 1024, 2048)),
    ("flow_warp", (1, 12, 512, 1024)),
]


@pytest.mark.parametrize("name, shape", BACKWARD_PATHS)
def test_backward_plan_on_the_paths(name, shape):
    """At every path shape the backward plan fits: its grid within CUDA's
    limits (gridDim.x below 2**31, gridDim.y and z at most 65535), its
    blocks of 32 to 512 threads (32 x rows x groups), its grid covering
    every output (tiles of 32 columns x rows in NCHW, of 64 columns x rows
    / 2 in s2d), and its channel groups covering C (groups x passes x
    kBwChunk channels, groups not above C's chunks). The training steps'
    frames fill the card: at least 132 blocks, one an SM."""
    k = kwarp.tile_constants()
    B, C, H, W = shape
    s2d = name in S2D
    plan = kwarp.backward_plan(kwarp.BACKWARD_LAYOUTS[name], B, C, H, W)
    assert plan.fits
    gx, gy, gz = plan.grid
    assert gx < 2**31 and gy <= 65535 and gz == B <= 65535
    assert 32 <= 32 * plan.rows * plan.groups <= 512
    assert gx * (64 if s2d else 32) >= W and gy * (plan.rows // 2 if s2d else plan.rows) >= H
    assert plan.rows % 2 == 0 or not s2d
    assert plan.groups * plan.passes * k["kBwChunk"] >= C
    assert plan.groups <= -(-C // k["kBwChunk"])
    if H * W <= 256 * 256 and B == 1:
        assert gx * gy * gz >= 132, plan


MCVC_TRAIN = (4, 18, 256, 256)  # MCVC's training step: the volume of 4 views at 256x256


def test_backward_plan_at_mcvc_training_shape():
    """MCVC's training step warps the 18-channel volume of 4 views of
    256x256: B*H*W alone is 262,144 outputs, two waves of kBwWaveThreads,
    so the plan takes one channel group (its 6 chunks of 3 channels in
    turn) in blocks of 32 x 4 threads over all 4 views: 2048 blocks."""
    plan = kwarp.backward_plan("nchw", *MCVC_TRAIN)
    assert plan.fits
    assert (plan.groups, plan.rows, plan.passes, plan.grid) == (1, 4, 6, (8, 64, 4))
    gx, gy, gz = plan.grid
    assert gx * gy * gz * 32 * plan.rows * plan.groups == 4 * 256 * 256


def test_backward_plan_reads_the_kernel_source(tmp_path):
    """The backward plan's chunk, group cap, block target and wave are
    warp.cu's own numbers, read from the source the kernels are built from:
    a source with other numbers gives other plans. Shapes the kernel does
    not take do not fit: no channel, no image, odd s2d frames, more row
    tiles or images than CUDA's grid holds."""
    k = kwarp.tile_constants()
    assert (k["kBwChunk"], k["kBwMaxGroups"], k["kBwBlockThreads"], k["kBwWaveThreads"]) == (
        3, 8, 128, 131072)
    plan = kwarp.backward_plan("nchw", 1, 15, 128, 128)
    assert (plan.groups, plan.rows, plan.passes, plan.grid) == (5, 1, 1, (4, 128, 1))
    plan = kwarp.backward_plan("nchw", 1, 18, 256, 256)  # two groups fill the wave
    assert (plan.groups, plan.rows, plan.passes, plan.grid) == (2, 2, 3, (8, 128, 1))
    plan = kwarp.backward_plan("phase", 1, 3, 256, 256)
    assert (plan.groups, plan.rows, plan.passes, plan.grid) == (1, 4, 1, (4, 128, 1))
    plan = kwarp.backward_plan("s2d", 1, 18, 128, 64)  # rows at least 2 in s2d
    assert (plan.groups, plan.rows, plan.passes, plan.grid) == (6, 2, 1, (1, 128, 1))
    plan = kwarp.backward_plan("s2d", 2, 18, 256, 256)  # a frame past the wave: one group
    assert (plan.groups, plan.rows, plan.passes, plan.grid) == (1, 4, 6, (4, 128, 2))
    assert kwarp.backward_plan("nchw", 1, 48, 8, 8)[:3] == (8, 1, 2)
    text = kwarp.build.SOURCE.read_text()
    variants = {"c1": ("kBwChunk = 3;", "kBwChunk = 1;"),
                "g2": ("kBwMaxGroups = 8;", "kBwMaxGroups = 2;"),
                "t256": ("kBwBlockThreads = 128;", "kBwBlockThreads = 256;"),
                "w16k": ("kBwWaveThreads = 131072;", "kBwWaveThreads = 16384;")}
    consts = {}
    for name, (old, new) in variants.items():
        assert text.count(old) == 1
        source = tmp_path / f"{name}.cu"
        source.write_text(text.replace(old, new))
        consts[name] = kwarp.tile_constants(source)
    assert kwarp.backward_plan("nchw", 1, 15, 128, 128, consts["c1"])[:3] == (8, 1, 2)
    assert kwarp.backward_plan("nchw", 1, 15, 128, 128, consts["g2"])[:3] == (2, 2, 3)
    assert kwarp.backward_plan("nchw", 1, 15, 128, 128, consts["t256"])[:3] == (5, 1, 1)
    assert kwarp.backward_plan("nchw", 1, 3, 128, 128, consts["t256"])[:3] == (1, 8, 1)
    assert kwarp.backward_plan("nchw", 1, 15, 128, 128, consts["w16k"])[:3] == (1, 4, 5)
    assert not kwarp.backward_plan("nchw", 1, 0, 8, 8).fits
    assert not kwarp.backward_plan("nchw", 0, 3, 8, 8).fits
    assert not kwarp.backward_plan("nchw", 65536, 3, 8, 8).fits
    assert kwarp.backward_plan("nchw", 65535, 3, 8, 8).fits
    assert kwarp.backward_plan("nchw", 1, 3, 9, 33).fits
    for layout in ("s2d", "phase"):
        assert not kwarp.backward_plan(layout, 1, 3, 8, 10 + 1).fits
        assert not kwarp.backward_plan(layout, 1, 3, 8 + 1, 10).fits
    assert kwarp.backward_plan("nchw", 1, 3, 4 * 65535, 8).fits  # 4 rows a block
    assert not kwarp.backward_plan("nchw", 1, 3, 4 * 65535 + 1, 8).fits
    assert kwarp.backward_plan("s2d", 1, 3, 2 * 65535, 8).fits  # 2 full-res rows a tile
    assert not kwarp.backward_plan("s2d", 1, 3, 2 * 65536, 8).fits
    with pytest.raises(ValueError):
        kwarp._backward_args("pixel_warp", 1, 0, 8, 8)


# what makes a backward launcher's incoming gradient wrong (ValueError)
BAD_GRADS = ("grad of another shape", "grad of another dtype", "grad on another card",
             "grad not contiguous")


@pytest.mark.parametrize("bad", list(BAD_INPUTS) + list(BAD_GRADS) + ["none"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_backward_launchers_check_before_loading_the_library(name, bad, monkeypatch):
    """Each backward launcher raises on the forward's bad inputs and on an
    incoming gradient of another shape, dtype or card, or not contiguous,
    before it loads (and so builds) the library; inputs that pass every
    check reach the load."""

    class Loaded(Exception):
        pass

    def load():
        raise Loaded

    monkeypatch.setattr(kwarp.build, "load", load)
    img_shape, flow_shape = SHAPES[name]
    dtype = torch.bfloat16
    flow_dtype = _flow_dtype(name, dtype)
    img, flow = CudaLike(img_shape, dtype), CudaLike(flow_shape, flow_dtype)
    grad = CudaLike(img_shape, dtype)
    if bad == "cpu tensors":
        img, flow = torch.zeros(img_shape, dtype=dtype), torch.zeros(flow_shape, dtype=flow_dtype)
        grad = torch.zeros(img_shape, dtype=dtype)
    elif bad == "flow on another card":
        flow = CudaLike(flow_shape, flow_dtype, index=1)
    elif bad == "float16 image":
        img = grad = CudaLike(img_shape, torch.float16)
    elif bad == "flow of another dtype":
        flow = CudaLike(flow_shape, torch.float16)
    elif bad == "flow of another shape":
        flow = CudaLike((*flow_shape[:3], flow_shape[3] + 1), flow_dtype)
    elif bad == "image not contiguous":
        img = CudaLike(img_shape, dtype, contiguous=False)
    elif bad == "flow not contiguous":
        flow = CudaLike(flow_shape, flow_dtype, contiguous=False)
    elif bad == "grad of another shape":
        grad = CudaLike((*img_shape[:3], img_shape[3] + 1), dtype)
    elif bad == "grad of another dtype":
        grad = CudaLike(img_shape, torch.float32)
    elif bad == "grad on another card":
        grad = CudaLike(img_shape, dtype, index=1)
    elif bad == "grad not contiguous":
        grad = CudaLike(img_shape, dtype, contiguous=False)
    with pytest.raises(BAD_INPUTS.get(bad, ValueError if bad in BAD_GRADS else Loaded)):
        getattr(kwarp, f"launch_{name}_backward")(img, flow, grad, False, True)


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
    # 15 and 7 channels: kPwChunk at a time and a remainder; 18 (MCVC's
    # full-resolution volume) on a batch of 4 views
    "pixel_warp": [(2, 15, 37, 141), (1, 7, 40, 268), (3, 3, 18, 34), (1, 15, 64, 512),
                   (4, 18, 37, 141)],
}
C18 = (4, 18, 37, 141)  # MCVC's volume warp: 6 levels x 3 colours, 4 views
RAGGED["pixel_warp_s2d"] = RAGGED["pixel_warp_s2d_sflow"] = RAGGED["flow_warp_s2d"]


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


# flow_warp's one kernel and each plan of pixel_warp, forced at any shape
VARIANTS = {"flow_warp": lambda img, flow: kwarp.launch_flow_warp(img, flow),
            "pixel_warp tiled": lambda img, flow: kwarp._pixel_warp(img, flow, "tiled"),
            "pixel_warp small": lambda img, flow: kwarp._pixel_warp(img, flow, "small")}
# the small-frame shapes beside RAGGED's: DVC's three SpyNet levels below
# full resolution, MCVC's 4 x 18 x 256x256 volume, a frame smaller than one
# tile, an odd width, and 1, 2, 4, 7 and 18 channels (the few-channel group
# short; the many-channel group short, with a remainder and whole)
SMALL_FRAMES = [(1, 3, 128, 256), (1, 3, 256, 512), (1, 3, 512, 1024), (4, 18, 256, 256),
                (1, 3, 16, 32), (1, 3, 9, 33), (2, 1, 40, 70), (2, 2, 40, 70), (1, 4, 33, 65),
                (1, 7, 24, 200), (3, 18, 20, 50)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", list(FLOWS))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_every_plan_is_exact(card, variant, kind, dtype):
    """flow_warp's kernel and each plan of pixel_warp, whichever the rule
    would pick at the shape, equal the plain version bit for bit on the
    ragged shapes and the small frames, with smooth, random and mixed
    flows."""
    rng = np.random.default_rng(49)
    name = variant.split()[0]
    for shape in RAGGED[name] + SMALL_FRAMES:
        img, flow = tiled_case(name, shape, kind, rng, dtype, "cuda")
        got = VARIANTS[variant](img, flow)
        torch.cuda.synchronize()
        want = twarp.PLAIN[name](img, flow)
        assert torch.equal(got, want), (shape, (got.float() - want.float()).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_every_plan_follows_nan_flows(card, variant, dtype):
    """NaN flows at the first pixel of the first item and the last pixel of
    the last: NaN in every channel of those two outputs, exactly where the
    plain version has NaN, every other output equal bit for bit, on the
    small frames and MCVC's ragged 18 channels."""
    rng = np.random.default_rng(50)
    name = variant.split()[0]
    for shape in SMALL_FRAMES + [C18]:
        B, C, H, W = shape
        img, flow = tiled_case(name, shape, "smooth", rng, dtype, "cuda")
        flow[0, :, 0, 0] = flow[B - 1, :, H - 1, W - 1] = float("nan")
        got = VARIANTS[variant](img, flow)
        torch.cuda.synchronize()
        want = twarp.PLAIN[name](img, flow)
        nan = want.isnan()
        assert int(nan.sum()) == 2 * C, shape
        assert torch.equal(got.isnan(), nan), shape
        assert torch.equal(got[~nan], want[~nan]), shape


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_every_plan_takes_unaligned_pointers(card, variant, dtype):
    """An image or a flow that starts one element past a pair's alignment (a
    contiguous view at an offset into a larger buffer): the kernels leave
    their pair vectors for masked scalar accesses and still equal the
    plain version bit for bit."""
    rng = np.random.default_rng(51)
    name = variant.split()[0]
    for shape in [(1, 3, 128, 256), (4, 18, 64, 64), (1, 3, 16, 32)]:
        img, flow = tiled_case(name, shape, "random", rng, dtype, "cuda")
        want = twarp.PLAIN[name](img, flow)
        for which in ("img", "flow"):
            t = img if which == "img" else flow
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
            moved = buf[1:].view(t.shape)
            moved.copy_(t)
            assert moved.is_contiguous() and moved.data_ptr() % (2 * t.element_size())
            got = VARIANTS[variant](*((moved, flow) if which == "img" else (img, moved)))
            torch.cuda.synchronize()
            assert torch.equal(got, want), (shape, which)


# flow_warp's new callers: LSVC-TPU-RW's rigid MC warp of the s2d reference
# (12 channels at half resolution) and LSVC-128's stock SpyNet over all 15
# P-frames of a GOP in one batch
FLOW_WARP_BATCHES = {"c12": (8, 12, 64, 128), "15_frames": (15, 3, 64, 128)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", list(FLOW_WARP_BATCHES))
def test_flow_warp_new_batches_are_exact(card, batch, dtype):
    """flow_warp at C = 12 on [8, 12, 64, 128] and on a 15-frame batch
    equals its plain version bit for bit on smooth, random and mixed flows;
    with NaN flows at (5, 7) of the first item and (30, 100) of the last,
    NaN in every channel of those outputs exactly where the plain version
    has NaN, every other output equal."""
    rng = np.random.default_rng(48)
    shape = FLOW_WARP_BATCHES[batch]
    B, C = shape[:2]
    for kind in FLOWS:
        img, flow = tiled_case("flow_warp", shape, kind, rng, dtype, "cuda")
        got = kwarp.launch_flow_warp(img, flow)
        torch.cuda.synchronize()
        assert torch.equal(got, twarp.plain_flow_warp(img, flow)), kind
    flow[0, :, 5, 7] = flow[B - 1, :, 30, 100] = float("nan")
    got = kwarp.launch_flow_warp(img, flow)
    torch.cuda.synchronize()
    want = twarp.plain_flow_warp(img, flow)
    nan = want.isnan()
    assert int(nan.sum()) == 2 * C
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got[~nan], want[~nan])


@pytest.mark.gpu
def test_pixel_warp_c18_nan_flow(card):
    """MCVC's shape (18 channels, 4 views, ragged): NaN flows at (5, 7) of
    view 0 and (30, 100) of view 3 give NaN in all 18 channels of those
    outputs, exactly where the plain version has NaN, in float32 and
    bfloat16; every other output equals it bit for bit."""
    rng = np.random.default_rng(47)
    for dtype in (torch.float32, torch.bfloat16):
        img, flow = tiled_case("pixel_warp", C18, "smooth", rng, dtype, "cuda")
        flow[0, :, 5, 7] = flow[3, :, 30, 100] = float("nan")
        got = kwarp.launch_pixel_warp(img, flow)
        torch.cuda.synchronize()
        want = twarp.plain_pixel_warp(img, flow)
        nan = want.isnan()
        assert int(nan.sum()) == 2 * 18
        assert torch.equal(got.isnan(), nan)
        assert torch.equal(got[~nan], want[~nan])


@pytest.mark.gpu
@pytest.mark.parametrize("name", TILED)
def test_tiled_kernels_stage_around_a_nan_flow(card, name):
    """Two NaN pixels in a smooth flow, at full-res (5, 7) and (37, 300):
    each gives NaN in every channel of its output, exactly where the plain
    version has NaN (a NaN weight; ROADMAP section 3, closed fault 3). The
    NaN reads index 0, so flow_warp_s2d's staged footprint must reach it:
    the first tile still stages, the other's box grows past the budget and
    gathers from global memory. Every other output equals the plain
    version bit for bit."""
    rng = np.random.default_rng(45)
    full = "pixel_warp_s2d" if name == "pixel_warp_s2d_sflow" else name
    img, flow = tiled_case(full, (1, 3, 64, 512), "smooth", rng, torch.float32, "cuda")
    flow[0, :, 5, 7] = flow[0, :, 37, 300] = float("nan")
    if name == "pixel_warp_s2d_sflow":
        flow = phase_form(flow).contiguous()
    if name == "flow_warp_s2d":
        assert share_of(img, flow) == 7 / 8
    got = getattr(kwarp, f"launch_{name}")(img, flow)
    torch.cuda.synchronize()
    want = twarp.PLAIN[name](img, flow)
    nan = want.isnan()
    assert int(nan.sum()) == 2 * 3
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got[~nan], want[~nan])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(SHAPES))
def test_gradients_on_the_card(card, name, dtype):
    """loss.backward() through each dispatcher on the card gives the image
    and the flow the gradients of autograd through the plain version, and
    the forward still went through the kernel. Every backward is a kernel
    whose image gradient sums float32 atomics in a run-dependent order.
    float32: within 1e-5 relative and 1e-5 absolute, but the pixel warps'
    image gradient within 5e-5 absolute (+-150 px flows pile hundreds of
    samples of both signs onto a corner, whose sum moved 2.49e-5 at MCVC's
    18 channels, where the plain vjp's deterministic scatter had stood
    before these warps had a backward kernel). In bfloat16 the flows span
    +-8 px: the image gradient is a bf16 scatter-add rounded in its atomic
    order, and +-150 px flows pile hundreds of samples onto the border
    pixels, whose sums that order then moves by several ulps."""
    check_card_gradients(name, SHAPES[name], dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pixel_warp_c18_gradients_on_the_card(card, dtype):
    """As test_gradients_on_the_card, at MCVC's 18 channels on 4 views."""
    B, C, H, W = C18
    check_card_gradients("pixel_warp", ((B, C, H, W), (B, 2, H, W)), dtype)


def check_card_gradients(name, shapes, dtype):
    spread = 150.0 if dtype == torch.float32 else 8.0
    img, flow, g = inputs(name, np.random.default_rng(44), dtype, "cuda", spread, shapes)
    kwarp.reset_launches()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        got = grads(DISPATCHERS[name], img, flow, g)
        want = grads(twarp.PLAIN[name], img, flow, g)
    finally:
        torch.use_deterministic_algorithms(False)
    assert kwarp.LAUNCHES[name] == 1
    for which, t, w in zip(("img", "flow"), got, want):
        assert t.dtype == w.dtype and bool(torch.isfinite(t).all())
        if dtype == torch.float32:
            atol = 5e-5 if which == "img" and name.startswith("pixel_warp") else 1e-5
            torch.testing.assert_close(t, w, rtol=1e-5, atol=atol)
        else:
            torch.testing.assert_close(t.float(), w.float(), rtol=2e-2,
                                       atol=2e-2 * float(w.float().abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("need_img, need_flow", [(True, True), (False, True), (True, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", list(FLOWS))
@pytest.mark.parametrize("name", list(twarp.PLAIN_BACKWARD))
def test_backward_kernels_are_the_plain_vjp(card, name, kind, dtype, need_img, need_flow):
    """Each of the five backward kernels on the ragged shapes and flows of
    the forward's test (pixel_warp at 3, 7, 15 and 18 channels; odd H/2 and
    W/2 for the s2d forms), the image and the flow gradient each on and
    off, against the plain version's vjp on the card: float32 within 1e-5
    relative and 1e-5 of the largest gradient (the image gradient's float32
    atomics sum in an order that changes from run to run). A bfloat16
    kernel sums in float32 and rounds once, so it is held, within 2e-2,
    to the plain vjp of the same (exactly widened) inputs in float32,
    rounded to bfloat16: the bfloat16 plain vjp scatter-adds bfloat16
    terms, and +-200 px flows pile hundreds of them onto a border pixel
    (measured 3.0 apart there); the pixel warps' flow gradient is float32,
    as their flow. A gradient not asked for is None; each call is one
    launch under the backward's own count."""
    rng = np.random.default_rng(45)
    for shape in RAGGED[name]:
        img, flow = tiled_case(name, shape, kind, rng, dtype, "cuda")
        g = torch.from_numpy(rng.normal(0, 1, img.shape).astype(np.float32)).to("cuda", dtype)
        kwarp.reset_launches()
        got = getattr(kwarp, f"launch_{name}_backward")(img, flow, g, need_img, need_flow)
        assert kwarp.LAUNCHES[f"{name}_backward"] == 1
        want = [None if w is None else w.to(t) for w, t in zip(twarp.PLAIN_BACKWARD[name](
            img.float(), flow.float(), g.float(), need_img, need_flow), (dtype, flow.dtype))]
        torch.cuda.synchronize()
        assert (got[0] is None) == (not need_img) and (got[1] is None) == (not need_flow)
        for t, w in zip(got, want):
            if w is None:
                continue
            assert t.dtype == w.dtype and t.shape == w.shape
            scale = float(w.float().abs().max())
            rtol, atol = (1e-5, 1e-5 * scale) if dtype == torch.float32 else (2e-2, 2e-2 * scale)
            torch.testing.assert_close(t.float(), w.float(), rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_pixel_warp_backward_at_mcvc_training_shape(card):
    """pixel_warp's backward kernel at MCVC's training step, 4 x 18 x
    256x256 float32, the flow gradient alone (the volume comes from the
    detached reference): one launch a call, within 1e-5 relative and 1e-5
    of the largest gradient of the plain vjp, and the same flow gradient
    bit for bit over two launches (each output's channel groups add in a
    fixed order)."""
    rng = np.random.default_rng(52)
    img, flow = tiled_case("pixel_warp", MCVC_TRAIN, "smooth", rng, torch.float32, "cuda")
    g = torch.from_numpy(rng.normal(0, 1, MCVC_TRAIN).astype(np.float32)).to("cuda")
    kwarp.reset_launches()
    first = kwarp.launch_pixel_warp_backward(img, flow, g, False, True)
    second = kwarp.launch_pixel_warp_backward(img, flow, g, False, True)
    want = twarp.PLAIN_BACKWARD["pixel_warp"](img, flow, g, False, True)
    torch.cuda.synchronize()
    assert kwarp.LAUNCHES["pixel_warp_backward"] == 2
    assert first[0] is None and second[0] is None and want[0] is None
    assert torch.equal(first[1], second[1])
    scale = float(want[1].abs().max())
    torch.testing.assert_close(first[1], want[1], rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(twarp.PLAIN_BACKWARD))
def test_backward_kernels_follow_the_plain_vjp_on_nan_flows(card, name):
    """Two NaN flow pixels (in the phase form of the sflow's flow, two s2d
    positions: 4 full-res pixels each): NaN in the image gradient exactly
    where the plain vjp has it (the taps the NaN sample reads), 0 in the
    flow gradient there (the border clamp's mask drops a NaN coordinate, as
    torch's clamp backward does), the plain vjp's values elsewhere."""
    rng = np.random.default_rng(46)
    img, flow = tiled_case(name, (1, 3, 64, 512), "smooth", rng, torch.float32, "cuda")
    flow[:, :, 5, 7] = float("nan")
    flow[:, :, flow.shape[2] * 37 // 64, flow.shape[3] * 300 // 512] = float("nan")
    g = torch.from_numpy(rng.normal(0, 1, img.shape).astype(np.float32)).cuda()
    got = getattr(kwarp, f"launch_{name}_backward")(img, flow, g)
    want = twarp.PLAIN_BACKWARD[name](img, flow, g)
    for t, w in zip(got, want):
        nan = w.isnan()
        assert torch.equal(t.isnan(), nan)
        torch.testing.assert_close(t[~nan], w[~nan], rtol=1e-5,
                                   atol=1e-5 * float(w[~nan].abs().max()))
    assert float(got[1][:, :, 5, 7].abs().max()) == 0.0


def hold_backward_to_plain_vjp(name, img, flow, g, need_img=True, need_flow=True):
    """One launch of ``name``'s backward kernel against the plain vjp on the
    card, as test_backward_kernels_are_the_plain_vjp holds it (float32 at
    1e-5 relative and 1e-5 of the largest gradient; bfloat16 at 2e-2,
    against the float32 plain vjp of the same inputs rounded to bfloat16);
    NaN exactly where the plain vjp has NaN. Returns the kernel's
    gradients."""
    got = getattr(kwarp, f"launch_{name}_backward")(img, flow, g, need_img, need_flow)
    want = [None if w is None else w.to(t) for w, t in zip(twarp.PLAIN_BACKWARD[name](
        img.float(), flow.float(), g.float(), need_img, need_flow), (img.dtype, flow.dtype))]
    torch.cuda.synchronize()
    assert (got[0] is None) == (not need_img) and (got[1] is None) == (not need_flow)
    for t, w in zip(got, want):
        if w is None:
            continue
        assert t.dtype == w.dtype and t.shape == w.shape
        nan = w.isnan()
        assert torch.equal(t.isnan(), nan)
        scale = float(w[~nan].float().abs().max()) if bool((~nan).any()) else 0.0
        rtol, atol = (1e-5, 1e-5 * scale) if img.dtype == torch.float32 else (2e-2, 2e-2 * scale)
        torch.testing.assert_close(t[~nan].float(), w[~nan].float(), rtol=rtol, atol=atol)
    return got


def backward_case(name, shape, kind, rng, dtype):
    """(img, flow, incoming gradient) of ``name``'s backward at full-res
    [B, C, H, W] on the card, as tiled_case builds the forward's."""
    img, flow = tiled_case(name, shape, kind, rng, dtype, "cuda")
    g = torch.from_numpy(rng.normal(0, 1, img.shape).astype(np.float32)).to("cuda", dtype)
    return img, flow, g


# the channel counts of the backward plan's cases: fewer channels than a
# chunk, one chunk, chunks with a remainder, 5 and 6 groups (the training
# steps' 15 and 18), 7 groups with a short one, and past the group cap a
# thread's two chunks and three (its double buffer's both turns and a
# short tail)
BACKWARD_CHANNELS = (1, 2, 3, 7, 13, 15, 18, 19, 30, 49)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(twarp.PLAIN_BACKWARD))
def test_backward_kernels_at_every_channel_count(card, name, dtype):
    """Each backward kernel on a batch of 2 at every channel count of
    BACKWARD_CHANNELS, on a ragged frame (odd width in NCHW; odd H/2 and W/2
    in s2d) with mixed flows, image and flow gradients both asked for,
    against the plain vjp."""
    rng = np.random.default_rng(52)
    H, W = (18, 70) if name in S2D else (17, 69)
    for C in BACKWARD_CHANNELS:
        hold_backward_to_plain_vjp(name, *backward_case(name, (2, C, H, W), "mixed", rng, dtype))


# the training steps' backward shapes (full-res [B, C, H, W]) and whether
# the path asks for the image gradient (BACKWARD_PATHS' first nine)
TRAINING_BACKWARDS = {name: [(shape, name == "flow_warp_s2d" and shape[0] > 1)
                             for n, shape in BACKWARD_PATHS[:9] if n == name]
                      for name in SHAPES}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["smooth", "random"])
@pytest.mark.parametrize("name", list(twarp.PLAIN_BACKWARD))
def test_backward_kernels_at_the_training_shapes(card, name, kind):
    """Each backward kernel at the training steps' shapes, in float32, with
    the gradients the path asks for (the flow's alone, and the image's too
    on LSVC-TPU's MC warps from the second tree layer on), against the
    plain vjp on smooth and +-200 px random flows."""
    rng = np.random.default_rng(53)
    for shape, need_img in TRAINING_BACKWARDS[name]:
        hold_backward_to_plain_vjp(name, *backward_case(name, shape, kind, rng, torch.float32),
                                   need_img=need_img)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(twarp.PLAIN_BACKWARD))
def test_backward_kernels_take_unaligned_pointers(card, name, dtype):
    """An image, a flow or an incoming gradient that starts one element past
    its pair alignment (a contiguous view at an offset into a larger
    buffer): the kernel leaves its pair vectors for scalar accesses and
    still agrees with the plain vjp."""
    rng = np.random.default_rng(54)
    for shape in [(2, 15, 16, 64), (1, 3, 18, 70)]:
        img, flow, g = backward_case(name, shape, "random", rng, dtype)
        for which in range(3):
            inputs = [img, flow, g]
            t = inputs[which]
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
            moved = buf[1:].view(t.shape)
            moved.copy_(t)
            assert moved.is_contiguous() and moved.data_ptr() % (2 * t.element_size())
            inputs[which] = moved
            hold_backward_to_plain_vjp(name, *inputs)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(twarp.PLAIN_BACKWARD))
def test_backward_flow_gradient_is_the_same_at_every_launch(card, name, dtype):
    """The flow gradient sums the channel groups' partials in a fixed order
    with no atomics: two launches on the same inputs give it bit for bit,
    with and without the image gradient beside it, at 18 channels (6
    groups) on a batch of 2 with random flows."""
    rng = np.random.default_rng(55)
    img, flow, g = backward_case(name, (2, 18, 32, 128), "random", rng, dtype)
    launch = getattr(kwarp, f"launch_{name}_backward")
    first = launch(img, flow, g, False, True)[1]
    for need_img in (False, True, True):
        again = launch(img, flow, g, need_img, True)[1]
        torch.cuda.synchronize()
        assert torch.equal(again, first), need_img


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(twarp.PLAIN_BACKWARD))
def test_backward_kernels_follow_nan_flows_at_18_channels(card, name):
    """NaN flows at the first full-res pixel of the first item and the last
    of the second, at 18 channels (6 groups): NaN in the image gradient
    exactly where the plain vjp has it, 0 in the flow gradient at the NaN
    pixels, the plain vjp's values elsewhere."""
    rng = np.random.default_rng(56)
    img, flow, g = backward_case(name, (2, 18, 32, 128), "smooth", rng, torch.float32)
    flow[0, :, 0, 0] = flow[1, :, -1, -1] = float("nan")
    got = hold_backward_to_plain_vjp(name, img, flow, g)
    assert float(got[1][0, :, 0, 0].abs().max()) == 0.0
    assert float(got[1][1, :, -1, -1].abs().max()) == 0.0


@pytest.mark.gpu
def test_elfvc_p_frame_launches_both_pixel_kernels_on_the_card(card):
    """ELFVC-SP-TPU-TINY (tiny_elfvctpu_l3, sp_stage 2), one P-frame at
    64x128 in float32, TF32 off: on the card each pixel kernel launches
    twice (the local prediction and the decoded motion) and nothing else
    does; on the CPU nothing launches. The card's recon is within 1e-4 mean
    abs of the CPU's and its bpp within 1e-3 relative (chip_smoke.py's
    card-vs-CPU bars)."""
    import fastvideocodec_torch as ft
    from fastvideocodec_torch.data.synthetic import synth_gop_multi

    clip = synth_gop_multi(np.random.default_rng(0), size=128, gop=2)[:, :64, :128]
    gop = torch.from_numpy(np.ascontiguousarray(clip)).permute(0, 3, 1, 2)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        for device in ("cuda", "cpu"):
            spec = ft.get_codec_model("ELFVC-SP-TPU-TINY", device=device, sp_stage=2)
            ft.load_asset(spec.module, "tiny_elfvctpu_l3")
            kwarp.reset_launches()
            recon, metrics = ft.rollout(spec, gop.to(device))
            out[device] = (recon.cpu(), float(metrics["bpp_est"][0]), dict(kwarp.LAUNCHES))
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    (card, card_bpp, launches), (cpu, cpu_bpp, cpu_launches) = out["cuda"], out["cpu"]
    assert launches == {**{k: 0 for k in launches}, "pixel_warp": 2, "pixel_warp_s2d_sflow": 2}
    assert set(cpu_launches.values()) == {0}
    assert float((card - cpu).abs().mean()) <= 1e-4
    assert abs(card_bpp - cpu_bpp) <= 1e-3 * cpu_bpp


@pytest.mark.gpu
def test_mcvc_p_frame_launches_pixel_warp_once_on_the_card(card):
    """MCVC-IA-TINY (tiny_mcvc_l3), 3 views of 64x64 with view 1 failed, a
    keyframe and one P-frame in float32, TF32 off: on the card pixel_warp
    launches once (the P-frame's volume warp, C = 18 on 3 views) and
    nothing else does; on the CPU nothing launches. The card's recon is
    within 1e-4 mean abs of the CPU's and its bpp within 1e-3 relative."""
    import fastvideocodec_torch as ft
    from fastvideocodec_torch.data.synthetic import synth_mv_gop

    clip = synth_mv_gop(np.random.default_rng(0), views=3, size=64, gop=2)
    gop = torch.from_numpy(np.ascontiguousarray(clip.transpose(0, 1, 4, 2, 3)))
    mask = np.asarray([1.0, 0.0, 1.0], np.float32)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for device in ("cuda", "cpu"):
            spec = ft.get_codec_model("MCVC-IA-TINY", device=device, num_views=3)
            ft.load_asset(spec.module, "tiny_mcvc_l3")
            kwarp.reset_launches()
            recon, metrics = ft.rollout(spec, gop.to(device), mask)
            out[device] = (recon.cpu(), float(metrics["bpp_est"].sum()), dict(kwarp.LAUNCHES))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    (card, card_bpp, launches), (cpu, cpu_bpp, cpu_launches) = out["cuda"], out["cpu"]
    assert launches == {**{k: 0 for k in launches}, "pixel_warp": 1}
    assert set(cpu_launches.values()) == {0}
    assert float((card - cpu).abs().mean()) <= 1e-4
    assert abs(card_bpp - cpu_bpp) <= 1e-3 * cpu_bpp


@pytest.mark.gpu
def test_mcvc_compress_takes_a_card_mask(card):
    """MCVC-IA-TINY real bits with the view mask a CUDA tensor, as a caller
    on the card holds it: the streams carry the mask, decode == encode bit
    for bit, and each side's P-frame launches pixel_warp once."""
    import fastvideocodec_torch as ft
    from fastvideocodec_torch.coder import video as tv
    from fastvideocodec_torch.data.synthetic import synth_mv_gop

    clip = synth_mv_gop(np.random.default_rng(0), views=3, size=64, gop=2)
    gop = torch.from_numpy(np.ascontiguousarray(clip.transpose(0, 1, 4, 2, 3))).cuda()
    spec = ft.get_codec_model("MCVC-IA-TINY", device="cuda", num_views=3)
    ft.load_asset(spec.module, "tiny_mcvc_l3")
    mask = torch.tensor([1.0, 0.0, 1.0], device="cuda")
    kwarp.reset_launches()
    streams, recon, bits = tv.mcvc_compress_gop(spec, gop, mask)
    decoded = tv.mcvc_decompress_gop(spec, streams)
    assert streams["mask"] == [1.0, 0.0, 1.0] and bits > 0
    assert torch.equal(decoded, recon)
    assert dict(kwarp.LAUNCHES) == {**{k: 0 for k in kwarp.LAUNCHES}, "pixel_warp": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("name, asset, per_frame", [("SSF-TINY", "tiny_ssf_l2", 1),
                                                    ("ELFVC-SP-TINY", "tiny_elfvc_l3", 2)])
def test_stock_p_frame_launches_pixel_warp_on_the_card(card, name, asset, per_frame):
    """The stock (s2d=1) tiny models, one P-frame at 64x128 in float32, TF32
    off: on the card pixel_warp launches once (SSF) or twice (ELFVC's local
    prediction and decoded motion) on the full-resolution volume, and
    nothing else does; on the CPU nothing launches. The card's recon is
    within 1e-4 mean abs of the CPU's and its bpp within 1e-3 relative; its
    real bits decode to its encode recon bit for bit."""
    import fastvideocodec_torch as ft
    from fastvideocodec_torch.coder import video as tv
    from fastvideocodec_torch.data.synthetic import synth_gop_multi

    clip = synth_gop_multi(np.random.default_rng(0), size=128, gop=2)[:, :64, :128]
    gop = torch.from_numpy(np.ascontiguousarray(clip)).permute(0, 3, 1, 2)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for device in ("cuda", "cpu"):
            spec = ft.get_codec_model(name, device=device, sp_stage=2)
            ft.load_asset(spec.module, asset)
            kwarp.reset_launches()
            recon, metrics = ft.rollout(spec, gop.to(device))
            out[device] = (recon.cpu(), float(metrics["bpp_est"][0]), dict(kwarp.LAUNCHES))
        compress, decompress = ((tv.elfvc_compress_gop, tv.elfvc_decompress_gop)
                                if spec.family == "elfvc" else
                                (tv.ssf_compress_gop, tv.ssf_decompress_gop))
        spec = ft.get_codec_model(name, sp_stage=2)
        ft.load_asset(spec.module, asset)
        streams, recon, _ = compress(spec, gop.cuda()[:, None])
        assert torch.equal(decompress(spec, streams), recon)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    (card, card_bpp, launches), (cpu, cpu_bpp, cpu_launches) = out["cuda"], out["cpu"]
    assert launches == {**{k: 0 for k in launches}, "pixel_warp": per_frame}
    assert set(cpu_launches.values()) == {0}
    assert float((card - cpu).abs().mean()) <= 1e-4
    assert abs(card_bpp - cpu_bpp) <= 1e-3 * cpu_bpp


@pytest.mark.gpu
@pytest.mark.parametrize("name, asset", [("DVC-TINY", "tiny_dvc_l2"),
                                         ("RLVC-TINY", "tiny_rlvc_l2")])
def test_dvc_family_p_frame_launches_flow_warp_on_the_card(card, name, asset):
    """One P-frame of the tiny model at 64x128 in float32, TF32 off: on the
    card flow_warp launches 5 times (4 SpyNet levels and the MC warp) and
    nothing else does; on the CPU nothing launches. The card's recon is
    within 1e-4 mean abs of the CPU's and its bpp within 1e-3 relative; its
    real bits decode to its encode recon bit for bit (5 + 1 launches)."""
    import fastvideocodec_torch as ft
    from fastvideocodec_torch.coder import video as tv
    from fastvideocodec_torch.data.synthetic import synth_gop_multi

    clip = synth_gop_multi(np.random.default_rng(0), size=128, gop=2)[:, :64, :128]
    gop = torch.from_numpy(np.ascontiguousarray(clip)).permute(0, 3, 1, 2)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for device in ("cuda", "cpu"):
            spec = ft.get_codec_model(name, device=device)
            ft.load_asset(spec.module, asset)
            kwarp.reset_launches()
            recon, metrics = ft.rollout(spec, gop.to(device))
            out[device] = (recon.cpu(), float(metrics["bpp_est"][0]), dict(kwarp.LAUNCHES))
        compress, decompress = ((tv.rlvc_compress_gop, tv.rlvc_decompress_gop)
                                if spec.family == "rlvc" else
                                (tv.dvc_compress_gop, tv.dvc_decompress_gop))
        spec = ft.get_codec_model(name)
        ft.load_asset(spec.module, asset)
        kwarp.reset_launches()
        streams, recon, _ = compress(spec, gop.cuda())
        assert torch.equal(decompress(spec, gop[0].cuda(), streams), recon)
        coded = dict(kwarp.LAUNCHES)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    (card, card_bpp, launches), (cpu, cpu_bpp, cpu_launches) = out["cuda"], out["cpu"]
    assert launches == {**{k: 0 for k in launches}, "flow_warp": 5}
    assert coded == {**{k: 0 for k in launches}, "flow_warp": 6}
    assert set(cpu_launches.values()) == {0}
    assert float((card - cpu).abs().mean()) <= 1e-4
    assert abs(card_bpp - cpu_bpp) <= 1e-3 * cpu_bpp
