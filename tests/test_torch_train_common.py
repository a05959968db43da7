"""What the training parity tests (tests/test_torch_train_{ssf,elfvc,mcvc,
olft,dvc,rlvc}.py, tests/test_torch_msssim.py) share: the tiny clip, the
recording of JAX's draws and their replay in the port, the carrying of
JAX's flat tensors onto the port's parameter names, JAX's references
(``jax_loss_grads``: gop_loss and its gradient under one ``jax.jit`` a
case, compiled on threads; ``jax_train_steps``: JAX's make_train_step),
and the bars that hold the port's training to JAX's (one copy of each).
It holds no test of its own (and ``yuv_clip_dir``, the video directory
that the eval tests read). The bf16 training files
(tests/test_torch_train_bf16*.py) take their bars from here too
(``bf16_drift_failures``).

JAX draws its training noise inline with ``jax.random.uniform``. For each
traced call that function is replaced by a ``JaxDraws`` (with pytest's
MonkeyPatch: nothing in the JAX package changes), whose ordered
``jax.debug.callback`` records every draw in the order the run makes it
(the SSF rollouts draw inside ``lax.scan``, where a trace meets each draw
once but the run makes it once a frame). The port replays them in that
order through ``Replay`` (NHWC to NCHW).

The bars:
- loss and metrics within METRIC_REL = 1e-5 relative;
- each gradient within GRAD_REL = 1e-4 of its parameter's max |grad|, that
  scale floored at NOISE_FLOOR = 1e-5 of the largest gradient of all:
  below it a gradient is float32 noise in both packages (the SPnets' last
  blocks' biases before their GroupNorm: 1e-11 of the largest);
- the parameters after Adam's steps (``assert_params_close``). Adam's
  first step is lr * g / (|g| + 1e-8): it turns on g's sign, and near
  1e-8 on g's size; a later step also turns on the ratio of the steps'
  gradients, so its error is about lr times their relative error. Where
  JAX's gradient in every step is 0 or at least SETTLED = 3 GRAD_REL of
  its parameter's max |grad| (its sign is then the port's), an element is
  held within PARAM_ABS = 1e-6, or one float32 ulp of the parameter where
  larger (the optimizer's rounding against optax on XLA:CPU, ROADMAP.md
  section 3), after one step, and after more within that plus 2 lr times
  GRAD_REL over its smallest share of the max (the gradient bar's
  relative error at that element); elsewhere within 2 lr a step (a
  gradient within float32 noise of 0 may take either sign, and Adam moves
  it about lr either way). Measured on the four models' two steps and
  stage steps: after one step, at SETTLED = GRAD_REL 1 to 3 elements a
  model moved 1.3 to 3.0 times the bar (gradients 1.0e-4 to 2.7e-4 of
  their max, in the motion decoders), at 3 GRAD_REL the worst held at
  0.84 of it; after two, at the plain 1e-6 bar an element at 8.6e-3 of its
  max (SSF-TPU-TINY's motion_encoder.Conv_2.weight) moved 1.2e-6.
  ``assert_params_close`` prints how many elements it holds to 2 lr a
  step.
- MCVC's motion decoder (``flow_path``): its gradient reaches it only
  through the volume warp's flow gradient, sums of differences of
  neighbouring samples that cancel to 1e-5 of the largest gradient or
  less, where the float32 sums of either package move with their order:
  the port's own gradient there moves 9.5e-4 of its max between one and
  eight CPU threads, and JAX's stands up to 3.1e-3 from it (MCVC-IA-TINY
  on tiny_mcvc_l3). There GRAD_REL gives way to FLOW_GRAD_REL = 5e-3,
  and SETTLED to 3 FLOW_GRAD_REL of the gradient bar's floored scale (an
  element near 1e-5 of the largest gradient is noise in its relative
  size too, and Adam's first step turns on that size near eps); every
  other parameter keeps the bars above.
"""

import copy
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import fastvideocodec_torch as ft
from fastvideocodec_torch.data.synthetic import synth_gop
from fastvideocodec_torch.layers.transforms import SSFHyperDecoder
from fastvideocodec_torch.weights import asset_path, flatten_params, load_flat

GOP, SIZE = 4, 64
LR = 1e-4
GRAD_REL = 1e-4
NOISE_FLOOR = 1e-5  # of the largest gradient: a smaller gradient scale is float32 noise
METRIC_REL = 1e-5
PARAM_ABS = 1e-6
SETTLED = 3 * GRAD_REL  # from this share of the max up a gradient's sign is JAX's
FLOW_GRAD_REL = 5e-3  # a gradient that reaches its parameter only through a flow gradient
METRICS = ("loss", "psnr", "bpp", "img_loss", "aux")
COMPILE_THREADS = 3  # JAX compiles at once in jax_loss_grads


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port runs as fast on one thread at these sizes, and the suite's
    parallel workers share the host's cores (autouse in each module that
    imports it)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t) -> np.ndarray:
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def clip() -> np.ndarray:
    return synth_gop(np.random.default_rng(0), size=SIZE, gop=GOP)


class JaxDraws:
    """``jax.random.uniform`` wrapped to record each draw's values, in the
    order the run makes them (an ordered debug callback)."""

    def __init__(self):
        self.orig = jax.random.uniform
        self.draws = []

    def __call__(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        u = self.orig(key, shape, dtype, minval, maxval)
        jax.debug.callback(lambda v: self.draws.append(np.asarray(v)), u, ordered=True)
        return u

    def take(self) -> list:
        out, self.draws = self.draws, []
        return out


class JaxBranches:
    """``jax.nn.relu`` wrapped, as ``JaxDraws`` wraps the draws: each call
    records the elements on its positive branch (x > 0), in the order the
    run makes them. JAX's PolyphaseDeconv applies its activation before
    its depth-to-space, on [B, h, w, (sy, sx, f)]; ``OnJaxBranches`` lays
    such a mask out as the port's [B, f, 2h, 2w]."""

    def __init__(self):
        self.orig = jax.nn.relu
        self.masks = []

    def __call__(self, x):
        jax.debug.callback(lambda v: self.masks.append(np.asarray(v)), x > 0, ordered=True)
        return self.orig(x)

    def take(self) -> list:
        out, self.masks = self.masks, []
        return out


class OnJaxBranches:
    """The port's ReLUs (``F.relu`` and the hyper decoders' ``act``) on the
    branches a ``JaxBranches`` recorded, as a context: each call takes the
    recorded call's branch, its value and its gradient (as
    tools/train_parity.py's ``CardBranches`` puts the CPU on the card's),
    and counts in ``flips`` the elements whose own branch differed. Both
    runs must make the same calls in the same order. A pre-activation
    within float32 noise of 0 may take the other branch in the other
    package; that is a branch, not an error of either package's
    arithmetic, and it parts the gradients by far more than the arithmetic
    does (MCVC's failed views feed the decoders constant fields, whole
    regions of which sit at such a pre-activation)."""

    def __init__(self, masks: list):
        self.masks, self.calls, self.flips = masks, 0, 0

    def _mask(self, x: torch.Tensor) -> torch.Tensor:
        m = self.masks[self.calls]
        self.calls += 1
        B, C, H, W = x.shape
        if m.shape == (B, H, W, C):
            return torch.from_numpy(np.ascontiguousarray(m.transpose(0, 3, 1, 2)))
        if m.shape == (B, H // 2, W // 2, 4 * C):  # before the depth-to-space
            m = m.reshape(B, H // 2, W // 2, 2, 2, C).transpose(0, 5, 1, 3, 2, 4)
            return torch.from_numpy(np.ascontiguousarray(m.reshape(B, C, H, W)))
        raise RuntimeError(f"ReLU call {self.calls - 1}: JAX's {m.shape}, the port's "
                           f"{tuple(x.shape)}")

    def relu(self, x, inplace=False):
        want = self._mask(x)
        self.flips += int((want != (x > 0)).sum())
        return x * want.to(x.dtype)

    def __enter__(self):
        self.saved = F.relu, SSFHyperDecoder.act
        F.relu = self.relu
        SSFHyperDecoder.act = staticmethod(self.relu)
        return self

    def __exit__(self, *exc):
        F.relu, SSFHyperDecoder.act = self.saved[0], staticmethod(self.saved[1])
        assert exc[0] is not None or self.calls == len(self.masks), (self.calls,
                                                                     len(self.masks))


class Replay:
    """The port's noise source: the recorded NHWC draws, in order, as NCHW."""

    def __init__(self, draws):
        self.draws = list(draws)
        self.used = 0

    def __call__(self, x):
        u = nchw(self.draws[self.used]).to(x.device, x.dtype)
        self.used += 1
        assert u.shape == x.shape, (u.shape, x.shape)
        return u


def grab_grads():
    """A pass-through optax stage that keeps the incoming gradients in its
    state."""
    return optax.GradientTransformation(
        lambda params: {"g": jax.tree.map(jnp.zeros_like, params)},
        lambda updates, state, params=None: (updates, {"g": updates}),
    )


def in_port_layout(module, flat) -> dict:
    """JAX's flat tensors (parameters or gradients) carried onto a clone of
    ``module`` by load_flat (a transpose of each kernel: linear)."""
    clone = copy.deepcopy(module)
    load_flat(clone, flat)
    return {k: v.detach() for k, v in clone.state_dict().items()}


def port_grads(params: dict) -> dict:
    return {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in params.items()}


def assert_close_to_scale(got: torch.Tensor, want: torch.Tensor, rel: float, what):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * max(scale, 1e-12), (what, err, scale)


def assert_grads_close(port: dict, jax_grads: dict, rel: float = GRAD_REL,
                       flow_path: tuple = ()):
    """Each parameter's gradient within ``rel`` of its max |grad|
    (FLOW_GRAD_REL for a name that starts with one of ``flow_path``), that
    scale floored at NOISE_FLOOR of the largest gradient of all. Prints
    the worst gap in each set."""
    assert set(port) == set(jax_grads)
    floor = NOISE_FLOOR * max(float(w.abs().max()) for w in jax_grads.values())
    worst = {}
    for name, want in jax_grads.items():
        scale = max(float(want.abs().max()), floor)
        err = float((port[name] - want).abs().max())
        flow = name.startswith(flow_path) if flow_path else False
        bar = FLOW_GRAD_REL if flow else rel
        worst[flow] = max(worst.get(flow, (0.0, "")), (err / scale, name))
        assert err <= bar * scale, (name, err, scale)
    print(f"worst gradient gap over its scale: {worst[False]}"
          + (f"; on the flow path {worst[True]}" if True in worst else ""))


def assert_metrics_close(got: dict, want: dict, keys=METRICS):
    for k in keys:
        value = float(got[k].detach())
        assert abs(value - want[k]) <= METRIC_REL * max(abs(want[k]), 1e-6), (k, value, want[k])


def assert_params_close(params: dict, want: dict, jax_grads: list, flow_path: tuple = ()):
    """The parameters after len(jax_grads) steps against JAX's, at each
    element whose gradient in every step (JAX's, ``jax_grads``) is 0 or at
    least SETTLED of its parameter's max |grad|: within PARAM_ABS, or one
    float32 ulp of the parameter where larger, plus after more than one
    step 2 lr GRAD_REL over the element's smallest share of its max;
    within 2 lr a step elsewhere. Prints how many elements that leaves at
    2 lr a step."""
    steps = len(jax_grads)
    loose = 2 * LR * steps + PARAM_ABS
    floors = [NOISE_FLOOR * max(float(t.abs().max()) for t in g.values()) for g in jax_grads]
    exempt = total = 0
    for name, p in params.items():
        w = want[name]
        a = w.abs()
        ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
        flow = bool(flow_path) and name.startswith(flow_path)
        rel = FLOW_GRAD_REL if flow else GRAD_REL
        share = torch.full_like(w, float("inf"))  # the smallest nonzero share of the max
        for g, floor in zip(jax_grads, floors):
            mag = g[name].abs()
            # on the flow path, of the gradient bar's scale (floored at
            # NOISE_FLOOR of the step's largest gradient)
            scale = max(float(mag.max()), floor) if flow else mag.max()
            share = torch.where(mag > 0, torch.minimum(share, mag / scale), share)
        signed = share >= 3 * rel
        bar = torch.clamp(ulp, min=PARAM_ABS)
        if steps > 1:
            bar = bar + 2 * LR * rel / share
        bar = torch.where(signed, torch.clamp(bar, max=loose), torch.full_like(w, loose))
        exempt += int((~signed).sum())
        total += w.numel()
        gap = (p.detach() - w).abs()
        assert bool((gap <= bar).all()), (name, float(torch.where(signed, gap, 0.0).max()),
                                          float((gap / bar).max()))
    print(f"parameters after {steps} step(s): {exempt} of {total} elements "
          f"({exempt / total:.3%}) have a gradient under SETTLED = {SETTLED:.0e} of their "
          f"parameter's max in some step and are held to 2 lr a step")


def asset_flat(name: str) -> dict:
    """A shipped checkpoint's flat '/'-joined flax names (under params/),
    float32."""
    with np.load(asset_path(name)) as data:
        return {k: data[k].astype(np.float32) for k in data.files}


def seeded_with_asset(name: str, asset: str, rename=lambda key: key) -> dict:
    """seeded_flat(name, 0) with the shipped ``asset``'s tensors where they
    fit (each asset key through ``rename`` first)."""
    flat = ft.seeded_flat(name, 0)
    for key, value in asset_flat(asset).items():
        key = rename(key)
        if key in flat and flat[key].shape == value.shape:
            flat[key] = value
    return flat


def port_spec(name: str, flat: dict, fields: dict | None = None):
    """The port's ``name`` on the CPU with the flat weights loaded and the
    module's ``fields`` set."""
    spec = ft.get_codec_model(name, device="cpu")
    load_flat(spec.module, flat)
    for key, value in (fields or {}).items():
        setattr(spec.module, key, value)
    return spec


def jax_tree(flat: dict) -> dict:
    """A flax variables dict {"params": {...}} from flat '/'-joined names."""
    tree = {}
    for key, value in flat.items():
        node = tree
        for part in key.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[key.split("/")[-1]] = jnp.asarray(value)
    return tree


def jax_loss_grads(jax_gop_loss, cases: list, seed: int = 3, grads: bool = True) -> list:
    """JAX's ``gop_loss`` in training with its gradient (none without
    ``grads``), for each case (jspec, flat variables, gop, TrainConfig[,
    mask]), each under one ``jax.jit``: [(metrics as floats, flat gradients
    or None, the draws in the run's order)]. Each case compiles on a thread
    of its own while the next is traced (XLA's compile releases the GIL; a
    trace does not)."""
    lowered = []
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"), \
            ThreadPoolExecutor(max_workers=COMPILE_THREADS) as pool:
        for jspec, flat, gop, cfg, *mask in cases:
            rec = JaxDraws()
            mp.setattr(jax.random, "uniform", rec)
            params = jax_tree(flat)

            def fn(p, jspec=jspec, gop=jnp.asarray(gop), cfg=cfg, mask=(mask or [None])[0]):
                return jax_gop_loss(jspec, p, gop, True, jax.random.PRNGKey(seed), cfg, mask)

            if grads:
                fn = jax.value_and_grad(fn, has_aux=True)
            lowered.append((pool.submit(jax.jit(fn).lower(params).compile), params, rec))
    out = []
    for compiled, params, rec in lowered:
        result = compiled.result()(params)
        jax.block_until_ready(result)
        (_, jm), g = result if grads else (result, None)
        out.append(({k: float(v) for k, v in jm.items()},
                    None if g is None else flatten_params(g), rec.take()))
    return out


def jax_train_steps(jax_trainer, jspec, flat: dict, gop, seeds=(1, 2)) -> list:
    """JAX's make_train_step (jitted once) from ``flat``, a step per seed:
    each step's draws, gradients (from a pass-through optax stage chained
    before the optimizer), parameters and metrics."""
    cfg = jax_trainer.TrainConfig(learning_rate=LR)
    params = jax_tree(flat)
    rec = JaxDraws()
    steps = []
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"):
        mp.setattr(jax.random, "uniform", rec)
        tx = optax.chain(grab_grads(), jax_trainer.make_optimizer(cfg))
        init_fn, step_fn = jax_trainer.make_train_step(jspec, cfg, optimizer=tx)
        opt_state = init_fn(params)
        step = jax.jit(step_fn)
        for seed in seeds:
            params, opt_state, metrics = step(params, opt_state, jnp.asarray(gop),
                                              jax.random.PRNGKey(seed))
            jax.block_until_ready(params)
            steps.append({"draws": rec.take(), "grads": flatten_params(opt_state[0]["g"]),
                          "params": flatten_params(params),
                          "metrics": {k: float(v) for k, v in metrics.items()}})
    return steps


# bf16 training (tests/test_torch_train_bf16*.py): a bf16 step is held to
# the port's float32 step on the same weights and draws, no farther from it
# than JAX's own bf16 step is. JAX's bf16 gradient stands 1.8% to 36% (by
# relative L2) from that float32 step on the tiny models at 64x64, so no
# fixed bar fits every family.
BF16_DRIFT = 1.5  # metrics and the whole gradient: at most this times JAX's drift
BF16_METRIC_REL = 1e-3  # plus this share of the float32 value, for a metric
BF16_SUB_DRIFT = 2.0  # a top-level submodule's gradient: this times JAX's drift,
BF16_SUB_FLOOR = 1e-2  # or this where that is smaller


def bf16_spec(name: str, flat: dict, fields: dict | None = None, **kw):
    """The port's ``name`` on the CPU, the flat weights loaded and the
    module's ``fields`` set, readied for bf16 training (float32 masters,
    bf16 compute)."""
    from fastvideocodec_torch.train import ready_for_training

    spec = ft.get_codec_model(name, device="cpu", **kw)
    load_flat(spec.module, flat)
    for key, value in (fields or {}).items():
        setattr(spec.module, key, value)
    ready_for_training(spec, torch.bfloat16)
    return spec


def replay32(draws: list) -> "Replay":
    """A Replay of JAX's draws, which a bf16 run makes in bfloat16 (the
    values widen exactly)."""
    return Replay([np.asarray(d, np.float32) for d in draws])


def port_step_grads(spec, gop, draws, cfg, mask=None):
    """One backward of the port's gop_loss under JAX's ``draws`` (replayed,
    all of them used), the masters cast once as make_train_step casts
    them: (metrics as floats, gradients)."""
    from fastvideocodec_torch.layers.blocks import cast_once
    from fastvideocodec_torch.train import gop_loss, ready_for_training

    params = ready_for_training(spec)
    noise = replay32(draws)
    with cast_once():
        loss, metrics = gop_loss(spec, gop, True, noise, cfg, mask)
        loss.backward()
    assert noise.used == len(noise.draws)
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {n: g.detach().clone() for n, g in port_grads(params).items()})


def rel_l2(got: dict, want: dict, names=None) -> float:
    """||got - want|| / ||want|| over ``names`` (every key by default)."""
    names = list(want) if names is None else names
    num = sum(float(torch.sum((got[n].double() - want[n].double()) ** 2)) for n in names)
    den = sum(float(torch.sum(want[n].double() ** 2)) for n in names)
    return (num / den) ** 0.5


def bf16_drift_failures(port: tuple, jax_bf16: tuple, f32: tuple) -> dict:
    """The bars a port bf16 step (metrics, gradients) misses, against JAX's
    bf16 step (metrics, gradients in the port's layout), both measured from
    the port's float32 step ``f32`` on the same weights and draws: each of
    METRICS within BF16_DRIFT times JAX's distance plus BF16_METRIC_REL of
    the float32 value; the whole gradient's relative L2 distance within
    BF16_DRIFT times JAX's; each top-level submodule's (those the loss
    reaches) within BF16_SUB_DRIFT times JAX's, or BF16_SUB_FLOOR where
    that is smaller. And the port's bf16 gradient against JAX's bf16 one,
    the whole and each submodule: within (1 + BF16_DRIFT) times JAX's
    distance from float32 (so that a bf16 fault as large as JAX's drift
    but in another direction misses, and none hides under the floor).
    Returns {"metrics": {...}, "grads": {...}} of the misses (empty where
    every bar holds; a miss against JAX's bf16 gradient is keyed "... vs
    jax"), and prints every distance."""
    (pm, pg), (jm, jg), (fm, fg) = port, jax_bf16, f32
    misses = {"metrics": {}, "grads": {}}
    for k in METRICS:
        got, want = abs(pm[k] - fm[k]), abs(jm[k] - fm[k])
        bar = BF16_DRIFT * want + BF16_METRIC_REL * abs(fm[k])
        print(f"{k}: float32 {fm[k]:.7g}, the port's bf16 {got:.3g} from it, JAX's {want:.3g}")
        if got > bar:
            misses["metrics"][k] = (got, bar)
    whole = (rel_l2(pg, fg), rel_l2(jg, fg))
    cross = rel_l2(pg, jg)
    print(f"gradient, relative L2 from float32: the port's bf16 {whole[0]:.4f}, JAX's "
          f"{whole[1]:.4f}; the port's bf16 from JAX's bf16 {cross:.4f}")
    if whole[0] > BF16_DRIFT * whole[1]:
        misses["grads"]["whole"] = whole
    if cross > (1 + BF16_DRIFT) * whole[1]:
        misses["grads"]["whole vs jax"] = (cross, whole[1])
    for sub in sorted({n.split(".")[0] for n in fg}):
        names = [n for n in fg if n.split(".")[0] == sub]
        if not any(float(fg[n].abs().max()) > 0 for n in names):
            continue  # the loss does not reach it (the keyframe's transforms)
        got, want, cross = rel_l2(pg, fg, names), rel_l2(jg, fg, names), rel_l2(pg, jg, names)
        print(f"  {sub}: the port's bf16 {got:.4f}, JAX's {want:.4f}; from JAX's {cross:.4f}")
        if got > max(BF16_SUB_DRIFT * want, BF16_SUB_FLOOR):
            misses["grads"][sub] = (got, want)
        if cross > (1 + BF16_DRIFT) * want:
            misses["grads"][f"{sub} vs jax"] = (cross, want)
    return misses


class ZeroFlowGradient:
    """The plain warps' flow gradient zeroed (or times ``scale``), as a
    context: the control that shows a bar bites (the flow gradient carries
    the motion path's whole gradient)."""

    def __init__(self, scale: float = 0.0):
        import fastvideocodec_torch.ops.warp as ow

        self.plain, self.scale = ow.PLAIN, scale

    def __enter__(self):
        self.saved = dict(self.plain)
        scale = self.scale

        class Cut(torch.autograd.Function):
            @staticmethod
            def forward(ctx, flow):
                return flow.view_as(flow)

            @staticmethod
            def backward(ctx, g):
                return g * scale

        for name, fn in self.saved.items():
            self.plain[name] = lambda img, flow, fn=fn: fn(img, Cut.apply(flow))
        return self

    def __exit__(self, *exc):
        self.plain.update(self.saved)


def yuv_clip_dir(root, clips, black: int = -1):
    """A directory of raw 1920x1080 I420 videos, ``root/clip{k}.yuv`` for
    each NHWC clip of ``clips`` (``data/video.py:write_yuv``); with
    ``black`` >= 0 an all-black frame is inserted at that index of each.
    Returns the directory as a string."""
    from fastvideocodec_torch.data import write_yuv

    root.mkdir(parents=True, exist_ok=True)
    for k, clip in enumerate(clips):
        frames = list(clip)
        if black >= 0:
            frames.insert(black, None)
        write_yuv(root / f"clip{k}.yuv", frames)
    return str(root)
