"""Package-level guards of the PyTorch port.

- The port (its training and evaluation modules too: train/, cli/,
  utils/, data/, anchors/, analysis/, the multi-device parallel/ and
  tools/dryrun_multichip.py, tools/multichip_smoke.py), chip_smoke.py, warp_ab.py and
  real_bits_ab.py import with jax, flax, optax, orbax, PIL, OpenCV,
  matplotlib and fastvideocodec_tpu unimportable (the card's machine has
  none of the JAX ones and no matplotlib); real_bits_ab.py's synchronous
  copies are swapped in for their scope only. These checks, and the
  runs below "without JAX", are snippets (``runs_blocked``) that run one
  after another in one interpreter on one torch thread; each test reads
  its own snippet's outcome.
- chip_smoke.py exits non-zero, printing no result, without a CUDA card and
  in a directory that holds nothing else of the repo.
- The weight loader raises on unknown and on missing parameters.
- Entry points default to the card, and a CUDA-side tensor never reaches
  a warp's plain version (on the ELFVC path too).
- ``seeded_flat`` gives the keys and shapes of the JAX modules' ``init``
  (MCVC's too), its SSF-TPU draws are those of the slice before ELFVC's
  and its ELFVC-SP-TPU draws those of the slice before MCVC's.
- The stock (s2d=1) SSF, ELFVC and MCVC-Original names build, default to
  the card, map their shipped weights completely, and run their rollouts
  and real bits without JAX.
- MCVC runs without JAX, defaults to the card, sends its volume warp to
  the pixel_warp kernel once a P-frame off the CPU, and maps the shipped
  tiny_mcvc_l{0,3,6} completely.
- The port holds only small text files, and builds its kernels with nvcc
  alone: no PyTorch extension builder, no PyTorch C++ headers.
- DVC, RLVC (RLVC2, RLVC-HP) and Base (-EC, -ER) build under every name
  the JAX registry gives them, on the card by default; their shipped
  tiny_{dvc,rlvc,base}_l{0,2,4} map completely; ``seeded_flat`` gives the
  keys and shapes of the JAX modules' init and their initialisers' values
  (GDN, BitEstimator, CodecNet's Xavier convs); their rollouts and real
  bits run without JAX; one DVC, Base-EC-ER and RLVC P-frame on meta
  tensors sends exactly 5 warps to flow_warp's launcher (4 SpyNet levels,
  the MC warp) and none to a plain version.
- Every LSVC form (s2d=1, the LSVC-TPU ablations, attention, the -L/-O
  graphs) defaults to the card, runs its rollout, real bits and decode
  graph without JAX, and off the CPU sends SpyNet's four levels to
  flow_warp and each layer's MC warp to the kernel of its branch:
  flow_warp for s2d=1 (3 channels) and -RW (12 channels at half
  resolution), flow_warp_s2d for the full-resolution s2d warps.
- An LSVC-TPU-TINY training step and checkpoint, and an MCVC-IA-OLFT-TINY
  online fine-tuning step with its touch-up labels priced, run without
  JAX; so do an evolve step and a real-bits evaluate_video of
  LSVC-TPU-TINY with its log read back, and VideoDataset raises JAX's
  error without OpenCV. cli/eval.py, cli/train.py --evaluate and
  cli/train_multiview.py --task speed build on the card by default.
"""

import inspect
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.ops.kernels import build

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "fastvideocodec_torch"
ELFVC_SP_TPU_SEEDED_SHA256 = "1d5b44f2e39bd50fdb17b75d90a53736fe236cfaf3bf44b27a23eb6576d6f5ce"

BLOCKER = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                  "fastvideocodec_tpu", "PIL", "cv2", "matplotlib"):
            raise ImportError(f"blocked: {{name}}")
        return None
sys.meta_path.insert(0, _Block())
sys.path.insert(0, {repo!r})
"""


# The checks that run with those modules unimportable, by test name: all
# of them run in one interpreter (``blocked_results``), one after another,
# each in a namespace of its own, and each test reads its own check's
# outcome, so that a check fails its own test alone.
BLOCKED_CHECKS: dict = {}
RUNNER = """
import contextlib, io, json, traceback
results = {}
for name, code in json.loads(sys.stdin.read()).items():
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            exec(compile(code, name, "exec"), {"__name__": "__check__", "sys": sys})
        results[name] = [out.getvalue().strip() == "ok", out.getvalue()[-4000:]]
    except BaseException:
        results[name] = [False, out.getvalue()[-4000:] + traceback.format_exc()]
print("RESULTS " + json.dumps(results))
"""


def runs_blocked(code: str):
    """Registers ``code`` as the blocked check of the test it decorates: it
    passes when it prints 'ok' and raises nothing."""
    def register(test):
        BLOCKED_CHECKS[test.__name__] = code
        return test
    return register


@pytest.fixture(scope="module")
def blocked_results() -> dict:
    """Every registered check's (passed, output), run in one interpreter
    with the BLOCKER's modules unimportable, on one torch thread (the
    suite's workers share the host's cores)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run(
        [sys.executable, "-c", BLOCKER.format(repo=str(REPO)) + RUNNER],
        input=json.dumps(BLOCKED_CHECKS), capture_output=True, text=True, timeout=900,
        cwd=str(REPO), env=env,
    )
    found = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULTS ")]
    assert r.returncode == 0 and found, r.stdout[-4000:] + r.stderr[-4000:]
    return json.loads(found[-1][len("RESULTS "):])


def check_blocked(results: dict, name: str) -> None:
    passed, output = results[name]
    assert passed, output


@runs_blocked(
    "import pkgutil, importlib, fastvideocodec_torch as p\n"
    "for m in pkgutil.walk_packages(p.__path__, 'fastvideocodec_torch.'):\n"
    "    importlib.import_module(m.name)\n"
    "assert 'fastvideocodec_torch.models.mcvc' in sys.modules\n"
    "for name in ('models.dvc', 'models.base', 'models.rlvc', 'entropy.rpm',\n"
    "             'layers.codecnet', 'train.trainer', 'train.checkpoint',\n"
    "             'train.olft', 'cli.train', 'cli.train_multiview', 'utils.meters',\n"
    "             'utils.logs', 'data.vimeo', 'data.loader', 'data.multiview',\n"
    "             'ops.msssim', 'data.video', 'anchors', 'train.evaluate',\n"
    "             'train.evolve', 'cli.eval', 'cli.plot', 'analysis.plots',\n"
    "             'utils.torch_import', 'cli.simulate', 'analysis.abr',\n"
    "             'analysis.trace_sim', 'utils.flowviz', 'layers.contextvp',\n"
    "             'tools.train_tiny', 'tools.price_hd', 'tools.speed_sweep',\n"
    "             'tools.warp_bench', 'tools.tools_smoke', 'tools.timing',\n"
    "             'parallel', 'parallel.mesh', 'parallel.frame', 'parallel.distributed',\n"
    "             'parallel.collectives', 'tools.dryrun_multichip',\n"
    "             'tools.multichip_smoke'):\n"
    "    assert 'fastvideocodec_torch.' + name in sys.modules, name\n"
    "bad = [m for m in sys.modules\n"
    "       if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'PIL',\n"
    "                              'fastvideocodec_tpu', 'cv2', 'matplotlib')]\n"
    "assert not bad, bad\n"
    "print('ok')\n"
)
def test_port_imports_without_jax(blocked_results):
    check_blocked(blocked_results, "test_port_imports_without_jax")


@runs_blocked(
    "import chip_smoke\n"
    "assert callable(chip_smoke.main)\n"
    "print('ok')\n"
)
def test_chip_smoke_imports_without_jax(blocked_results):
    check_blocked(blocked_results, "test_chip_smoke_imports_without_jax")


def _no_result(r: subprocess.CompletedProcess) -> bool:
    return r.returncode != 0 and '"ok"' not in r.stdout


@runs_blocked(
    "import warp_ab\n"
    "assert callable(warp_ab.main)\n"
    "print('ok')\n"
)
def test_warp_ab_imports_without_jax_and_needs_a_card(blocked_results):
    check_blocked(blocked_results, "test_warp_ab_imports_without_jax_and_needs_a_card")
    if not torch.cuda.is_available():
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        r = subprocess.run([sys.executable, "warp_ab.py", f"warp={build.SOURCE}"],
                           capture_output=True, text=True, timeout=120, cwd=str(REPO), env=env)
        assert r.returncode != 0 and "median" not in r.stdout, r.stdout


@runs_blocked(
    "import torch, real_bits_ab as ab\n"
    "from fastvideocodec_torch.coder import video as cv\n"
    "shipped = cv.HostCopy\n"
    "with ab.copies('shipped'):\n"
    "    assert cv.HostCopy is shipped\n"
    "try:\n"
    "    with ab.copies('synchronous'):\n"
    "        assert cv.HostCopy is ab._SyncCopy\n"
    "        t = torch.arange(6).reshape(2, 3)\n"
    "        assert (cv.HostCopy(t).numpy() == t.numpy()).all()\n"
    "        raise KeyError('inside')\n"
    "except KeyError:\n"
    "    pass\n"
    "assert cv.HostCopy is shipped\n"
    "print('ok')\n"
)
def test_real_bits_ab_imports_without_jax_and_restores_the_copies(blocked_results):
    check_blocked(blocked_results, "test_real_bits_ab_imports_without_jax_and_restores_the_copies")


def test_chip_smoke_fails_without_a_card_or_alone(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if not torch.cuda.is_available():
        r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], capture_output=True,
                           text=True, timeout=120, cwd=str(tmp_path), env=env)
        assert _no_result(r), r.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                       timeout=120, cwd=str(tmp_path), env=env)
    assert _no_result(r), r.stdout


@runs_blocked(
    "import numpy as np, torch, fastvideocodec_torch as ft\n"
    "from fastvideocodec_torch.data.synthetic import synth_gop_multi\n"
    "spec = ft.get_codec_model('SSF-TPU-TINY', device='cpu')\n"
    "ft.load_asset(spec.module, 'tiny_ssftpu_l2')\n"
    "clip = synth_gop_multi(np.random.default_rng(0), size=64, gop=2)[:, :32]\n"
    "gop = torch.from_numpy(np.ascontiguousarray(clip)).permute(0, 3, 1, 2)\n"
    "recon, m = ft.rollout(spec, gop)\n"
    "assert recon.shape == (1, 3, 32, 64) and bool(torch.isfinite(recon).all())\n"
    "assert float(m['bpp_est'][0]) > 0\n"
    "bad = [m for m in sys.modules\n"
    "       if m.split('.')[0] in ('jax', 'flax', 'fastvideocodec_tpu')]\n"
    "assert not bad, bad\n"
    "print('ok')\n"
)
def test_ssf_rollout_runs_without_jax(blocked_results):
    check_blocked(blocked_results, "test_ssf_rollout_runs_without_jax")


def _tiny_cpu_model():
    return ft.get_codec_model("LSVC-TPU-TINY", device="cpu").module


def test_loader_raises_on_unknown_key():
    with np.load(ft.weights.asset_path("tiny_lsvctpu_l2")) as data:
        flat = {k: data[k] for k in data.files}
    ft.weights.load_flat(_tiny_cpu_model(), flat)  # the whole asset maps
    flat["params/res_encoder/Conv_9/kernel"] = np.zeros((3, 3, 4, 4), np.float16)
    with pytest.raises(KeyError, match="Conv_9"):
        ft.weights.load_flat(_tiny_cpu_model(), flat)


def test_loader_raises_on_missing_key():
    with np.load(ft.weights.asset_path("tiny_lsvctpu_l2")) as data:
        flat = {k: data[k] for k in data.files if "warpnet/Conv_1" not in k}
    with pytest.raises(KeyError, match="warpnet.Conv_1"):
        ft.weights.load_flat(_tiny_cpu_model(), flat)


def test_loader_raises_on_wrong_shape():
    with np.load(ft.weights.asset_path("tiny_lsvctpu_l2")) as data:
        flat = {k: data[k] for k in data.files}
    flat["params/warpnet/Conv_1/bias"] = np.zeros((5,), np.float16)
    with pytest.raises(ValueError, match="warpnet/Conv_1/bias"):
        ft.weights.load_flat(_tiny_cpu_model(), flat)


def test_shipped_flagship_weights_map_completely():
    spec = ft.get_codec_model("LSVC-TPU", device="cpu")
    with np.load(ft.weights.asset_path("hd_lsvctpuf2_l2")) as data:
        assert len(data.files) == 144
        ft.weights.load_flat(spec.module, {k: data[k] for k in data.files})
        w = data["params/res_decoder/PolyphaseDeconv_0/kernel"].astype(np.float32)
    got = spec.module.res_decoder.PolyphaseDeconv_0.weight.detach().numpy()
    np.testing.assert_array_equal(got, w.transpose(2, 3, 0, 1))


def test_entry_points_default_to_the_card():
    assert inspect.signature(ft.get_codec_model).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        spec = ft.get_codec_model("LSVC-TPU-TINY")
        assert next(spec.module.parameters()).device.type == "cuda"
    else:
        with (pytest.raises((RuntimeError, AssertionError))):
            ft.get_codec_model("LSVC-TPU-TINY")


def test_ssf_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        spec = ft.get_codec_model("SSF-TPU-TINY")
        assert next(spec.module.parameters()).device.type == "cuda"
    else:
        with (pytest.raises((RuntimeError, AssertionError))):
            ft.get_codec_model("SSF-TPU-TINY")


@pytest.mark.parametrize("name, args", [
    ("pixel_warp", ((1, 15, 8, 16), (1, 2, 8, 16))),
    ("pixel_warp_s2d", ((1, 12, 8, 16), (1, 2, 16, 32))),
    ("pixel_warp_s2d_sflow", ((1, 12, 8, 16), (1, 8, 8, 16))),
])
def test_pixel_dispatchers_never_reach_the_plain_version_off_cpu(monkeypatch, name, args):
    """A tensor that is not on the CPU goes to the launcher, which raises
    here (no card), and never to the plain version."""
    from fastvideocodec_torch.ops import warp as twarp

    reached = []
    monkeypatch.setattr(twarp, f"plain_{name}", lambda *a: reached.append(a))
    img, flow = (torch.empty(shape, device="meta") for shape in args)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(twarp, name)(img, flow)
    assert not reached


def test_shipped_ssf_weights_map_completely():
    spec = ft.get_codec_model("SSF-TPU-TINY", device="cpu")
    with np.load(ft.weights.asset_path("tiny_ssftpu_l2")) as data:
        assert len(data.files) == 141
        ft.weights.load_flat(spec.module, {k: data[k] for k in data.files})
        q = data["params/motion_hyperprior/bottleneck/quantiles"].astype(np.float32)
    got = spec.module.motion_hyperprior.bottleneck.quantiles.detach().numpy()
    np.testing.assert_array_equal(got, q)
    assert ft.weights.flax_shapes(spec.module)[
        "params/res_hyperprior/bottleneck/matrix_4"] == (48, 1, 3)


@pytest.mark.parametrize("name", ["SSF-TPU", "SSF-TPU-TINY", "ELFVC-SP-TPU", "ELFVC-TPU-TINY",
                                  "MCVC-IA", "MCVC-IA-TINY", "SSF-Official", "MCVC-Original",
                                  "ELFVC-SP", "ELFVC-TINY"])
def test_seeded_flat_has_the_jax_init_keys_and_shapes(name):
    """Keys and shapes equal those of the JAX module's init (traced with
    eval_shape, which computes nothing); the deterministic initialisers
    (bottleneck matrices, factors, quantiles; zero biases) equal its values
    of them; kernels are lecun_normal: truncated at 2 standard deviations,
    variance 1/fan_in."""
    import jax
    import jax.numpy as jnp

    from fastvideocodec_tpu.entropy.factorized import EntropyBottleneck
    from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model

    module = jax_get_codec_model(name, num_views=1).module
    if name.startswith("MCVC-IA"):  # a view mask; its weights do not depend on the views
        def init(k, f):
            return module.init(k, f, jnp.ones((1,)), training=False)
    else:
        def init(k, f):
            return module.init(k, f)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), jnp.zeros((2, 1, 32, 64, 3)))
    want = {"/".join(path): leaf.shape for path, leaf in _paths(shapes)}
    flat = ft.weights.seeded_flat(name, 0)
    assert {k: v.shape for k, v in flat.items()} == want
    ch = flat["params/img_hyperprior/bottleneck/quantiles"].shape[0]
    init = EntropyBottleneck(ch).init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 1, ch)),
                                      training=False)["params"]
    for leaf in ("matrix_0", "matrix_2", "factor_1", "quantiles"):
        np.testing.assert_array_equal(flat[f"params/res_hyperprior/bottleneck/{leaf}"],
                                      np.asarray(init[leaf]))
    kernel = flat["params/res_decoder/PolyphaseDeconv_0/kernel"]
    std = 1 / np.sqrt(np.prod(kernel.shape[:-1]))
    assert np.abs(kernel).max() < 2 * std / 0.8796256610342398
    assert abs(kernel.std() / std - 1) < 0.02
    assert not flat["params/res_decoder/PolyphaseDeconv_0/bias"].any()


def test_seeded_flat_follows_its_seed():
    a, b, c = (ft.weights.seeded_flat("SSF-TPU-TINY", s) for s in (0, 0, 1))
    key = "params/motion_encoder/Conv_0/kernel"
    np.testing.assert_array_equal(a[key], b[key])
    assert not np.array_equal(a[key], c[key])


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def test_bf16_ssf_model_keeps_bottlenecks_in_float32():
    m = ft.get_codec_model("SSF-TPU-TINY", dtype=torch.bfloat16, device="cpu").module
    assert m.motion_encoder.Conv_0.weight.dtype == torch.bfloat16
    assert m.res_decoder.PolyphaseDeconv_2.weight.dtype == torch.bfloat16
    assert m.res_hyperprior.hyper_decoder_scale.PolyphaseDeconv_0.weight.dtype == torch.bfloat16
    assert m.res_hyperprior.bottleneck.matrix_0.dtype == torch.float32


def test_bf16_model_keeps_rate_and_gdn_params_in_float32():
    m = ft.get_codec_model("LSVC-TPU-TINY", dtype=torch.bfloat16, device="cpu").module
    assert m.res_encoder.Conv_0.weight.dtype == torch.bfloat16
    assert m.res_decoder.PolyphaseDeconv_0.weight.dtype == torch.bfloat16
    assert m.res_encoder.GDN_0.gamma.dtype == torch.float32
    assert m.bit_estimator_z.f1.h.dtype == torch.float32


def test_unported_codec_raises():
    """Every name of the JAX registry builds in the port now; a name that
    JAX's registry does not recognize raises as there."""
    with pytest.raises(ValueError, match="Cannot recognize codec"):
        ft.get_codec_model("H265", device="cpu")


def test_kernel_library_path_keys_source_and_flags():
    path = build.library_path()
    assert path.name == "libfvc_warp.so"
    assert path.parent.parent == REPO / "build" / "kernels"
    assert "-gencode" in build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def _port_files():
    files = [p for p in PORT.rglob("*") if p.is_file() and "__pycache__" not in p.parts]
    files += sorted((REPO / "tests").glob("test_torch_*"))
    files += [REPO / "chip_smoke.py", REPO / "warp_ab.py"]
    return files


def test_port_files_are_small_text():
    for path in _port_files():
        data = path.read_bytes()
        assert len(data) <= 256 * 1024, path
        assert b"\0" not in data, f"binary file {path}"
        data.decode("utf-8")


def test_port_builds_without_torch_extensions():
    banned = ["torch.utils." + "cpp_extension", "from torch.utils import " + "cpp_extension",
              "#include <" + "torch/", '#include "' + "torch/", "<ATen" + "/", "c10" + "/cuda"]
    for path in _port_files():
        text = path.read_text()
        for word in banned:
            assert word not in text, f"{path} uses {word}"


@runs_blocked(
    "import numpy as np, torch, fastvideocodec_torch as ft\n"
    "from fastvideocodec_torch.coder import video as cv\n"
    "from fastvideocodec_torch.data.synthetic import synth_gop_multi\n"
    "spec = ft.get_codec_model('ELFVC-SP-TPU-TINY', device='cpu', sp_stage=2)\n"
    "ft.load_asset(spec.module, 'tiny_elfvctpu_l3')\n"
    "clip = synth_gop_multi(np.random.default_rng(0), size=64, gop=2)[:, :32]\n"
    "gop = torch.from_numpy(np.ascontiguousarray(clip)).permute(0, 3, 1, 2)\n"
    "recon, m = ft.rollout(spec, gop)\n"
    "assert recon.shape == (1, 3, 32, 64) and bool(torch.isfinite(recon).all())\n"
    "assert float(m['bpp_est'][0]) > 0 and float(m['pred_err_norm'][0]) > 0\n"
    "streams, rec, bits = cv.elfvc_compress_gop(spec, gop[:, None])\n"
    "assert torch.equal(cv.elfvc_decompress_gop(spec, streams), rec) and bits > 0\n"
    "bad = [m for m in sys.modules\n"
    "       if m.split('.')[0] in ('jax', 'flax', 'fastvideocodec_tpu')]\n"
    "assert not bad, bad\n"
    "print('ok')\n"
)
def test_elfvc_rollout_and_real_bits_run_without_jax(blocked_results):
    check_blocked(blocked_results, "test_elfvc_rollout_and_real_bits_run_without_jax")


@pytest.mark.parametrize("name", ["ELFVC-TPU", "ELFVC-SP-TPU", "ELFVC-TPU-TINY",
                                  "ELFVC-SP-TPU-TINY"])
def test_elfvc_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        spec = ft.get_codec_model(name)
        assert next(spec.module.parameters()).device.type == "cuda"
    else:
        with (pytest.raises((RuntimeError, AssertionError))):
            ft.get_codec_model(name)


@pytest.mark.parametrize("name", ["ELFVC", "ELFVC-SP", "ELFVC-TINY", "ELFVC-SP-TINY"])
def test_s2d1_elfvc_is_not_ported_yet(name):
    """The name is the slice's before the stock forms: each s2d=1 ELFVC
    name now builds, in family elfvc, with the full-resolution flow
    predictor (9 -> mid channels, stride 1)."""
    spec = ft.get_codec_model(name, device="meta", sp_stage=2)
    assert spec.family == "elfvc" and spec.module.s2d == 1
    assert spec.module.super_prec == ("-SP" in name)
    conv0 = spec.module.flow_predictor.Conv_0
    assert conv0.in_channels == 9 and conv0.stride == (1, 1)


def test_elfvc_path_off_cpu_launches_both_pixel_kernels_twice(monkeypatch):
    """One ELFVC-SP-TPU-TINY P-frame on meta tensors (not the CPU): each
    of the two pixel warps goes to its launcher twice (the local prediction
    and the decoded motion), and no warp reaches a plain version. The
    launchers are stood in for by ones that count and return empty
    outputs, since there is no card here."""
    from fastvideocodec_torch.ops import warp as twarp
    from fastvideocodec_torch.ops.kernels import warp as kwarp

    calls, reached = [], []
    for name in twarp.PLAIN:
        monkeypatch.setitem(twarp.PLAIN, name, lambda *a, n=name: reached.append(n))
        monkeypatch.setattr(kwarp, f"launch_{name}",
                            lambda img, flow, n=name: calls.append(n) or torch.empty_like(img))
    m = ft.get_codec_model("ELFVC-SP-TPU-TINY", device="meta", sp_stage=2).module
    x = torch.empty(1, 12, 32, 64, device="meta")
    with torch.inference_mode():
        rec, _, state = m.forward_inter(x, x, m.init_state(1, 32, 64))
    assert rec.shape == x.shape and state.motion_info_prior.shape == x.shape
    assert sorted(calls) == ["pixel_warp"] * 2 + ["pixel_warp_s2d_sflow"] * 2
    assert not reached


@pytest.mark.parametrize("level", [0, 3, 6])
def test_shipped_elfvc_weights_map_completely(level):
    """tiny_elfvctpu_l{0,3,6}: ELFVC-SP-TPU-TINY, every one of the 217 keys
    mapped and every parameter set (the loader raises otherwise)."""
    spec = ft.get_codec_model("ELFVC-SP-TPU-TINY", device="cpu", sp_stage=2)
    with np.load(ft.weights.asset_path(f"tiny_elfvctpu_l{level}")) as data:
        assert len(data.files) == 217
        ft.weights.load_flat(spec.module, {k: data[k] for k in data.files})
        w = data["params/res_hyperprior/y_predictor/ResnetBlock_2/WSConvBlock_0/kernel"]
    got = spec.module.res_hyperprior.y_predictor.ResnetBlock_2.WSConvBlock_0.weight
    np.testing.assert_array_equal(got.detach().numpy(), w.astype(np.float32).transpose(3, 2, 0, 1))
    assert set(ft.weights.flax_shapes(spec.module)) == set(data.files)


def test_bf16_elfvc_keeps_spnet_norms_and_ws_kernels_in_float32():
    m = ft.get_codec_model("ELFVC-SP-TPU-TINY", dtype=torch.bfloat16, device="cpu").module
    sp = m.motion_hyperprior.y_predictor
    assert sp.Conv_0.weight.dtype == torch.bfloat16
    assert sp.ConvAttention_0.Conv_0.weight.dtype == torch.bfloat16
    assert m.flow_predictor.Conv_3.weight.dtype == torch.bfloat16
    for t in (sp.ResnetBlock_0.WSConvBlock_0.weight, sp.ResnetBlock_0.WSConvBlock_0.bias,
              sp.ResnetBlock_0.WSConvBlock_0.GroupNorm_0.scale, sp.ChannelLayerNorm_0.g):
        assert t.dtype == torch.float32


def test_seeded_ssf_weights_are_unchanged():
    """seeded_flat("SSF-TPU", 0): a sha256 over its sorted keys and float32
    bytes, taken on the tree before the ELFVC slice (new initialisers must
    not shift the draws of a codec that has none of their leaves)."""
    import hashlib

    flat = ft.weights.seeded_flat("SSF-TPU", 0)
    h = hashlib.sha256()
    for key in sorted(flat):
        h.update(key.encode())
        h.update(np.ascontiguousarray(flat[key], np.float32).tobytes())
    assert len(flat) == 141
    assert h.hexdigest() == "b0fd06ea58fc48050865cd7aee59ad3ddce4cc9b75eb7a81f0cc76b791ed9dcc"


@runs_blocked(
    "import numpy as np, torch, fastvideocodec_torch as ft\n"
    "from fastvideocodec_torch.coder import video as cv\n"
    "from fastvideocodec_torch.data.synthetic import synth_mv_gop\n"
    "spec = ft.get_codec_model('MCVC-IA-TINY', device='cpu', num_views=3)\n"
    "ft.load_asset(spec.module, 'tiny_mcvc_l3')\n"
    "clip = synth_mv_gop(np.random.default_rng(0), views=3, size=32, gop=2)\n"
    "gop = torch.from_numpy(np.ascontiguousarray(clip.transpose(0, 1, 4, 2, 3)))\n"
    "mask = np.asarray([1, 0, 1], np.float32)\n"
    "recon, m = ft.rollout(spec, gop, mask)\n"
    "assert recon.shape == (2, 3, 3, 32, 32) and bool(torch.isfinite(recon).all())\n"
    "assert float(m['bpp_est'][1]) > 0 and abs(float(m['completeness']) - 2 / 3) < 1e-6\n"
    "streams, rec, bits = cv.mcvc_compress_gop(spec, gop, mask)\n"
    "assert torch.equal(cv.mcvc_decompress_gop(spec, streams), rec) and bits > 0\n"
    "bad = [m for m in sys.modules\n"
    "       if m.split('.')[0] in ('jax', 'flax', 'fastvideocodec_tpu')]\n"
    "assert not bad, bad\n"
    "print('ok')\n"
)
def test_mcvc_rollout_and_real_bits_run_without_jax(blocked_results):
    check_blocked(blocked_results, "test_mcvc_rollout_and_real_bits_run_without_jax")


@pytest.mark.parametrize("name", ["MCVC", "MCVC-IA", "MCVC-IA-OLFT", "MCVC-IA-TINY"])
def test_mcvc_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        spec = ft.get_codec_model(name, num_views=2)
        assert next(spec.module.parameters()).device.type == "cuda"
    else:
        with (pytest.raises((RuntimeError, AssertionError))):
            ft.get_codec_model(name, num_views=2)


def test_mcvc_path_off_cpu_launches_pixel_warp_once_a_p_frame(monkeypatch):
    """One MCVC-IA-TINY P-frame on meta tensors (not the CPU), 2 items of 3
    views: the volume warp goes to pixel_warp's launcher once, with all 18
    channels of the 6 folded views, and no warp reaches a plain version.
    The launchers are stood in for by ones that count and return empty
    outputs, since there is no card here."""
    from fastvideocodec_torch.ops import warp as twarp
    from fastvideocodec_torch.ops.kernels import warp as kwarp

    calls, reached = [], []
    for name in twarp.PLAIN:
        monkeypatch.setitem(twarp.PLAIN, name, lambda *a, n=name: reached.append(n))
        monkeypatch.setattr(kwarp, f"launch_{name}",
                            lambda img, flow, n=name: calls.append((n, tuple(img.shape)))
                            or torch.empty_like(img))
    m = ft.get_codec_model("MCVC-IA-TINY", device="meta", num_views=3).module
    x = torch.empty(6, 3, 32, 64, device="meta")
    with torch.inference_mode():
        rec, enh, _ = m.forward_inter(x, x, torch.ones(6, device="meta"))
    assert rec.shape == enh.shape == x.shape
    assert calls == [("pixel_warp", (6, 18, 32, 64))]
    assert not reached


@pytest.mark.parametrize("level", [0, 3, 6])
def test_shipped_mcvc_weights_map_completely(level):
    """tiny_mcvc_l{0,3,6}: MCVC-IA-TINY, every one of the 169 keys mapped
    and every parameter set (the loader raises otherwise)."""
    spec = ft.get_codec_model("MCVC-IA-TINY", device="cpu", num_views=3)
    with np.load(ft.weights.asset_path(f"tiny_mcvc_l{level}")) as data:
        assert len(data.files) == 169
        ft.weights.load_flat(spec.module, {k: data[k] for k in data.files})
        w = data["params/backup_res_decoder/ConvAttention_0/Conv_0/kernel"]
    got = spec.module.backup_res_decoder.ConvAttention_0.Conv_0.weight
    np.testing.assert_array_equal(got.detach().numpy(),
                                  w.astype(np.float32).transpose(3, 2, 0, 1))
    assert set(ft.weights.flax_shapes(spec.module)) == set(data.files)


def test_seeded_elfvc_weights_are_unchanged():
    """seeded_flat("ELFVC-SP-TPU", 0): a sha256 over its sorted keys and
    float32 bytes, taken on the tree before the MCVC slice (its transforms
    gained the s2d=1 form without moving a draw)."""
    import hashlib

    flat = ft.weights.seeded_flat("ELFVC-SP-TPU", 0)
    h = hashlib.sha256()
    for key in sorted(flat):
        h.update(key.encode())
        h.update(np.ascontiguousarray(flat[key], np.float32).tobytes())
    assert h.hexdigest() == ELFVC_SP_TPU_SEEDED_SHA256


STOCK = ["SSF-Official", "SSF-TINY", "MCVC-Original", "ELFVC", "ELFVC-SP", "ELFVC-TINY",
         "ELFVC-SP-TINY"]


@pytest.mark.parametrize("name", STOCK)
def test_stock_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        spec = ft.get_codec_model(name)
        assert next(spec.module.parameters()).device.type == "cuda"
    else:
        with (pytest.raises((RuntimeError, AssertionError))):
            ft.get_codec_model(name)


@pytest.mark.parametrize("asset, name, n_keys", [
    *[(f"tiny_ssf_l{lv}", "SSF-TINY", 147) for lv in (0, 2, 4)],
    *[(f"lr_ssf_l{lv}", "SSF-TINY", 147) for lv in (0, 2, 4)],
    *[(f"tiny_elfvc_l{lv}", "ELFVC-SP-TINY", 223) for lv in (0, 3, 6)],
])
def test_shipped_stock_weights_map_completely(asset, name, n_keys):
    """Every key of the shipped stock checkpoints maps, and every parameter
    is set (the loader raises otherwise); the stock flow predictor's first
    kernel is (5, 5, 9, 32)."""
    spec = ft.get_codec_model(name, device="cpu", sp_stage=2)
    with np.load(ft.weights.asset_path(asset)) as data:
        assert len(data.files) == n_keys
        ft.weights.load_flat(spec.module, {k: data[k] for k in data.files})
        key = "params/res_decoder/PolyphaseDeconv_3/kernel"
        w = data[key].astype(np.float32)
        if name.startswith("ELFVC"):
            assert data["params/flow_predictor/Conv_0/kernel"].shape == (5, 5, 9, 32)
    got = spec.module.res_decoder.PolyphaseDeconv_3.weight.detach().numpy()
    np.testing.assert_array_equal(got, w.transpose(2, 3, 0, 1))
    assert set(ft.weights.flax_shapes(spec.module)) == set(data.files)


@runs_blocked(
    "import numpy as np, torch, fastvideocodec_torch as ft\n"
    "from fastvideocodec_torch.coder import video as cv\n"
    "from fastvideocodec_torch.data.synthetic import synth_gop, synth_mv_gop\n"
    "gop = torch.from_numpy(np.ascontiguousarray(\n"
    "    synth_gop(np.random.default_rng(0), size=32, gop=2).transpose(0, 3, 1, 2)))\n"
    "for name, asset, fns in (\n"
    "        ('SSF-TINY', 'tiny_ssf_l2', (cv.ssf_compress_gop, cv.ssf_decompress_gop)),\n"
    "        ('ELFVC-SP-TINY', 'tiny_elfvc_l3',\n"
    "         (cv.elfvc_compress_gop, cv.elfvc_decompress_gop))):\n"
    "    spec = ft.get_codec_model(name, device='cpu', sp_stage=2)\n"
    "    ft.load_asset(spec.module, asset)\n"
    "    recon, m = ft.rollout(spec, gop)\n"
    "    assert recon.shape == (1, 3, 32, 32) and bool(torch.isfinite(recon).all())\n"
    "    assert float(m['bpp_est'][0]) > 0\n"
    "    streams, rec, bits = fns[0](spec, gop[:, None])\n"
    "    assert torch.equal(fns[1](spec, streams), rec) and bits > 0\n"
    "views = torch.from_numpy(np.ascontiguousarray(\n"
    "    synth_mv_gop(np.random.default_rng(0), views=2, size=32, gop=2)\n"
    "    .transpose(0, 1, 4, 2, 3)))\n"
    "spec = ft.get_codec_model('MCVC-Original', device='cpu')\n"
    "ft.load_flat(spec.module, ft.seeded_flat('MCVC-Original', 0))\n"
    "recon, m = ft.rollout(spec, views)\n"
    "assert spec.family == 'ssf' and recon.shape == (1, 2, 3, 32, 32)\n"
    "bad = [m for m in sys.modules\n"
    "       if m.split('.')[0] in ('jax', 'flax', 'fastvideocodec_tpu')]\n"
    "assert not bad, bad\n"
    "print('ok')\n"
)
def test_stock_rollouts_and_real_bits_run_without_jax(blocked_results):
    check_blocked(blocked_results, "test_stock_rollouts_and_real_bits_run_without_jax")


DVC_FAMILY = ["DVC", "DVC-TINY", "DVC-pretrained", "RLVC", "RLVC2", "RLVC-HP", "RLVC-TINY",
              "RLVC2-TINY", "RLVC-HP-TINY", "Base", "Base-EC", "Base-ER", "Base-EC-ER",
              "Base-ER-TINY"]


@pytest.mark.parametrize("name", DVC_FAMILY)
def test_dvc_family_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        spec = ft.get_codec_model(name)
        assert next(spec.module.parameters()).device.type == "cuda"
    else:
        with (pytest.raises((RuntimeError, AssertionError))):
            ft.get_codec_model(name)
    spec = ft.get_codec_model(name, device="meta")
    assert spec.family == name.split("-")[0].rstrip("2").lower()


@pytest.mark.parametrize("asset, name, n_keys", [
    *[(f"tiny_dvc_l{lv}", "DVC-TINY", 162) for lv in (0, 2, 4)],
    *[(f"tiny_rlvc_l{lv}", "RLVC-TINY", 196) for lv in (0, 2, 4)],
    *[(f"tiny_base_l{lv}", "Base-ER-TINY", 186) for lv in (0, 2, 4)],
])
def test_shipped_dvc_family_weights_map_completely(asset, name, n_keys):
    """Every key of the shipped checkpoints maps and every parameter is set
    (the loader raises otherwise); a flax-SAME transposed conv's kernel
    [k, k, in, out] lands as torch's [in, out, k, k], unflipped."""
    spec = ft.get_codec_model(name, device="cpu")
    with np.load(ft.weights.asset_path(asset)) as data:
        assert len(data.files) == n_keys
        ft.weights.load_flat(spec.module, {k: data[k] for k in data.files})
        assert set(ft.weights.flax_shapes(spec.module)) == set(data.files)
        key = "params/res_dec4/kernel" if name.startswith("RLVC") else (
            "params/mv_decoder/PolyphaseDeconv_3/kernel")
        w = data[key].astype(np.float32)
    sub = spec.module.res_dec4 if name.startswith("RLVC") else (
        spec.module.mv_decoder.PolyphaseDeconv_3)
    np.testing.assert_array_equal(sub.weight.detach().numpy(), w.transpose(2, 3, 0, 1))


@pytest.mark.parametrize("name", ["DVC", "RLVC", "RLVC2", "RLVC-HP", "Base-EC-ER",
                                  "Base-ER-TINY", "RLVC-HP-TINY"])
def test_dvc_family_seeded_flat_has_the_jax_init(name):
    """Keys and shapes of the JAX module's init (eval_shape, nothing
    computed), and the values of its deterministic initialisers: GDN's
    beta and gamma; the CodecNet convs' 0.01 biases and Xavier-normal
    kernels (variance 2 / fan_avg, untruncated); BitEstimator N(0, 0.01)."""
    import jax
    import jax.numpy as jnp

    from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model

    module = jax_get_codec_model(name).module
    x = jnp.zeros((1, 64, 64, 3))
    if name.startswith("RLVC"):
        hidden = module.init_hidden(1, 64, 64)
        shapes = jax.eval_shape(lambda k: module.init(k, x, x, hidden, True, training=False),
                                jax.random.PRNGKey(0))
    else:
        shapes = jax.eval_shape(lambda k: module.init(k, x, x, training=False),
                                jax.random.PRNGKey(0))
    want = {"/".join(path): leaf.shape for path, leaf in _paths(shapes)}
    flat = ft.weights.seeded_flat(name, 0)
    assert {k: v.shape for k, v in flat.items()} == want
    from fastvideocodec_tpu.layers.codecnet import CodecNet, er_gen_config
    from fastvideocodec_tpu.ops.gdn import GDN

    gdn = [k for k in flat if k.endswith("/gamma")]
    assert gdn
    for key in gdn:  # GDN's own init, at the layer's width
        ch = flat[key].shape[0]
        want = GDN(ch).init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 1, ch)))["params"]
        for leaf in ("beta", "gamma"):
            np.testing.assert_array_equal(flat[key[: -len("gamma")] + leaf],
                                          np.asarray(want[leaf]))
    gens = sorted({k.split("/")[1] for k in flat if k.split("/")[1].endswith("_gen")})
    assert bool(gens) == ("-ER" in name)
    for gen in gens:  # the ER stacks: CodecNet's Xavier-normal kernels, 0.01 biases
        cin = flat[f"params/{gen}/conv_0/kernel"].shape[2]
        hidden_w = flat[f"params/{gen}/conv_0/kernel"].shape[3]
        want = CodecNet(er_gen_config(cin, hidden_w)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 1, 1, cin)))["params"]
        for conv in want:
            np.testing.assert_array_equal(flat[f"params/{gen}/{conv}/bias"],
                                          np.asarray(want[conv]["bias"]))
            kernel = flat[f"params/{gen}/{conv}/kernel"]
            k_, ci, co = kernel.shape[0], *kernel.shape[2:]
            std = np.sqrt(2.0 / (0.5 * k_ * k_ * (ci + co)))
            assert abs(kernel.std() / std - 1) < 0.1, (gen, conv)
            assert np.abs(kernel).max() > 2.5 * std  # untruncated
    h = [v for k, v in flat.items() if k.endswith(("/h", "/b", "/a"))]
    if "-HP" not in name and name != "RLVC" and name != "RLVC-TINY":  # BitEstimators
        assert h and 0.005 < np.concatenate(h).std() < 0.015


@runs_blocked(
    "import numpy as np, torch, fastvideocodec_torch as ft\n"
    "from fastvideocodec_torch.coder import video as cv\n"
    "from fastvideocodec_torch.data.synthetic import synth_gop\n"
    "gop = torch.from_numpy(np.ascontiguousarray(\n"
    "    synth_gop(np.random.default_rng(0), size=64, gop=3).transpose(0, 3, 1, 2)))\n"
    "for name, asset, fns in (\n"
    "        ('DVC-TINY', 'tiny_dvc_l2', (cv.dvc_compress_gop, cv.dvc_decompress_gop)),\n"
    "        ('Base-ER-TINY', 'tiny_base_l2', (cv.base_compress_gop, cv.base_decompress_gop)),\n"
    "        ('RLVC-TINY', 'tiny_rlvc_l2', (cv.rlvc_compress_gop, cv.rlvc_decompress_gop))):\n"
    "    spec = ft.get_codec_model(name, device='cpu')\n"
    "    ft.load_asset(spec.module, asset)\n"
    "    recon, m = ft.rollout(spec, gop)\n"
    "    assert recon.shape == (2, 3, 64, 64) and bool(torch.isfinite(recon).all())\n"
    "    assert float(m['bpp_est'][0]) > 0\n"
    "    streams, rec, bits = fns[0](spec, gop)\n"
    "    assert torch.equal(fns[1](spec, gop[0], streams), rec) and bits > 0\n"
    "from fastvideocodec_torch.layers.spynet import load_pretrained_spynet\n"
    "spec = ft.get_codec_model('RLVC-HP', device='cpu')\n"
    "ft.load_flat(spec.module, ft.seeded_flat('RLVC-HP', 0))\n"
    "load_pretrained_spynet(spec.module.optic_flow)\n"
    "recon, m = ft.rollout(spec, gop)\n"
    "assert spec.family == 'rlvc' and recon.shape == (2, 3, 64, 64)\n"
    "bad = [m for m in sys.modules\n"
    "       if m.split('.')[0] in ('jax', 'flax', 'fastvideocodec_tpu')]\n"
    "assert not bad, bad\n"
    "print('ok')\n"
)
def test_dvc_family_rollouts_and_real_bits_run_without_jax(blocked_results):
    check_blocked(blocked_results, "test_dvc_family_rollouts_and_real_bits_run_without_jax")


@pytest.mark.parametrize("name", ["DVC", "Base-EC-ER", "RLVC", "RLVC-HP", "RLVC2"])
def test_dvc_family_p_frame_off_cpu_launches_flow_warp_five_times(monkeypatch, name):
    """One full-width P-frame on meta tensors (not the CPU), 2 items of
    64x128 given as a permuted (not contiguous) view (RLVC's second
    P-frame, the RPM's branch, too): the four SpyNet levels and the MC warp
    go to flow_warp's launcher with contiguous tensors, the MC warp with
    the 3-channel frame at full resolution, and no warp reaches a plain
    version. The launchers are stood in for by ones that count and return
    empty outputs, since there is no card here."""
    from fastvideocodec_torch.ops import warp as twarp
    from fastvideocodec_torch.ops.kernels import warp as kwarp

    calls, reached = [], []

    def launcher(img, flow, n):
        assert img.is_contiguous() and flow.is_contiguous(), n
        calls.append((n, tuple(img.shape)))
        return torch.empty_like(img)

    for kname in twarp.PLAIN:
        monkeypatch.setitem(twarp.PLAIN, kname, lambda *a, n=kname: reached.append(n))
        monkeypatch.setattr(kwarp, f"launch_{kname}",
                            lambda img, flow, n=kname: launcher(img, flow, n))
    spec = ft.get_codec_model(name, device="meta")
    m = spec.module
    x = torch.empty(2, 64, 128, 3, device="meta").permute(0, 3, 1, 2)
    levels = [("flow_warp", (2, 3, 64 // f, 128 // f)) for f in (8, 4, 2, 1)]
    with torch.inference_mode():
        if spec.family == "rlvc":
            hidden = m.init_hidden(2, 64, 128)
            for flag in (False, True):
                calls.clear()
                rec, hidden, _ = m(x, x, hidden, flag)
                assert calls == levels + [("flow_warp", (2, 3, 64, 128))]
        else:
            rec, _ = m(x, x)
            assert calls == levels + [("flow_warp", (2, 3, 64, 128))]
    assert rec.shape == x.shape
    assert not reached


LSVC_FORMS = ["LSVC", "LSVC-128", "LSVC-TINY", "LSVC-TPU-RW", "LSVC-TPU-HF", "LSVC-TPU-WT",
              "LSVC-TPU-HU", "LSVC-TPU-QU", "LSVC-TPU-A", "LSVC-TPU-S", "LSVC-TPU-L",
              "LSVC-TPU-O", "LSVC-TPU-D"]


@pytest.mark.parametrize("name", LSVC_FORMS)
def test_lsvc_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        spec = ft.get_codec_model(name)
        assert next(spec.module.parameters()).device.type == "cuda"
    else:
        with (pytest.raises((RuntimeError, AssertionError))):
            ft.get_codec_model(name)
    assert ft.get_codec_model(name, device="meta").family == "lsvc"


@pytest.mark.parametrize("name", ["LSVC-128", "LSVC-TPU-RW", "LSVC-TPU-HF", "LSVC-TPU-QU",
                                  "LSVC-TPU-S", "LSVC-TPU-L", "LSVC-TPU-O"])
def test_lsvc_forward_off_cpu_sends_each_warp_to_its_kernel(monkeypatch, name):
    """The full-width forward of 3 P-frames of 64x128 on meta tensors (not
    the CPU): SpyNet's 4 levels, all P-frames in one batch, go to
    flow_warp's launcher; each graph layer's MC warp to flow_warp (s2d=1:
    the 3-channel frame; -RW: the 12-channel s2d frame at half resolution)
    or to flow_warp_s2d; no warp reaches a plain version. The launchers are
    stood in for by ones that record and return empty outputs."""
    from fastvideocodec_torch.ops import warp as twarp
    from fastvideocodec_torch.ops.kernels import warp as kwarp

    calls, reached = [], []

    def launcher(img, flow, n):
        assert img.is_contiguous() and flow.is_contiguous(), n
        calls.append((n, tuple(img.shape)))
        return torch.empty_like(img)

    for kname in twarp.PLAIN:
        monkeypatch.setitem(twarp.PLAIN, kname, lambda *a, n=kname: reached.append(n))
        monkeypatch.setattr(kwarp, f"launch_{kname}",
                            lambda img, flow, n=kname: launcher(img, flow, n))
    m = ft.get_codec_model(name, device="meta").module
    with torch.inference_mode():
        com, *_ = m(torch.empty(4, 3, 64, 128, device="meta"))
    s2d = m.s2d
    h, w = 64 // s2d, 128 // s2d
    spynet = [("flow_warp", (3, 3, h // f, w // f)) for f in (8, 4, 2, 1)]
    layers = [len(layer) for layer in m.schedule(3).layers]
    if s2d == 1:
        mc = [("flow_warp", (n, 3, 64, 128)) for n in layers]
    elif name == "LSVC-TPU-RW":
        mc = [("flow_warp", (n, 12, 32, 64)) for n in layers]
    else:
        mc = [("flow_warp_s2d", (n, 12, 32, 64)) for n in layers]
    assert calls == spynet + mc
    assert com.shape == (3, 3, 64, 128)
    assert not reached


@runs_blocked(
    "import numpy as np, torch, fastvideocodec_torch as ft\n"
    "from fastvideocodec_torch.coder import video as cv\n"
    "from fastvideocodec_torch.data.synthetic import synth_gop\n"
    "gop = torch.from_numpy(np.ascontiguousarray(\n"
    "    synth_gop(np.random.default_rng(0), size=64, gop=3).transpose(0, 3, 1, 2)))\n"
    "for name, weights in (('LSVC-TINY', 'tiny_lsvc_l2'), ('LSVC-TPU-HF-TINY', None),\n"
    "                      ('LSVC-TPU-TINY-L', 'tiny_lsvctpu_l2')):\n"
    "    spec = ft.get_codec_model(name, device='cpu')\n"
    "    if weights:\n"
    "        ft.load_asset(spec.module, weights)\n"
    "    else:\n"
    "        ft.load_flat(spec.module, ft.seeded_flat(name, 0))\n"
    "    recon, m = ft.rollout(spec, gop)\n"
    "    assert recon.shape == (2, 3, 64, 64) and bool(torch.isfinite(recon).all())\n"
    "    streams, rec, bits = cv.lsvc_compress(spec, gop)\n"
    "    assert torch.equal(cv.lsvc_decompress(spec, gop[0], streams, 2), rec) and bits > 0\n"
    "    decode, (mv, zs, fs) = ft.build_lsvc_decode(spec.module, 3, 64, 64)\n"
    "    iframe = spec.module.fold(gop[:1])[0][0]\n"
    "    assert decode(iframe, mv, zs, fs)[2].shape == (2, 3, 64, 64)\n"
    "from fastvideocodec_torch.analysis import bd_rate\n"
    "curve = ([1, 2, 3, 4], [30, 32, 33, 34])\n"
    "assert abs(bd_rate(*curve, *curve)) < 1e-9\n"
    "bad = [m for m in sys.modules\n"
    "       if m.split('.')[0] in ('jax', 'flax', 'fastvideocodec_tpu')]\n"
    "assert not bad, bad\n"
    "print('ok')\n"
)
def test_lsvc_forms_run_without_jax(blocked_results):
    check_blocked(blocked_results, "test_lsvc_forms_run_without_jax")


@runs_blocked(
    "import os, tempfile, numpy as np, torch, fastvideocodec_torch as ft\n"
    "from fastvideocodec_torch.data.synthetic import synth_gop\n"
    "from fastvideocodec_torch.ops.math import UniformNoise\n"
    "from fastvideocodec_torch import train\n"
    "spec = ft.get_codec_model('LSVC-TPU-TINY', device='cpu')\n"
    "ft.load_asset(spec.module, 'tiny_lsvctpu_l2')\n"
    "clip = synth_gop(np.random.default_rng(0), size=64, gop=4)\n"
    "gop = torch.from_numpy(np.array(clip.transpose(0, 3, 1, 2)))\n"
    "ft.rollout(spec, gop)\n"
    "params = train.ready_for_training(spec)\n"
    "init_fn, step_fn = train.make_train_step(spec, train.TrainConfig())\n"
    "params, state, m = step_fn(params, init_fn(params), gop, UniformNoise(0))\n"
    "assert all(bool(torch.isfinite(v)) for v in m.values())\n"
    "with tempfile.TemporaryDirectory() as d:\n"
    "    train.save_checkpoint(d, {'params': params, 'opt_state': state, 'epoch': 0,\n"
    "                              'score': 1.0})\n"
    "    assert train.load_checkpoint(d)['opt_state']['main']['count'] == 1\n"
    "bad = [m for m in sys.modules\n"
    "       if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'PIL',\n"
    "                              'fastvideocodec_tpu')]\n"
    "assert not bad, bad\n"
    "print('ok')\n"
)
def test_training_step_runs_without_jax(blocked_results):
    """An eval rollout, then a training step and a checkpoint round trip of
    LSVC-TPU-TINY on the CPU, with JAX, optax, orbax and PIL unimportable."""
    check_blocked(blocked_results, "test_training_step_runs_without_jax")


@runs_blocked(
    "import numpy as np, torch, fastvideocodec_torch as ft\n"
    "from fastvideocodec_torch.cli import train_multiview\n"
    "from fastvideocodec_torch.data import multiview\n"
    "from fastvideocodec_torch.data.synthetic import synth_mv_gop\n"
    "from fastvideocodec_torch.ops.math import UniformNoise\n"
    "from fastvideocodec_torch.train import olft, TrainConfig, ready_for_training\n"
    "spec = ft.get_codec_model('MCVC-IA-OLFT-TINY', device='cpu', num_views=3)\n"
    "ft.load_asset(spec.module, 'tiny_mcvc_l3')\n"
    "assert spec.olft\n"
    "clip = synth_mv_gop(np.random.default_rng(0), views=3, size=64, gop=3)\n"
    "gop = torch.from_numpy(np.ascontiguousarray(clip.transpose(0, 1, 4, 2, 3)))\n"
    "params = ready_for_training(spec)\n"
    "init_fn, step_fn = olft.make_olft_step(spec, TrainConfig(learning_rate=1e-5), 0.1)\n"
    "mask = np.array([1, 1, 0], np.float32)\n"
    "params, state, m = step_fn(params, init_fn(params), gop, UniformNoise(0), mask)\n"
    "n = olft.touchup_bytes(m.pop('touch_refs'), m.pop('touch_labels'), m.pop('touch_mask'))\n"
    "assert n > 0 and all(bool(torch.isfinite(v)) for v in m.values()), m\n"
    "assert state['main']['count'] == 1\n"
    "bad = [m for m in sys.modules\n"
    "       if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'PIL',\n"
    "                              'fastvideocodec_tpu')]\n"
    "assert not bad, bad\n"
    "print('ok')\n"
)
def test_olft_step_runs_without_jax(blocked_results):
    """One OLFT step of MCVC-IA-OLFT-TINY on the CPU, its touch-up labels
    priced on the host, with train.olft, data.multiview and
    cli.train_multiview imported and JAX, optax, orbax and PIL
    unimportable."""
    check_blocked(blocked_results, "test_olft_step_runs_without_jax")


@runs_blocked(
    "import numpy as np, torch, fastvideocodec_torch as ft\n"
    "from fastvideocodec_torch.data.synthetic import synth_gop\n"
    "from fastvideocodec_torch.ops import ms_ssim\n"
    "from fastvideocodec_torch.ops.math import UniformNoise\n"
    "from fastvideocodec_torch.train import TrainConfig, make_train_step, ready_for_training\n"
    "spec = ft.get_codec_model('DVC-TINY', device='cpu')\n"
    "ft.load_asset(spec.module, 'tiny_dvc_l2')\n"
    "clip = synth_gop(np.random.default_rng(0), size=64, gop=3)\n"
    "gop = torch.from_numpy(np.ascontiguousarray(clip.transpose(0, 3, 1, 2)))\n"
    "params = ready_for_training(spec)\n"
    "init_fn, step_fn = make_train_step(spec, TrainConfig())\n"
    "params, state, m = step_fn(params, init_fn(params), gop, UniformNoise(0))\n"
    "assert all(bool(torch.isfinite(v)) for v in m.values()), m\n"
    "assert state['main']['count'] == 1\n"
    "x = torch.rand(1, 3, 176, 176)\n"
    "assert abs(float(ms_ssim(x, x)) - 1.0) < 1e-5\n"
    "bad = [m for m in sys.modules\n"
    "       if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'PIL',\n"
    "                              'fastvideocodec_tpu')]\n"
    "assert not bad, bad\n"
    "print('ok')\n"
)
def test_dvc_step_runs_without_jax(blocked_results):
    """One training step of DVC-TINY on tiny_dvc_l2 on the CPU, and the
    MS-SSIM loss of the module's ops, with JAX, optax, orbax and PIL
    unimportable."""
    check_blocked(blocked_results, "test_dvc_step_runs_without_jax")


@runs_blocked(
    "import numpy as np, torch, fastvideocodec_torch as ft\n"
    "from fastvideocodec_torch.data.synthetic import synth_gop\n"
    "from fastvideocodec_torch.ops.math import UniformNoise\n"
    "from fastvideocodec_torch.train import TrainConfig, make_train_step, ready_for_training\n"
    "spec = ft.get_codec_model('SSF-TPU-TINY', device='cpu')\n"
    "ft.load_asset(spec.module, 'tiny_ssftpu_l2')\n"
    "clip = synth_gop(np.random.default_rng(0), size=64, gop=3)\n"
    "gop = torch.from_numpy(np.ascontiguousarray(clip.transpose(0, 3, 1, 2)))\n"
    "params = ready_for_training(spec, torch.bfloat16)\n"
    "start = {n: p.detach().clone() for n, p in params.items()}\n"
    "init_fn, step_fn = make_train_step(spec, TrainConfig())\n"
    "params, state, m = step_fn(params, init_fn(params), gop, UniformNoise(0))\n"
    "assert all(bool(torch.isfinite(v)) for v in m.values()), m\n"
    "assert {p.dtype for p in params.values()} == {torch.float32}\n"
    "assert any(not torch.equal(p, start[n]) for n, p in params.items())\n"
    "bad = [m for m in sys.modules\n"
    "       if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'PIL',\n"
    "                              'fastvideocodec_tpu')]\n"
    "assert not bad, bad\n"
    "print('ok')\n"
)
def test_bf16_step_runs_without_jax(blocked_results):
    """One bf16 training step (float32 masters, bf16 compute) of
    SSF-TPU-TINY on tiny_ssftpu_l2 on the CPU with JAX, optax, orbax and
    PIL unimportable: finite metrics, float32 parameters that moved."""
    check_blocked(blocked_results, "test_bf16_step_runs_without_jax")


@runs_blocked(
    "import os, tempfile, numpy as np, torch, fastvideocodec_torch as ft\n"
    "from fastvideocodec_torch import anchors, data\n"
    "from fastvideocodec_torch.analysis import rd_points\n"
    "from fastvideocodec_torch.data.synthetic import synth_gop\n"
    "from fastvideocodec_torch.train.evaluate import evaluate_video\n"
    "from fastvideocodec_torch.train.evolve import evolve_on_video\n"
    "spec = ft.get_codec_model('LSVC-TPU-TINY', device='cpu')\n"
    "ft.load_asset(spec.module, 'tiny_lsvctpu_l2')\n"
    "clip = synth_gop(np.random.default_rng(0), size=64, gop=3)\n"
    "class Clip:\n"
    "    seen = 0\n"
    "    def __len__(self):\n"
    "        return len(clip)\n"
    "    def __getitem__(self, idx):\n"
    "        self.seen += 1\n"
    "        return clip[self.seen - 1], self.seen == len(clip)\n"
    "_, best = evolve_on_video(spec, [clip], steps=1)\n"
    "assert np.isfinite(best)\n"
    "with tempfile.TemporaryDirectory() as d:\n"
    "    log = os.path.join(d, 'LSVC-TPU-TINY.clip.0.log')\n"
    "    s = evaluate_video(spec, Clip(), gop_size=3, log_path=log, real_bits=True)\n"
    "    pts = rd_points(log)\n"
    "    try:\n"
    "        data.VideoDataset(d)\n"
    "    except RuntimeError as e:\n"
    "        assert 'OpenCV required' in str(e)\n"
    "    else:\n"
    "        raise AssertionError('VideoDataset without OpenCV')\n"
    "assert s['bpp'] > 0 and abs(pts[0]['bpp'] - s['bpp']) < 1e-4, (s, pts)\n"
    "bad = [m for m in sys.modules\n"
    "       if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'PIL',\n"
    "                              'fastvideocodec_tpu', 'cv2', 'matplotlib')]\n"
    "assert not bad, bad\n"
    "print('ok')\n"
)
def test_eval_path_runs_without_jax(blocked_results):
    """LSVC-TPU-TINY evolved one step, then evaluated with real bits on an
    in-memory clip that keeps VideoDataset's contract, its log read back
    by rd_points, with JAX, optax, orbax, PIL, OpenCV and matplotlib
    unimportable; VideoDataset raises JAX's error without OpenCV."""
    check_blocked(blocked_results, "test_eval_path_runs_without_jax")


def test_eval_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """cli/eval.py, cli/train.py --evaluate and cli/train_multiview.py
    --task speed build their codecs on the card unless --device cpu: with
    no card here each raises where it builds one."""
    from fastvideocodec_torch.cli import eval as eval_cli
    from fastvideocodec_torch.cli import train as train_cli
    from fastvideocodec_torch.cli import train_multiview as mv_cli

    for cli in (eval_cli, train_cli, mv_cli):
        assert cli.parse_args(["--dataset-dir", "d"]).device == "cuda"
    if torch.cuda.is_available():
        return
    monkeypatch.chdir(tmp_path)
    (tmp_path / "empty").mkdir()
    runs = [
        lambda: eval_cli.main(["--codec", "LSVC-TPU-TINY", "--dataset-dir", "empty"]),
        lambda: train_cli.main(["--codec", "LSVC-TPU-TINY", "--dataset-dir", "d", "--evaluate",
                                "--test-dataset-dir", "empty"]),
        lambda: mv_cli.main(["--task", "speed", "--codec", "MCVC-IA-TINY", "--max-views", "1"]),
    ]
    for run in runs:
        with pytest.raises((RuntimeError, AssertionError)):
            run()


@runs_blocked(
    "import numpy as np, torch\n"
    "from fastvideocodec_torch.tools import train_tiny as tt\n"
    "from fastvideocodec_torch.cli import simulate\n"
    "from fastvideocodec_torch.utils.flowviz import flow_to_image\n"
    "from fastvideocodec_torch.layers import ContextVP\n"
    "from fastvideocodec_torch.ops.warp import warp_volume_pyramid\n"
    "import contextlib, io, tempfile, os\n"
    "d = tempfile.mkdtemp()\n"
    "with contextlib.redirect_stdout(io.StringIO()):\n"
    "    done = tt.main(['lsvctpu', '--levels', '2', '--steps', '1', '--out', d,\n"
    "                    '--device', 'cpu'])\n"
    "assert os.path.exists(os.path.join(d, 'tiny_lsvctpu_l2.npz')), done\n"
    "from fastvideocodec_torch.utils.logs import write_eval_log\n"
    "for lvl in (0, 2):\n"
    "    write_eval_log(os.path.join(d, 'a.log'), lvl, 0.1 * (lvl + 1), 0.01, 0.006,\n"
    "                   [30.0 + lvl] * 32)\n"
    "with contextlib.redirect_stdout(io.StringIO()):\n"
    "    (_, r), = simulate.main(['--logs', os.path.join(d, 'a.log'), '--num-traces', '2'])\n"
    "assert np.isfinite(r['qoe']).all()\n"
    "assert flow_to_image(np.ones((4, 5, 2), np.float32)).shape == (4, 5, 3)\n"
    "cvp = ContextVP(8, 8, num_views=2, width=4, height=4)\n"
    "assert cvp(torch.zeros(4, 8, 4, 4)).shape == (4, 8, 4, 4)\n"
    "out = warp_volume_pyramid(torch.rand(1, 3, 8, 8), torch.rand(1, 15, 4, 4),\n"
    "                          torch.zeros(1, 2, 8, 8), torch.zeros(1, 1, 8, 8), 5)\n"
    "assert out.shape == (1, 3, 8, 8)\n"
    "bad = [m for m in sys.modules\n"
    "       if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'PIL',\n"
    "                              'fastvideocodec_tpu', 'cv2', 'matplotlib')]\n"
    "assert not bad, bad\n"
    "print('ok')\n"
)
def test_tools_run_without_jax(blocked_results):
    """train_tiny (one step of LSVC-TPU-TINY, its npz written),
    cli/simulate.py on a log the port wrote, flow_to_image, ContextVP and
    warp_volume_pyramid, with JAX, optax, orbax, PIL, OpenCV and
    matplotlib unimportable."""
    check_blocked(blocked_results, "test_tools_run_without_jax")


def test_tool_entry_points_default_to_the_card():
    """train_tiny, price_hd and speed_sweep run on the card unless
    --device cpu: with no card here each raises where it builds a codec."""
    from fastvideocodec_torch.tools import price_hd, speed_sweep
    from fastvideocodec_torch.tools import train_tiny as tt

    assert tt.parse_args(["lsvctpu"]).device == "cuda"
    assert price_hd.parse_args([]).device == "cuda"
    assert speed_sweep.parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        return
    runs = [lambda: tt.main(["lsvctpu", "--levels", "2", "--steps", "1", "--out", "/nonexistent"]),
            lambda: speed_sweep.main(["--codec", "LSVC-TPU-TINY", "--gops", "2", "--skip-ssf",
                                      "--h", "64", "--w", "64"]),
            lambda: price_hd.main(["LSVC-TPU", "lsvctpuf2"]),
            lambda: tt.FAMILIES["lsvctpu"].spec(2)]
    for run in runs:
        with pytest.raises((RuntimeError, AssertionError)):
            run()
