"""Package-level guards of the PyTorch port.

- The port, chip_smoke.py and warp_ab.py import with jax, flax and
  fastvideocodec_tpu unimportable (the card's machine has none of them).
- chip_smoke.py exits non-zero, printing no result, without a CUDA card and
  in a directory that holds nothing else of the repo.
- The weight loader raises on unknown and on missing parameters.
- Entry points default to the card, and a CUDA-side tensor never reaches
  a warp's plain version.
- ``seeded_flat`` gives the keys and shapes of the JAX modules' ``init``.
- The port holds only small text files, and builds its kernels with nvcc
  alone: no PyTorch extension builder, no PyTorch C++ headers.
"""

import inspect
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

BLOCKER = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "fastvideocodec_tpu"):
            raise ImportError(f"blocked: {{name}}")
        return None
sys.meta_path.insert(0, _Block())
sys.path.insert(0, {repo!r})
"""


def run_blocked(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-c", BLOCKER.format(repo=str(REPO)) + code],
        capture_output=True, text=True, timeout=120, cwd=str(REPO), env=env,
    )


def test_port_imports_without_jax():
    r = run_blocked(
        "import pkgutil, importlib, fastvideocodec_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'fastvideocodec_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'fastvideocodec_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_chip_smoke_imports_without_jax():
    r = run_blocked(
        "import chip_smoke\n"
        "assert callable(chip_smoke.main)\n"
        "print('ok')\n"
    )
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def _no_result(r: subprocess.CompletedProcess) -> bool:
    return r.returncode != 0 and '"ok"' not in r.stdout


def test_warp_ab_imports_without_jax_and_needs_a_card():
    r = run_blocked(
        "import warp_ab\n"
        "assert callable(warp_ab.main)\n"
        "print('ok')\n"
    )
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
    if not torch.cuda.is_available():
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        r = subprocess.run([sys.executable, "warp_ab.py", f"warp={build.SOURCE}"],
                           capture_output=True, text=True, timeout=120, cwd=str(REPO), env=env)
        assert r.returncode != 0 and "median" not in r.stdout, r.stdout


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


def test_ssf_rollout_runs_without_jax():
    r = run_blocked(
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
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


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


@pytest.mark.parametrize("name", ["SSF-TPU", "SSF-TPU-TINY"])
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

    module = jax_get_codec_model(name).module
    shapes = jax.eval_shape(lambda k, f: module.init(k, f),
                            jax.random.PRNGKey(0), jnp.zeros((2, 1, 32, 64, 3)))
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
    with pytest.raises(ValueError):
        ft.get_codec_model("DVC", device="cpu")


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
