"""Package-level guards of the PyTorch port.

- The port and chip_smoke.py import with jax, flax and fastvideocodec_tpu
  unimportable (the card's machine has none of them).
- chip_smoke.py exits non-zero, printing no result, without a CUDA card and
  in a directory that holds nothing else of the repo.
- The weight loader raises on unknown and on missing parameters.
- Entry points default to the card.
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
    files.append(REPO / "chip_smoke.py")
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
