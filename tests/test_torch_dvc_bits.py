"""Real bitstreams of DVC, Base and RLVC in the port against the JAX
package's, on the CPU, in float32.

Cases, on ``synth_gop(np.random.default_rng(123), size=64, gop=4)`` (the
golden RD clip) unless stated: DVC-TINY (tiny_dvc_l2), Base-ER-TINY
(tiny_base_l2), RLVC-TINY (tiny_rlvc_l2), RLVC-HP-TINY on
``seeded_flat(.., 0)``, and full-width Base-EC on ``seeded_flat(.., 0)``
at 64x128. For each:

- decode == encode recon, bit for bit;
- every stream's bytes and every latent's shape equal JAX's, and the bits;
- the port decodes JAX's streams to its own recon, bit for bit;
- the port's recon within 1e-5 of JAX's (seeded Base-EC: 1e-4);
- the symbols each P-frame hands the coder are not all 0 in any P-frame
  of DVC-TINY and RLVC-TINY (checked here, so that the byte equality
  covers nonzero symbols);
- in bfloat16, decode == encode bit for bit (DVC-TINY, RLVC-TINY,
  RLVC-HP-TINY).

RLVC2's real-bits call raises: the JAX package has no real-bits path for
'rpm2'.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.coder import video as tv
from fastvideocodec_torch.data.synthetic import synth_gop
from fastvideocodec_torch.weights import load_flat
from fastvideocodec_tpu.coder import video as jv
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model

CASES = {  # case: (registry name, weights, family, H, W, recon tolerance)
    "DVC-TINY": ("DVC-TINY", "tiny_dvc_l2", "dvc", 64, 64, 1e-5),
    "Base-ER-TINY": ("Base-ER-TINY", "tiny_base_l2", "base", 64, 64, 1e-5),
    "RLVC-TINY": ("RLVC-TINY", "tiny_rlvc_l2", "rlvc", 64, 64, 1e-5),
    "RLVC-HP-TINY": ("RLVC-HP-TINY", "seeded 0", "rlvc", 64, 64, 1e-5),
    "Base-EC": ("Base-EC", "seeded 0", "base", 64, 128, 1e-4),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's convs at these sizes run as fast on one thread as on
    eight, and the suite's parallel workers share the host's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@functools.lru_cache(maxsize=8)
def flat_params(name: str, weights: str) -> dict:
    if weights == "seeded 0":
        return ft.seeded_flat(name, 0)
    with np.load(ft.weights.asset_path(weights)) as data:
        return {k: data[k].astype(np.float32) for k in data.files}


def jax_params(name, weights) -> dict:
    tree: dict = {}
    for key, value in flat_params(name, weights).items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(value)
    return tree


def port_model(name, weights, dtype=torch.float32):
    spec = ft.get_codec_model(name, dtype=dtype, device="cpu")
    load_flat(spec.module, flat_params(name, weights))
    return spec


def frames(h, w) -> np.ndarray:
    clip = synth_gop(np.random.default_rng(123), size=max(h, w), gop=4)
    return clip[:, :h, :w]


def tensor(clip: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(clip.transpose(0, 3, 1, 2)))


def coders(family):
    return {"dvc": (tv.dvc_compress_gop, tv.dvc_decompress_gop),
            "base": (tv.base_compress_gop, tv.base_decompress_gop),
            "rlvc": (tv.rlvc_compress_gop, tv.rlvc_decompress_gop)}[family]


@functools.lru_cache(maxsize=8)
def jax_streams(case):
    """JAX's (streams, recon, bits) in the port's stream layout."""
    name, weights, family, h, w, _ = CASES[case]
    spec = jax_get_codec_model(name)
    out = getattr(jv, f"{family}_compress_gop")(spec, jax_params(name, weights),
                                                 jnp.asarray(frames(h, w)))
    if family == "rlvc":
        streams, recon, bits, shapes = out
        streams = {"frames": streams, "shapes": shapes}
    else:
        streams, recon, bits = out
    return streams, np.asarray(recon), bits


@pytest.mark.parametrize("case", sorted(CASES))
def test_streams_are_jax_bytes(case):
    name, weights, family, h, w, tol = CASES[case]
    compress, decompress = coders(family)
    spec = port_model(name, weights)
    gop = tensor(frames(h, w))
    streams, recon, bits = compress(spec, gop)
    assert recon.shape == (3, 3, h, w)
    assert torch.equal(decompress(spec, gop[0], streams), recon)
    jstreams, jrecon, jbits = jax_streams(case)
    assert bits == jbits
    assert len(streams["frames"]) == len(jstreams["frames"]) == 3
    for got, want in zip(streams["frames"], jstreams["frames"]):
        assert sorted(got) == sorted(want)
        for key in got:
            assert got[key] == want[key], key
    if family == "rlvc":
        assert {k: tuple(v) for k, v in streams["shapes"].items()} == {
            k: tuple(v) for k, v in jstreams["shapes"].items()}
    else:
        assert [{k: tuple(v) for k, v in s.items()} for s in streams["shapes"]] == [
            {k: tuple(v) for k, v in s.items()} for s in jstreams["shapes"]]
    np.testing.assert_allclose(recon.numpy().transpose(0, 2, 3, 1), jrecon, rtol=0, atol=tol)
    # JAX's streams, as the JAX package returns them, decode in the port
    assert torch.equal(decompress(spec, gop[0], jstreams), recon)


@pytest.mark.parametrize("case", ["DVC-TINY", "RLVC-TINY"])
def test_every_p_frame_codes_nonzero_symbols(case, monkeypatch):
    """The integer symbols each P-frame hands the coder, recorded as the
    encoder takes them (DVC: mv, z, features; RLVC's Gaussian frames: mv,
    residual) and, for RLVC's factorized first frame, decoded back from its
    streams: not all 0 in any frame, so the byte equality above holds on
    real symbols."""
    name, weights, family, h, w, _ = CASES[case]
    taken = []
    shipped = tv._int_symbols
    monkeypatch.setattr(tv, "_int_symbols", lambda q: taken.append(q.clone()) or shipped(q))
    spec = port_model(name, weights)
    streams, _, _ = coders(family)[0](spec, tensor(frames(h, w)))
    if family == "dvc":
        per_frame = [taken[3 * t: 3 * t + 3] for t in range(3)]
    else:
        mv, res = tv.rlvc_codecs(spec.module)
        first = [c.fcodec.decompress(streams["frames"][0][k], streams["shapes"][k])
                 - c.fcodec.medians for c, k in ((mv, "mv"), (res, "res"))]
        per_frame = [first] + [taken[2 * t: 2 * t + 2] for t in range(2)]
    assert len(taken) == (9 if family == "dvc" else 4)
    for t, symbols in enumerate(per_frame):
        assert any(np.count_nonzero(np.asarray(s)) for s in symbols), (case, t)


@pytest.mark.parametrize("case", ["DVC-TINY", "RLVC-TINY", "RLVC-HP-TINY"])
def test_bf16_decode_equals_encode(case):
    name, weights, family, h, w, _ = CASES[case]
    compress, decompress = coders(family)
    spec = port_model(name, weights, torch.bfloat16)
    gop = tensor(frames(h, w))
    streams, recon, bits = compress(spec, gop)
    assert recon.dtype == torch.bfloat16 and bits > 0
    assert torch.equal(decompress(spec, gop[0], streams), recon)


def test_rlvc2_real_bits_raise():
    spec = port_model("RLVC2-TINY", "seeded 0")
    with pytest.raises(ValueError, match="RLVC2"):
        tv.rlvc_compress_gop(spec, tensor(frames(64, 64)))
    with pytest.raises(ValueError, match="RLVC2"):
        tv.rlvc_codecs(spec.module)
