"""Whole-GOP real-bitstream encode and decode of LSVC (every form: s2d=1
and s2d=2, every graph), the SSF, ELFVC and MCVC families, DVC,
Base(-EC/-ER) and RLVC (RLVC, RLVC-HP), ported from
fastvideocodec_tpu/coder/video.py.

LSVC (tree codec):
  encode: flow + mv analysis for all P-frames in one batch -> mv symbols to
          the host BitEstimator coder; then per graph layer, the whole
          layer in one batch: motion compensation, residual analysis -> z
          symbols (BitEstimator coder) and f16 sigmas (one prior-decoder
          call on the layer's z) -> feature symbols (Laplace coder) ->
          recon, which feeds the next layer. These are the rollout's
          batches, and JAX's coder's, for every registry name; a module
          built with ``per_layer_mv`` or ``layer_chunk`` batches its
          rollout otherwise, which changes the result of an -A/-S form.
  decode: the mirror image, from (I-frame, bitstreams) only.
SSF (chain codec): keyframe, then per P-frame the motion and the residual
  hyperpriors (z: factorized tables; y: Gaussian scale-table coder).
ELFVC (chain codec with state): as SSF, with the motion coded as a delta
  on the carried motion prior, after a flow predictor that only the
  encoder runs; with -SP the hyperpriors' SPnets predict y from the
  decoded symbols (and the previous frame's) on both sides.
MCVC (chain codec over views folded into the batch): as SSF with the
  keyframe coded, the failed views zeroed before analysis and the view
  mask carried in the streams; with -IA both sides run the backup
  cross-view-attention decoders on the decoded masked latents.
DVC and Base (chain of P-frames on the previous recon, frame 0 uncoded):
  three streams a frame, mv and z by their BitEstimators, the residual
  features by the Laplace coder with the scales decoded from z; Base's
  ER and EC corrections come from the decoded symbols on both sides.
RLVC (chain with recurrent state): per frame the mv and the residual
  latents of the two Coder2Ds, factorized on the first P-frame and
  Gaussian with the RPM's (sigma, mu) after ('rpm'), or z by its
  factorized tables and the latent Gaussian ('mshyper', RLVC-HP); the
  decoder rebuilds the LSTM, RPM and prior state from decoded latents.

The decoder sees only the bitstreams, so ``decode == encode recon`` bit
for bit is the correctness invariant. Both sides take every tensor they
share (motion compensation, recon, sigmas, means and scales) from the same
model function on the same shapes, under deterministic cuDNN algorithms
(``deterministic_convs``): a sigma one ulp away picks another table and
corrupts the stream. The encoder computes each tree layer's motion
compensation once, for its analysis and its recon.

Symbols leave the card as NHWC arrays (``permute(0, 2, 3, 1)``), the JAX
package's order, so both packages write the same bytes for the same
symbols; each ``*_shape`` in the streams is that NHWC shape. The scales
are bucketed into the coder's scale table on the card, so one byte a
symbol crosses. Host coding runs on AsyncCoder threads: a tensor is copied
into pinned memory without blocking (``HostCopy``) and the worker waits on
its event, so the host keeps enqueuing the next layer's work while this
layer is coded.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from fastvideocodec_torch.coder import AsyncCoder
from fastvideocodec_torch.coder.service import (
    BitEstimatorCodec,
    FactorizedCodec,
    GaussianCodec,
    LaplaceCodec,
)
from fastvideocodec_torch.entropy.rpm import rpm_sigma
from fastvideocodec_torch.models.mcvc import mask_views
from fastvideocodec_torch.models.registry import CodecSpec


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic algorithms, picked by heuristics rather than by
    timing, for the scope; the caller's settings come back after it. Some
    of cuDNN's backward-data algorithms (the forward of ConvTranspose2d)
    accumulate with atomics, so two identical calls could differ in the
    last bit."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


class HostCopy:
    """A tensor's copy on the host, started without waiting for the card: a
    non-blocking copy into pinned memory and an event that ``numpy()``
    waits on. A CPU tensor is used as it is."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._buf.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._buf = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._buf.numpy()


def nhwc(t: torch.Tensor) -> torch.Tensor:
    """NCHW -> the coder's NHWC order, contiguous (bfloat16 as float32,
    which numpy holds exactly)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.permute(0, 2, 3, 1).contiguous()


def nhwc_shape(t: torch.Tensor) -> tuple:
    n, c, h, w = t.shape
    return (n, h, w, c)


def from_nhwc(a: np.ndarray, device) -> torch.Tensor:
    """A decoded NHWC array -> a contiguous NCHW tensor on ``device``: the
    memory layout the encoder's tensor had, so the convs pick the same
    algorithms on both sides. A copy with fresh strides: where H and W are
    1, the permuted view already counts as contiguous, and its strides
    would send the convs down another path than the encoder's (a sigma an
    ulp away on the CPU)."""
    nchw = torch.from_numpy(np.ascontiguousarray(a)).to(device).permute(0, 3, 1, 2)
    return nchw.clone(memory_format=torch.contiguous_format)


def _device(spec: CodecSpec) -> torch.device:
    return next(spec.module.parameters()).device


def _resolve(obj):
    """Replace AsyncCoder futures by their bytes, recursively."""
    if hasattr(obj, "result") and callable(obj.result):
        return obj.result()
    if isinstance(obj, dict):
        return {k: _resolve(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_resolve(v) for v in obj]
    return obj


def bit_estimator_laplace_codecs(module):
    """(mv, z, feature) codecs of LSVC, DVC and Base: the tables of the
    module's two BitEstimators (mv and z) and the Laplace scale table."""
    return (BitEstimatorCodec(module.bit_estimator_mv.numpy_params()),
            BitEstimatorCodec(module.bit_estimator_z.numpy_params()),
            LaplaceCodec())


@torch.inference_mode()
def lsvc_compress(spec: CodecSpec, gop: torch.Tensor, codecs=None):
    """gop [T, 3, H, W] with frame 0 already I-coded -> (streams, recon
    [T-1, 3, H, W] in the model dtype, bits). ``codecs`` (from
    ``bit_estimator_laplace_codecs``) spares a caller that codes many GOPs the tables."""
    m = spec.module
    mv_codec, z_codec, feat_codec = codecs or bit_estimator_laplace_codecs(m)
    x = gop.to(_device(spec), m.dtype)
    bs = x.shape[0] - 1
    sched = m.schedule(bs)
    x, x_flow = m.fold(x)
    target = x[1:]
    with deterministic_convs(), AsyncCoder(workers=len(sched.layers) + 1) as coder:
        mv_q = m.mv_encode(x_flow[1:], x_flow[list(sched.ref_index)])
        mv_host = HostCopy(nhwc(mv_q))
        mv_future = coder.submit(lambda: mv_codec.compress(mv_host.numpy()))
        mv_hat = m.mv_decode(mv_q)

        com = [None] * bs
        z_futures, feat_futures, z_shapes, feat_shapes = [], [], [], []
        for layer in sched.layers:
            refs = torch.stack([x[0] if sched.parents[f] == 0 else com[sched.parents[f] - 1]
                                for f in layer])
            mc = m.layer_mc(refs, mv_hat[[f - 1 for f in layer]])
            z_q, feat_q = m.analyze(target[[f - 1 for f in layer]], mc)
            z_host, feat_host = HostCopy(nhwc(z_q)), HostCopy(nhwc(feat_q))
            idx_host = HostCopy(nhwc(feat_codec.bucket(m.sigmas(z_q))))
            z_futures.append(coder.submit(lambda h=z_host: z_codec.compress(h.numpy())))
            feat_futures.append(coder.submit(
                lambda f=feat_host, i=idx_host: feat_codec.encode(f.numpy(), i.numpy())))
            z_shapes.append(nhwc_shape(z_q))
            feat_shapes.append(nhwc_shape(feat_q))
            com_frames = m.layer_recon(feat_q, mc)
            for i, f in enumerate(layer):
                com[f - 1] = com_frames[i]
        recon = m.unfold(torch.stack(com))
        streams = {
            "mv": mv_future.result(),
            "mv_shape": nhwc_shape(mv_q),
            "z": [f.result() for f in z_futures],
            "z_shapes": z_shapes,
            "features": [f.result() for f in feat_futures],
            "feat_shapes": feat_shapes,
        }
    bits = 8 * (len(streams["mv"]) + sum(map(len, streams["z"]))
                + sum(map(len, streams["features"])))
    return streams, recon, bits


@torch.inference_mode()
def lsvc_decompress(spec: CodecSpec, iframe: torch.Tensor, streams: dict, num_p_frames: int,
                    codecs=None) -> torch.Tensor:
    """P-frames [num_p_frames, 3, H, W] from (I-frame [3, H, W], streams) only."""
    m = spec.module
    mv_codec, z_codec, feat_codec = codecs or bit_estimator_laplace_codecs(m)
    device = _device(spec)
    sched = m.schedule(num_p_frames)
    iframe = m.fold(iframe[None].to(device, m.dtype))[0][0]
    layers = range(len(sched.layers))
    # Nothing in the entropy decode depends on the tree recursion: a layer's
    # features need only its sigmas, which need only its z. So the mv stream
    # (the largest), every z and then every layer's features decode on
    # their own threads at once, and the card reconstructs layer after
    # layer as they arrive.
    with deterministic_convs(), AsyncCoder(workers=len(layers) + 1) as coder:
        mv_future = coder.submit(mv_codec.decompress, streams["mv"], streams["mv_shape"])
        z_futures = [coder.submit(z_codec.decompress, streams["z"][li], streams["z_shapes"][li])
                     for li in layers]

        def decode_features(li, idx_host):
            return feat_codec.decode(streams["features"][li], idx_host.numpy()).astype(np.int16)

        feat_futures = []
        for li in layers:
            z_q = from_nhwc(z_futures[li].result().astype(np.int16), device)
            idx_host = HostCopy(nhwc(feat_codec.bucket(m.sigmas(z_q))))
            feat_futures.append(coder.submit(decode_features, li, idx_host))
        mv_hat = m.mv_decode(from_nhwc(mv_future.result().astype(np.int16), device))

        com = [None] * num_p_frames
        for li, layer in enumerate(sched.layers):
            refs = torch.stack([iframe if sched.parents[f] == 0 else com[sched.parents[f] - 1]
                                for f in layer])
            mc = m.layer_mc(refs, mv_hat[[f - 1 for f in layer]])
            com_frames = m.layer_recon(from_nhwc(feat_futures[li].result(), device), mc)
            for i, f in enumerate(layer):
                com[f - 1] = com_frames[i]
    return m.unfold(torch.stack(com))


class HyperpriorCoder:
    """Real coding of one SSFHyperprior (reference Hyperprior,
    models.py:1958-1999): z through the bottleneck's factorized tables, y
    through the Gaussian scale-table coder with the decoded means and
    scales. The y symbol round_y = round(y - means) is taken in the model
    dtype. What the decoders get (``y_out``) is round_y + means, or, when
    the hyperprior has an SPnet and ``sp`` set (ELFVC-SP by its sp_stage),
    the SPnet's prediction from round_y and the previous frame's round_y
    (the zeros of ``ELFVC.init_state`` on the GOP's first P-frame). Both
    sides predict from the symbols themselves, so the decoder's input to
    the SPnet is the encoder's bit for bit."""

    def __init__(self, hyperprior, dtype: torch.dtype):
        self.hp = hyperprior
        self.dtype = dtype
        self.sp = hyperprior.sp and hyperprior.y_predictor is not None
        self.z_codec = FactorizedCodec(hyperprior.bottleneck.numpy_params())
        self.y_codec = GaussianCodec()

    def _finish(self, round_y: torch.Tensor, means: torch.Tensor, q_y_prior):
        """(y_out, the next frame's prior round_y)."""
        if self.sp:
            return self.hp.predict_y(round_y, q_y_prior, means), round_y
        return round_y + means, round_y

    def compress(self, y: torch.Tensor, coder: AsyncCoder, q_y_prior=None):
        """y [B, C, h, w] -> (streams holding futures of ``coder``, y_out in
        y's dtype, round_y). The card never waits for the host: z_hat is
        the bottleneck's dequantized z, which is what the decoder gets back
        from the z stream."""
        z = self.hp.hyper_encoder(y)
        z_host = HostCopy(nhwc(z.float()))
        z_stream = coder.submit(lambda: self.z_codec.compress(z_host.numpy()))
        means, scales = self.hp.means_scales(self.hp.bottleneck.dequantize(z).to(y.dtype),
                                             *y.shape[2:])
        q = torch.round(y - means)
        q_host = HostCopy(nhwc(q.to(torch.int32)))
        idx_host = HostCopy(nhwc(self.y_codec.bucket(scales)))
        y_stream = coder.submit(lambda: self.y_codec.encode(q_host.numpy(), idx_host.numpy()))
        streams = {"z": z_stream, "y": y_stream, "z_shape": nhwc_shape(z)}
        return (streams, *self._finish(q, means, q_y_prior))

    def decompress(self, streams: dict, y_shape: tuple, device, coder: AsyncCoder):
        """Start decoding y (y_shape NHWC): z on this thread, the means and
        scales on the card, the y symbols on a ``coder`` thread. Returns a
        function of the prior (unused without an SPnet) that gives (y_out
        [B, C, h, w], round_y) once the symbols are in."""
        z_hat = from_nhwc(self.z_codec.decompress(streams["z"], streams["z_shape"]), device)
        means, scales = self.hp.means_scales(z_hat.to(self.dtype), *y_shape[1:3])
        idx_host = HostCopy(nhwc(self.y_codec.bucket(scales)))
        q = coder.submit(lambda: self.y_codec.decode(streams["y"], idx_host.numpy()))

        def finish(q_y_prior=None):
            return self._finish(from_nhwc(q.result(), device).to(self.dtype), means, q_y_prior)

        return finish


def ssf_codecs(module):
    """The keyframe's, the motion's and the residual's HyperpriorCoders
    (of SSF and ELFVC alike)."""
    return tuple(HyperpriorCoder(hp, module.dtype) for hp in
                 (module.img_hyperprior, module.motion_hyperprior, module.res_hyperprior))


def _streams_bits(streams: dict) -> int:
    """The bits of a chain codec's streams: the keyframe's z and y, and
    every P-frame's motion and residual z and y."""
    return 8 * (len(streams["keyframe"]["z"]) + len(streams["keyframe"]["y"])
                + sum(len(s[k]["z"]) + len(s[k]["y"])
                      for s in streams["inter"] for k in ("motion", "residual")))


@torch.inference_mode()
def ssf_compress_gop(spec: CodecSpec, gop: torch.Tensor, codecs=None):
    """Keyframe + chain of inter frames, gop [T, B, 3, H, W] -> (streams,
    recon [T, B, 3, H, W] in the model dtype, bits). ``codecs`` (from
    ``ssf_codecs``) spares a caller that codes many GOPs the tables."""
    m = spec.module
    img_hp, mot_hp, res_hp = codecs or ssf_codecs(m)
    x = m.fold_gop(gop.to(_device(spec), m.dtype))
    with deterministic_convs(), AsyncCoder(workers=4) as coder:
        y0 = m.img_encoder(x[0])
        key_streams, y0_hat, _ = img_hp.compress(y0, coder)
        x_ref = m.img_decoder(y0_hat)
        frames, inter = [x_ref], []
        for t in range(1, x.shape[0]):
            y_mot = m.motion_encoder(torch.cat([x[t], x_ref], dim=1))
            mot_s, y_mot_hat, _ = mot_hp.compress(y_mot, coder)
            x_pred = m.forward_prediction(x_ref, m.motion_decoder(y_mot_hat))
            y_res = m.res_encoder(x[t] - x_pred)
            res_s, y_res_hat, _ = res_hp.compress(y_res, coder)
            x_ref = x_pred + m.res_decoder(torch.cat([y_res_hat, y_mot_hat], dim=1))
            frames.append(x_ref)
            inter.append({"motion": mot_s, "residual": res_s,
                          "y_mot_shape": nhwc_shape(y_mot), "y_res_shape": nhwc_shape(y_res)})
        streams = _resolve({"keyframe": key_streams, "y0_shape": nhwc_shape(y0),
                            "inter": inter})
    return streams, m.unfold_gop(torch.stack(frames)), _streams_bits(streams)


@torch.inference_mode()
def ssf_decompress_gop(spec: CodecSpec, streams: dict, codecs=None) -> torch.Tensor:
    """The whole GOP [T, B, 3, H, W] from the streams only."""
    m = spec.module
    img_hp, mot_hp, res_hp = codecs or ssf_codecs(m)
    device = _device(spec)
    # Each y needs only its own z, not the frames before it: every y of the
    # GOP starts decoding on the coder's threads at once, and the card's
    # chain of frames takes them as they arrive.
    with deterministic_convs(), AsyncCoder(workers=4) as coder:
        y0_hat = img_hp.decompress(streams["keyframe"], streams["y0_shape"], device, coder)
        inter = [(mot_hp.decompress(s["motion"], s["y_mot_shape"], device, coder),
                  res_hp.decompress(s["residual"], s["y_res_shape"], device, coder))
                 for s in streams["inter"]]
        x_ref = m.img_decoder(y0_hat()[0])
        frames = [x_ref]
        for y_mot, y_res in inter:
            y_mot_hat, _ = y_mot()
            x_pred = m.forward_prediction(x_ref, m.motion_decoder(y_mot_hat))
            x_ref = x_pred + m.res_decoder(torch.cat([y_res()[0], y_mot_hat], dim=1))
            frames.append(x_ref)
    return m.unfold_gop(torch.stack(frames))


@torch.inference_mode()
def elfvc_compress_gop(spec: CodecSpec, gop: torch.Tensor, codecs=None):
    """ELFVC(-SP) keyframe + chain, gop [T, B, 3, H, W] -> (streams, recon
    [T, B, 3, H, W] in the model dtype, bits), with the streams of
    ``ssf_compress_gop``'s form. The flow predictor runs on the decoded
    context (x_ref, x_ref_ref, the motion prior), so only the motion's
    delta is coded; each frame's scale-space volume is built once for its
    two warps. ``codecs`` from ``ssf_codecs``."""
    m = spec.module
    img_hp, mot_hp, res_hp = codecs or ssf_codecs(m)
    x = m.fold_gop(gop.to(_device(spec), m.dtype))
    with deterministic_convs(), AsyncCoder(workers=4) as coder:
        y0 = m.img_encoder(x[0])
        key_streams, y0_hat, _ = img_hp.compress(y0, coder)
        x_ref = m.img_decoder(y0_hat)
        B, _, h, w = x_ref.shape
        state = m.init_state(B, h, w)
        qpm, qpr = state.q_y_prior_motion, state.q_y_prior_res
        frames, inter = [x_ref], []
        for t in range(1, x.shape[0]):
            motion_info_local = m.flow_predictor(
                torch.cat([x_ref, state.x_ref_ref, state.motion_info_prior], dim=1))
            volume = m.make_volume(x_ref)
            y_mot = m.motion_encoder(
                torch.cat([x[t], m.warp_prediction(volume, motion_info_local)], dim=1))
            mot_s, y_mot_out, qpm = mot_hp.compress(y_mot, coder, qpm)
            motion_info = state.motion_info_prior + m.motion_decoder(y_mot_out)
            x_pred = m.warp_prediction(volume, motion_info)
            y_res = m.res_encoder(x[t] - x_pred)
            res_s, y_res_out, qpr = res_hp.compress(y_res, coder, qpr)
            x_rec = x_pred + m.res_decoder(torch.cat([y_res_out, y_mot_out], dim=1))
            state = state._replace(x_ref_ref=x_ref, motion_info_prior=motion_info)
            x_ref = x_rec
            frames.append(x_ref)
            inter.append({"motion": mot_s, "residual": res_s,
                          "y_mot_shape": nhwc_shape(y_mot), "y_res_shape": nhwc_shape(y_res)})
        streams = _resolve({"keyframe": key_streams, "y0_shape": nhwc_shape(y0),
                            "inter": inter})
    return streams, m.unfold_gop(torch.stack(frames)), _streams_bits(streams)


@torch.inference_mode()
def elfvc_decompress_gop(spec: CodecSpec, streams: dict, codecs=None) -> torch.Tensor:
    """The whole GOP [T, B, 3, H, W] from the streams only. The decoder runs
    no flow predictor: it needs only the carried prior plus the decoded
    delta. Every y starts decoding at once, as in ``ssf_decompress_gop``;
    the SPnets then run in the chain's order on the card."""
    m = spec.module
    img_hp, mot_hp, res_hp = codecs or ssf_codecs(m)
    device = _device(spec)
    with deterministic_convs(), AsyncCoder(workers=4) as coder:
        y0_hat = img_hp.decompress(streams["keyframe"], streams["y0_shape"], device, coder)
        inter = [(mot_hp.decompress(s["motion"], s["y_mot_shape"], device, coder),
                  res_hp.decompress(s["residual"], s["y_res_shape"], device, coder))
                 for s in streams["inter"]]
        x_ref = m.img_decoder(y0_hat()[0])
        B, _, h, w = x_ref.shape
        state = m.init_state(B, h, w)
        qpm, qpr = state.q_y_prior_motion, state.q_y_prior_res
        frames = [x_ref]
        for y_mot, y_res in inter:
            y_mot_out, qpm = y_mot(qpm)
            motion_info = state.motion_info_prior + m.motion_decoder(y_mot_out)
            x_pred = m.forward_prediction(x_ref, motion_info)
            y_res_out, qpr = y_res(qpr)
            x_rec = x_pred + m.res_decoder(torch.cat([y_res_out, y_mot_out], dim=1))
            state = state._replace(x_ref_ref=x_ref, motion_info_prior=motion_info)
            x_ref = x_rec
            frames.append(x_ref)
    return m.unfold_gop(torch.stack(frames))


@torch.inference_mode()
def mcvc_compress_gop(spec: CodecSpec, gop: torch.Tensor, mask, codecs=None):
    """MCVC(-IA) encode (reference models.py:2354-2400), gop [T, B*V, 3, H, W]
    with the views folded into the batch, mask [B*V] of {0, 1} (numpy or
    tensor) -> (streams, the enhanced recon [T, B*V, 3, H, W] in the model
    dtype, bits). The failed views are zeroed before analysis and the
    joint latents of all views coded once per frame, the keyframe
    included; the next frame predicts from the plain recon of the masked
    reference, and with -IA the output is the backup decoders' frames from
    the masked latents. The mask travels in the streams (the receiver
    knows which views failed). ``codecs`` from ``ssf_codecs``."""
    m = spec.module
    img_hp, mot_hp, res_hp = codecs or ssf_codecs(m)
    device = _device(spec)
    x = gop.to(device, m.dtype)
    mask_list = torch.as_tensor(mask).float().cpu().tolist()
    alive = torch.tensor(mask_list, dtype=torch.float32, device=device)
    with deterministic_convs(), AsyncCoder(workers=4) as coder:
        y0 = m.img_encoder(mask_views(x[0], alive))
        key_streams, y0_hat, _ = img_hp.compress(y0, coder)
        x_ref = m.img_decoder(y0_hat)
        frames, inter = [m.enhance_keyframe(x_ref, y0_hat, alive)], []
        for t in range(1, x.shape[0]):
            x_cur, x_ref_m = mask_views(x[t], alive), mask_views(x_ref, alive)
            y_mot = m.motion_encoder(torch.cat([x_cur, x_ref_m], dim=1))
            mot_s, y_mot_hat, _ = mot_hp.compress(y_mot, coder)
            x_pred = m.forward_prediction(x_ref_m, m.motion_decoder(y_mot_hat))
            y_res = m.res_encoder(x_cur - x_pred)
            res_s, y_res_hat, _ = res_hp.compress(y_res, coder)
            x_ref = x_pred + m.res_decoder(torch.cat([y_res_hat, y_mot_hat], dim=1))
            frames.append(m.enhance_inter(x_ref, x_pred, y_res_hat, y_mot_hat, alive))
            inter.append({"motion": mot_s, "residual": res_s,
                          "y_mot_shape": nhwc_shape(y_mot), "y_res_shape": nhwc_shape(y_res)})
        streams = _resolve({"keyframe": key_streams, "y0_shape": nhwc_shape(y0),
                            "inter": inter, "mask": mask_list})
    return streams, torch.stack(frames), _streams_bits(streams)


@torch.inference_mode()
def mcvc_decompress_gop(spec: CodecSpec, streams: dict, codecs=None) -> torch.Tensor:
    """The enhanced GOP [T, B*V, 3, H, W] from the streams and the mask
    they carry only: the plain chain of references, and with -IA the
    backup decoders on the decoded masked latents. Every y starts decoding
    at once, as in ``ssf_decompress_gop``."""
    m = spec.module
    img_hp, mot_hp, res_hp = codecs or ssf_codecs(m)
    device = _device(spec)
    alive = torch.tensor(streams["mask"], dtype=torch.float32, device=device)
    with deterministic_convs(), AsyncCoder(workers=4) as coder:
        y0_hat = img_hp.decompress(streams["keyframe"], streams["y0_shape"], device, coder)
        inter = [(mot_hp.decompress(s["motion"], s["y_mot_shape"], device, coder),
                  res_hp.decompress(s["residual"], s["y_res_shape"], device, coder))
                 for s in streams["inter"]]
        y0_hat = y0_hat()[0]
        x_ref = m.img_decoder(y0_hat)
        frames = [m.enhance_keyframe(x_ref, y0_hat, alive)]
        for y_mot, y_res in inter:
            y_mot_hat, _ = y_mot()
            y_res_hat, _ = y_res()
            x_pred = m.forward_prediction(mask_views(x_ref, alive), m.motion_decoder(y_mot_hat))
            x_ref = x_pred + m.res_decoder(torch.cat([y_res_hat, y_mot_hat], dim=1))
            frames.append(m.enhance_inter(x_ref, x_pred, y_res_hat, y_mot_hat, alive))
    return torch.stack(frames)


# ---------------------------------------------------------------------------
# DVC and Base: mv and z through their BitEstimators, the features through
# the Laplace coder (reference DVC/net.py:121-205, models.py:1722-1806)
# ---------------------------------------------------------------------------


def _chain_gop(spec: CodecSpec, gop: torch.Tensor) -> torch.Tensor:
    """gop [T, 3, H, W] (batch 1) on the model's device, in its dtype,
    contiguous (the warp kernel takes contiguous frames)."""
    if gop.dim() != 4:
        raise ValueError(f"gop must be [T, 3, H, W], got {tuple(gop.shape)}")
    return gop.to(_device(spec), spec.module.dtype).contiguous()


def _int_symbols(q: torch.Tensor) -> HostCopy:
    return HostCopy(nhwc(q.to(torch.int32)))


def _symbols_in(a: np.ndarray, device, dtype) -> torch.Tensor:
    return from_nhwc(a.astype(np.int32), device).to(dtype)


@torch.inference_mode()
def dvc_compress_gop(spec: CodecSpec, gop: torch.Tensor, codecs=None):
    """DVC or Base, gop [T, 3, H, W] with frame 0 the uncoded reference ->
    (streams, recon [T-1, 3, H, W] in the model dtype, bits). Each frame
    codes against the previous recon; its mv, z and feature symbols code
    on AsyncCoder threads while the card goes on. The features' scales are
    the decode side's (``sigma`` of the z symbols, Base's ER applied), and
    the residual is taken against the decode side's motion compensation
    (``mc`` of the mv symbols). ``codecs`` from ``bit_estimator_laplace_codecs``."""
    m = spec.module
    mv_codec, z_codec, feat_codec = codecs or bit_estimator_laplace_codecs(m)
    x = _chain_gop(spec, gop)
    x_ref = x[0:1]
    recon, frames, shapes = [], [], []
    with deterministic_convs(), AsyncCoder(workers=3) as coder:
        for t in range(1, x.shape[0]):
            mv_q = m.mv_symbols(x[t:t + 1], x_ref)
            mv_host = _int_symbols(mv_q)
            x_mc = m.mc(x_ref, mv_q)
            z_q, feat_q = m.analyze(x[t:t + 1], x_mc)
            z_host, feat_host = _int_symbols(z_q), _int_symbols(feat_q)
            sigma, correction = m.sigma(z_q)
            idx_host = HostCopy(nhwc(feat_codec.bucket(sigma)))
            frames.append({
                "mv": coder.submit(lambda h=mv_host: mv_codec.compress(h.numpy())),
                "z": coder.submit(lambda h=z_host: z_codec.compress(h.numpy())),
                "feat": coder.submit(
                    lambda f=feat_host, i=idx_host: feat_codec.encode(f.numpy(), i.numpy())),
            })
            shapes.append({"mv": nhwc_shape(mv_q), "z": nhwc_shape(z_q),
                           "feat": nhwc_shape(feat_q)})
            x_ref = m.reconstruct(x_mc, feat_q, correction)
            recon.append(x_ref[0])
        streams = {"frames": _resolve(frames), "shapes": shapes}
    bits = 8 * sum(len(f["mv"]) + len(f["z"]) + len(f["feat"]) for f in streams["frames"])
    return streams, torch.stack(recon), bits


@torch.inference_mode()
def dvc_decompress_gop(spec: CodecSpec, iframe: torch.Tensor, streams: dict,
                       codecs=None) -> torch.Tensor:
    """The P-frames [T-1, 3, H, W] from (frame 0 [3, H, W], streams) only.
    Every mv and z stream starts decoding at once; each frame's features
    follow its scales."""
    m = spec.module
    mv_codec, z_codec, feat_codec = codecs or bit_estimator_laplace_codecs(m)
    device = _device(spec)
    x_ref = iframe[None].to(device, m.dtype).contiguous()
    recon = []
    with deterministic_convs(), AsyncCoder(workers=3) as coder:
        pending = [(coder.submit(mv_codec.decompress, f["mv"], sh["mv"]),
                    coder.submit(z_codec.decompress, f["z"], sh["z"]))
                   for f, sh in zip(streams["frames"], streams["shapes"])]
        for f, (mv_f, z_f) in zip(streams["frames"], pending):
            z_q = _symbols_in(z_f.result(), device, m.dtype)
            sigma, correction = m.sigma(z_q)
            idx_host = HostCopy(nhwc(feat_codec.bucket(sigma)))
            feat = coder.submit(lambda d=f["feat"], i=idx_host: feat_codec.decode(d, i.numpy()))
            x_mc = m.mc(x_ref, _symbols_in(mv_f.result(), device, m.dtype))
            x_ref = m.reconstruct(x_mc, _symbols_in(feat.result(), device, m.dtype), correction)
            recon.append(x_ref[0])
    return torch.stack(recon)


base_compress_gop = dvc_compress_gop
base_decompress_gop = dvc_decompress_gop


# ---------------------------------------------------------------------------
# RLVC: recurrent state rebuilt from decoded latents on both sides
# (reference entropy_models.py:97-148 compress_slow / decompress_slow)
# ---------------------------------------------------------------------------


class Coder2DCoder:
    """Real coding of one Coder2D's latent: 'rpm' (RLVC) factorized on the
    first P-frame, then Gaussian with the RPM's (sigma, mu) from the
    previous frame's decoded latent; 'mshyper' (RLVC-HP) z by its
    factorized tables, the latent Gaussian with the hyper decoder's
    (sigma, mu). The next prior is round(latent_hat), the decoded latent
    (the rollout takes round(latent)): both sides then run the RPM on the
    same input. The symbol round(latent - mu) is taken in the model
    dtype."""

    def __init__(self, codec, dtype: torch.dtype):
        if codec.entropy_type == "rpm2":
            raise ValueError("RLVC2 ('rpm2') has no real-bits path: the JAX package codes "
                             "only RLVC ('rpm') and RLVC-HP ('mshyper')")
        self.codec, self.dtype = codec, dtype
        self.bottleneck = codec.entropy.bottleneck
        self.fcodec = FactorizedCodec(self.bottleneck.numpy_params())
        self.gcodec = GaussianCodec()

    def _gaussian(self, latent, sigma, mu, coder):
        q = torch.round(latent - mu)
        q_host, idx_host = _int_symbols(q), HostCopy(nhwc(self.gcodec.bucket(sigma)))
        return coder.submit(lambda: self.gcodec.encode(q_host.numpy(), idx_host.numpy())), q + mu

    def compress(self, x, state, dec4, rpm_flag: bool, coder: AsyncCoder):
        """x -> (hat, new state, stream future(s), the latent's NHWC shape);
        ``state`` (rae_hidden, rpm_hidden, prior_latent)."""
        rae, rpm_hidden, prior = state
        state_enc, state_dec = rae.chunk(2, dim=1)
        latent, state_enc = self.codec.encode(x, state_enc)
        if self.codec.entropy_type == "mshyper":
            hp = self.codec.entropy
            z = hp.hyper_encode(latent)
            z_host = HostCopy(nhwc(z.float()))
            z_stream = coder.submit(lambda: self.fcodec.compress(z_host.numpy()))
            sigma, mu = hp.hyper_decode(self.bottleneck.dequantize(z).to(latent.dtype))
            y_stream, latent_hat = self._gaussian(latent, sigma, mu, coder)
            stream = {"z": z_stream, "y": y_stream, "z_shape": nhwc_shape(z)}
        elif rpm_flag:
            sigma, mu, rpm_hidden = self._rpm(prior, rpm_hidden)
            stream, latent_hat = self._gaussian(latent, sigma, mu, coder)
        else:
            l_host = HostCopy(nhwc(latent.float()))
            stream = coder.submit(lambda: self.fcodec.compress(l_host.numpy()))
            latent_hat = self.bottleneck.dequantize(latent)
        hat, state_dec = self.codec.decode(latent_hat.to(self.dtype), state_dec, dec4)
        state = (torch.cat([state_enc, state_dec], dim=1), rpm_hidden, torch.round(latent_hat))
        return hat, state, stream, nhwc_shape(latent)

    def _rpm(self, prior, rpm_hidden):
        sigma_raw, mu, rpm_hidden = self.codec.entropy.rpm(prior.to(self.dtype), rpm_hidden)
        return rpm_sigma(sigma_raw), mu, rpm_hidden

    def decompress(self, stream, shape, state_dec, rpm_hidden, prior, dec4, rpm_flag: bool):
        """The decoder's mirror of ``compress``: (hat, state_dec, rpm_hidden,
        prior). Each latent's scales need the last one's decoded latent, so
        the range decode runs on this thread."""
        device = state_dec.device
        if self.codec.entropy_type == "mshyper":
            z_hat = from_nhwc(self.fcodec.decompress(stream["z"], stream["z_shape"]), device)
            sigma, mu = self.codec.entropy.hyper_decode(z_hat.to(self.dtype))
            latent_hat = self._gaussian_decode(stream["y"], sigma, mu)
        elif rpm_flag:
            sigma, mu, rpm_hidden = self._rpm(prior, rpm_hidden)
            latent_hat = self._gaussian_decode(stream, sigma, mu)
        else:
            latent_hat = from_nhwc(self.fcodec.decompress(stream, shape), device)
        hat, state_dec = self.codec.decode(latent_hat.to(self.dtype), state_dec, dec4)
        return hat, state_dec, rpm_hidden, torch.round(latent_hat)

    def _gaussian_decode(self, data, sigma, mu):
        q = self.gcodec.decode(data, nhwc(self.gcodec.bucket(sigma)).cpu().numpy())
        return _symbols_in(q, sigma.device, mu.dtype) + mu


def rlvc_codecs(module):
    """The mv and the residual Coder2Ds' coders."""
    return (Coder2DCoder(module.mv_codec, module.dtype),
            Coder2DCoder(module.res_codec, module.dtype))


def _stream_len(s) -> int:
    """Bytes of one latent's stream: {z, y} for RLVC-HP, else bytes."""
    return len(s["z"]) + len(s["y"]) if isinstance(s, dict) else len(s)


@torch.inference_mode()
def rlvc_compress_gop(spec: CodecSpec, gop: torch.Tensor, codecs=None):
    """RLVC or RLVC-HP, gop [T, 3, H, W] with frame 0 the uncoded reference
    -> (streams, recon [T-1, 3, H, W] in the model dtype, bits). The
    streams hold each frame's {"mv", "res"} and the latents' NHWC shapes.
    RLVC2 raises. ``codecs`` from ``rlvc_codecs``."""
    m = spec.module
    mv_coder, res_coder = codecs or rlvc_codecs(m)
    x = _chain_gop(spec, gop)
    _, _, H, W = x.shape
    hid = m.init_hidden(1, H, W, x.device)
    mv_state = (hid.rae_mv, hid.rpm_mv, hid.mv_prior)
    res_state = (hid.rae_res, hid.rpm_res, hid.res_prior)
    x_ref = x[0:1]
    recon, frames = [], []
    with deterministic_convs(), AsyncCoder(workers=4) as coder:
        for t in range(1, x.shape[0]):
            mv = m.optic_flow(x[t:t + 1], x_ref)
            mv_hat, mv_state, mv_stream, mv_shape = mv_coder.compress(
                mv, mv_state, m.mv_dec4, t > 1, coder)
            x_mc, _ = m.motion_compensation(x_ref, mv_hat)
            res_hat, res_state, res_stream, res_shape = res_coder.compress(
                x[t:t + 1] - x_mc, res_state, m.res_dec4, t > 1, coder)
            x_ref = torch.clamp(res_hat + x_mc, 0.0, 1.0)
            recon.append(x_ref[0])
            frames.append({"mv": mv_stream, "res": res_stream})
        streams = {"frames": _resolve(frames), "shapes": {"mv": mv_shape, "res": res_shape}}
    bits = 8 * sum(_stream_len(f["mv"]) + _stream_len(f["res"]) for f in streams["frames"])
    return streams, torch.stack(recon), bits


@torch.inference_mode()
def rlvc_decompress_gop(spec: CodecSpec, iframe: torch.Tensor, streams: dict,
                        codecs=None) -> torch.Tensor:
    """The P-frames [T-1, 3, H, W] from (frame 0 [3, H, W], streams) only:
    the decoder's LSTM, RPM and prior state start at zeros and follow the
    decoded latents."""
    m = spec.module
    mv_coder, res_coder = codecs or rlvc_codecs(m)
    device = _device(spec)
    x_ref = iframe[None].to(device, m.dtype).contiguous()
    _, _, H, W = x_ref.shape
    hid = m.init_hidden(1, H, W, device)
    mv_state = [hid.rae_mv.chunk(2, dim=1)[1], hid.rpm_mv, hid.mv_prior]
    res_state = [hid.rae_res.chunk(2, dim=1)[1], hid.rpm_res, hid.res_prior]
    shapes = streams["shapes"]
    recon = []
    with deterministic_convs():
        for t, f in enumerate(streams["frames"], start=1):
            mv_hat, *mv_state = mv_coder.decompress(f["mv"], shapes["mv"], *mv_state,
                                                    m.mv_dec4, t > 1)
            x_mc, _ = m.motion_compensation(x_ref, mv_hat)
            res_hat, *res_state = res_coder.decompress(f["res"], shapes["res"], *res_state,
                                                       m.res_dec4, t > 1)
            x_ref = torch.clamp(res_hat + x_mc, 0.0, 1.0)
            recon.append(x_ref[0])
    return torch.stack(recon)
