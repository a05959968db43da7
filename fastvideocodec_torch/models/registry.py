"""Codec registry of the port: the LSVC, DVC, RLVC, Base, SSF, ELFVC and
MCVC branches of fastvideocodec_tpu/models/registry.py, which take the
same names by the same tests of the name.

``get_codec_model`` builds the module on ``device`` (the card unless the
caller passes ``device="cpu"``) in eval mode. With ``dtype=torch.bfloat16``
the conv weights are held in bfloat16 and activations run in bfloat16, as
the JAX modules do with ``dtype=bfloat16``; GDN, BitEstimator, the
entropy bottlenecks, the rate math and the SPnet's weight-standardized
kernels and norm parameters stay in float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from fastvideocodec_torch.models.base import Base
from fastvideocodec_torch.models.dvc import DVC
from fastvideocodec_torch.models.elfvc import ELFVC
from fastvideocodec_torch.models.lsvc import LSVC
from fastvideocodec_torch.models.mcvc import MCVC
from fastvideocodec_torch.models.rlvc import RLVC
from fastvideocodec_torch.models.ssf import ScaleSpaceFlow


# the reference's RD lambdas by compression level (models.py:72-76)
PSNR_LAMBDAS = [256, 512, 1024, 2048, 4096, 8192, 16384, 16384 * 2, 16384 * 4]
MSSSIM_LAMBDAS = [8, 16, 32, 64]
I_LEVELS = [37, 32, 27, 22, 17, 12, 7, 2, 1]  # BPG's -q by compression level


@dataclass
class CodecSpec:
    """A built codec and its training operating point: ``loss_type`` "P"
    (MSE) or "M" (MS-SSIM) and ``compression_level``, which pick the RD
    lambda ``r``."""

    name: str
    family: str
    module: nn.Module
    loss_type: str = "P"
    compression_level: int = 2

    @property
    def r(self) -> float:
        table = PSNR_LAMBDAS if self.loss_type == "P" else MSSSIM_LAMBDAS
        return float(table[self.compression_level])

    @property
    def I_level(self) -> int:
        """BPG's quantizer for the I-frame at this compression level."""
        return I_LEVELS[self.compression_level]

    @property
    def olft(self) -> bool:
        """MCVC-IA-OLFT's online fine-tuning: touch-up labels in place of
        the rate term (the JAX registry's ``extras["olft"]``, an MCVC name
        holding "OLFT")."""
        return self.family == "mcvc" and "OLFT" in self.name


def _lsvc(name: str, dtype: torch.dtype) -> LSVC:
    """The JAX registry's LSVC branch. -L/-O pick the chain/one-hop graph;
    -TINY the golden-RD widths (with -TPU the flagship's s2d architecture);
    -TPU the flagship (s2d codec domain, pooled-RGB SpyNet with 5x5/3x3
    kernels, 128-wide transforms), whose default warp is the full-res warp
    by the decoder's full-res flow, with the ablations -HF (half-res flow
    upsampled), -RW (rigid s2d warp), -WT (WarpNetTPU, stride-2 stem,
    128 wide), -HU (32-wide U-net) and -QU (U-net on the pooled input);
    -A/-S attention in the analysis/synthesis transforms, -D the
    stop-gradient between layers (a training knob). Any other LSVC name
    is the reference-structure s2d=1 LSVC-128 (LSVC and LSVC-128 among
    them). -F/-F2 name the default. The TPU kernel's displacement bound
    (``mc_displacement``) is no part of the port's semantics."""
    graph = "chain" if "-L" in name else ("onehop" if "-O" in name else "tree")
    if "-TINY" in name:
        tpu = "-TPU" in name
        rigid, halfres = "-RW" in name, "-HF" in name
        return LSVC(channels=48, conv_channels=32, s2d=2 if tpu else 1,
                    spynet_widths=(8, 16, 8, 4), spynet_kernel=5,
                    spynet_s2d_levels=2 if tpu else 0, mv_polyphase_out=tpu,
                    warp_width=32 if tpu else 16, full_res_warp=tpu and not rigid,
                    mv_full_res_out=tpu and not (rigid or halfres), graph=graph, dtype=dtype)
    flags = dict(use_attn="-A" in name, use_syn_attn="-S" in name, graph=graph,
                 detach_tree="-D" in name, dtype=dtype)
    if "-TPU" in name:
        rigid, halfres = "-RW" in name, "-HF" in name
        wt, hu = "-WT" in name, "-HU" in name
        return LSVC(channels=128, conv_channels=128, s2d=2, spynet_widths=(32, 64, 32, 16),
                    spynet_kernels=(5, 5, 3, 3), spynet_s2d_levels=2, mv_polyphase_out=True,
                    warp_tpu=wt, warp_stride=2, warp_width=128 if wt else (32 if hu else 64),
                    warp_pooled="-QU" in name, full_res_warp=not rigid,
                    mv_full_res_out=not (rigid or halfres), **flags)
    return LSVC(channels=128, **flags)


def _build(name: str, dtype: torch.dtype, sp_stage: int,
           num_views: int, use_attn: bool = True) -> tuple[str, nn.Module]:
    if name.startswith("LSVC"):
        return "lsvc", _lsvc(name, dtype)
    # DVC, RLVC and Base: the reference's widths (SpyNet 32/64/32/16 at 7x7,
    # the stock transforms), or with -TINY the golden-RD widths of
    # tiny_{dvc,rlvc,base}_l{0,2,4}. DVC-pretrained builds DVC's module
    # (its reference checkpoints are not in the repo)
    tiny_widths = dict(spynet_widths=(8, 16, 8, 4), spynet_kernel=5, warp_width=16)
    if name in ("DVC", "DVC-pretrained"):
        return "dvc", DVC(dtype=dtype)
    if name == "DVC-TINY":
        return "dvc", DVC(channels_n=32, channels_m=48, channels_mv=32, dtype=dtype,
                          **tiny_widths)
    if name.startswith("RLVC") and "-TINY" in name:
        ent = ("mshyper" if name.startswith("RLVC-HP")
               else "rpm2" if name.startswith("RLVC2") else "rpm")
        return "rlvc", RLVC(channels=32, entropy_type=ent, dtype=dtype, **tiny_widths)
    if name in ("RLVC", "RLVC2", "RLVC-HP"):
        ent = {"RLVC": "rpm", "RLVC2": "rpm2", "RLVC-HP": "mshyper"}[name]
        return "rlvc", RLVC(entropy_type=ent, dtype=dtype)
    if name.startswith("Base"):
        flags = dict(use_ec="-EC" in name, use_er="-ER" in name, dtype=dtype)
        if "-TINY" in name:
            return "base", Base(channels_n=32, channels_m=48, channels_mv=32, gen_width_mv=48,
                                gen_width=32, **flags, **tiny_widths)
        return "base", Base(**flags)
    # the SSF, ELFVC and MCVC branches take the names JAX's do, by the same
    # tests of the name: '-TPU' the s2d form, '-TINY' the golden-RD widths
    s2d = 2 if "-TPU" in name else 1
    tiny = "-TINY" in name
    if (name.startswith("SSF") and tiny) or name in ("SSF-Official", "SSF-TPU",
                                                     "MCVC-Original"):
        # compressai's widths (mid 128, planes 192); tiny_ssf_l{0,2,4} and
        # tiny_ssftpu_l{0,2,4} are the -TINY forms. SSF-TPU: the whole inter
        # pipeline in the s2d domain, pyramid scale-space warp.
        # MCVC-Original: stock SSF with the views as the batch
        widths = dict(mid_planes=32, planes=48) if tiny else {}
        return "ssf", ScaleSpaceFlow(s2d=s2d, dtype=dtype, **widths)
    if name.startswith("ELFVC"):
        # SSF's widths and a flow predictor (full resolution in the stock
        # form, a quarter-resolution trunk in -TPU); with -SP an SPnet
        # (trunk 8 * 64 = 512 wide) in the motion and residual hyperpriors.
        # tiny_elfvc_l{0,3,6} and tiny_elfvctpu_l{0,3,6} are the -SP-TINY
        # forms trained at sp_stage=2
        widths = dict(mid_planes=32, planes=48, sp_dim=16) if tiny else {}
        return "elfvc", ELFVC(super_prec="-SP" in name, sp_stage=sp_stage, s2d=s2d,
                              dtype=dtype, **widths)
    if name.startswith("MCVC"):
        # stock SSF's full-resolution transforms and volume warp over the
        # views folded into the batch; -IA adds the cross-view attention
        # backup decoders; -TINY at golden-RD scale (tiny_mcvc_l{0,3,6});
        # OLFT's online fine-tuning changes training only
        widths = dict(planes=48, mid_planes=32) if tiny else {}
        return "mcvc", MCVC(num_views, imbalanced_correlation="-IA" in name, dtype=dtype,
                            use_attn=use_attn, **widths)
    raise ValueError(f"Cannot recognize codec: {name}")


def get_codec_model(name: str, dtype: torch.dtype = torch.float32, device="cuda",
                    sp_stage: int = 1, num_views: int = 0, loss_type: str = "P",
                    compression_level: int = 2, use_attn: bool = True) -> CodecSpec:
    """``sp_stage`` (ELFVC-SP only): 1 lets the motion SPnet replace the
    motion latent, 2 the residual SPnet as well. ``num_views`` (MCVC only,
    at least 1 there): the views folded into each batch item; MCVC-Original
    takes the views as the batch of its rollout and needs none.
    ``loss_type`` and ``compression_level``: the training operating point
    (``CodecSpec.r``). ``use_attn=False`` (MCVC-IA only) drops the backup
    decoders' cross-view attention, as JAX's keyword does."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
    family, module = _build(name, dtype, sp_stage, num_views, use_attn)
    return CodecSpec(name=name, family=family, module=place(module, dtype, device),
                     loss_type=loss_type, compression_level=compression_level)


def place(module: nn.Module, dtype: torch.dtype, device) -> nn.Module:
    """``module`` on ``device`` for eval, its conv and Dense weights in
    ``dtype`` (everything else float32), as ``get_codec_model`` builds
    its codecs; for a module built from its arguments."""
    module = module.to(device).eval().requires_grad_(False)
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            m.to(dtype)
    return module
