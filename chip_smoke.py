#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (fastvideocodec_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each timed on its own line:

1. device: the card's name and power limit, the host's CPU; TF32 off for
   cuDNN and matmul;
2. build: nvcc builds the warp kernels (ops/kernels/csrc/warp.cu); ptxas's
   report (registers, spills, shared memory) of every kernel;
3. kernels: each of the five (tiled) kernels against its plain PyTorch
   version on the card, float32 and bfloat16 images (float32 flows for the
   pixel warps), bit for bit (max abs 0): at the shapes of the LSVC-TPU and
   SSF-TPU paths, with large and off-border displacements; on ragged
   shapes (pixel_warp also at MCVC's 18 channels on 4 views) with smooth
   flows (every tile of flow_warp_s2d staged in shared
   memory), +-200 px random flows (none) and flows smooth on one
   half and random on the other (both in one launch); and with two NaN
   flow pixels, which must give NaN exactly where the plain version does;
   then flow_warp (pair_warp_kernel at every shape) and both plans of
   pixel_warp (pixel_warp_kernel and pair_warp_kernel, whichever
   ops/kernels/warp.py:pixel_warp_plan picks at the shape) the same way on
   the ragged shapes and SMALL_FRAMES (DVC's small SpyNet levels, MCVC's
   4 x 18 x 256x256, a sub-tile frame, an odd width, 1, 2, 4, 7 and 18
   channels), and with an image or a flow one element past its pairs'
   alignment; every later timing phase holds both plans of pixel_warp bit
   for bit on its main-path inputs and logs the plan of each launch;
   then each kernel's gradient (its autograd Function) against autograd
   through its plain version (each launching its backward kernel once a
   backward), and the five backward kernels against the plain version's
   vjp at GRAD_TOL on the ragged shapes (pixel_warp at 3, 7, 15 and 18
   channels; odd H/2 and W/2 for the s2d forms) with smooth, random, mixed
   and NaN flows, float32 and bfloat16, with the image and the flow
   gradient each on and off (the image gradient's float32 atomics change
   order from run to run);
4. card vs CPU: LSVC-TPU in float32 at 64x128, GOP 4, shipped weights, on
   the card (kernels) and on the CPU (plain versions); then bfloat16 on the
   card against that float32 result;
5. rollout: LSVC-TPU in bfloat16 at 1024x2048, GOP 16, weights
   hd_lsvctpuf2_l2, on a synth_gop_multi clip (seed 0): one run with the
   launch counts zeroed before it, then 3 runs timed with CUDA events,
   each beside its host enqueue time (host clock until the call returns,
   before the card is waited for): when the two are close, the host's
   launches bound the run;
6. decode graph: the receiver's graph at the same setup, same timing;
7. kernel timing: each LSVC kernel, its plain version and the nearest
   single PyTorch call (grid_sample), on the inputs the main path gives it
   in one GOP, beside the least time the card could take (the bytes the
   warp must move over 3.35 TB/s); the kernel also with the L2 cache
   flushed before each launch, on smooth flows of the same shapes (a
   trained codec's) and on random ones, its worst case; for flow_warp_s2d
   the share of tiles whose footprint fits the shared-memory budget (the
   host's copy of the kernel's rule, ops/warp.py:staged_tiles), on the
   path's flows and on the smooth ones;
8. SSF card vs CPU: SSF-TPU-TINY in float32 at 64x128, GOP 4, shipped
   weights tiny_ssftpu_l2, card against CPU; then bfloat16 on the card
   against that float32 result;
9. SSF rollout: SSF-TPU at its full widths in bfloat16, 1024x2048, GOP 16
   (15 chained P-frames), numpy-seeded weights seeded_flat("SSF-TPU", 0),
   the same clip: one run with the launch counts zeroed, then 3 timed
   runs with their host enqueue times; its bpp and PSNR are printed, not
   gated (random weights);
10. SSF kernel timing: the three pixel warps as in phase 7, on the inputs
   the SSF rollout gives them (pixel_warp_s2d, which no codec calls, on
   the level-0 inputs with the phase flow unpacked to full resolution);
11. coder: g++ builds the host range coder (coder/range_coder.cc); the
   four codecs' tables from hd_lsvctpuf2_l2 and the seeded SSF-TPU
   weights; a seeded batch of symbols, past the support on both sides,
   round-trips through each; the scale-table codecs' bucketing of scales
   on the card (the video path's) equals their bucketing of the same
   scales on the host (the one the CPU tests hold to the JAX codecs');
12. LSVC real bits: LSVC-TPU's real bitstream encode and decode
   (coder/video.py) in bfloat16 at 1024x2048, GOP 16, hd_lsvctpuf2_l2, on
   the rollout's clip: one warm-up run, then 3 runs, each with the launch
   counts zeroed before its encode and before its decode, timed by the
   host clock around the call (range coding included, the card
   synchronised at its end), the range coder's seconds of each, real bpp
   beside the rollout's estimate on the same clip; decode must equal the
   encode recon bit for bit in every run;
13. SSF real bits: the same for SSF-TPU (seeded weights, keyframe coded),
   its real bpp held within 5% of the model's estimate over the same GOP
   (its forward, which codes the keyframe as the coder does);
14. ELFVC card vs CPU: ELFVC-SP-TPU-TINY (tiny_elfvctpu_l3, sp_stage 2) in
   float32 at 64x128, GOP 4, card against CPU; then bfloat16 on the card
   against that float32 result; the same on seeded_flat weights at 128x256,
   where the P-frame symbols the SPnets take are not all 0;
15. ELFVC rollout: ELFVC-SP-TPU at its full widths (SPnet trunk 512) in
   bfloat16, sp_stage 2, 1024x2048, GOP 16, seeded_flat("ELFVC-SP-TPU",
   0), the same clip: one run with the launch counts zeroed (exactly 30
   pixel_warp and 30 pixel_warp_s2d_sflow: two of each per P-frame), then
   3 timed runs with their host enqueue times; bpp, PSNR, pred_err_norm and
   peak memory printed, not gated (random weights); then one full-width
   SPnet attention call (4 heads, 8192 tokens, d 32, bf16) timed in the
   fused SDPA form the card runs and in the plain form;
16. ELFVC real bits: the same setup through elfvc_compress_gop and
   elfvc_decompress_gop as in phase 12: a warm-up GOP, then 3, each with
   decode == encode bit for bit, launches exactly 30 + 30 on encode and
   15 + 15 on decode, and real bpp within 5% of the model's forward
   estimate over the same GOP;
17. MCVC card vs CPU: MCVC-IA-TINY (tiny_mcvc_l3) on 3 views of 64x64
   (synth_mv_gop, seed 0), GOP 4, float32, with masks [1,1,1] and [1,1,0],
   card against CPU (3 pixel_warp launches on the card, one a P-frame),
   then bfloat16 on the card against that float32 result; MCVC-IA at its
   full widths on seeded_flat("MCVC-IA", 0) at 64x128, card against CPU;
   the fused attention's backend of each attention shape on the card;
18. MCVC rollout: MCVC-IA at its full widths (seeded) in bfloat16, GOP 16
   with the keyframe coded, 4 views of 256x256 (synth_mv_gop, seed 0; the
   multi-view dataset's frame size) with every view alive and with view 2
   failed: one run with the launch counts zeroed (exactly 15 pixel_warp at
   C = 18 and no other warp), then 3 timed runs with their host enqueue
   times; ms/GOP, ms per view-frame, view-frames/s, bpp, PSNR over the
   alive views, completeness, peak memory, the attention's backend;
19. the views sweep 1..6 at 256x256 on uniform random frames (the JAX
   package's speed task), the same;
20. MCVC at 4 views of 1024x2048, the row-offset crops (0, 320, 640, 1024)
   of the 2048x2048 clip of phase 5, the same;
21. MCVC kernel timing: pixel_warp at C = 18 as in phase 7, on the inputs
   the 4 x 256x256 and the 4 x 1024x2048 rollouts give it, and beside it,
   as in phase 31, the device time of the kernel and of F.grid_sample
   under torch.profiler and the host's enqueue time of each;
22. MCVC real bits: 4 views of 256x256, view 2 failed, through
   mcvc_compress_gop and mcvc_decompress_gop as in phase 12: launches
   exactly 15 + 15, decode == encode bit for bit, real bpp within 5% of
   the model's estimate over the same GOP and mask;
23. stock card vs CPU: the stock (s2d=1) tiny models SSF-TINY
   (tiny_ssf_l2) and ELFVC-SP-TINY (tiny_elfvc_l3, sp_stage 2) as in
   phase 8, with bars of their own for bf16 (STOCK_*: the stock forms'
   rates and PSNR move more in bf16, in JAX too);
24. SSF-Official rollout: full widths, seeded_flat("SSF-Official", 0),
   bf16, 1024x2048, GOP 16, the clip of phase 5: one run with the launch
   counts zeroed (exactly 15 pixel_warp at C = 18 full resolution, no
   other warp), then 3 timed runs with their host enqueue times and peak
   memory;
25. pixel_warp on SSF-Official's own volume (1 x 18 x 1024x2048), as in
   phase 7: warm and L2-flushed against its byte bound and F.grid_sample;
26. SSF-Official real bits as in phase 13: launches exactly 15 + 15,
   decode == encode, real bpp within 5% of the forward's estimate;
27. ELFVC-SP (sp_stage 2) at full widths, seeded, the same clip: the
   rollout (exactly 30 pixel_warp), the full-resolution flow predictor
   alone with and without deterministic_convs, and real bits (launches
   exactly 30 + 15);
28. MCVC-Original: stock SSF over the 4 views of 256x256 of phase 18 as a
   batch, seeded: the rollout (15 pixel_warp over the 4 views), the
   keyframe-coded forward timed, and real bits (15 + 15);
29. DVC family card vs CPU: DVC-TINY (tiny_dvc_l2), RLVC-TINY
   (tiny_rlvc_l2) and Base-ER-TINY (tiny_base_l2) at 64x64 (JAX's golden
   size) as in phase 8, with bars of their own for bf16 (DVC_BF16_*);
30. DVC at full widths, seeded_flat("DVC", 0) with the pretrained
   spynet.npz in its SpyNet (real motion on the clip), bf16, 1024x2048,
   GOP 16, the clip of phase 5: one run with the launch counts zeroed
   (exactly 75 flow_warp: 4 SpyNet levels and the MC warp a P-frame, no
   other warp), then 3 timed runs with their host enqueue times and peak
   memory;
31. flow_warp on DVC's own inputs, the 75 launches of one GOP by shape
   (each SpyNet level, 1 x 3 x 128x256 .. 1024x2048, and the 15
   full-resolution MC warps) and in all, as in phase 7: warm and
   L2-flushed against the byte bound, the plain version and
   F.grid_sample, and beside them the device time of the kernel and of
   F.grid_sample under torch.profiler and the host's enqueue time of each;
   then the host's cost of one flow_warp launch at 1 x 3 x 128x256, piece
   by piece (tools/launch_cost.py), beside F.grid_sample's call;
32. DVC real bits at 1024x2048 (a warm-up GOP and one timed): launches
   exactly 75 + 15, decode == encode bit for bit, real bpp within 5% of
   the rollout's estimate on the same P-frames;
33. RLVC the same (rollout 3 timed runs, real bits at 1024x2048);
34-36. RLVC-HP, RLVC2 and Base-EC-ER: the rollout (75 flow_warp, one
   timed run), and real bits at 256x512 (the clip's top-left crop) for
   RLVC-HP and Base-EC-ER (RLVC2 has no real-bits path);
37. the rest of LSVC, card vs CPU in float32 at 64x128, GOP 4: LSVC-TINY
   (tiny_lsvc_l2, then bfloat16 against that float32 result, LSVC_BF16_*),
   the full-width LSVC-128 (hd_lsvc128_l2), the tiny -RW and -HF forms and
   the tiny flagship with -A and -S at attn_depth 2 (seeded), with the
   fused attention's backend;
38. LSVC-128 (hd_lsvc128_l2, the s2d=1 reference structure: the stock
   SpyNet over all 15 P-frames in one batch, the full-resolution WarpNet)
   at 1024x2048, GOP 16, bf16: the rollout (launches exactly 4 + 4
   flow_warp, 3 timed runs with their enqueue ms, peak memory), the decode
   graph (4 flow_warp), real bits (a warm-up GOP and 3: decode == encode,
   8 and 4 flow_warp, bpp within 5% of the rollout's estimate and PSNR
   within 0.1 dB), and flow_warp on its 8 inputs (the 4 SpyNet levels,
   15 frames a launch, and the 4 layers' MC warps) as in phase 31;
39. LSVC-TPU-RW, -HF, -WT, -QU (their shipped level-2 checkpoints), -HU,
   -A and -S (seeded; attn_depth 12) the same way, the launches of each
   exact (4 flow_warp and 4 MC warps: flow_warp at C = 12 for -RW,
   flow_warp_s2d for the others); the trained forms' real bpp within 5%
   of the estimate; flow_warp on -RW's 4 MC warps ([n, 12, 512, 1024])
   and flow_warp_s2d on -HF's, as in phase 31;
40. the graphs on hd_lsvctpuf2_l2: -L (a chain of 15 layers, GOP 16) and
   -O (one layer; the one-hop graph reaches 14 P-frames, in JAX too, so
   GOP 15): the rollout, its launches exact;
41. JAX's HD head-to-head (tests/test_rd.py:TestHDHeadToHead) on the card
   in float32: LSVC-128, LSVC-TPU, -HF and -RW on hd_*_l{0,2,4}, four
   held-out synth_gop_multi clips (seed 123) of 128x128, GOP 8, real
   bits with decode == encode on each: every curve monotone, LSVC-TPU's
   BD-rate against LSVC-128 under 10% and its BD-PSNR above -0.6 dB, and
   full < half-res < rigid with rigid under 32% and half-res under 16%;
42. LSVC-TPU training, card vs CPU: one step of the full-width model
   (hd_lsvctpuf2_l2) in float32 at 64x128, GOP 4 (phase 4's clip), the
   same noise on both devices, the CPU on the card's ReLU branches (an
   activation whose input lies within float32 noise of 0 may pass its
   gradient on one device and not on the other: the card's run records
   each ReLU's and leaky ReLU's positive set, the CPU's takes it, and the
   elements that differed are counted): loss and metrics, each parameter's
   gradient (the worst max abs / max |grad| named) and the parameters
   after one Adam step, at the TRAIN_CPU_* bars; the card under
   deterministic cuDNN from an emptied cache, as in phase 53 (phases 46
   and 49 keep cuDNN's defaults, as users train);
43. LSVC-TPU train at 256x256, GOP 16, float32 (tools/train_tiny.py's
   lsvctpu256_hd rung): 10 steps of make_train_step from
   hd_lsvctpuf2_l2, one synth_gop_multi clip a step from default_rng(0),
   lr 1e-4: ms/step by CUDA events (median and range over steps 5-10),
   host enqueue ms/step, peak GiB, loss/PSNR/bpp/grad_norm of the first
   and last step; the launches exact (a step: 4 + 4 forward warps, 3
   flow_warp and 4 flow_warp_s2d backward kernels), no plain warp called
   (PLAIN and PLAIN_BACKWARD wrapped with counters), every value finite,
   the parameters moved; then one more step with the backward kernels'
   inputs captured;
44. the batched train, 4 clips x 7 frames x 256x256 float32 (cli/train.py's
   default shape), 5 steps under a staircase exponential decay, launches
   exact, no plain warp; then save_checkpoint/load_checkpoint in a
   temporary directory: parameters, optimizer state, epoch and score equal
   bit for bit, and the next step runs; ms/step and peak GiB (the batch is
   not shrunk to fit: an out-of-memory error fails the phase);
45. backward kernel timing on the captured step's inputs: each backward
   kernel's ms per step's launches (warm, with the L2 flushed, and device
   time under the profiler), its byte bound at 3.35 TB/s, its launch floor
   (an empty kernel on each launch's backward grid, L2 flushed), ptxas's
   report of its float32 entry, the plain vjp's time and, for flow_warp,
   F.grid_sample's forward and backward on the same inputs;
46. ELFVC-SP-TPU and ELFVC-SP training, card vs CPU: one step of each at
   full width (seeded_flat(name, 0), sp_stage 1 as cli/train.py builds
   them) in float32 at 64x128, GOP 4, as phase 42, at its bars, their
   gradient norms printed (JAX's ELFVC-SP at its own random init is
   degenerate, ~1e30); then, as a control, the card's step once more with
   the pixel warps' backward kernels' flow gradient zeroed, which must
   fail the gradient bar at the motion decoder;
47. ELFVC-SP, cli/train.py's default codec, on its default batch of 4
   clips x 7 frames x 256x256, float32, full width from seeded_flat: 2
   steps of the default stage, then 2 steps each of
   make_elfvc_stage_optimizer's stages 0, 1 and 2; per stage ms/step by
   CUDA events (median and range), host enqueue, peak GiB, and loss, PSNR,
   bpp and grad_norm of the first and last step; the launches exact and
   stated beforehand (each P-frame 2 pixel_warp and 2 flow-only backward
   kernels), no plain warp or plain vjp called, every parameter outside a
   stage's groups bit for bit unchanged through it; the stage masking on
   unit gradients (JAX's test); then one step with the pixel warps'
   backward inputs captured;
48. SSF-TPU and ELFVC-SP-TPU at 256x256, GOP 16, float32 (phase 43's
   shape), 3 steps each from seeded_flat, the same readings: each
   P-frame 1 (SSF-TPU) or 2 (ELFVC-SP-TPU) pixel_warp at C = 15 and
   pixel_warp_s2d_sflow, each with a flow-only backward kernel; the
   parameters outside the keyframe's transforms moved; one step's
   backward inputs captured;
49. MCVC-IA and MCVC-IA-OLFT training, card vs CPU: one step of each at
   full width (seeded_flat) in float32 on 3 views of 64x128, GOP 4, view
   2 failed, as phase 46 (the OLFT step's loss is olft_loss; the CPU also
   takes the card's touch-up masks), with the same control;
50. cli/train_multiview.py's loop at full width on 4 views of 256x256,
   GOP 16, float32: 3 OLFT steps of MCVC-IA-OLFT (touch-up ratio 0.1,
   each step's labels priced on the host) and 3 steps of MCVC-IA, the
   view masks of --resilience 1 from the host's default_rng(0); the
   readings of phase 48 and touch_bpp, each P-frame 1 pixel_warp at C = 18
   and its flow-only backward kernel; the parameters OLFT's loss does not
   reach (the plain decoders, the hyperpriors) bit for bit unchanged;
   OLFT's checkpoint round trip; one MCVC-IA step's backward inputs
   captured;
51. OLFT on the card (JAX's TestOlftImprovesHeldout): MCVC-IA-OLFT-TINY
   from tiny_mcvc_l3, 40 steps at lr 1e-5 on a gamma-shifted synth_mv_gop
   category must lift the held-out PSNR (seed 555, 3 GOPs) by more than
   0.6 dB;
52. the pixel warps' backward kernels timed on those inputs, by path:
   ms per step's launches, warm, L2-flushed and device time, against the
   byte bound and the launch floor (as phase 45), with ptxas's report,
   the plain vjp and, for pixel_warp, F.grid_sample's forward and backward
   on the prepared grid (pixel_warp_s2d, which no codec calls, on the
   sflow's inputs with the flow unpacked to full resolution);
53. DVC, RLVC and Base-EC-ER training, card vs CPU: one step of each at
   full width (seeded_flat with the pretrained SpyNet, Base-EC-ER with the
   soft2hard three passes) in float32 at 64x128, GOP 4, as phase 46 (the
   CPU also on RLVC's clip as the card took it), under deterministic
   cuDNN (the seeded DVC step's SpyNet gradient, a small sum of large
   terms, moves with the order of cuDNN's atomic backward), with a control
   that zeroes flow_warp_backward's flow gradient;
54. those three and RLVC2 and RLVC-HP for 2 steps each on
   cli/train.py's default batch of 4 x 7 x 256x256, float32, the readings
   of phase 47; each P-frame 5 flow_warp and 4 flow-only backward launches
   (Base-EC-ER's soft2hard 15 and 5: ``chain_train_launches``), stated
   beforehand and exact, no plain warp or vjp, every parameter moved; one
   DVC step's warp inputs captured;
55. cli/train.py --codec DVC --loss-type M through its main, on the card,
   on a tree of 7-frame PNG clips of 256x448 the phase writes: 1 epoch of
   3 steps of 4 clips, finite metrics, the launches exact, the checkpoint
   written; the checkpoint's img_loss on a clip equal to 1 - ms_ssim of
   its recon, and that MS-SSIM on the card against the CPU's;
56. flow_warp and flow_warp_backward on DVC's training step's 120 and 96
   launches, by shape: as phases 31 and 45 (the backward held to the
   plain vjp on each launch);
57. bf16 training (flax's mixed precision, JAX's --bf16: float32 masters,
   bfloat16 convs and Denses, the masters cast once a step), card against
   itself under deterministic cuDNN: one step of LSVC-TPU, SSF-TPU,
   ELFVC-SP-TPU, MCVC-IA (3 views, view 2 failed) and DVC at full width
   (the weights of phases 42-53) at 64x128, GOP 4, in bf16 and in float32
   on the card and on the CPU: the card's bf16 gradient's relative L2
   distance from its own float32 step within BF16_DRIFT times the CPU's
   (each top-level submodule within BF16_SUB_DRIFT times, or
   BF16_SUB_FLOOR), its distance from the CPU's bf16 gradient within
   1 + BF16_DRIFT times the CPU's drift plus the two float32 steps' gap,
   and a control with the warps' flow gradient zeroed (MCVC's scaled by
   BF16_MCVC_CONTROL_SCALE) that must miss;
58. those five at the float32 phases' shapes (LSVC-TPU, SSF-TPU and
   ELFVC-SP-TPU at 256x256 GOP 16, MCVC-IA at 4 x 256x256 GOP 16, DVC on
   4 x 7 x 256x256): BF16_STEPS steps in float32 and as many in bf16 in
   the same call, each with ms/step by CUDA events, enqueue ms and peak
   GiB; the warp launches of the two equal, no plain warp or vjp, every
   value finite, parameters and Adam moments float32; one more bf16 step's
   backward inputs captured (their image dtype printed: float32 but
   MCVC's, as the frames keep their dtype in training);
59. the launches of those steps that run a bf16 backward kernel
   (MCVC-IA's pixel_warp_backward: every other warp takes a float32 image
   in training), on their captured inputs, held to the float32 plain vjp
   at GRAD_TOL["bfloat16"]: warm, L2-flushed and device ms, the byte
   bound at bf16 bytes, the plain vjp and F.grid_sample's bf16 forward
   and backward;
60. cli/train.py --bf16 --codec LSVC-TPU through its main on PNG clips the
   phase writes: 1 epoch of 3 steps (the float32 CLI's launches), then
   --resume for a second: float32 checkpoints, the optimizer's count 3
   then 6;
61-64. the evaluation path (``fastvideocodec_torch/tools/eval_smoke.py``,
   which states each gate): ``evaluate_video`` of LSVC-TPU at 1024x2048
   bf16 GOP 16 on a .yuv clip through ``VideoDataset``, estimated and real
   bits (4 + 4 warp launches a GOP, no plain warp, decode == encode, real
   bpp within 5%, the log read back by ``rd_points``); SSF-TPU,
   ELFVC-SP-TPU and DVC through ``_real_bits_gop`` and
   ``cli/train_multiview.py --task eval --real-bits`` of MCVC-IA (decode
   == encode); ``evolve_on_video`` of LSVC-TPU at 256x256 (both flow
   backward kernels, frozen parameters bit for bit, the evolved stream
   decoding on an un-evolved receiver) and ``cli/train.py --evaluate
   --evolve``; ``cli/eval.py --real-bits``, ``--task speed`` for 1..6
   views and the x26x anchors where ffmpeg is there;
65-68. the offline tools and the last library modules
   (``fastvideocodec_torch/tools/tools_smoke.py``, which states each gate):
   ``tools/train_tiny.py`` on the card (LSVC-TPU at full width, 128x128
   GOP 8, 10 steps, exactly its forward and backward warp launches and no
   plain warp or vjp; SSF-TPU-TINY, ELFVC-SP-TPU-TINY through its four
   stages and MCVC-IA-TINY 2 steps each; every npz in its shipped asset's
   layout, reloaded bit for bit); ``cli/simulate.py`` over phase 61's log
   with LSVC-TPU's levels 0 and 4 added (the card's decode times) and over
   phase 62's ``MCVC-IA.avg.log``; ``warp_volume_pyramid`` bit for bit at
   1024x2048 with 2 launches, ``ContextVP`` card against CPU, ``flow_to_image``
   of LSVC-TPU's SpyNet flow, the three knobs; ``tools/speed_sweep.py``'s
   GOP and SSF encode sweeps at 1024x2048 bf16. The hd head-to-head of the
   LSVC forms' phase runs through ``tools/price_hd.py``;
69-70. the multi-device layer (``fastvideocodec_torch/tools/multichip_smoke.py``,
   which states each gate): ``tools/dryrun_multichip.py 4 --device cuda``,
   4 ranks over gloo time-sharing the card, each of JAX's four dry-run
   halves one training step on a mesh at full width (LSVC-TPU from
   hd_lsvctpuf2_l2 over 'data' on 4 clips of 7 x 256x256 and over (data 2
   x frame 2) on 2 clips of GOP 16; SSF-TPU seeded over 'data'; MCVC-IA
   seeded over 'view' 4 on 4 views of 256x256, GOP 4, view 2 failed)
   against the same step in one process under deterministic cuDNN: loss
   within 1e-4, gradients within 5e-3 of their max, the ranks bit for bit
   equal, no plain warp or vjp, the launches exact by rank; then a world of
   one over NCCL in this process (the data parallel halves of LSVC-TPU and
   SSF-TPU against the unsharded step: the loss bit for bit, SSF-TPU's
   parameters bit for bit).

Along the way it prints a JSON line of MCVC's numbers, one of the stock
codecs', one of the DVC family's, one of the training numbers, one of the
evaluation path's, one of the tools', one of the multi-device steps' (each
half's losses, gradient gaps, ms/step sharded and single with the note
that the ranks time-share the card, launches and enqueue ms by rank) and
one of the LSVC forms'; then a JSON line of the
kernels (the five warps, each with its launches on every path it was
counted on; ``launches`` and the
times stay those of the path that defined them in earlier slices:
LSVC-TPU's rollout for the two flow warps, SSF-TPU's timing and
ELFVC-SP-TPU's launches for the pixel warps; pixel_warp's MCVC-IA and
SSF-Official timings, flow_warp's on DVC's, LSVC-128's and -RW's inputs
and flow_warp_s2d's on -HF's stand under ``timing_by_path``; and the two
backward kernels of the flow warps, their launches those of phase 43's
training steps, their times those of phase 45 (flow_warp_backward's
launches in phase 54 by codec and its times on DVC's step beside them); the three of the pixel
warps, their launches those of phases 47, 48 and 50, their times those
of phase 52: ten kernels in all; pixel_warp_backward's bf16 instantiation
on phase 58's bf16 launches under ``bf16_timing_by_path``; the launches
of phases 61-68 by path under ``launches_by_path`` and
``launches_by_eval_path``; those of phases 69-70's steps, summed over the
ranks, under ``launches_by_path`` of every kernel),
the card's name and power limit,
and last the line ``{"ok": true, "device": {...}}``. Any failed phase
raises, so the run exits non-zero without that line. It needs no JAX and
nothing of the JAX package; it exits non-zero when no CUDA device is found.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# the timing shared with warp_ab.py and the port's tools (the package is
# on the path only beside the rest of the repo: alone, this import fails)
from fastvideocodec_torch.tools.timing import (  # noqa: F401 (warp_ab.py reads them here)
    F32_FLOPS,
    FLUSH_BYTES,
    HBM_BYTES_PER_S,
    bound_ms,
    cold_ms,
    cuda_ms,
    device_ms,
    host_ms,
    timed_runs as _timed_runs,
)

ROOT = Path(__file__).resolve().parent
SSF_BF16_PSNR_DB = 0.11  # SSF-TPU-TINY bf16 card vs f32 CPU: max per-frame PSNR gap
SSF_BF16_BPP_REL = 0.095  # and relative bpp gap (an H100 measured 0.0222 dB, 0.019)
# ELFVC-SP-TPU-TINY bf16 card vs f32 CPU (an H100 measured 0.0803-0.0806 dB and
# 1.5e-7: every P-frame symbol is 0 on this clip)
ELFVC_BF16_PSNR_DB = 0.25
ELFVC_BF16_BPP_REL = 0.05
# ELFVC-SP-TPU-TINY on seeded_flat(.., 0) at 128x256, nonzero P-frame symbols
# (bf16 against f32: 0.051 dB and 0.031 on the CPU, 0.0567 dB and 0.0349 on an H100)
ELFVC_SEEDED_BF16_PSNR_DB = 0.25
ELFVC_SEEDED_BF16_BPP_REL = 0.1
ELFVC_SP_STAGE = 2
# the stock tiny models' bf16 against f32 (SSF-TINY tiny_ssf_l2, ELFVC-SP-TINY
# tiny_elfvc_l3): their rates and PSNR move more in bf16 than the -TPU forms'
# (the CPU port measured 0.015 dB and 0.107 for SSF-TINY, 0.238 dB and 0 for
# ELFVC-SP-TINY; JAX's own bf16 rollout sits 6.7-18% in rate per P-frame from
# its f32 for SSF-TINY, 0.10-0.37 dB in PSNR for ELFVC-SP-TINY)
STOCK_SSF_BF16_PSNR_DB = SSF_BF16_PSNR_DB
STOCK_SSF_BF16_BPP_REL = 0.15
STOCK_ELFVC_BF16_PSNR_DB = 0.4
# MCVC-IA-TINY (tiny_mcvc_l3) bf16 against f32, 3 views of 64x64, GOP 4 (the
# CPU port measured 0.0094 dB and 0.0048, an H100 0.0056 dB and 0.0028)
MCVC_BF16_PSNR_DB = 0.03
MCVC_BF16_BPP_REL = 0.01
MCVC_SIZE = 256  # the multi-view dataset's frame size (data/multiview.py)
MCVC_VIEWS = 4
MCVC_FAILED = 2  # the view that fails in the masked runs
# DVC-TINY, RLVC-TINY and Base-ER-TINY (tiny_{dvc,rlvc,base}_l2) bf16 against
# f32 at 64x64, GOP 4: the CPU port measured 0.0055, 0.0067 and 0.0129 dB and
# 0.0021, 0.0074 and 0.0016 of bpp
DVC_BF16_PSNR_DB = 0.05
DVC_BF16_BPP_REL = 0.03
# LSVC-TINY (tiny_lsvc_l2) bf16 against f32 at 64x128, GOP 4: the CPU port
# measured 0.0040 dB and 0.0029 of bpp
LSVC_BF16_PSNR_DB = 0.05
LSVC_BF16_BPP_REL = 0.01
# the tiny widths of the flagship's architecture (the registry's -TINY branch)
TINY_TPU = dict(channels=48, conv_channels=32, s2d=2, spynet_widths=(8, 16, 8, 4),
                spynet_kernel=5, spynet_s2d_levels=2, mv_polyphase_out=True, warp_width=32,
                full_res_warp=True, mv_full_res_out=True)
# the LSVC-TPU forms at full width: (name, weights), trained where shipped
LSVC_VARIANTS = [("LSVC-TPU-RW", "hd_lsvctpu_l2"), ("LSVC-TPU-HF", "hd_lsvctpuf_l2"),
                 ("LSVC-TPU-WT", "hd_lsvctpuwt_l2"), ("LSVC-TPU-QU", "hd_lsvctpuqu_l2"),
                 ("LSVC-TPU-HU", "seeded"), ("LSVC-TPU-A", "seeded"), ("LSVC-TPU-S", "seeded")]
# JAX's TestHDHeadToHead: (name, checkpoint family) of each curve
HD_CURVES = [("LSVC-128", "lsvc128"), ("LSVC-TPU", "lsvctpuf2"), ("LSVC-TPU-HF", "lsvctpuf"),
             ("LSVC-TPU-RW", "lsvctpu")]
HD_SIZE, HD_GOP = 128, 8
C18_RAGGED = (4, 18, 37, 141)  # MCVC's volume warp: 6 levels x 3 colours, 4 views
GOP, H, W = 16, 1024, 2048
SPYNET_SHAPES = [(64, 128), (128, 256), (256, 512), (512, 1024)]  # per GOP
# gradients through the Function vs autograd through the plain version: the
# image gradient is a scatter-add whose atomic order may change per run
GRAD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}  # rtol, atol x max |grad|
KERNEL_SOURCE = "fastvideocodec_torch/ops/kernels/csrc/warp.cu"
REPLACES = {
    "flow_warp": "fastvideocodec_tpu/ops/pallas/warp_kernel.py:502",
    "flow_warp_s2d": "fastvideocodec_tpu/ops/pallas/warp_kernel.py:548",
    "pixel_warp": "fastvideocodec_tpu/ops/pallas/warp_kernel.py:577",
    "pixel_warp_s2d": "fastvideocodec_tpu/ops/pallas/warp_kernel.py:618",
    "pixel_warp_s2d_sflow": "fastvideocodec_tpu/ops/pallas/warp_kernel.py:673",
    # the custom_vjp backwards (the vjp of the XLA exact path)
    "flow_warp_backward": "fastvideocodec_tpu/ops/pallas/warp_kernel.py:522",
    "flow_warp_s2d_backward": "fastvideocodec_tpu/ops/pallas/warp_kernel.py:567",
    "pixel_warp_backward": "fastvideocodec_tpu/ops/pallas/warp_kernel.py:594",
    "pixel_warp_s2d_backward": "fastvideocodec_tpu/ops/pallas/warp_kernel.py:642",
    "pixel_warp_s2d_sflow_backward": "fastvideocodec_tpu/ops/pallas/warp_kernel.py:698",
}
FLOW_BACKWARD = {"flow_warp_backward": "flow_warp", "flow_warp_s2d_backward": "flow_warp_s2d"}
# each backward's float32 kernel entry in ptxas's report (a part of its
# mangled name: the template's type and layout)
BACKWARD_ENTRY = {"flow_warp_backward": "flow_warp_backward_kernelIfLb0E",
                  "flow_warp_s2d_backward": "flow_warp_backward_kernelIfLb1E",
                  "pixel_warp_backward": "pixel_warp_backward_kernelIfLi0E",
                  "pixel_warp_s2d_backward": "pixel_warp_backward_kernelIfLi1E",
                  "pixel_warp_s2d_sflow_backward": "pixel_warp_backward_kernelIfLi2E"}
PIXEL_BACKWARD = {"pixel_warp_backward": "pixel_warp", "pixel_warp_s2d_backward": "pixel_warp_s2d",
                  "pixel_warp_s2d_sflow_backward": "pixel_warp_s2d_sflow"}
BACKWARD = {**FLOW_BACKWARD, **PIXEL_BACKWARD}
# LSVC-TPU training on the card (train_tiny.py's lsvctpu256_hd rung, and
# cli/train.py's default batch): full width, float32, hd_lsvctpuf2_l2
TRAIN_SIZE, TRAIN_GOP, TRAIN_STEPS, TRAIN_LR = 256, 16, 10, 1e-4
BATCH_CLIPS, BATCH_GOP, BATCH_STEPS = 4, 7, 5
# card vs CPU, one training step at 64x128, GOP 4 (float32, TF32 off): the
# loss and metrics within 1e-4 relative, each parameter's gradient within
# 5e-3 of its max |grad| (cuDNN's algorithms and the backward's atomics
# sum in other orders than the CPU), the parameters after one Adam step
# within 2 lr + 1e-6: a gradient near 0 that differs in sign between the
# devices moves its parameter 2 lr the other way
TRAIN_CPU_METRIC_REL, TRAIN_CPU_GRAD_REL = 1e-4, 5e-3
# the launches of one LSVC-TPU training step on a GOP whose tree has
# ``layers`` layers (4 at GOP 16, 2 at GOP 7): each forward warp once a
# SpyNet level and once a tree layer; flow_warp's backward at the 3 finer
# levels (the coarsest level's flow is zeros: nothing of it needs a
# gradient), flow_warp_s2d's at each layer (the flow always, the reference
# from layer 1 on: layer 0's parents are the input I-frame)
def train_launches_of(layers: int) -> dict:
    return {"flow_warp": 4, "flow_warp_s2d": layers, "flow_warp_backward": 3,
            "flow_warp_s2d_backward": layers}
# SSF and ELFVC training on the card, float32, full width from
# seeded_flat(name, 0), the ELFVC-SP forms at sp_stage 1 (cli/train.py's):
# ELFVC-SP's default stage (2 steps), then 2 steps of each make_elfvc_stage_optimizer
# stage (JAX's staged recipe, tools/train_tiny.py:train_elfvc, shortened);
# the -TPU forms at phase 43's 256x256, GOP 16
ELFVC_TRAIN_STEPS, ELFVC_STAGE_STEPS, TPU_FORM_STEPS = 2, 2, 3
DEGENERATE_GRAD_NORM = 1e20  # JAX's ELFVC-SP at its own random init: ~1e30
# MCVC training on the card, float32, full width from seeded_flat(name, 0):
# one step card vs CPU of MCVC-IA and MCVC-IA-OLFT on 3 views of 64x128,
# GOP 4, view 2 failed, at phase 46's bars; then cli/train_multiview.py's
# loop on a category of 4 views of 256x256, GOP 16 (MCVC_VIEWS, MCVC_SIZE,
# GOP): MCVC-IA-OLFT's online fine-tuning (touch-up ratio 0.1, view masks
# of --resilience 1 from the host's default_rng) and MCVC-IA's RD training,
# 3 steps each at the CLI's lr; and JAX's TestOlftImprovesHeldout on the
# card: MCVC-IA-OLFT-TINY from tiny_mcvc_l3, 40 OLFT steps at lr 1e-5 on a
# gamma-shifted synth_mv_gop must lift the held-out PSNR by more than 0.6 dB
# (JAX measured +1.32 on the CPU)
MCVC_TRAIN_STEPS, MCVC_TRAIN_LR, OLFT_RATIO, MCVC_RESILIENCE = 3, 1e-5, 0.1, 1
OLFT_STEPS, OLFT_GAMMA, OLFT_GAIN_DB = 40, 1.8, 0.6
OLFT_UNREACHED = ("img_decoder.", "res_decoder.", "img_hyperprior.", "motion_hyperprior.",
                  "res_hyperprior.")
# DVC, RLVC (RLVC2, RLVC-HP) and Base-EC-ER training on the card, float32,
# full width from seeded_flat(name, 0) with the pretrained SpyNet, Base-ER's
# form with the soft2hard three passes (TrainConfig.soft2hard): one step card
# vs CPU at 64x128, GOP 4, at phase 46's bars; then cli/train.py's default
# batch of 4 x 7 x 256x256, CHAIN_TRAIN_STEPS steps each (CHAIN_SHORT_STEPS
# for RLVC2 and RLVC-HP); then cli/train.py --codec DVC --loss-type M through
# its main on a tree of CLI_CLIPS 7-frame clips of 256x448 PNGs, 1 epoch of
# CLI_STEPS steps, its checkpoint's MS-SSIM on the card against the CPU's
CHAIN_TRAIN = {"DVC": 2, "RLVC": 2, "Base-EC-ER": 2, "RLVC2": 2, "RLVC-HP": 2}
SOFT2HARD = ("Base-EC-ER",)
CLI_CLIPS, CLI_STEPS, MSSSIM_CARD_CPU_REL = 12, 3, 1e-5
# the launches of a DVC, RLVC or Base training step over ``p_frames``
# P-frames, derived from the code: each P-frame warps 4 SpyNet levels and
# its MC warp forward; the backward reaches the 3 finer levels (the
# coarsest level's flow is zeros) and the MC warp (the reference is the
# input or a detached recon: flow gradient only). Base-ER's soft2hard runs
# the P-frame three times (15 forward): pass 1's decoders take round(l), so
# its backward reaches the MC warp alone (its mv decoder's input is the
# detached round), and pass 2 detaches the motion compensation (none)
def chain_train_launches(name: str, p_frames: int) -> dict:
    forward, backward = (15, 5) if name in SOFT2HARD else (5, 4)
    return {"flow_warp": forward * p_frames, "flow_warp_backward": backward * p_frames}
# the launches of an SSF or ELFVC training step over ``p_frames`` P-frames:
# each warp call a forward and a flow-only backward (the warped reference
# is detached, the flow comes from the parameters); stock SSF warps its
# volume once a P-frame and ELFVC twice (pixel_warp at C = 18), the -TPU
# forms' pyramid warp is one pixel_warp (C = 15) and one sflow warp
def pixel_train_launches(name: str, p_frames: int) -> dict:
    per = 2 if name.startswith("ELFVC") else 1
    warps = ("pixel_warp", "pixel_warp_s2d_sflow") if "-TPU" in name else ("pixel_warp",)
    return {f"{k}{part}": per * p_frames for k in warps for part in ("", "_backward")}
# bf16 training on the card (flax's mixed precision, JAX's --bf16: float32
# masters, bfloat16 convs and Denses): one step card against the card's own
# float32 step at 64x128, GOP 4, each bf16 gradient's relative L2 distance
# within BF16_DRIFT times the CPU's own (every top-level submodule within
# BF16_SUB_DRIFT times the CPU's, or BF16_SUB_FLOOR), a control with the
# warps' flow gradient zeroed (MCVC's times BF16_MCVC_CONTROL_SCALE: its
# motion decoder's gradient is float32 noise, and bf16 rounding moves it
# more than zeroing its flow part does) that must miss them; then
# BF16_STEPS steps of each at the float32 phases' shapes beside as many
# float32 steps in the same call
BF16_CASES = ("LSVC-TPU", "SSF-TPU", "ELFVC-SP-TPU", "MCVC-IA", "DVC")
BF16_DRIFT, BF16_SUB_DRIFT, BF16_SUB_FLOOR = 1.5, 2.0, 1e-2
BF16_MCVC_CONTROL_SCALE, BF16_STEPS = 100.0, 2
NCHW_KERNELS = ("flow_warp", "pixel_warp")
PLANS = ("tiled", "small")  # of pixel_warp (ops/kernels/warp.py:pixel_warp_plan)
# the small-frame plan's shapes beside the ragged ones: DVC's three SpyNet
# levels below full resolution, MCVC's 4 x 18 x 256x256 volume, a frame
# smaller than one tile, an odd width, and 1, 2, 4, 7 and 18 channels (the
# few-channel group short; the many-channel group short, with a remainder
# and whole)
SMALL_FRAMES = [(1, 3, 128, 256), (1, 3, 256, 512), (1, 3, 512, 1024), (4, 18, 256, 256),
                (1, 3, 16, 32), (1, 3, 9, 33), (2, 1, 40, 70), (2, 2, 40, 70), (1, 4, 33, 65),
                (1, 7, 24, 200), (3, 18, 20, 50)]
LSVC_KERNELS = ("flow_warp", "flow_warp_s2d")
SSF_KERNELS = ("pixel_warp", "pixel_warp_s2d", "pixel_warp_s2d_sflow")
S2D_KERNELS = ("flow_warp_s2d", "pixel_warp_s2d", "pixel_warp_s2d_sflow")


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== phase {name}")
    yield
    log(f"== phase {name}: {time.perf_counter() - t0:.3f} s")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke failed: {msg}")


def ptxas_report(build_log: str, part: str) -> list:
    """(entry, "spills; registers and shared memory") from ptxas's -v report
    in build_log, for each kernel entry whose name holds ``part``."""
    lines = build_log.splitlines()
    return [(line.split("'")[1],
             f"{lines[i + 2].strip()}; {lines[i + 3].split(':', 1)[1].strip()}")
            for i, line in enumerate(lines)
            if "Compiling entry function" in line and part in line]


def plain_vjp_like(plain, img, flow, g, need_img, need_flow) -> list:
    """The plain vjp ``plain`` (ops.warp.PLAIN_BACKWARD's) of the inputs
    widened to float32 (exactly), each gradient rounded to its input's
    dtype: what a backward kernel, which sums in float32 and rounds once,
    is held to (the bfloat16 plain vjp scatter-adds bfloat16 terms, and
    +-200 px flows pile hundreds onto a border pixel)."""
    return [None if w is None else w.to(t) for w, t in zip(
        plain(img.float(), flow.float(), g.float(), need_img, need_flow),
        (img.dtype, flow.dtype))]


def hold_gradients(torch, got, want, tol, what: str) -> float:
    """A backward kernel's (grad_img, grad_flow) against the plain vjp's
    ``want`` at ``tol`` (GRAD_TOL's rtol, atol x max(max |grad|, 1)): the
    same gradients given (None where not asked for), NaN exactly where the
    plain vjp has NaN, every other element within the tolerance. Returns
    the max abs error over the two gradients."""
    torch.cuda.synchronize()
    require([t is None for t in got] == [w is None for w in want],
            f"{what}: gradients given {[t is not None for t in got]}")
    rtol, atol = tol
    worst = 0.0
    for t, w in zip(got, want):
        if w is None:
            continue
        require(t.dtype == w.dtype and t.shape == w.shape, f"{what}: {t.dtype} {t.shape}")
        nan = w.isnan()
        require(torch.equal(t.isnan(), nan), f"{what}: NaN where the plain vjp has none")
        d = (t[~nan].float() - w[~nan].float()).abs()
        scale = w[~nan].float().abs().max().item() if bool((~nan).any()) else 0.0
        require(bool((d <= atol * max(scale, 1.0) + rtol * w[~nan].float().abs()).all()),
                f"{what}: max abs {d.max().item()}")
        worst = max(worst, d.max().item() if d.numel() else 0.0)
    return worst


def backward_bound_ms(img, flow, need_img, need_flow) -> float:
    """Least milliseconds for one backward: the image, the flow and the
    incoming gradient read once, the asked-for gradients written once
    (each in its dtype), over the HBM rate; its flops (about 40 a pixel
    and 30 a pixel and channel) are far below the float32 rate."""
    esize = img.element_size()
    nbytes = (2 + int(need_img)) * img.numel() * esize + \
        (1 + int(need_flow)) * flow.numel() * flow.element_size()
    pixels = flow.numel() // 2
    flops = pixels * (40 + 30 * img.numel() // pixels)
    require(flops / F32_FLOPS < nbytes / HBM_BYTES_PER_S, "backward bound by operations")
    return nbytes / HBM_BYTES_PER_S * 1e3


def grad_drifts(torch, got: dict, want: dict) -> dict:
    """Relative L2 distances of the gradients ``got`` from ``want``: the
    whole set's ("whole") and each top-level submodule's that ``want``
    reaches (a name's first part)."""
    def rel(names):
        num = sum(float(torch.sum((got[n].double() - want[n].double()) ** 2)) for n in names)
        return (num / sum(float(torch.sum(want[n].double() ** 2)) for n in names)) ** 0.5

    out = {"whole": rel(list(want))}
    for part in sorted({n.split(".")[0] for n in want}):
        names = [n for n in want if n.split(".")[0] == part]
        if any(float(want[n].abs().max()) > 0 for n in names):
            out[part] = rel(names)
    return out


def bf16_misses(card: dict, cpu: dict, cross: dict | None = None,
                gap32: dict | None = None) -> dict:
    """The bars of the bf16 card phase the card's drifts ``card`` miss
    against the CPU's ``cpu`` (grad_drifts of each bf16 step from its
    float32 step): {part: (card, bar)}. With ``cross`` (grad_drifts of the
    card's bf16 step from the CPU's) and ``gap32`` (of the card's float32
    step from the CPU's), also each part's distance from the CPU's bf16
    gradient within (1 + BF16_DRIFT) times the CPU's drift plus the float32
    gap (the triangle through the two float32 steps), keyed "... vs cpu"."""
    misses = {}
    for part, d in card.items():
        bar = (BF16_DRIFT * cpu[part] if part == "whole"
               else max(BF16_SUB_DRIFT * cpu[part], BF16_SUB_FLOOR))
        if d > bar:
            misses[part] = (d, bar)
        if cross is not None and part in cross and part in gap32:
            bar = (1 + BF16_DRIFT) * cpu[part] + gap32[part]
            if cross[part] > bar:
                misses[f"{part} vs cpu"] = (cross[part], bar)
    return misses


@contextlib.contextmanager
def capture_warp_inputs(captured: dict):
    """Record a clone of the inputs of every warp the models call, by kernel
    name (the attributes the LSVC, SSF, DVC, Base and RLVC paths look the
    dispatchers up by)."""
    from fastvideocodec_torch.layers import spynet
    from fastvideocodec_torch.models import dvc, lsvc, rlvc
    from fastvideocodec_torch.ops import warp

    sites = [(spynet, "flow_warp", "flow_warp"),
             (dvc, "flow_warp", "flow_warp"),
             (rlvc, "flow_warp", "flow_warp"),
             (lsvc, "flow_warp", "flow_warp"),
             (lsvc, "flow_warp_fullres_s2d", "flow_warp_s2d"),
             (warp, "pixel_warp", "pixel_warp"),
             (warp, "pixel_warp_s2d_sflow", "pixel_warp_s2d_sflow")]

    def grab(name, fn):
        def wrapped(img, flow):
            captured.setdefault(name, []).append((img.clone(), flow.clone()))
            return fn(img, flow)
        return wrapped

    saved = [getattr(module, attr) for module, attr, _ in sites]
    for (module, attr, name), fn in zip(sites, saved):
        setattr(module, attr, grab(name, fn))
    try:
        yield
    finally:
        for (module, attr, _), fn in zip(sites, saved):
            setattr(module, attr, fn)


def host_cpu() -> str:
    """The host CPU's model name (from /proc/cpuinfo, else lscpu), its
    architecture and core count: host-bound times follow it."""
    lines = []
    with contextlib.suppress(OSError):
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    with contextlib.suppress(OSError, subprocess.SubprocessError):
        lines += subprocess.run(["lscpu"], capture_output=True, text=True,
                                timeout=10).stdout.splitlines()
    models = [ln.split(":", 1)[1].strip() for ln in lines
              if ln.lower().startswith("model name")]
    model = models[0] if models else "unknown"
    return f"{model} ({platform.machine()}), {os.cpu_count()} logical cores"


def warp_inputs(torch, gen, img_shape, flow_shape, dtype, flow_dtype=None):
    """Image in [0, 1) and a flow mixing small motion with displacements
    far past 56 px and samples far outside the frame; the flow in
    ``flow_dtype`` (default: the image's)."""
    img = torch.rand(img_shape, generator=gen, device="cuda")
    flow = torch.randn(flow_shape, generator=gen, device="cuda") * 8.0
    flow += (torch.rand(flow_shape, generator=gen, device="cuda") - 0.5) * 400.0
    return img.to(dtype).contiguous(), flow.to(flow_dtype or dtype).contiguous()


def smooth_flow(torch, gen, shape):
    """A shift of up to 10 px plus a slow wave of 3 px: every tile's
    footprint fits its budget."""
    B, _, h, w = shape
    yy = torch.arange(h, device="cuda", dtype=torch.float32)[:, None]
    xx = torch.arange(w, device="cuda", dtype=torch.float32)[None, :]
    shift = (torch.rand(B, 2, 1, 1, generator=gen, device="cuda") - 0.5) * 20.0
    phase = torch.rand(B, 2, 1, 1, generator=gen, device="cuda") * 6.2832
    return shift + 3.0 * torch.sin(xx / 17.0 + phase) * torch.cos(yy / 13.0)


def random_flow(torch, gen, shape):
    return (torch.rand(shape, generator=gen, device="cuda") - 0.5) * 400.0


def mixed_flow(torch, gen, shape):
    """Smooth on the top half of the frame, +-200 px random on the bottom."""
    flow = smooth_flow(torch, gen, shape)
    h = shape[2]
    flow[:, :, h // 2:] = random_flow(torch, gen, flow[:, :, h // 2:].shape)
    return flow


def phase_form(torch, flow):
    """A full-res flow [B, 2, H, W] in c-major s2d phase form [B, 8, H/2, W/2]
    (channel comp*4 + 2*ry + rx)."""
    from fastvideocodec_torch.ops.warp import space_to_depth

    return torch.cat([space_to_depth(flow[:, :1]), space_to_depth(flow[:, 1:])], dim=1)


def flow_like(torch, gen, make, flow):
    """A flow made by ``make`` (smooth_flow, random_flow, mixed_flow) with
    the shape, layout and dtype of ``flow``: a c-major phase flow [B, 8, h,
    w] is made at full resolution [B, 2, 2h, 2w] and folded into phase
    form, so that it is smooth in the image's pixels."""
    B, ch, h, w = flow.shape
    if ch == 8:
        out = phase_form(torch, make(torch, gen, (B, 2, 2 * h, 2 * w)))
    else:
        out = make(torch, gen, tuple(flow.shape))
    return out.to(flow.dtype).contiguous()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch.nn.functional as F

    from fastvideocodec_torch import build_lsvc_decode, get_codec_model, load_asset, rollout
    from fastvideocodec_torch.data.synthetic import synth_gop_multi
    from fastvideocodec_torch.ops.kernels import build
    from fastvideocodec_torch.ops.kernels import warp as kw
    from fastvideocodec_torch.ops import warp as ow
    from fastvideocodec_torch.tools import launch_cost
    from fastvideocodec_torch.ops.warp import (
        _full_res_flow,
        _linspace,
        grid_norm,
        plain_flow_warp,
        plain_flow_warp_s2d,
        plain_pixel_warp,
        plain_pixel_warp_s2d,
        plain_pixel_warp_s2d_sflow,
        space_to_depth,
        staged_tiles,
    )
    from fastvideocodec_torch import weights
    from fastvideocodec_torch.weights import load_flat

    # one codec's seeded weights at a time, kept while consecutive phases
    # build it again (drawing ELFVC-SP-TPU's takes seconds)
    seeded_flat = functools.lru_cache(maxsize=1)(weights.seeded_flat)

    def sample_grid(flow):
        """The normalized sampling grid of a flow, in the flow's dtype."""
        _, _, h, w = flow.shape
        xs = _linspace(w, flow.device)[None, None, :] + flow[:, 0].float() * grid_norm(w)
        ys = _linspace(h, flow.device)[None, :, None] + flow[:, 1].float() * grid_norm(h)
        return torch.stack([xs, ys], dim=-1).to(flow.dtype)

    def grid_sample(img, grid):
        return F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                             align_corners=False)

    def pixel_grid(flow):
        """The normalized sampling grid of a pixel flow: (2*(i + f) + 1)/n - 1."""
        _, _, h, w = flow.shape
        xs = torch.arange(w, device=flow.device, dtype=torch.float32) + flow[:, 0]
        ys = torch.arange(h, device=flow.device, dtype=torch.float32)[:, None] + flow[:, 1]
        return torch.stack([(2 * xs + 1) / w - 1, (2 * ys + 1) / h - 1], dim=-1)

    kernels = {
        "flow_warp": kw.launch_flow_warp,
        "flow_warp_s2d": kw.launch_flow_warp_s2d,
        "pixel_warp": kw.launch_pixel_warp,
        "pixel_warp_s2d": kw.launch_pixel_warp_s2d,
        "pixel_warp_s2d_sflow": kw.launch_pixel_warp_s2d_sflow,
    }
    plains = {
        "flow_warp": plain_flow_warp,
        "flow_warp_s2d": plain_flow_warp_s2d,
        "pixel_warp": plain_pixel_warp,
        "pixel_warp_s2d": plain_pixel_warp_s2d,
        "pixel_warp_s2d_sflow": plain_pixel_warp_s2d_sflow,
    }
    dispatchers = {
        "flow_warp": ow.flow_warp,
        "flow_warp_s2d": ow.flow_warp_fullres_s2d,
        "pixel_warp": ow.pixel_warp,
        "pixel_warp_s2d": ow.pixel_warp_s2d,
        "pixel_warp_s2d_sflow": ow.pixel_warp_s2d_sflow,
    }
    # the backward kernels of flow_warp and flow_warp_s2d, by launch-count
    # name, and their plain versions (the plain forward's vjp)
    backward_kernels = {b: getattr(kw, f"launch_{b}") for b in BACKWARD}
    backward_plains = {b: ow.PLAIN_BACKWARD[f] for b, f in BACKWARD.items()}
    require(set(kernels) == set(REPLACES) - set(BACKWARD) == set(dispatchers)
            and set(kw.LAUNCHES) == set(REPLACES)
            and set(ow.PLAIN_BACKWARD) == set(BACKWARD.values()), "kernel tables disagree")
    max_err = {k: 0.0 for k in REPLACES}
    zero_counts = {k: 0 for k in kw.LAUNCHES}

    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()[0]
        card_name = torch.cuda.get_device_name(0)
        log(f"card: {smi}")
        log(f"host: {host_cpu()}")
        log(f"torch {torch.__version__} cuda {torch.version.cuda} device {card_name} "
            f"count {torch.cuda.device_count()}")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    with phase("build"):
        build.load()
        log(f"nvcc seconds: {build.last_build_seconds} (None: library already built) "
            f"library {build.library_path().relative_to(ROOT)}")
        for entry, report in ptxas_report(build.build_log(), "warp"):
            log(f"ptxas {entry}: {report}")

    def spynet_inputs(gen, dtype):
        return [warp_inputs(torch, gen, (15, 3, h, w), (15, 2, h, w), dtype)
                for h, w in SPYNET_SHAPES]

    def s2d_inputs(gen, n, dtype):
        return warp_inputs(torch, gen, (n, 12, H // 2, W // 2), (n, 2, H, W), dtype)

    def ssf_inputs(gen, dtype):
        """The SSF-TPU path's shapes, float32 flows: the half-res blurred
        stack (5 levels x 3 colours), the level-0 sample with its c-major
        phase flow, and that sample with a full-res flow."""
        f32 = torch.float32
        return [
            ("pixel_warp", *warp_inputs(torch, gen, (1, 15, H // 2, W // 2),
                                        (1, 2, H // 2, W // 2), dtype, f32)),
            ("pixel_warp_s2d_sflow", *warp_inputs(torch, gen, (1, 12, H // 2, W // 2),
                                                  (1, 8, H // 2, W // 2), dtype, f32)),
            ("pixel_warp_s2d", *warp_inputs(torch, gen, (1, 12, H // 2, W // 2),
                                            (1, 2, H, W), dtype, f32)),
        ]

    def hold_exact(name, img, flow, what, launch=None) -> int:
        """The kernel (``launch``, default its launcher) against its plain
        version: NaN at the same outputs, bit for bit equal at all others;
        returns the NaN count."""
        got = (launch or kernels[name])(img, flow)
        want = plains[name](img, flow)
        torch.cuda.synchronize()
        nan = want.isnan()
        require(torch.equal(got.isnan(), nan), f"{what}: NaN where the plain version has none")
        err = (got[~nan].float() - want[~nan].float()).abs().max().item()
        require(err == 0.0, f"{what}: max abs {err}")
        max_err[name] = max(max_err[name], err)
        return int(nan.sum())

    with phase("kernels vs plain"):
        gen = torch.Generator(device="cuda").manual_seed(0)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            cases = [("flow_warp", *io) for io in spynet_inputs(gen, dtype)]
            cases.append(("flow_warp_s2d", *s2d_inputs(gen, 8, dtype)))
            cases += ssf_inputs(gen, dtype)
            for name, img, flow in cases:
                what = (f"{name} {dname} img {tuple(img.shape)} flow {tuple(flow.shape)} "
                        f"{str(flow.dtype).split('.')[1]}")
                hold_exact(name, img, flow, what)
                log(f"{what}: max abs 0 (tolerance 0)")

    # full-res [B, C, H, W]: rows odd, even but off a multiple of 8, and on
    # it; tiles ragged at the bottom and right; the last holds whole tiles;
    # pixel_warp with 15 and 7 channels (its chunks and a remainder)
    s2d_ragged = [(2, 3, 38, 150), (1, 3, 40, 264), (3, 3, 18, 36), (1, 3, 64, 512)]
    ragged = {"flow_warp": [(2, 3, 37, 141), (1, 3, 40, 268), (3, 3, 18, 34), (1, 3, 64, 512)],
              "pixel_warp": [(2, 15, 37, 141), (1, 7, 40, 268), (3, 3, 18, 34),
                             (1, 15, 64, 512), C18_RAGGED],
              **{name: s2d_ragged for name in S2D_KERNELS}}
    flows = {"smooth": smooth_flow, "random": random_flow, "mixed": mixed_flow}

    def tiled_case(gen, name, shape, make, dtype, nan_at=()):
        """(img, flow) of kernel ``name`` at full-res [B, C, H, W]: the image
        in s2d form for the s2d kernels, the flow float32 for the pixel
        kernels and in phase form for the sflow; NaN flows at the full-res
        pixels ``nan_at``."""
        img = torch.rand(shape, generator=gen, device="cuda")
        if name in S2D_KERNELS:
            img = space_to_depth(img)
        flow = make(torch, gen, (shape[0], 2, *shape[2:]))
        for y, x in nan_at:
            flow[:, :, y, x] = float("nan")
        if name == "pixel_warp_s2d_sflow":
            flow = phase_form(torch, flow)
        flow_dtype = torch.float32 if name in SSF_KERNELS else dtype
        return img.to(dtype).contiguous(), flow.to(flow_dtype).contiguous()

    with phase("tiled kernels: ragged shapes, smooth, random, mixed and NaN flows"):
        gen = torch.Generator(device="cuda").manual_seed(2)
        for name in kernels:
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).split(".")[1]
                for pattern, make in flows.items():
                    for shape in ragged[name]:
                        img, flow = tiled_case(gen, name, shape, make, dtype)
                        hold_exact(name, img, flow, f"{name} {dname} {pattern} {shape}")
                        if name != "flow_warp_s2d":  # the one kernel that stages
                            continue
                        staged, tiles = staged_tiles(img, flow)
                        if pattern == "smooth":
                            require(staged == tiles, f"{name} {pattern} {shape}: {staged}/{tiles}")
                        if shape == ragged[name][-1]:
                            want_share = {"smooth": 1.0, "random": 0.0, "mixed": 0.5}[pattern]
                            require(staged == want_share * tiles,
                                    f"{name} {pattern} {shape}: {staged}/{tiles} staged")
                    share = (f"; staged tiles of the last {staged}/{tiles}"
                             if name == "flow_warp_s2d" else "")
                    log(f"{name} {dname} {pattern} flows on {len(ragged[name])} shapes: "
                        f"max abs 0 (tolerance 0){share}")
                # two NaN flow pixels: NaN in each channel of their outputs,
                # as in the plain version; flow_warp_s2d still stages the
                # first tile (its footprint reaching index 0) but not the other
                img, flow = tiled_case(gen, name, (1, 3, 64, 512), smooth_flow, dtype,
                                       nan_at=((5, 7), (37, 300)))
                nans = hold_exact(name, img, flow, f"{name} {dname} NaN flow")
                require(nans == 2 * 3, f"{name} {dname}: {nans} NaN outputs, want 6")
                share = ""
                if name == "flow_warp_s2d":
                    staged, tiles = staged_tiles(img, flow)
                    require((staged, tiles) == (7, 8), f"{name} NaN flow: {staged}/{tiles} staged")
                    share = f"; staged tiles {staged}/{tiles}"
                log(f"{name} {dname} NaN flow at 2 pixels: NaN at the plain version's "
                    f"{nans} outputs, max abs 0 elsewhere{share}")
                if name == "pixel_warp":  # MCVC's 18 channels on 4 views
                    img, flow = tiled_case(gen, name, C18_RAGGED, smooth_flow, dtype,
                                           nan_at=((5, 7), (30, 100)))
                    nans = hold_exact(name, img, flow, f"{name} {dname} NaN flow {C18_RAGGED}")
                    want = C18_RAGGED[0] * 2 * C18_RAGGED[1]
                    require(nans == want, f"{name} {dname} C18: {nans} NaN outputs, want {want}")
                    log(f"{name} {dname} NaN flow at 2 pixels of each of 4 views {C18_RAGGED}: "
                        f"NaN at the plain version's {nans} outputs, max abs 0 elsewhere")

    # flow_warp's one kernel and each plan of pixel_warp, forced at any shape
    plan_launchers = {"flow_warp": {"pair": kernels["flow_warp"]},
                      "pixel_warp": {plan: functools.partial(kw._pixel_warp, plan=plan)
                                     for plan in PLANS}}
    with phase("flow_warp and both plans of pixel_warp: ragged shapes, small frames, smooth, "
               "random, mixed and NaN flows, unaligned pointers"):
        gen = torch.Generator(device="cuda").manual_seed(7)
        for name in NCHW_KERNELS:
            shapes = ragged[name] + SMALL_FRAMES
            if name == "pixel_warp":
                log(f"{name} plans by the rule: " + ", ".join(
                    f"{shape} {kw.pixel_warp_plan(*shape)}" for shape in shapes))
            for plan, launch in plan_launchers[name].items():
                for dtype in (torch.float32, torch.bfloat16):
                    dname = str(dtype).split(".")[1]
                    for pattern, make in flows.items():
                        for shape in shapes:
                            img, flow = tiled_case(gen, name, shape, make, dtype)
                            hold_exact(name, img, flow, f"{name} {plan} {dname} {pattern} {shape}",
                                       launch)
                    nans = 0
                    for shape in SMALL_FRAMES + [C18_RAGGED]:
                        B, C, h, w = shape
                        img, flow = tiled_case(gen, name, shape, smooth_flow, dtype)
                        flow[0, :, 0, 0] = flow[B - 1, :, h - 1, w - 1] = float("nan")
                        n = hold_exact(name, img, flow, f"{name} {plan} {dname} NaN {shape}",
                                       launch)
                        require(n == 2 * C, f"{name} {plan} {dname} NaN {shape}: {n} NaN outputs")
                        nans += n
                    # an image or a flow one element past a pair's alignment
                    for shape in ((1, 3, 128, 256), (4, 18, 64, 64), (1, 3, 16, 32)):
                        img, flow = tiled_case(gen, name, shape, random_flow, dtype)
                        for which, t in (("img", img), ("flow", flow)):
                            moved = torch.empty(t.numel() + 1, dtype=t.dtype,
                                                device="cuda")[1:].view(t.shape)
                            moved.copy_(t)
                            require(moved.data_ptr() % (2 * t.element_size()) != 0, "aligned")
                            args = (moved, flow) if which == "img" else (img, moved)
                            got = launch(*args)
                            require(torch.equal(got, plains[name](img, flow)),
                                    f"{name} {plan} {dname} unaligned {which} {shape}")
                    log(f"{name} {plan} {dname}: smooth, random and mixed flows on "
                        f"{len(shapes)} shapes max abs 0 (tolerance 0); NaN flows NaN at the "
                        f"plain version's {nans} outputs, max abs 0 elsewhere; unaligned image "
                        f"and flow equal")

    grad_cases = [("flow_warp", (2, 3, 12, 20), (2, 2, 12, 20)),
                  ("flow_warp_s2d", (2, 12, 6, 10), (2, 2, 12, 20)),
                  ("pixel_warp", (2, 5, 12, 20), (2, 2, 12, 20)),
                  ("pixel_warp", C18_RAGGED, (C18_RAGGED[0], 2, *C18_RAGGED[2:])),
                  ("pixel_warp_s2d", (2, 12, 6, 10), (2, 2, 12, 20)),
                  ("pixel_warp_s2d_sflow", (2, 12, 6, 10), (2, 8, 6, 10))]
    # The image gradient is a scatter-add whose rounding follows the order of
    # its atomics: deterministic algorithms where PyTorch has them, and in
    # bf16 flows of a few pixels, so that no source pixel sums the hundreds
    # of samples that +-150 px flows pile onto the border (each sum a few
    # bf16 roundings, far inside the bar)
    torch.use_deterministic_algorithms(True, warn_only=True)
    with phase("gradients through the kernels"):
        gen = torch.Generator(device="cuda").manual_seed(3)
        for name, img_shape, flow_shape in grad_cases:
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).split(".")[1]
                spread = 300.0 if dtype == torch.float32 else 16.0
                img = torch.rand(img_shape, generator=gen, device="cuda").to(dtype)
                flow = (torch.randn(flow_shape, generator=gen, device="cuda") * 3.0
                        + (torch.rand(flow_shape, generator=gen, device="cuda") - 0.5) * spread)
                flow = flow.to(torch.float32 if name.startswith("pixel") else dtype)
                g = torch.randn(img_shape, generator=gen, device="cuda").to(dtype)
                res = {}
                for how, fn in (("kernel", dispatchers[name]), ("plain", plains[name])):
                    kw.reset_launches()
                    i = img.detach().requires_grad_()
                    f = flow.detach().requires_grad_()
                    (fn(i, f).float() * g.float()).sum().backward()
                    res[how] = (i.grad, f.grad, dict(kw.LAUNCHES))
                torch.cuda.synchronize()
                (gi, gf, n), (pi, pf, _) = res["kernel"], res["plain"]
                # the forward's kernel once, and for flow_warp and
                # flow_warp_s2d their backward kernel once
                want_n = {**zero_counts, name: 1}
                if name in ow.PLAIN_BACKWARD:
                    want_n[f"{name}_backward"] = 1
                require(n == want_n, f"{name}: launches {n}, want {want_n}")
                rtol, atol = GRAD_TOL[dname]
                errs = []
                for got, want in ((gi, pi), (gf, pf)):
                    require(got is not None and got.dtype == want.dtype, f"{name}: no gradient")
                    d = (got.float() - want.float()).abs()
                    scale = want.float().abs().max().item()
                    errs.append(d.max().item() / max(scale, 1e-30))
                    require(bool((d <= atol * max(scale, 1.0) + rtol * want.float().abs()).all()),
                            f"{name} {dname} gradient off: max abs {d.max().item()}")
                log(f"{name} {dname} {img_shape} gradients of image and flow vs plain: max "
                    f"abs / max "
                    f"|grad| {errs[0]:.2e} and {errs[1]:.2e} (rtol {rtol:.0e}, atol "
                    f"{atol:.0e} x max |grad|); launches {n}")
    torch.use_deterministic_algorithms(False)

    def hold_backward(bname, img, flow, g, need_img, what, dname="float32", need_flow=True):
        """A backward kernel against its plain version (the plain forward's
        vjp) on the card, at GRAD_TOL: NaN where the plain vjp has NaN; a
        gradient None when not asked for. A bfloat16 kernel sums in
        float32 and rounds once: it is held to the plain vjp of the same
        inputs widened to float32 (exactly), rounded to bfloat16 (the flow
        gradient to the flow's dtype: float32 for the pixel warps), since
        the bfloat16 plain vjp scatter-adds bfloat16 terms (random +-200 px
        flows pile hundreds onto a border pixel). Returns the max abs error
        over the two gradients."""
        got = backward_kernels[bname](img, flow, g, need_img, need_flow)
        worst = hold_gradients(torch, got, plain_vjp_like(
            backward_plains[bname], img, flow, g, need_img, need_flow), GRAD_TOL[dname], what)
        if dname == "float32":
            max_err[bname] = max(max_err[bname], worst)
        return worst

    with phase("backward kernels vs the plain vjp: ragged shapes, smooth, random, mixed and "
               "NaN flows, image and flow gradient each on and off"):
        log(f"tolerance GRAD_TOL {GRAD_TOL} (rtol, atol x max(max |grad|, 1)): the image "
            f"gradient is a scatter-add of float32 atomics whose order changes from run to "
            f"run, so it is not bit-reproducible; a bfloat16 kernel is held to the float32 "
            f"plain vjp of its inputs rounded to bfloat16 (the bfloat16 plain vjp "
            f"scatter-adds bfloat16 terms)")
        gen = torch.Generator(device="cuda").manual_seed(5)
        for bname, name in BACKWARD.items():
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).split(".")[1]
                for pattern, make in flows.items():
                    for need_img, need_flow in ((True, True), (False, True), (True, False)):
                        worst = 0.0
                        for shape in ragged[name]:
                            img, flow = tiled_case(gen, name, shape, make, dtype)
                            g = torch.randn(img.shape, generator=gen, device="cuda").to(dtype)
                            kw.reset_launches()
                            worst = max(worst, hold_backward(
                                bname, img, flow, g, need_img,
                                f"{bname} {dname} {pattern} {shape} image grad {need_img} "
                                f"flow grad {need_flow}", dname, need_flow))
                            require(kw.LAUNCHES[bname] == 1, f"{bname}: {kw.LAUNCHES}")
                        log(f"{bname} {dname} {pattern} flows on {len(ragged[name])} shapes "
                            f"{ragged[name]}, image gradient {'on' if need_img else 'off'}, "
                            f"flow gradient {'on' if need_flow else 'off'}: max abs {worst:.3e} "
                            f"(GRAD_TOL {GRAD_TOL[dname]})")
                img, flow = tiled_case(gen, name, (1, 3, 64, 512), smooth_flow, dtype,
                                       nan_at=((5, 7), (37, 300)))
                g = torch.randn(img.shape, generator=gen, device="cuda").to(dtype)
                worst = hold_backward(bname, img, flow, g, True, f"{bname} {dname} NaN flow",
                                      dname)
                log(f"{bname} {dname} NaN flow at 2 pixels: NaN where the plain vjp has NaN, "
                    f"max abs {worst:.3e} elsewhere")

    with phase("card vs cpu port"):
        clip = synth_gop_multi(np.random.default_rng(0), size=128, gop=4)[:, :64, :128]
        small = torch.from_numpy(np.ascontiguousarray(clip)).permute(0, 3, 1, 2).contiguous()
        res = {}
        for device in ("cuda", "cpu"):
            spec = get_codec_model("LSVC-TPU", device=device)
            load_asset(spec.module, "hd_lsvctpuf2_l2")
            com, m = rollout(spec, small.to(device))
            res[device] = (com.float().cpu(), float(m["bpp"]), m["psnr"].float().cpu())
        (cg, bg, pg), (cc, bc, pc) = res["cuda"], res["cpu"]
        dmax = (cg - cc).abs().max().item()
        dmean = (cg - cc).abs().mean().item()
        dpsnr = (pg - pc).abs().max().item()
        dbpp = abs(bg - bc) / bc
        log(f"card vs cpu: recon max abs {dmax:.3e} mean abs {dmean:.3e} (tolerance mean "
            f"1e-4); psnr card {pg.tolist()} cpu {pc.tolist()} max diff {dpsnr:.2e} dB "
            f"(tolerance 0.01); bpp card {bg:.6f} cpu {bc:.6f} rel {dbpp:.2e} (tolerance 1e-3)")
        require(dmean <= 1e-4 and dpsnr <= 0.01 and dbpp <= 1e-3, "card disagrees with cpu")
        # the bf16 path on the same input, held to the f32 result: bf16 rounding
        # moved PSNR by 0.010 dB and bpp by 5e-4 relative on an H100
        spec = get_codec_model("LSVC-TPU", dtype=torch.bfloat16, device="cuda")
        load_asset(spec.module, "hd_lsvctpuf2_l2")
        _, m = rollout(spec, small.to("cuda", torch.bfloat16))
        pb, bb = m["psnr"].float().cpu(), float(m["bpp"])
        dpsnr, dbpp = (pb - pc).abs().max().item(), abs(bb - bc) / bc
        log(f"bf16 card vs f32 cpu: psnr {pb.tolist()} max diff {dpsnr:.3f} dB (tolerance "
            f"0.05); bpp {bb:.6f} rel {dbpp:.2e} (tolerance 0.005)")
        require(dpsnr <= 0.05 and dbpp <= 0.005, "bf16 path far from f32")

    spec = get_codec_model("LSVC-TPU", dtype=torch.bfloat16, device="cuda")
    load_asset(spec.module, "hd_lsvctpuf2_l2")
    # the whole 2048x2048 clip stays on the host for MCVC's row-offset views
    full_clip = synth_gop_multi(np.random.default_rng(0), size=max(H, W), gop=GOP)
    gop = torch.from_numpy(np.ascontiguousarray(full_clip[:, :H, :W])).permute(0, 3, 1, 2)
    gop = gop.to("cuda", torch.bfloat16).contiguous()

    def timed_runs(fn, *args, runs: int = 3):
        return _timed_runs(torch, fn, *args, runs=runs)

    with phase("rollout 1024x2048 GOP16 bf16"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kw.reset_launches()
        com, m = rollout(spec, gop)
        torch.cuda.synchronize()
        rollout_launches = dict(kw.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"launches in one GOP: {rollout_launches}")
        require(rollout_launches == {**zero_counts, "flow_warp": 4, "flow_warp_s2d": 4},
                f"rollout launch counts {rollout_launches}, want 4 and 4")
        psnr = m["psnr"].float().cpu()
        bpp = float(m["bpp"])
        require(tuple(com.shape) == (GOP - 1, 3, H, W), f"recon shape {tuple(com.shape)}")
        require(bool(torch.isfinite(com).all()), "recon not finite")
        require(bool(torch.isfinite(psnr).all()) and float(psnr.min()) > 20.0,
                f"psnr {psnr.tolist()}")
        require(np.isfinite(bpp) and bpp > 0.0, f"bpp {bpp}")
        del com, m
        times, enqueue = timed_runs(rollout, spec, gop)
        require(dict(kw.LAUNCHES) == {**zero_counts, "flow_warp": 16, "flow_warp_s2d": 16},
                f"counts after 4 GOPs {kw.LAUNCHES}")
        ms = sum(times) / len(times)
        log(f"rollout: ms/GOP {times} mean {ms:.3f}; host enqueue ms/GOP "
            f"{[round(t, 3) for t in enqueue]}; fps {1000.0 * (GOP - 1) / ms:.3f}; "
            f"bpp {bpp:.6f}; psnr mean {float(psnr.mean()):.4f} per frame "
            f"{[round(v, 4) for v in psnr.tolist()]}; peak memory {peak:.3f} GiB")

    with phase("decode graph 1024x2048 GOP16 bf16"):
        decode, (mv_q, z_qs, feat_qs) = build_lsvc_decode(spec.module, GOP, H, W)
        iframe_s2d = space_to_depth(gop[0:1], 2)[0].contiguous()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kw.reset_launches()
        mean, sigma, out = decode(iframe_s2d, mv_q, z_qs, feat_qs)
        torch.cuda.synchronize()
        decode_launches = dict(kw.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"launches in one GOP: {decode_launches}")
        require(decode_launches == {**zero_counts, "flow_warp_s2d": 4},
                f"decode launch counts {decode_launches}, want s2d warp 4")
        require(tuple(out.shape) == (GOP - 1, 3, H, W) and bool(torch.isfinite(out).all()),
                "decode output not finite or misshapen")
        require(np.isfinite(float(mean)) and np.isfinite(float(sigma)), "decode scalars")
        del out
        times, enqueue = timed_runs(decode, iframe_s2d, mv_q, z_qs, feat_qs)
        ms = sum(times) / len(times)
        log(f"decode: ms/GOP {times} mean {ms:.3f}; host enqueue ms/GOP "
            f"{[round(t, 3) for t in enqueue]}; fps {1000.0 * (GOP - 1) / ms:.3f}; "
            f"recon mean {float(mean):.6f} sigma sum {float(sigma):.6f}; "
            f"peak memory {peak:.3f} GiB")

    def time_kernels(names, captured, rows, lib, library_call=None):
        """Sum over one GOP's captured launches of each kernel's time, its
        plain version's, its bound and its time on smooth and on random
        flows of the same shapes; ``library_call(name, img, flow)`` gives
        the library time where one PyTorch call computes the same function."""
        gen = torch.Generator(device="cuda").manual_seed(1)
        sgen = torch.Generator(device="cuda").manual_seed(4)
        flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
        for name in names:
            r = rows[name] = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "random_ms": 0.0,
                              "smooth_ms": 0.0, "cold_ms": 0.0, "launches": [],
                              "staged": [0, 0], "smooth_staged": [0, 0]}
            lib[name] = None
            for img, flow in captured[name]:
                sflow = flow_like(torch, sgen, smooth_flow, flow)
                for f in (flow, sflow):
                    hold_exact(name, img, f, f"{name} on main-path inputs")
                    for plan in PLANS if name == "pixel_warp" else ():
                        hold_exact(name, img, f, f"{name} {plan} on main-path inputs",
                                   plan_launchers[name][plan])
                if name == "flow_warp_s2d":
                    for key, f in (("staged", flow), ("smooth_staged", sflow)):
                        r[key] = [a + b for a, b in zip(r[key], staged_tiles(img, f))]
                warm = cuda_ms(torch, kernels[name], img, flow)
                cold = cold_ms(torch, kernels[name], img, flow, flush=flush)
                r["ms"] += warm
                r["cold_ms"] += cold
                plan = kw.pixel_warp_plan(*img.shape) if name == "pixel_warp" else "one plan"
                r["launches"].append(f"{tuple(img.shape)} {plan}: {warm:.4f} / {cold:.4f}")
                r["plain_ms"] += cuda_ms(torch, plains[name], img, flow, iters=5)
                r["bound_ms"] += bound_ms(img, flow)
                r["smooth_ms"] += cuda_ms(torch, kernels[name], img, sflow)
                rimg, rflow = warp_inputs(torch, gen, img.shape, flow.shape, img.dtype,
                                          flow.dtype)
                hold_exact(name, rimg, rflow, f"{name} on random flows of main-path shapes")
                r["random_ms"] += cuda_ms(torch, kernels[name], rimg, rflow)
                t = library_call(name, img, flow) if library_call else None
                if t is not None:
                    lib[name] = (lib[name] or 0.0) + t
            staged = ""
            if name == "flow_warp_s2d":
                (sp, tp), (ss, ts) = r["staged"], r["smooth_staged"]
                staged = (f"; tiles staged on the path {sp}/{tp} ({sp / tp:.4f}), on the "
                          f"smooth flows {ss}/{ts} ({ss / ts:.4f})")
            log(f"{name}: kernel {r['ms']:.4f} ms/GOP over {len(captured[name])} launches "
                f"(L2 flushed before each launch: {r['cold_ms']:.4f}; on smooth flows: "
                f"{r['smooth_ms']:.4f}; on uniform random flows of +-200 px: "
                f"{r['random_ms']:.4f}), plain {r['plain_ms']:.4f}, bound "
                f"{r['bound_ms']:.4f} (bytes), library {lib[name]}{staged}")
            log(f"{name} per launch, img shape and plan: warm / L2-flushed ms: {r['launches']}")

    rows, lib = {}, {}
    with phase("kernel timing (bf16, one GOP's launches)"):
        # the kernels' inputs from one more rollout of the clip: the main
        # path's shapes and its real (smooth) flows
        captured = {}
        with capture_warp_inputs(captured):
            rollout(spec, gop)
        require([len(captured.get(k, [])) for k in LSVC_KERNELS] == [4, 4],
                f"captured {[len(v) for v in captured.values()]} launches")

        def lsvc_library(name, img, flow):
            if name == "flow_warp":
                return cuda_ms(torch, grid_sample, img, sample_grid(flow))
            return None

        time_kernels(LSVC_KERNELS, captured, rows, lib, lsvc_library)
        del captured, spec

    def chain_card_vs_cpu(label, name, asset, bf16_psnr_db, bf16_bpp_rel, norms=(),
                          size=(64, 128)):
        """A tiny chain codec (shipped weights, or ``seeded_flat(name, 0)``
        for asset "seeded") in float32 at ``size``, GOP 4, on the card
        against the CPU port; then in bfloat16 on the card against that
        float32 result. ``norms``: metrics held card vs CPU to 1e-3
        relative too."""
        h, w = size
        clip = synth_gop_multi(np.random.default_rng(0), size=max(h, w), gop=4)[:, :h, :w]
        small = torch.from_numpy(np.ascontiguousarray(clip)).permute(0, 3, 1, 2).contiguous()
        res = {}
        for device, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                              ("cuda", torch.bfloat16)):
            spec = get_codec_model(name, dtype=dtype, device=device, sp_stage=ELFVC_SP_STAGE)
            if asset == "seeded":
                load_flat(spec.module, seeded_flat(name, 0))
            else:
                load_asset(spec.module, asset)
            com, m = rollout(spec, small.to(device, dtype))
            res[device, dtype] = (com.float().cpu(), m["psnr"].float().cpu(),
                                  float(m["bpp_est"].sum()),
                                  {k: m[k].float().cpu() for k in norms})
        (cg, pg, bg, ng), (cc, pc, bc, nc) = res["cuda", torch.float32], res["cpu", torch.float32]
        dmax = (cg - cc).abs().max().item()
        dmean = (cg - cc).abs().mean().item()
        dpsnr = (pg - pc).abs().max().item()
        dbpp = abs(bg - bc) / bc
        dnorm = {k: ((ng[k] - nc[k]).abs() / nc[k]).max().item() for k in norms}
        log(f"{label} card vs cpu: recon max abs {dmax:.3e} mean abs {dmean:.3e} (tolerance "
            f"mean 1e-4); psnr card {pg.tolist()} cpu {pc.tolist()} max diff {dpsnr:.2e} dB "
            f"(tolerance 0.01); bpp card {bg:.6f} cpu {bc:.6f} rel {dbpp:.2e} (tolerance 1e-3)"
            + "".join(f"; {k} card {ng[k].tolist()} cpu {nc[k].tolist()} max rel "
                      f"{dnorm[k]:.2e} (tolerance 1e-3)" for k in norms))
        require(dmean <= 1e-4 and dpsnr <= 0.01 and dbpp <= 1e-3
                and all(d <= 1e-3 for d in dnorm.values()), f"{label} card disagrees with cpu")
        # the bf16 path on the same input, held to the f32 result
        _, pb, bb, _ = res["cuda", torch.bfloat16]
        dpsnr, dbpp = (pb - pc).abs().max().item(), abs(bb - bc) / bc
        log(f"{label} bf16 card vs f32 cpu: psnr {pb.tolist()} max diff {dpsnr:.4f} dB "
            f"(tolerance {bf16_psnr_db}); bpp {bb:.6f} rel {dbpp:.3e} (tolerance "
            f"{bf16_bpp_rel})")
        require(dpsnr <= bf16_psnr_db and dbpp <= bf16_bpp_rel, f"{label} bf16 far from f32")

    with phase("ssf card vs cpu port"):
        chain_card_vs_cpu("ssf", "SSF-TPU-TINY", "tiny_ssftpu_l2", SSF_BF16_PSNR_DB,
                          SSF_BF16_BPP_REL)

    sspec = get_codec_model("SSF-TPU", dtype=torch.bfloat16, device="cuda")
    t0 = time.perf_counter()
    load_flat(sspec.module, seeded_flat("SSF-TPU", 0))
    log(f"SSF-TPU seeded weights: {sum(p.numel() for p in sspec.module.parameters())} "
        f"parameters in {time.perf_counter() - t0:.3f} s")

    with phase("ssf rollout 1024x2048 GOP16 bf16"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kw.reset_launches()
        com, m = rollout(sspec, gop)
        torch.cuda.synchronize()
        ssf_launches = dict(kw.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"launches in one GOP: {ssf_launches}")
        want = {**zero_counts, "pixel_warp": GOP - 1, "pixel_warp_s2d_sflow": GOP - 1}
        require(ssf_launches == want, f"ssf launch counts {ssf_launches}, want {want}")
        psnr = m["psnr"].float().cpu()
        bpp = m["bpp_est"].float().cpu()
        require(tuple(com.shape) == (GOP - 1, 3, H, W), f"recon shape {tuple(com.shape)}")
        require(bool(torch.isfinite(com).all()), "ssf recon not finite")
        require(bool(torch.isfinite(psnr).all() and torch.isfinite(bpp).all())
                and float(bpp.min()) > 0.0, f"ssf psnr {psnr.tolist()} bpp {bpp.tolist()}")
        del com, m
        times, enqueue = timed_runs(rollout, sspec, gop)
        ms = sum(times) / len(times)
        log(f"ssf rollout: ms/GOP {times} mean {ms:.3f}; host enqueue ms/GOP "
            f"{[round(t, 3) for t in enqueue]}; fps {1000.0 * (GOP - 1) / ms:.3f}; "
            f"bpp (random weights, not gated) mean {float(bpp.mean()):.6f}; psnr mean "
            f"{float(psnr.mean()):.4f}; peak memory {peak:.3f} GiB")

    with phase("ssf kernel timing (bf16, one GOP's launches)"):
        captured = {}
        with capture_warp_inputs(captured):
            rollout(sspec, gop)
        require([len(captured.get(k, [])) for k in ("pixel_warp", "pixel_warp_s2d_sflow")]
                == [GOP - 1, GOP - 1], f"captured {[len(v) for v in captured.values()]}")
        # no codec calls pixel_warp_s2d: time it on the level-0 sample's
        # inputs, its phase flow unpacked to full resolution
        captured["pixel_warp_s2d"] = [(img, _full_res_flow(flow).contiguous())
                                      for img, flow in captured["pixel_warp_s2d_sflow"]]

        def ssf_library(name, img, flow):
            if name == "pixel_warp":
                return cuda_ms(torch, grid_sample, img, pixel_grid(flow).to(img.dtype))
            return None

        time_kernels(SSF_KERNELS, captured, rows, lib, ssf_library)
        del captured

    from fastvideocodec_torch import coder
    from fastvideocodec_torch.coder import service
    from fastvideocodec_torch.gop.engine import estimated_bits
    from fastvideocodec_torch.tools.real_bits_fps import code_gop, codecs_of

    with phase("coder"):
        coder.get_lib()
        log(f"g++ seconds: {coder.last_build_seconds} (None: library already built) "
            f"library {coder.library_path().relative_to(ROOT)}")
        lspec = get_codec_model("LSVC-TPU", dtype=torch.bfloat16, device="cuda")
        load_asset(lspec.module, "hd_lsvctpuf2_l2")
        t0 = time.perf_counter()
        lsvc_codecs, ssf_codecs = codecs_of(lspec), codecs_of(sspec)
        log(f"tables of the LSVC-TPU and SSF-TPU codecs: {time.perf_counter() - t0:.3f} s")
        rng = np.random.default_rng(0)
        mv_codec, _, feat_codec = lsvc_codecs
        n = 200_000
        cases = {  # symbols past the support on both sides, and in it
            "BitEstimator (mv)": (mv_codec, (1, 1, n // 128, 128), None),
            "Laplace (features)": (feat_codec, (1, 1, n // 96, 96), (0.1, 300.0)),
            "factorized (img z)": (ssf_codecs[0].z_codec, (1, 1, n // 192, 192), None),
            "Gaussian (img y)": (ssf_codecs[0].y_codec, (1, 1, n // 192, 192), (0.1, 300.0)),
        }
        for what, (codec, shape, scale_range) in cases.items():
            sym = np.round(rng.laplace(0.0, 3.0, shape)).astype(np.float32)
            sym.flat[rng.choice(sym.size, 64, replace=False)] = rng.choice([-1, 1], 64) * 1000
            if scale_range is None:
                want = sym
                if isinstance(codec, service.FactorizedCodec):  # codes round(x - median)
                    sym = sym + codec.medians
                    want = np.round(sym - codec.medians) + codec.medians
                data = codec.compress(sym)
                got = codec.decompress(data, shape)
            else:
                scales = np.exp(rng.uniform(*np.log(scale_range), shape)).astype(np.float16)
                want = sym
                data = codec.compress(sym, scales)
                got = codec.decompress(data, scales)
            require(np.array_equal(got, want), f"{what}: round trip differs")
            log(f"{what}: {sym.size} symbols (64 of them at +-1000, past the support of "
                f"most tables, both signs) in {len(data)} bytes, decoded equal")
        # the video path buckets scales on the card, compress/decompress on
        # the host: the same indexes, also at the table's entries and next
        # to them, for the sigmas' f16, the SSF scales' bf16 and float32
        table = feat_codec.cond.table
        scales = np.concatenate([np.exp(rng.uniform(-4.0, 7.0, 1_000_000)), table,
                                 np.nextafter(table, 0), np.nextafter(table, np.inf),
                                 [0.0, -1.0, np.nan, np.inf]])
        for dt in (torch.float16, torch.bfloat16, torch.float32):
            t = torch.from_numpy(scales).to(dt)
            for what, codec in (("Laplace", feat_codec), ("Gaussian", ssf_codecs[0].y_codec)):
                on_card = codec.bucket(t.cuda()).cpu()
                require(torch.equal(on_card, codec.bucket(t)),
                        f"{what} {dt}: bucketing on the card differs from the host's")
        log(f"bucketing of {scales.size} scales on the card equals the host's "
            f"(f16, bf16, f32; Laplace and Gaussian codecs)")

    def real_bits(spec, codecs, want_enc, want_dec, est_bpp, key, clip=None, mask=None,
                  runs=3):
        """A warm-up GOP, then ``runs``: launch counts, times, bpp, identity;
        of the rollouts' clip unless ``clip`` (MCVC's views, with their
        ``mask``) is given."""
        clip = gop if clip is None else clip
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r = code_gop(spec, clip, codecs, mask)
        require(r["identical"], "warm-up: decode != encode recon")
        timed = runs
        runs = []
        for i in range(timed):
            r = code_gop(spec, clip, codecs, mask)
            runs.append(r)
            require(r["identical"], f"run {i}: decode != encode recon")
            require(r["enc_launches"] == {**zero_counts, **want_enc},
                    f"run {i}: encode launches {r['enc_launches']}, want {want_enc}")
            require(r["dec_launches"] == {**zero_counts, **want_dec},
                    f"run {i}: decode launches {r['dec_launches']}, want {want_dec}")
            log(f"run {i}: encode {r['enc_s'] * 1e3:.3f} ms/GOP (AC {r['enc_ac_s']:.4f} s), "
                f"decode {r['dec_s'] * 1e3:.3f} ms/GOP (AC {r['dec_ac_s']:.4f} s); real bpp "
                f"{r['bpp']:.6f}{key(r)}, estimated {est_bpp:.6f}; decode == encode bit for "
                f"bit; launches encode {r['enc_launches']} decode {r['dec_launches']}")
        recon = r["recon"]
        require(bool(torch.isfinite(recon).all()), "real-bits recon not finite")
        views = clip.shape[1] if clip.dim() == 5 else 1
        frames, what = (GOP - 1, "P-frames") if views == 1 else (GOP * views, "view-frames")
        log(f"real bits: encode ms/GOP {[round(x['enc_s'] * 1e3, 3) for x in runs]}, decode "
            f"ms/GOP {[round(x['dec_s'] * 1e3, 3) for x in runs]}, encode+decode fps of the "
            f"{what} {[round(frames / (x['enc_s'] + x['dec_s']), 3) for x in runs]}; peak "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        return runs

    with phase("lsvc real bits 1024x2048 GOP16 bf16"):
        _, m = rollout(lspec, gop)
        est, psnr_est = float(m["bpp"]), float(m["psnr"].float().mean())
        runs = real_bits(lspec, lsvc_codecs, {"flow_warp": 4, "flow_warp_s2d": 4},
                         {"flow_warp_s2d": 4}, est, lambda r: "")
        recon = runs[-1]["recon"]
        require(tuple(recon.shape) == (GOP - 1, 3, H, W), f"recon shape {tuple(recon.shape)}")
        mse = torch.mean((recon.float() - gop[1:].float()) ** 2, dim=(1, 2, 3))
        psnr = float((10 * torch.log10(1 / mse)).mean())
        rel = abs(runs[-1]["bpp"] - est) / est
        log(f"lsvc real bits: bpp {runs[-1]['bpp']:.6f} vs the rollout's estimate {est:.6f} "
            f"(rel {rel:.4f}, tolerance 0.05); psnr mean {psnr:.4f} vs the rollout's "
            f"{psnr_est:.4f} (tolerance 0.1 dB)")
        require(rel < 0.05 and abs(psnr - psnr_est) < 0.1, "real bits far from the rollout")
        del runs, recon, lspec, lsvc_codecs

    with phase("ssf real bits 1024x2048 GOP16 bf16"):
        # the model's estimate over the same GOP, keyframe coded as the
        # coder codes it (the rollout predicts from the uncoded frame 0)
        with torch.inference_mode():
            _, liks = sspec.module(gop[:, None])
        est = estimated_bits(liks) / (GOP * H * W)
        del liks
        want = {"pixel_warp": GOP - 1, "pixel_warp_s2d_sflow": GOP - 1}
        runs = real_bits(sspec, ssf_codecs, want, want, est,
                         lambda r: f" over {GOP} frames, {r['bpp_inter']:.6f} over the P-frames")
        recon = runs[-1]["recon"]
        require(tuple(recon.shape) == (GOP, 1, 3, H, W), f"recon shape {tuple(recon.shape)}")
        rel = abs(runs[-1]["bpp"] - est) / est
        log(f"ssf real bits (seeded weights): bpp {runs[-1]['bpp']:.6f} vs the model's "
            f"estimate {est:.6f} over the same {GOP} frames (rel {rel:.4f}, tolerance 0.05)")
        require(rel < 0.05, "ssf real bits far from the model's estimate")
        del runs, recon, sspec, ssf_codecs

    from fastvideocodec_torch.layers.blocks import plain_attention

    with phase("elfvc card vs cpu port"):
        chain_card_vs_cpu("elfvc", "ELFVC-SP-TPU-TINY", "tiny_elfvctpu_l3", ELFVC_BF16_PSNR_DB,
                          ELFVC_BF16_BPP_REL, norms=("pred_err_norm",))
        # the trained model codes every P-frame symbol as 0 on that clip; the
        # seeded one at 128x256 feeds its SPnets nonzero symbols
        chain_card_vs_cpu("elfvc seeded", "ELFVC-SP-TPU-TINY", "seeded",
                          ELFVC_SEEDED_BF16_PSNR_DB, ELFVC_SEEDED_BF16_BPP_REL,
                          norms=("pred_err_norm",), size=(128, 256))

    espec = get_codec_model("ELFVC-SP-TPU", dtype=torch.bfloat16, device="cuda",
                            sp_stage=ELFVC_SP_STAGE)
    t0 = time.perf_counter()
    load_flat(espec.module, seeded_flat("ELFVC-SP-TPU", 0))
    log(f"ELFVC-SP-TPU seeded weights: {sum(p.numel() for p in espec.module.parameters())} "
        f"parameters in {time.perf_counter() - t0:.3f} s (sp_stage {ELFVC_SP_STAGE})")
    elfvc_want = {**zero_counts, "pixel_warp": 2 * (GOP - 1),
                  "pixel_warp_s2d_sflow": 2 * (GOP - 1)}

    with phase("elfvc rollout 1024x2048 GOP16 bf16"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kw.reset_launches()
        com, m = rollout(espec, gop)
        torch.cuda.synchronize()
        elfvc_launches = dict(kw.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"launches in one GOP: {elfvc_launches}")
        require(elfvc_launches == elfvc_want,
                f"elfvc launch counts {elfvc_launches}, want {elfvc_want}")
        psnr = m["psnr"].float().cpu()
        bpp = m["bpp_est"].float().cpu()
        pred_err = m["pred_err_norm"].float().cpu()
        require(tuple(com.shape) == (GOP - 1, 3, H, W), f"recon shape {tuple(com.shape)}")
        require(bool(torch.isfinite(com).all()), "elfvc recon not finite")
        require(all(bool(torch.isfinite(v).all()) for v in (psnr, bpp, pred_err))
                and float(bpp.min()) > 0.0, f"elfvc psnr {psnr.tolist()} bpp {bpp.tolist()}")
        del com, m
        times, enqueue = timed_runs(rollout, espec, gop)
        ms = sum(times) / len(times)
        log(f"elfvc rollout: ms/GOP {times} mean {ms:.3f}; host enqueue ms/GOP "
            f"{[round(t, 3) for t in enqueue]}; fps {1000.0 * (GOP - 1) / ms:.3f}; "
            f"bpp (random weights, not gated) mean {float(bpp.mean()):.6f}; psnr mean "
            f"{float(psnr.mean()):.4f}; pred_err_norm mean {float(pred_err.mean()):.4f}; "
            f"peak memory {peak:.3f} GiB")
        # the SPnet's attention at full width: [1, heads 4, 64 * 128 tokens, d 32]
        gen = torch.Generator(device="cuda").manual_seed(5)
        q, k, v = (torch.randn((1, 4, (H // 16) * (W // 16), 32), generator=gen,
                               device="cuda").to(torch.bfloat16) for _ in range(3))
        fused = F.scaled_dot_product_attention(q, k, v)
        plain = plain_attention(q, k, v)
        diff = (fused.float() - plain.float()).abs().max().item()
        fused_ms = cuda_ms(torch, F.scaled_dot_product_attention, q, k, v)
        plain_ms = cuda_ms(torch, plain_attention, q, k, v, iters=5)
        log(f"attention {tuple(q.shape)} bf16: fused SDPA {fused_ms:.4f} ms, plain (scores "
            f"materialised) {plain_ms:.4f} ms; max abs diff {diff:.3e}; "
            f"{2 * (GOP - 1)} calls per GOP")
        del q, k, v, fused, plain

    with phase("elfvc real bits 1024x2048 GOP16 bf16"):
        # the model's estimate over the same GOP, keyframe coded as the
        # coder codes it
        with torch.inference_mode():
            _, liks = espec.module(gop[:, None])
        est = estimated_bits(liks) / (GOP * H * W)
        del liks
        elfvc_codecs = codecs_of(espec)
        half = {"pixel_warp": GOP - 1, "pixel_warp_s2d_sflow": GOP - 1}
        runs = real_bits(espec, elfvc_codecs, {k: 2 * n for k, n in half.items()}, half, est,
                         lambda r: f" over {GOP} frames, {r['bpp_inter']:.6f} over the P-frames")
        recon = runs[-1]["recon"]
        require(tuple(recon.shape) == (GOP, 1, 3, H, W), f"recon shape {tuple(recon.shape)}")
        rel = abs(runs[-1]["bpp"] - est) / est
        log(f"elfvc real bits (seeded weights, sp_stage {ELFVC_SP_STAGE}): bpp "
            f"{runs[-1]['bpp']:.6f} vs the model's estimate {est:.6f} over the same {GOP} "
            f"frames (rel {rel:.4f}, tolerance 0.05)")
        require(rel < 0.05, "elfvc real bits far from the model's estimate")
        elfvc_enc, elfvc_dec = runs[-1]["enc_launches"], runs[-1]["dec_launches"]
        del runs, recon

    del espec, elfvc_codecs

    # -- MCVC-IA: the multi-camera codec over the views folded into the batch
    from fastvideocodec_torch.data.synthetic import row_views, synth_mv_gop
    from fastvideocodec_torch.layers import blocks

    @contextlib.contextmanager
    def attention_backends(seen: dict):
        """Record the fused attention's backend for every attention call on
        the card, by q's shape [b, heads, tokens, d] and dtype: PyTorch's
        own choice for those inputs."""
        shipped = blocks.attention

        def recording(q, k, v):
            key = f"{tuple(q.shape)} {str(q.dtype).split('.')[1]}"
            if q.is_cuda and key not in seen:
                try:
                    from torch.nn.attention import SDPBackend
                    names = {int(b.value): name for name, b in SDPBackend.__members__.items()}
                    seen[key] = names.get(int(torch._fused_sdp_choice(q, k, v)), "unknown")
                except (AttributeError, ImportError, RuntimeError, TypeError) as e:
                    seen[key] = f"not measured ({type(e).__name__})"
            return shipped(q, k, v)

        blocks.attention = recording
        try:
            yield
        finally:
            blocks.attention = shipped

    def mv_frames(frames):
        """numpy [T, V, h, w, 3] -> [T, V, 3, h, w] float32 on the host."""
        return torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 1, 4, 2, 3)))

    def mcvc_card_vs_cpu(label, name, asset, size, masks, bf16=True):
        """MCVC on 3 views of synth_mv_gop (seed 0) at ``size``, GOP 4 in
        float32, card against the CPU port for each mask; then, with
        ``bf16``, bfloat16 on the card against that float32 result."""
        h, w = size
        frames = mv_frames(synth_mv_gop(np.random.default_rng(0), views=3, size=max(h, w),
                                        gop=4)[:, :, :h, :w])
        runs = [("cuda", torch.float32), ("cpu", torch.float32)]
        runs += [("cuda", torch.bfloat16)] if bf16 else []
        for mask in masks:
            res, seen = {}, {}
            mk = np.asarray(mask, np.float32)
            for device, dtype in runs:
                spec = get_codec_model(name, dtype=dtype, device=device, num_views=3)
                if asset == "seeded":
                    load_flat(spec.module, seeded_flat(name, 0))
                else:
                    load_asset(spec.module, asset)
                kw.reset_launches()
                with attention_backends(seen):
                    com, m = rollout(spec, frames.to(device, dtype), mk)
                want = {**zero_counts, "pixel_warp": 3 if device == "cuda" else 0}
                require(dict(kw.LAUNCHES) == want, f"{label} {device}: launches {kw.LAUNCHES}")
                res[device, dtype] = (com.float().cpu(), m["psnr"].float().cpu(),
                                      float(m["bpp_est"].sum()))
            (cg, pg, bg), (cc, pc, bc) = res["cuda", torch.float32], res["cpu", torch.float32]
            dmax = (cg - cc).abs().max().item()
            dmean = (cg - cc).abs().mean().item()
            dpsnr = (pg - pc).abs().max().item()
            dbpp = abs(bg - bc) / bc
            log(f"{label} mask {list(mask)} card vs cpu: recon max abs {dmax:.3e} mean abs "
                f"{dmean:.3e} (tolerance mean 1e-4); psnr over the alive views card "
                f"{pg.tolist()} cpu {pc.tolist()} max diff {dpsnr:.2e} dB (tolerance 0.01); bpp "
                f"card {bg:.6f} cpu {bc:.6f} rel {dbpp:.2e} (tolerance 1e-3); launches on the "
                f"card 3 pixel_warp (one a P-frame); attention backend on the card {seen}")
            require(dmean <= 1e-4 and dpsnr <= 0.01 and dbpp <= 1e-3,
                    f"{label} card disagrees with cpu")
            if bf16:
                _, pb, bb = res["cuda", torch.bfloat16]
                dpsnr, dbpp = (pb - pc).abs().max().item(), abs(bb - bc) / bc
                log(f"{label} mask {list(mask)} bf16 card vs f32 cpu: psnr {pb.tolist()} max "
                    f"diff {dpsnr:.4f} dB (tolerance {MCVC_BF16_PSNR_DB}); bpp {bb:.6f} rel "
                    f"{dbpp:.3e} (tolerance {MCVC_BF16_BPP_REL})")
                require(dpsnr <= MCVC_BF16_PSNR_DB and dbpp <= MCVC_BF16_BPP_REL,
                        f"{label} bf16 far from f32")

    with phase("mcvc card vs cpu port"):
        mcvc_card_vs_cpu("mcvc-ia tiny", "MCVC-IA-TINY", "tiny_mcvc_l3", (64, 64),
                         ((1, 1, 1), (1, 1, 0)))
        mcvc_card_vs_cpu("mcvc-ia seeded", "MCVC-IA", "seeded", (64, 128), ((1, 1, 0),),
                         bf16=False)

    mcvc_flat = seeded_flat("MCVC-IA", 0)

    def mcvc_model(views):
        spec = get_codec_model("MCVC-IA", dtype=torch.bfloat16, device="cuda", num_views=views)
        load_flat(spec.module, mcvc_flat)
        return spec

    mspec = mcvc_model(MCVC_VIEWS)
    log(f"MCVC-IA seeded weights: {sum(p.numel() for p in mspec.module.parameters())} "
        f"parameters")
    mcvc_want = {**zero_counts, "pixel_warp": GOP - 1}
    failed = np.ones(MCVC_VIEWS, np.float32)
    failed[MCVC_FAILED] = 0.0
    alive = np.ones(MCVC_VIEWS, np.float32)
    mcvc_rows = {}  # setup: the rollout's numbers, for the report

    def mcvc_rollout(label, spec, frames, mask):
        """One run with the launch counts zeroed (exactly GOP - 1 pixel_warp,
        no other warp), then 3 timed runs beside their host enqueue ms."""
        _, V, _, h, w = frames.shape
        seen = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kw.reset_launches()
        with attention_backends(seen):
            com, m = rollout(spec, frames, mask)
        torch.cuda.synchronize()
        launches = dict(kw.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        require(launches == mcvc_want, f"{label}: launches {launches}, want {mcvc_want}")
        psnr, bpp = m["psnr"].float().cpu(), m["bpp_est"].float().cpu()
        completeness = float(m["completeness"])
        require(tuple(com.shape) == (GOP, V, 3, h, w), f"{label}: recon {tuple(com.shape)}")
        require(bool(torch.isfinite(com).all()), f"{label}: recon not finite")
        require(bool(torch.isfinite(psnr).all() and torch.isfinite(bpp).all())
                and float(bpp.min()) > 0.0, f"{label}: psnr {psnr.tolist()} bpp {bpp.tolist()}")
        require(abs(completeness - float(mask.mean())) < 1e-6, f"{label}: {completeness}")
        del com, m
        times, enqueue = timed_runs(rollout, spec, frames, mask)
        ms = sum(times) / len(times)
        row = {"views": V, "h": h, "w": w, "mask": mask.tolist(), "ms_per_gop": times,
               "ms": ms, "enqueue_ms": enqueue, "ms_per_view_frame": ms / (GOP * V),
               "fps": 1000.0 * GOP * V / ms, "bpp": float(bpp.mean()),
               "psnr": float(psnr.mean()), "completeness": completeness, "peak_gib": peak,
               "launches": launches["pixel_warp"], "attention": seen}
        log(f"mcvc rollout {label}: ms/GOP {times} mean {ms:.3f}; ms per view-frame "
            f"{row['ms_per_view_frame']:.4f}; view-frames/s {row['fps']:.3f}; host enqueue "
            f"ms/GOP {[round(t, 3) for t in enqueue]}; bpp (random weights, not gated) "
            f"{row['bpp']:.6f}; psnr over the alive views {row['psnr']:.4f}; completeness "
            f"{completeness:.4f}; peak memory {peak:.3f} GiB; launches {launches}; attention "
            f"backend {seen}")
        mcvc_rows[label] = row
        return launches

    gen = torch.Generator(device="cuda").manual_seed(6)
    with phase(f"mcvc rollout {MCVC_VIEWS}x{MCVC_SIZE}x{MCVC_SIZE} GOP16 bf16"):
        mv_small = mv_frames(synth_mv_gop(np.random.default_rng(0), views=MCVC_VIEWS,
                                          size=MCVC_SIZE, gop=GOP))
        mv_small = mv_small.to("cuda", torch.bfloat16).contiguous()
        mcvc_rollout(f"{MCVC_VIEWS}x{MCVC_SIZE} alive", mspec, mv_small, alive)
        mcvc_rollout(f"{MCVC_VIEWS}x{MCVC_SIZE} view {MCVC_FAILED} failed", mspec, mv_small,
                     failed)

    with phase(f"mcvc views sweep 1..6 x{MCVC_SIZE} GOP16 bf16"):
        # the JAX speed task's inputs: uniform random frames, every view alive
        for views in range(1, 7):
            spec = mcvc_model(views)
            frames = torch.rand((GOP, views, 3, MCVC_SIZE, MCVC_SIZE), generator=gen,
                                device="cuda").to(torch.bfloat16)
            mcvc_rollout(f"{views} views x{MCVC_SIZE}", spec, frames,
                         np.ones(views, np.float32))
            del spec, frames
        log("views sweep: ms per view-frame " + ", ".join(
            f"{v}: {mcvc_rows[f'{v} views x{MCVC_SIZE}']['ms_per_view_frame']:.4f}"
            for v in range(1, 7)))

    with phase(f"mcvc rollout {MCVC_VIEWS}x{H}x{W} GOP16 bf16"):
        mv_big = row_views(full_clip[:, :, :W], MCVC_VIEWS, H)  # rows 0, 320, 640, 1024
        mv_big = mv_frames(mv_big).to("cuda", torch.bfloat16).contiguous()
        del full_clip
        mcvc_launches = mcvc_rollout(f"{MCVC_VIEWS}x{H}x{W} alive", mspec, mv_big, alive)

    mcvc_timing = {}
    with phase("mcvc kernel timing (bf16, one GOP's pixel_warp launches at C = 18)"):
        flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
        for label, frames in ((f"{MCVC_VIEWS}x{MCVC_SIZE}", mv_small),
                              (f"{MCVC_VIEWS}x{H}x{W}", mv_big)):
            captured = {}
            with capture_warp_inputs(captured):
                rollout(mspec, frames, alive)
            require(len(captured.get("pixel_warp", [])) == GOP - 1
                    and all(img.shape[1] == 18 for img, _ in captured["pixel_warp"]),
                    f"captured {[(k, len(v)) for k, v in captured.items()]}")
            mrows, mlib = {}, {}
            time_kernels(("pixel_warp",), captured, mrows, mlib, ssf_library)
            # the card's time under the profiler and the host's enqueue, of
            # the kernel and of F.grid_sample (the grid built beforehand)
            inputs = captured["pixel_warp"]
            grids = [(img, pixel_grid(flow).to(img.dtype)) for img, flow in inputs]
            dev, per_call = device_ms(torch, kernels["pixel_warp"], inputs)
            ldev, lper_call = device_ms(torch, grid_sample, grids)
            t = mcvc_timing[label] = {
                **mrows["pixel_warp"], "library_ms": mlib["pixel_warp"],
                "library_cold_ms": sum(cold_ms(torch, grid_sample, *g, flush=flush)
                                       for g in grids),
                "device_ms": dev, "library_device_ms": ldev,
                "host_ms": host_ms(torch, kernels["pixel_warp"], inputs),
                "library_host_ms": host_ms(torch, grid_sample, grids)}
            log(f"pixel_warp C = 18 at {label}: kernel {t['ms']:.4f} ms/GOP (L2 flushed "
                f"{t['cold_ms']:.4f}) against its byte bound {t['bound_ms']:.4f} "
                f"({t['bound_ms'] / t['cold_ms']:.3f} of it L2-flushed) and F.grid_sample "
                f"{t['library_ms']:.4f} (L2 flushed {t['library_cold_ms']:.4f}); device time "
                f"under the profiler kernel {dev} ({per_call} kernels a call) / F.grid_sample "
                f"{ldev} ({lper_call} a call); host enqueue kernel {t['host_ms']:.4f} / "
                f"F.grid_sample {t['library_host_ms']:.4f}")
            del captured, inputs, grids
        del mv_big, flush

    with phase(f"mcvc real bits {MCVC_VIEWS}x{MCVC_SIZE}x{MCVC_SIZE} GOP16 bf16"):
        # the model's estimate over the same GOP and mask, keyframe coded as
        # the coder codes it
        with torch.inference_mode():
            _, liks, _ = mspec.module(mv_small, torch.from_numpy(failed).cuda())
        est = estimated_bits(liks) / (GOP * MCVC_VIEWS * MCVC_SIZE * MCVC_SIZE)
        del liks
        mcvc_codecs = codecs_of(mspec)
        want = {"pixel_warp": GOP - 1}
        runs = real_bits(mspec, mcvc_codecs, want, want, est,
                         lambda r: f" over {GOP} frames of {MCVC_VIEWS} views, "
                                   f"{r['bpp_inter']:.6f} over the P-frames",
                         clip=mv_small, mask=failed)
        recon = runs[-1]["recon"]
        require(tuple(recon.shape) == (GOP, MCVC_VIEWS, 3, MCVC_SIZE, MCVC_SIZE),
                f"recon shape {tuple(recon.shape)}")
        rel = abs(runs[-1]["bpp"] - est) / est
        log(f"mcvc real bits (seeded weights, view {MCVC_FAILED} failed): bpp "
            f"{runs[-1]['bpp']:.6f} vs the model's estimate {est:.6f} over the same {GOP} "
            f"frames (rel {rel:.4f}, tolerance 0.05)")
        require(rel < 0.05, "mcvc real bits far from the model's estimate")
        mcvc_enc, mcvc_dec = runs[-1]["enc_launches"], runs[-1]["dec_launches"]
        del runs, recon
    log(json.dumps({"mcvc": {"rollouts": mcvc_rows, "pixel_warp_c18": {
        k: {key: v[key] for key in ("ms", "cold_ms", "plain_ms", "bound_ms", "smooth_ms",
                                    "random_ms", "library_ms", "library_cold_ms", "device_ms",
                                    "library_device_ms", "host_ms", "library_host_ms")}
        for k, v in mcvc_timing.items()}}}))

    # -- the stock (s2d=1) scale-space codecs: SSF-Official, ELFVC-SP and
    # MCVC-Original, full resolution through pixel_warp at C = 18
    from fastvideocodec_torch.coder.video import deterministic_convs

    with phase("stock ssf/elfvc card vs cpu port"):
        chain_card_vs_cpu("ssf stock", "SSF-TINY", "tiny_ssf_l2", STOCK_SSF_BF16_PSNR_DB,
                          STOCK_SSF_BF16_BPP_REL)
        chain_card_vs_cpu("elfvc stock", "ELFVC-SP-TINY", "tiny_elfvc_l3",
                          STOCK_ELFVC_BF16_PSNR_DB, ELFVC_BF16_BPP_REL, norms=("pred_err_norm",))

    stock_rows, stock_want = {}, {**zero_counts, "pixel_warp": GOP - 1}

    def stock_model(name):
        spec = get_codec_model(name, dtype=torch.bfloat16, device="cuda",
                               sp_stage=ELFVC_SP_STAGE)
        t0 = time.perf_counter()
        load_flat(spec.module, seeded_flat(name, 0))
        log(f"{name} seeded weights: {sum(p.numel() for p in spec.module.parameters())} "
            f"parameters in {time.perf_counter() - t0:.3f} s")
        return spec

    def stock_rollout(label, spec, frames, per_frame, kernel="pixel_warp", runs=3, rows=None):
        """One run with the launch counts zeroed (exactly ``per_frame``
        launches of ``kernel`` a P-frame, no other warp), then ``runs`` timed
        runs beside their host enqueue ms, into ``rows`` (stock_rows);
        frames [T, 3, H, W] or a batch of views."""
        rows = stock_rows if rows is None else rows
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kw.reset_launches()
        com, m = rollout(spec, frames)
        torch.cuda.synchronize()
        launches = dict(kw.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = {**zero_counts, kernel: per_frame * (GOP - 1)}
        require(launches == want, f"{label}: launches {launches}, want {want}")
        psnr, bpp = m["psnr"].float().cpu(), m["bpp_est"].float().cpu()
        require(tuple(com.shape) == (GOP - 1, *frames.shape[1:]),
                f"{label}: recon {tuple(com.shape)}")
        require(bool(torch.isfinite(com).all()), f"{label}: recon not finite")
        require(bool(torch.isfinite(psnr).all() and torch.isfinite(bpp).all())
                and float(bpp.min()) > 0.0, f"{label}: psnr {psnr.tolist()} bpp {bpp.tolist()}")
        extra = ""
        if "pred_err_norm" in m:
            pred_err = m["pred_err_norm"].float().cpu()
            require(bool(torch.isfinite(pred_err).all()), f"{label}: pred_err_norm")
            extra = f"; pred_err_norm mean {float(pred_err.mean()):.4f}"
        del com, m
        times, enqueue = timed_runs(rollout, spec, frames, runs=runs)
        ms = sum(times) / len(times)
        pixels = (GOP - 1) * frames[0].numel() // 3
        rows[label] = {"ms_per_gop": times, "ms": ms, "enqueue_ms": enqueue,
                       "peak_gib": peak, "launches": launches[kernel],
                       "bpp": float(bpp.mean()), "psnr": float(psnr.mean())}
        log(f"{label} rollout: ms/GOP {times} mean {ms:.3f}; host enqueue ms/GOP "
            f"{[round(t, 3) for t in enqueue]}; P-frame pixels/s {pixels / ms * 1e3:.4e}; bpp "
            f"(random weights, not gated) mean {float(bpp.mean()):.6f}; psnr mean "
            f"{float(psnr.mean()):.4f}{extra}; peak memory {peak:.3f} GiB; launches {launches}")
        return launches

    def stock_real_bits(label, spec, frames, per_frame_enc, per_frame_dec):
        """Real bits of ``frames`` (a warm-up GOP and 3), held within 5% of the
        model's estimate over the same GOP, keyframe coded as the coder codes
        it; returns the last run's encode and decode launches."""
        batch = frames if frames.dim() == 5 else frames[:, None]
        with torch.inference_mode():
            _, liks = spec.module(batch)
        est = estimated_bits(liks) / (GOP * batch[0].numel() // 3)
        del liks
        runs = real_bits(spec, codecs_of(spec), {"pixel_warp": per_frame_enc * (GOP - 1)},
                         {"pixel_warp": per_frame_dec * (GOP - 1)}, est,
                         lambda r: f" over {GOP} frames, {r['bpp_inter']:.6f} over the P-frames",
                         clip=frames)
        recon = runs[-1]["recon"]
        require(tuple(recon.shape) == tuple(batch.shape), f"{label}: recon {tuple(recon.shape)}")
        rel = abs(runs[-1]["bpp"] - est) / est
        log(f"{label} real bits (seeded weights): bpp {runs[-1]['bpp']:.6f} vs the model's "
            f"estimate {est:.6f} over the same {GOP} frames (rel {rel:.4f}, tolerance 0.05)")
        require(rel < 0.05, f"{label} real bits far from the model's estimate")
        stock_rows[label]["real_bits"] = {
            "enc_ms": [r["enc_s"] * 1e3 for r in runs], "dec_ms": [r["dec_s"] * 1e3 for r in runs],
            "bpp": runs[-1]["bpp"], "est_bpp": est}
        return runs[-1]["enc_launches"], runs[-1]["dec_launches"]

    stock_launches = {}
    ospec = stock_model("SSF-Official")
    with phase(f"ssf-official rollout {H}x{W} GOP16 bf16"):
        stock_launches["ssf_official_rollout"] = stock_rollout("ssf-official", ospec, gop, 1)

    stock_timing = {}
    with phase("ssf-official kernel timing (bf16, one GOP's pixel_warp launches at C = 18)"):
        captured = {}
        with capture_warp_inputs(captured):
            rollout(ospec, gop)
        require(len(captured.get("pixel_warp", [])) == GOP - 1
                and all(tuple(img.shape) == (1, 18, H, W) for img, _ in captured["pixel_warp"]),
                f"captured {[(k, len(v)) for k, v in captured.items()]}")
        orows, olib = {}, {}
        time_kernels(("pixel_warp",), captured, orows, olib, ssf_library)
        r = orows["pixel_warp"]
        stock_timing["ssf_official_rollout"] = {**r, "library_ms": olib["pixel_warp"],
                                                "launches": GOP - 1}
        log(f"pixel_warp C = 18 at 1 x {H}x{W} (SSF-Official): kernel {r['ms']:.4f} ms/GOP "
            f"(L2 flushed {r['cold_ms']:.4f}) against its byte bound {r['bound_ms']:.4f} "
            f"({r['bound_ms'] / r['ms']:.3f} of it), plain {r['plain_ms']:.4f} and "
            f"F.grid_sample {olib['pixel_warp']:.4f}")
        del captured

    with phase(f"ssf-official real bits {H}x{W} GOP16 bf16"):
        enc, dec = stock_real_bits("ssf-official", ospec, gop, 1, 1)
        stock_launches.update(ssf_official_real_bits_encode=enc, ssf_official_real_bits_decode=dec)
    del ospec

    xspec = stock_model("ELFVC-SP")
    with phase(f"elfvc-sp rollout {H}x{W} GOP16 bf16 (sp_stage {ELFVC_SP_STAGE})"):
        stock_launches["elfvc_sp_rollout"] = stock_rollout("elfvc-sp", xspec, gop, 2)
        # the full-resolution flow predictor alone, 9 -> 128 -> 128 -> 128 -> 3
        # 5x5 convs at 1024x2048: about 3.6 TFLOP a call, once a P-frame
        fp = xspec.module.flow_predictor
        ctx = torch.rand((1, 9, H, W), generator=gen, device="cuda").to(torch.bfloat16)
        flops = 2 * 25 * H * W * sum(c.in_channels * c.out_channels
                                     for c in (fp.Conv_0, fp.Conv_1, fp.Conv_2, fp.Conv_3))
        with torch.inference_mode():
            free_ms = cuda_ms(torch, fp, ctx, iters=5)
            with deterministic_convs():
                det_ms = cuda_ms(torch, fp, ctx, iters=5)
        stock_rows["elfvc-sp"]["flow_predictor"] = {"ms": free_ms, "deterministic_ms": det_ms,
                                                    "tflop": flops / 1e12}
        log(f"flow predictor (1, 9, {H}, {W}) bf16: {flops / 1e12:.3f} TFLOP a call; "
            f"{free_ms:.3f} ms ({flops / free_ms / 1e9:.1f} TFLOP/s), under "
            f"deterministic_convs (the real bits') {det_ms:.3f} ms "
            f"({flops / det_ms / 1e9:.1f} TFLOP/s); {GOP - 1} calls a GOP")
        del ctx

    with phase(f"elfvc-sp real bits {H}x{W} GOP16 bf16"):
        enc, dec = stock_real_bits("elfvc-sp", xspec, gop, 2, 1)
        stock_launches.update(elfvc_sp_real_bits_encode=enc, elfvc_sp_real_bits_decode=dec)
    del xspec

    gspec = stock_model("MCVC-Original")
    with phase(f"mcvc-original rollout {MCVC_VIEWS}x{MCVC_SIZE}x{MCVC_SIZE} GOP16 bf16"):
        # stock SSF with the views as the batch: the rollout predicts from
        # frame 0; the forward codes the keyframe, as MCVC's phase does
        label = f"mcvc-original {MCVC_VIEWS}x{MCVC_SIZE}"
        stock_launches["mcvc_original_rollout"] = stock_rollout(label, gspec, mv_small, 1)
        kw.reset_launches()
        with torch.inference_mode():
            times, enqueue = timed_runs(gspec.module, mv_small)
        require(dict(kw.LAUNCHES) == {**zero_counts, "pixel_warp": 3 * (GOP - 1)},
                f"{label} forward: launches {kw.LAUNCHES}")
        ms = sum(times) / len(times)
        stock_rows[label]["keyframe_coded_ms"] = times
        log(f"{label} forward, keyframe coded: ms/GOP {times} mean {ms:.3f}; ms per view-frame "
            f"{ms / (GOP * MCVC_VIEWS):.4f}; host enqueue ms/GOP {[round(t, 3) for t in enqueue]}")

    with phase(f"mcvc-original real bits {MCVC_VIEWS}x{MCVC_SIZE}x{MCVC_SIZE} GOP16 bf16"):
        enc, dec = stock_real_bits(label, gspec, mv_small, 1, 1)
        stock_launches.update(mcvc_original_real_bits_encode=enc,
                              mcvc_original_real_bits_decode=dec)
    del gspec, mv_small
    log(json.dumps({"stock": stock_rows}))

    # -- DVC, RLVC (RLVC2, RLVC-HP) and Base (-EC-ER): chains of P-frames on
    # the previous recon, through flow_warp: 4 SpyNet levels and the MC warp
    # of the full-resolution frame a P-frame, 75 a GOP
    from fastvideocodec_torch.layers.spynet import load_pretrained_spynet

    with phase("dvc/rlvc/base card vs cpu port"):
        for label, name, asset in (("dvc tiny", "DVC-TINY", "tiny_dvc_l2"),
                                   ("rlvc tiny", "RLVC-TINY", "tiny_rlvc_l2"),
                                   ("base-er tiny", "Base-ER-TINY", "tiny_base_l2")):
            chain_card_vs_cpu(label, name, asset, DVC_BF16_PSNR_DB, DVC_BF16_BPP_REL,
                              size=(64, 64))

    chain_rows, chain_launches, chain_timing = {}, {}, {}

    def chain_model(name):
        """Full widths on seeded_flat(name, 0), the pretrained SpyNet."""
        spec = get_codec_model(name, dtype=torch.bfloat16, device="cuda")
        t0 = time.perf_counter()
        load_flat(spec.module, seeded_flat(name, 0))
        load_pretrained_spynet(spec.module.optic_flow)
        log(f"{name} seeded weights, pretrained SpyNet: "
            f"{sum(p.numel() for p in spec.module.parameters())} parameters in "
            f"{time.perf_counter() - t0:.3f} s")
        return spec

    def chain_real_bits(label, spec, frames):
        """A warm-up GOP and one timed: launches 5 + 1 a P-frame, decode ==
        encode, real bpp within 5% of the rollout's estimate on the same
        frames."""
        _, m = rollout(spec, frames)
        est = float(m["bpp_est"].float().mean())
        del m
        five = {"flow_warp": 5 * (GOP - 1)}
        runs = real_bits(spec, codecs_of(spec), five, {"flow_warp": GOP - 1}, est,
                         lambda r: f" ({tuple(frames.shape[-2:])})", clip=frames, runs=1)
        rel = abs(runs[-1]["bpp"] - est) / est
        log(f"{label} real bits (seeded weights): bpp {runs[-1]['bpp']:.6f} vs the rollout's "
            f"estimate {est:.6f} over the same P-frames (rel {rel:.4f}, tolerance 0.05)")
        require(rel < 0.05, f"{label} real bits far from the rollout's estimate")
        chain_rows.setdefault(label, {})["real_bits"] = {
            "hw": list(frames.shape[-2:]), "enc_ms": [r["enc_s"] * 1e3 for r in runs],
            "dec_ms": [r["dec_s"] * 1e3 for r in runs], "enc_ac_s": runs[-1]["enc_ac_s"],
            "dec_ac_s": runs[-1]["dec_ac_s"], "bpp": runs[-1]["bpp"], "est_bpp": est}
        return runs[-1]["enc_launches"], runs[-1]["dec_launches"]

    small_gop = gop[:, :, :256, :512].contiguous()  # the small real-bits cell
    dspec = chain_model("DVC")
    with phase(f"dvc rollout {H}x{W} GOP16 bf16"):
        chain_launches["dvc_rollout"] = stock_rollout("dvc", dspec, gop, 5, "flow_warp",
                                                      rows=chain_rows)

    with phase("flow_warp on DVC's inputs (bf16, one GOP's 75 launches)"):
        captured = {}
        with capture_warp_inputs(captured):
            rollout(dspec, gop)
        warps = captured.get("flow_warp", [])
        require(len(warps) == 5 * (GOP - 1) and set(captured) == {"flow_warp"},
                f"captured {[(k, len(v)) for k, v in captured.items()]}")
        # each P-frame warps 4 SpyNet levels, coarsest first (the finest at
        # full resolution too), then the MC warp
        mc = warps[4::5]
        require(all(tuple(img.shape) == (1, 3, H, W) for img, _ in mc),
                f"MC warps {[tuple(img.shape) for img, _ in mc]}")
        # by shape: the 4 SpyNet levels (H/8 .. H), then the MC warp; each
        # group's device time under the profiler beside its time by CUDA
        # events and the host's enqueue time, against F.grid_sample's (the
        # grid built beforehand)
        groups = {f"dvc_rollout_spynet_{H >> (3 - k)}x{W >> (3 - k)}": warps[k::5]
                  for k in range(4)}
        groups["dvc_rollout_mc_warp"] = mc
        flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
        for what, inputs in groups.items():
            drows, dlib = {}, {}
            time_kernels(("flow_warp",), {"flow_warp": inputs}, drows, dlib, lsvc_library)
            grids = [(img, sample_grid(flow)) for img, flow in inputs]
            dev, per_call = device_ms(torch, kernels["flow_warp"], inputs)
            ldev, lper_call = device_ms(torch, grid_sample, grids)
            t = chain_timing[what] = {
                **drows["flow_warp"], "library_ms": dlib["flow_warp"], "launches": len(inputs),
                "library_cold_ms": sum(cold_ms(torch, grid_sample, *g, flush=flush)
                                       for g in grids),
                "device_ms": dev, "library_device_ms": ldev,
                "host_ms": host_ms(torch, kernels["flow_warp"], inputs),
                "library_host_ms": host_ms(torch, grid_sample, grids)}
            log(f"flow_warp {what}, {len(inputs)} launches of {tuple(inputs[0][0].shape)}: "
                f"by CUDA events kernel {t['ms']:.4f} / F.grid_sample {t['library_ms']:.4f} "
                f"ms/GOP, L2 flushed {t['cold_ms']:.4f} / {t['library_cold_ms']:.4f}; device "
                f"time under the profiler kernel {dev} ({per_call} kernels a call) / "
                f"F.grid_sample {ldev} ({lper_call} a call); host enqueue kernel "
                f"{t['host_ms']:.4f} / F.grid_sample {t['library_host_ms']:.4f}; bound "
                f"{t['bound_ms']:.4f}")
        sums = ("ms", "cold_ms", "plain_ms", "bound_ms", "smooth_ms", "random_ms",
                "library_ms", "library_cold_ms", "device_ms", "library_device_ms", "host_ms",
                "library_host_ms", "launches")
        r = chain_timing["dvc_rollout"] = {
            key: (None if any(t[key] is None for t in chain_timing.values())
                  else sum(t[key] for t in chain_timing.values())) for key in sums}
        q = chain_timing["dvc_rollout_mc_warp"]
        require(r["launches"] == 5 * (GOP - 1), f"timed {r['launches']} launches")
        log(f"flow_warp on DVC's 75 launches a GOP: kernel {r['ms']:.4f} ms/GOP (L2 flushed "
            f"{r['cold_ms']:.4f}; device {r['device_ms']}) against its byte bound "
            f"{r['bound_ms']:.4f}, plain {r['plain_ms']:.4f}, F.grid_sample "
            f"{r['library_ms']:.4f} (device {r['library_device_ms']}); of it the 15 MC "
            f"warps (1 x 3 x {H}x{W}) {q['ms']:.4f} (L2 flushed {q['cold_ms']:.4f}, bound "
            f"{q['bound_ms']:.4f}, F.grid_sample {q['library_ms']:.4f})")
        del captured, warps, mc, groups, inputs, grids, flush  # the captured frames
        # the launcher's host cost, piece by piece, beside F.grid_sample's call
        launch_host_us = launch_cost.pieces(torch)
        log("host us a call of one flow_warp launch at 1 x 3 x 128x256 bf16 "
            "(tools/launch_cost.py), piece by piece: " + "; ".join(
                f"{what} {us:.3f}" for what, us in launch_host_us.items()))

    with phase(f"dvc real bits {H}x{W} GOP16 bf16"):
        enc, dec = chain_real_bits("dvc", dspec, gop)
        chain_launches.update(dvc_real_bits_encode=enc, dvc_real_bits_decode=dec)
    del dspec

    rspec = chain_model("RLVC")
    with phase(f"rlvc rollout {H}x{W} GOP16 bf16"):
        chain_launches["rlvc_rollout"] = stock_rollout("rlvc", rspec, gop, 5, "flow_warp",
                                                       rows=chain_rows)
    with phase(f"rlvc real bits {H}x{W} GOP16 bf16"):
        enc, dec = chain_real_bits("rlvc", rspec, gop)
        chain_launches.update(rlvc_real_bits_encode=enc, rlvc_real_bits_decode=dec)
    del rspec

    for name, bits_too in (("RLVC-HP", True), ("RLVC2", False), ("Base-EC-ER", True)):
        label, path = name.lower(), name.lower().replace("-", "_")
        cspec = chain_model(name)
        with phase(f"{label} rollout {H}x{W} GOP16 bf16"):
            chain_launches[f"{path}_rollout"] = stock_rollout(label, cspec, gop, 5, "flow_warp",
                                                              runs=1, rows=chain_rows)
        if bits_too:  # RLVC2 has no real-bits path
            with phase(f"{label} real bits 256x512 GOP16 bf16"):
                enc, dec = chain_real_bits(label, cspec, small_gop)
                chain_launches.update({f"{path}_real_bits_encode": enc,
                                       f"{path}_real_bits_decode": dec})
        del cspec
    del small_gop
    log(json.dumps({"dvc_family": chain_rows, "flow_warp": {
        k: {key: v[key] for key in sums} for k, v in chain_timing.items()},
        "launch_host_us": launch_host_us}))

    # -- The rest of LSVC: the s2d=1 LSVC-128 (the stock SpyNet over all 15
    # P-frames in one batch, flow_warp at full resolution), the LSVC-TPU
    # warp ablations, the -A/-S attention, the -L/-O graphs, and JAX's HD
    # head-to-head on the card
    from fastvideocodec_torch.analysis import bd_psnr, bd_rate
    from fastvideocodec_torch.models.lsvc import LSVC
    from fastvideocodec_torch.models.registry import CodecSpec, place
    from fastvideocodec_torch.weights import seeded_params

    lsvc_rows, lsvc_launches = {}, {}
    lsvc_timing = {"flow_warp": {}, "flow_warp_s2d": {}}

    def lsvc_model(name, weights, dtype=torch.bfloat16, device="cuda"):
        """A registry LSVC form on its shipped checkpoint, or seeded_flat."""
        spec = get_codec_model(name, dtype=dtype, device=device)
        if weights == "seeded":
            load_flat(spec.module, seeded_flat(name, 0))
        else:
            load_asset(spec.module, weights)
        return spec

    def narrow_attention(dtype, device):
        """The tiny flagship with -A and -S at attn_depth 2, seeded."""
        module = LSVC(**TINY_TPU, use_attn=True, use_syn_attn=True, attn_depth=2, dtype=dtype)
        load_flat(module, seeded_params(module, 0))
        return CodecSpec("LSVC-TPU-TINY -A -S", "lsvc", place(module, dtype, device))

    def lsvc_warps(module, n_p):
        """(rollout and encode launches, decode launches) of an LSVC form
        over n_p P-frames: SpyNet's 4 levels (one batch of every P-frame) and
        one MC warp a graph layer, flow_warp for s2d=1 and the rigid -RW
        warp, flow_warp_s2d for the full-resolution warps of the s2d forms."""
        layers = len(module.schedule(n_p).layers)
        mc = "flow_warp_s2d" if module.s2d > 1 and module.full_res_warp else "flow_warp"
        enc = {"flow_warp": 4}
        enc[mc] = enc.get(mc, 0) + layers
        return enc, {mc: layers}

    def lsvc_card_vs_cpu(label, make, bf16=None):
        """An LSVC form (``make(dtype, device)``) in float32 at 64x128, GOP 4,
        on the card against the CPU port; with ``bf16`` (PSNR dB, bpp rel)
        bars, bfloat16 on the card against that float32 result."""
        clip = synth_gop_multi(np.random.default_rng(0), size=128, gop=4)[:, :64, :128]
        small = torch.from_numpy(np.ascontiguousarray(clip)).permute(0, 3, 1, 2).contiguous()
        runs = [("cuda", torch.float32), ("cpu", torch.float32)]
        runs += [("cuda", torch.bfloat16)] if bf16 else []
        res, seen = {}, {}
        for device, dtype in runs:
            spec = make(dtype, device)
            with attention_backends(seen):
                com, m = rollout(spec, small.to(device, dtype))
            res[device, dtype] = (com.float().cpu(), m["psnr"].float().cpu(), float(m["bpp"]))
        (cg, pg, bg), (cc, pc, bc) = res["cuda", torch.float32], res["cpu", torch.float32]
        dmax = (cg - cc).abs().max().item()
        dmean = (cg - cc).abs().mean().item()
        dpsnr = (pg - pc).abs().max().item()
        dbpp = abs(bg - bc) / bc
        log(f"{label} card vs cpu: recon max abs {dmax:.3e} mean abs {dmean:.3e} (tolerance "
            f"mean 1e-4); psnr card {pg.tolist()} cpu {pc.tolist()} max diff {dpsnr:.2e} dB "
            f"(tolerance 0.01); bpp card {bg:.6f} cpu {bc:.6f} rel {dbpp:.2e} (tolerance "
            f"1e-3){f'; attention backend on the card {seen}' if seen else ''}")
        require(dmean <= 1e-4 and dpsnr <= 0.01 and dbpp <= 1e-3, f"{label} card disagrees")
        row = lsvc_rows.setdefault(label, {})
        row["card_vs_cpu"] = {"max_abs": dmax, "mean_abs": dmean, "psnr_db": dpsnr,
                              "bpp_rel": dbpp}
        if bf16:
            _, pb, bb = res["cuda", torch.bfloat16]
            dpsnr, dbpp = (pb - pc).abs().max().item(), abs(bb - bc) / bc
            log(f"{label} bf16 card vs f32 cpu: psnr {pb.tolist()} max diff {dpsnr:.4f} dB "
                f"(tolerance {bf16[0]}); bpp {bb:.6f} rel {dbpp:.3e} (tolerance {bf16[1]})")
            require(dpsnr <= bf16[0] and dbpp <= bf16[1], f"{label} bf16 far from f32")
            row["bf16_vs_f32"] = {"psnr_db": dpsnr, "bpp_rel": dbpp}

    def lsvc_rollout(label, spec, frames, trained, runs=3):
        """One run with the launch counts zeroed (exactly ``lsvc_warps``),
        then ``runs`` timed runs beside their host enqueue ms; peak memory.
        Returns (launches, bpp, mean PSNR)."""
        n_p = frames.shape[0] - 1
        want = {**zero_counts, **lsvc_warps(spec.module, n_p)[0]}
        seen = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kw.reset_launches()
        with attention_backends(seen):
            com, m = rollout(spec, frames)
        torch.cuda.synchronize()
        launches = dict(kw.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        require(launches == want, f"{label}: launches {launches}, want {want}")
        psnr, bpp = m["psnr"].float().cpu(), float(m["bpp"])
        require(tuple(com.shape) == (n_p, 3, H, W), f"{label}: recon {tuple(com.shape)}")
        require(bool(torch.isfinite(com).all()), f"{label}: recon not finite")
        require(bool(torch.isfinite(psnr).all()) and np.isfinite(bpp) and bpp > 0.0,
                f"{label}: psnr {psnr.tolist()} bpp {bpp}")
        if trained:
            require(float(psnr.min()) > 20.0, f"{label}: psnr {psnr.tolist()}")
        del com, m
        times, enqueue = timed_runs(rollout, spec, frames, runs=runs)
        ms = sum(times) / len(times)
        lsvc_rows.setdefault(label, {})["rollout"] = {
            "gop": n_p + 1, "ms_per_gop": times, "ms": ms, "enqueue_ms": enqueue,
            "peak_gib": peak, "bpp": bpp, "psnr": float(psnr.mean()), "trained": trained,
            "attention": seen}
        log(f"{label} rollout ({'trained' if trained else 'seeded'} weights, GOP {n_p + 1}): "
            f"ms/GOP {times} mean {ms:.3f}; host enqueue ms/GOP "
            f"{[round(t, 3) for t in enqueue]}; fps {1000.0 * n_p / ms:.3f}; bpp {bpp:.6f}; "
            f"psnr mean {float(psnr.mean()):.4f}; peak memory {peak:.3f} GiB; launches "
            f"{launches}{f'; attention backends {seen}' if seen else ''}")
        return launches, bpp, float(psnr.mean())

    def lsvc_real_bits(label, spec, est, psnr_est, trained):
        """A warm-up GOP and 3 (real_bits): decode == encode, the launches of
        ``lsvc_warps``; trained weights: real bpp within 5% of the rollout's
        estimate and PSNR within 0.1 dB of its."""
        enc, dec = lsvc_warps(spec.module, GOP - 1)
        runs = real_bits(spec, codecs_of(spec), enc, dec, est, lambda r: "")
        recon = runs[-1]["recon"]
        mse = torch.mean((recon.float() - gop[1:].float()) ** 2, dim=(1, 2, 3))
        psnr = float((10 * torch.log10(1 / mse)).mean())
        rel = abs(runs[-1]["bpp"] - est) / est
        log(f"{label} real bits ({'trained' if trained else 'seeded, not gated'}): bpp "
            f"{runs[-1]['bpp']:.6f} vs the rollout's estimate {est:.6f} (rel {rel:.4f}, "
            f"tolerance 0.05); psnr mean {psnr:.4f} vs the rollout's {psnr_est:.4f} "
            f"(tolerance 0.1 dB)")
        if trained:
            require(rel < 0.05 and abs(psnr - psnr_est) < 0.1,
                    f"{label} real bits far from the rollout")
        lsvc_rows[label]["real_bits"] = {
            "enc_ms": [r["enc_s"] * 1e3 for r in runs], "dec_ms": [r["dec_s"] * 1e3 for r in runs],
            "enc_ac_s": runs[-1]["enc_ac_s"], "dec_ac_s": runs[-1]["dec_ac_s"],
            "bpp": runs[-1]["bpp"], "est_bpp": est, "psnr": psnr}
        return runs[-1]["enc_launches"], runs[-1]["dec_launches"]

    def time_path(kernel, what, inputs):
        """``kernel`` on one GOP's captured ``inputs`` as time_kernels times
        it (each held bit for bit against its plain version), beside its
        byte bound and, for flow_warp, F.grid_sample."""
        trows, tlib = {}, {}
        time_kernels((kernel,), {kernel: inputs}, trows, tlib, lsvc_library)
        t = lsvc_timing[kernel][what] = {**trows[kernel], "library_ms": tlib[kernel],
                                         "launches": len(inputs)}
        log(f"{kernel} {what}, {len(inputs)} launches of "
            f"{sorted({tuple(img.shape) for img, _ in inputs})}: kernel {t['ms']:.4f} ms/GOP "
            f"(L2 flushed {t['cold_ms']:.4f}) against its byte bound {t['bound_ms']:.4f}, "
            f"plain {t['plain_ms']:.4f}, library {t['library_ms']}")

    def captured_warps(spec, frames):
        captured = {}
        with capture_warp_inputs(captured):
            rollout(spec, frames)
        return captured

    with phase("lsvc forms card vs cpu port"):
        lsvc_card_vs_cpu("lsvc-tiny", lambda dt, dev: lsvc_model("LSVC-TINY", "tiny_lsvc_l2",
                                                                 dt, dev),
                         bf16=(LSVC_BF16_PSNR_DB, LSVC_BF16_BPP_REL))
        lsvc_card_vs_cpu("lsvc-128", lambda dt, dev: lsvc_model("LSVC-128", "hd_lsvc128_l2",
                                                                dt, dev))
        for name in ("LSVC-TPU-RW-TINY", "LSVC-TPU-HF-TINY"):
            lsvc_card_vs_cpu(name.lower(), lambda dt, dev, n=name: lsvc_model(n, "seeded",
                                                                                dt, dev))
        lsvc_card_vs_cpu("lsvc-tpu-tiny -a -s (attn_depth 2)", narrow_attention)

    l128 = lsvc_model("LSVC-128", "hd_lsvc128_l2")
    with phase(f"lsvc-128 rollout {H}x{W} GOP16 bf16"):
        lsvc_launches["lsvc128_rollout"], est, psnr_est = lsvc_rollout("lsvc-128", l128, gop,
                                                                       trained=True)

    with phase(f"lsvc-128 decode graph {H}x{W} GOP16 bf16"):
        decode, (mv_q, z_qs, feat_qs) = build_lsvc_decode(l128.module, GOP, H, W)
        iframe = gop[0].contiguous()  # s2d=1: the I-frame as it is
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kw.reset_launches()
        mean, sigma, out = decode(iframe, mv_q, z_qs, feat_qs)
        torch.cuda.synchronize()
        launches = lsvc_launches["lsvc128_decode_graph"] = dict(kw.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        require(launches == {**zero_counts, "flow_warp": 4},
                f"lsvc-128 decode launches {launches}, want flow_warp 4")
        require(tuple(out.shape) == (GOP - 1, 3, H, W) and bool(torch.isfinite(out).all()),
                "lsvc-128 decode output not finite or misshapen")
        del out
        times, enqueue = timed_runs(decode, iframe, mv_q, z_qs, feat_qs)
        ms = sum(times) / len(times)
        lsvc_rows["lsvc-128"]["decode_graph"] = {"ms_per_gop": times, "ms": ms,
                                                 "enqueue_ms": enqueue, "peak_gib": peak}
        log(f"lsvc-128 decode graph: ms/GOP {times} mean {ms:.3f}; host enqueue ms/GOP "
            f"{[round(t, 3) for t in enqueue]}; fps {1000.0 * (GOP - 1) / ms:.3f}; peak "
            f"memory {peak:.3f} GiB; launches {launches}")
        del decode, mv_q, z_qs, feat_qs

    with phase(f"lsvc-128 real bits {H}x{W} GOP16 bf16"):
        enc, dec = lsvc_real_bits("lsvc-128", l128, est, psnr_est, trained=True)
        lsvc_launches.update(lsvc128_real_bits_encode=enc, lsvc128_real_bits_decode=dec)

    with phase("flow_warp on LSVC-128's inputs (bf16, one GOP's 8 launches)"):
        warps = captured_warps(l128, gop)
        fw = warps.get("flow_warp", [])
        require(len(fw) == 8 and set(warps) == {"flow_warp"},
                f"captured {[(k, len(v)) for k, v in warps.items()]}")
        # SpyNet's 4 levels, each one launch over the 15 P-frames, then the
        # MC warp of each tree layer's frames at full resolution
        require([tuple(img.shape) for img, _ in fw] ==
                [(GOP - 1, 3, H >> k, W >> k) for k in (3, 2, 1, 0)]
                + [(n, 3, H, W) for n in (1, 2, 4, 8)],
                f"LSVC-128's warps {[tuple(img.shape) for img, _ in fw]}")
        time_path("flow_warp", "lsvc128_rollout_spynet", fw[:4])
        time_path("flow_warp", "lsvc128_rollout_mc_warp", fw[4:])
        del warps, fw
    del l128

    for name, weights in LSVC_VARIANTS:
        label, path = name.lower(), name.lower().replace("-", "_")
        trained = weights != "seeded"
        vspec = lsvc_model(name, weights)
        with phase(f"{label} rollout {H}x{W} GOP16 bf16"):
            lsvc_launches[f"{path}_rollout"], est, psnr_est = lsvc_rollout(label, vspec, gop,
                                                                           trained)
        if name in ("LSVC-TPU-RW", "LSVC-TPU-HF"):
            kernel = "flow_warp" if name == "LSVC-TPU-RW" else "flow_warp_s2d"
            with phase(f"{kernel} on {name}'s MC inputs (bf16, one GOP's 4 launches)"):
                mc = captured_warps(vspec, gop)[kernel][-4:]
                require([tuple(img.shape) for img, _ in mc] ==
                        [(n, 12, H // 2, W // 2) for n in (1, 2, 4, 8)],
                        f"{name}'s MC warps {[tuple(img.shape) for img, _ in mc]}")
                time_path(kernel, f"{path}_rollout_mc_warp", mc)
                del mc
        with phase(f"{label} real bits {H}x{W} GOP16 bf16"):
            enc, dec = lsvc_real_bits(label, vspec, est, psnr_est, trained)
            lsvc_launches.update({f"{path}_real_bits_encode": enc,
                                  f"{path}_real_bits_decode": dec})
        del vspec

    # the graphs: the chain codes 15 layers of one frame; the one-hop graph
    # reaches 14 P-frames (in JAX too), so it codes a GOP of 15
    for name, frames in (("LSVC-TPU-L", gop), ("LSVC-TPU-O", gop[:GOP - 1])):
        label, path = name.lower(), name.lower().replace("-", "_")
        gspec = lsvc_model(name, "hd_lsvctpuf2_l2")
        with phase(f"{label} rollout {H}x{W} GOP{frames.shape[0]} bf16"):
            lsvc_launches[f"{path}_rollout"], *_ = lsvc_rollout(label, gspec, frames, True)
        del gspec

    with phase(f"hd head-to-head {HD_SIZE}x{HD_SIZE} GOP{HD_GOP} f32 real bits"):
        # JAX's TestHDHeadToHead on the card through tools/price_hd.py: four
        # held-out clips (seed 123; the checkpoints trained on seed 0),
        # levels 0, 2, 4, real bits, decode == encode on every GOP
        from fastvideocodec_torch.tools import price_hd

        clips = price_hd.held_out_clips(device="cuda")
        curves = {}
        for name, family in HD_CURVES:
            bpps, psnrs = price_hd.curve(
                name, family, clips,
                check=lambda what, same: require(same, f"{what}: decode != encode"))
            require(bpps[0] < bpps[1] < bpps[2] and psnrs[0] < psnrs[1] < psnrs[2],
                    f"hd {name}: curve not monotone {bpps} {psnrs}")
            curves[name] = (bpps, psnrs)
            log(f"hd {name} (hd_{family}_l0/2/4): bpp {bpps} psnr {psnrs}")
        ref = curves["LSVC-128"]
        bdr = {name: bd_rate(*ref, *curves[name]) for name, _ in HD_CURVES[1:]}
        bdp = bd_psnr(*ref, *curves["LSVC-TPU"])
        full, halfres, rigid = bdr["LSVC-TPU"], bdr["LSVC-TPU-HF"], bdr["LSVC-TPU-RW"]
        log(f"hd head-to-head: BD-rate against LSVC-128: LSVC-TPU {full:+.2f}% (bound < 10), "
            f"-HF {halfres:+.2f}% (< 16), -RW {rigid:+.2f}% (< 32); LSVC-TPU's BD-PSNR "
            f"{bdp:+.3f} dB (bound > -0.6)")
        require(full < 10.0 and bdp > -0.6, "the flagship's BD-rate bound")
        require(full < halfres < rigid and rigid < 32.0 and halfres < 16.0,
                "the ablation chain")
        lsvc_rows["hd_head_to_head"] = {"curves": curves, "bd_rate": bdr, "bd_psnr": bdp}
        del clips

    # ---- training: LSVC-TPU at full width, float32 ----
    from fastvideocodec_torch.ops.math import UniformNoise
    from fastvideocodec_torch.train import (
        TrainConfig,
        apply_updates,
        exponential_decay,
        gop_loss,
        load_checkpoint,
        make_optimizer,
        make_train_step,
        ready_for_training,
        save_checkpoint,
    )

    def nchw_clip(frames) -> "torch.Tensor":
        return torch.from_numpy(np.ascontiguousarray(frames)).permute(0, 3, 1, 2).contiguous()

    def train_spec(device, dtype=torch.float32):
        """LSVC-TPU on hd_lsvctpuf2_l2, readied for training in ``dtype``
        (bfloat16: flax's mixed precision, float32 masters): (spec,
        params)."""
        spec = get_codec_model("LSVC-TPU", device=device)
        load_asset(spec.module, "hd_lsvctpuf2_l2")
        return spec, ready_for_training(spec, dtype)

    def grads_of(params):
        return {n: p.grad if p.grad is not None else torch.zeros_like(p)
                for n, p in params.items()}

    from fastvideocodec_torch.tools.train_parity import CardBranches, CardTouchups, own_gaps

    def step_card_vs_cpu(label, make_spec, small, control=None, loss_fn=None,
                         deterministic=False):
        """One training step of ``make_spec(device)`` (spec, params) on the
        card and on the CPU on the clip ``small``, the same noise on both
        devices (drawn on the host from one seed, copied to the card), the
        CPU on the card's ReLU branches and OLFT touch-up masks
        (tools/train_parity.py's CardBranches and CardTouchups): the loss
        and metrics, each parameter's gradient and the parameters after one
        Adam step, at the TRAIN_CPU_* bars. ``loss_fn(spec, clip, noise)``
        gives (loss, metrics), by default gop_loss's. ``control`` (name: a
        launcher to put in its place) runs the card's step once more with
        those launchers, and that step's gradients must fail the bar.
        ``deterministic``: the card runs cuDNN's deterministic algorithms,
        from an emptied cache (with cuDNN's defaults an H100 once gave
        LSVC-TPU's gradient 2.25e-2 of its max from the CPU's at
        res_encoder.Conv_2.weight, its norm 1.5e-4 off, where 43 other card
        steps stood at 4e-6 to 6e-4: the cause is not found, cuDNN's choice
        of algorithm the suspect); else cuDNN's defaults, as users train.
        Returns the numbers."""
        cfg = TrainConfig(learning_rate=TRAIN_LR)
        loss_fn = loss_fn or (lambda spec, clip, noise: gop_loss(spec, clip, True, noise, cfg))

        def run(device, replay=(None, None), launchers=None):
            saved = {n: getattr(kw, n) for n in launchers or {}}
            if deterministic:
                torch.cuda.empty_cache()
            try:
                for n, fn in (launchers or {}).items():
                    setattr(kw, n, fn)
                spec, params = make_spec(device)
                with CardBranches(replay[0]) as branches, CardTouchups(replay[1]) as touchups, \
                        deterministic_convs() if deterministic else contextlib.nullcontext():
                    loss, m = loss_fn(spec, small.to(device), UniformNoise(0, device="cpu"))
                    loss.backward()
            finally:
                for n, fn in saved.items():
                    setattr(kw, n, fn)
            grads = grads_of(params)
            tx = make_optimizer(cfg)
            updates, _ = tx.update(grads, tx.init(params), params)
            apply_updates(params, updates)
            return ((branches, touchups),
                    {k: float(v.detach()) for k, v in m.items() if v.dim() == 0},
                    {n: g.detach().float().cpu() for n, g in grads.items()},
                    {n: p.detach().cpu() for n, p in params.items()})

        (card, card_touch), mg, gg, pg = run("cuda")
        (cpu, cpu_touch), mc, gc, pc = run("cpu", replay=(card.masks, card_touch.masks))
        metric_rel = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in mc}
        norms = [float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values())))
                 for grads in (gg, gc)]
        gaps = own_gaps(gg, gc)
        grad_rel, grad_name = max((v, n) for n, v in gaps.items())
        param_abs, param_name = max(((pg[n] - pc[n]).abs().max().item(), n) for n in pc)
        log(f"{label} gradient norm card {norms[0]:.6e} cpu {norms[1]:.6e} (degenerate, as "
            f"JAX's ELFVC-SP at its own random init, from {DEGENERATE_GRAD_NORM:.0e}); the CPU "
            f"on the card's branches: {cpu.flips} of "
            f"{sum(m.numel() for m in card.masks)} activation elements in "
            f"{len(card.masks)} calls took the other branch on the CPU; of "
            f"{sum(m.numel() for m in card_touch.masks)} OLFT touch-up mask elements "
            f"{cpu_touch.flips} took the other side of the threshold")
        log(f"{label} training step card vs cpu ({smi}): loss card {mg['loss']:.6f} cpu "
            f"{mc['loss']:.6f}; metrics max rel {max(metric_rel.values()):.2e} "
            f"{ {k: f'{v:.1e}' for k, v in metric_rel.items()} } (tolerance "
            f"{TRAIN_CPU_METRIC_REL}); worst gradient max abs / max |grad| {grad_rel:.2e} at "
            f"{grad_name} (tolerance {TRAIN_CPU_GRAD_REL}); parameters after one Adam step "
            f"max abs {param_abs:.2e} at {param_name} (tolerance 2 lr + 1e-6 = "
            f"{2 * TRAIN_LR + 1e-6:.2e}: a gradient near 0 of another sign moves 2 lr)")
        require(max(metric_rel.values()) <= TRAIN_CPU_METRIC_REL,
                f"{label} training metrics card vs cpu")
        require(grad_rel <= TRAIN_CPU_GRAD_REL, f"{label} gradient card vs cpu at {grad_name}")
        require(param_abs <= 2 * TRAIN_LR + 1e-6,
                f"{label} parameters card vs cpu at {param_name}")
        out = {"metric_rel": metric_rel, "grad_rel": grad_rel, "grad_rel_at": grad_name,
               "param_abs": param_abs, "grad_norm": norms, "relu_flips": cpu.flips,
               "touch_flips": cpu_touch.flips}
        if control:
            control_grads = run("cuda", launchers=control)[2]
            control_rel, control_at = max((v, n) for n, v in own_gaps(control_grads, gc).items())
            log(f"{label} control, {sorted(control)} replaced: worst gradient gap "
                f"{control_rel:.2e} at {control_at} (must exceed {TRAIN_CPU_GRAD_REL})")
            require(control_rel > TRAIN_CPU_GRAD_REL, f"{label}: the control passed the bar")
            out["control_grad_rel"], out["control_at"] = control_rel, control_at
        return out

    training = {"card": smi}
    with phase("lsvc-tpu training step, card vs cpu, 64x128 GOP4 f32, deterministic cuDNN"):
        # the clip of phase 4
        clip = synth_gop_multi(np.random.default_rng(0), size=128, gop=4)[:, :64, :128]
        training["card_vs_cpu"] = step_card_vs_cpu("lsvc-tpu", train_spec, nchw_clip(clip),
                                                    deterministic=True)

    def count_calls(table, calls):
        """``table``'s functions wrapped to count their calls in ``calls``."""
        def counted(name, fn):
            def wrapped(*args, **kwargs):
                calls[name] = calls.get(name, 0) + 1
                return fn(*args, **kwargs)
            return wrapped
        return {name: counted(name, fn) for name, fn in table.items()}

    @contextlib.contextmanager
    def capture_backward(captured):
        """Record a clone of the inputs of each backward kernel named in
        ``captured`` (by launch-count name), launched as the run goes."""
        saved = {b: getattr(kw, f"launch_{b}") for b in captured}

        def capture(bname):
            def wrapped(img, flow, grad, need_img=True, need_flow=True):
                captured[bname].append((img.clone(), flow.clone(), grad.clone(), need_img,
                                        need_flow))
                return saved[bname](img, flow, grad, need_img, need_flow)
            return wrapped

        for b in captured:
            setattr(kw, f"launch_{b}", capture(b))
        try:
            yield
        finally:
            for b in captured:
                setattr(kw, f"launch_{b}", saved[b])

    def train_run(label, step_fn, params, opt_state, batches, noise, masks=None, after=None):
        """Every step of ``batches`` timed (MCVC's with its view mask of
        ``masks``): CUDA events around each step, and the host clock until
        the step returns (its enqueue); ``after(gop, metrics)``, when
        given, runs on the host after each step's end event (OLFT's
        touch-up pricing, as the CLI's loop prices them) and adds its
        metrics; the launch counts zeroed before the run and the plain
        warps' calls counted in it. Returns (params, opt_state, per-step
        metrics, times, enqueue, launches, plain calls, peak GiB)."""
        plain_calls = {}
        saved = dict(ow.PLAIN), dict(ow.PLAIN_BACKWARD)
        ow.PLAIN.update(count_calls(saved[0], plain_calls))
        ow.PLAIN_BACKWARD.update(count_calls(saved[1], plain_calls))
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kw.reset_launches()
            marks, enqueue, metrics = [], [], []
            for i, gop_i in enumerate(batches):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                if masks is None:
                    params, opt_state, m = step_fn(params, opt_state, gop_i, noise)
                else:
                    params, opt_state, m = step_fn(params, opt_state, gop_i, noise, masks[i])
                enqueue.append((time.perf_counter() - t0) * 1e3)
                end.record()
                if after is not None:
                    m.update(after(gop_i, m))
                marks.append((start, end))
                metrics.append(m)
            torch.cuda.synchronize()
            launches = dict(kw.LAUNCHES)
        finally:
            ow.PLAIN.update(saved[0])
            ow.PLAIN_BACKWARD.update(saved[1])
        times = [a.elapsed_time(b) for a, b in marks]
        peak = torch.cuda.max_memory_allocated() / 2**30
        metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
        require(all(np.isfinite(v) for m in metrics for v in m.values()),
                f"{label}: a metric is not finite")
        require(all(bool(torch.isfinite(p).all()) for p in params.values()),
                f"{label}: a parameter is not finite")
        return params, opt_state, metrics, times, enqueue, launches, plain_calls, peak

    def run_summary(label, metrics, times, enqueue, peak, skip):
        steady = sorted(times[skip:])
        row = {"ms_per_step": times, "ms_median": float(np.median(steady)),
               "ms_range": [steady[0], steady[-1]], "enqueue_ms": enqueue,
               "enqueue_median": float(np.median(enqueue[skip:])), "peak_gib": peak,
               "first": metrics[0], "last": metrics[-1]}
        log(f"{label} ({smi}): ms/step by CUDA events, median {row['ms_median']:.3f} range "
            f"{steady[0]:.3f}-{steady[-1]:.3f} over steps {skip + 1}-{len(times)}; host "
            f"enqueue ms/step median {row['enqueue_median']:.3f}; peak {peak:.3f} GiB; first "
            f"step {metrics[0]}; last step {metrics[-1]}")
        log(f"{label}: ms/step {[round(t, 3) for t in times]}; enqueue "
            f"{[round(t, 3) for t in enqueue]}")
        return row

    with phase(f"lsvc-tpu train {TRAIN_SIZE}x{TRAIN_SIZE} GOP{TRAIN_GOP} f32, "
               f"{TRAIN_STEPS} steps"):
        # tools/train_tiny.py's lsvctpu256_hd rung: one synth_gop_multi clip
        # a step from default_rng(0), constant lr 1e-4, from hd_lsvctpuf2_l2
        rng = np.random.default_rng(0)
        clips = [nchw_clip(synth_gop_multi(rng, size=TRAIN_SIZE, gop=TRAIN_GOP)).cuda()
                 for _ in range(TRAIN_STEPS + 1)]
        spec, params = train_spec("cuda")
        cfg = TrainConfig(learning_rate=TRAIN_LR)
        init_fn, step_fn = make_train_step(spec, cfg)
        start_params = {n: p.detach().clone() for n, p in params.items()}
        noise = UniformNoise(0)
        params, opt_state, metrics, times, enqueue, train_launches, plain_calls, peak = \
            train_run("train", step_fn, params, init_fn(params), clips[:TRAIN_STEPS], noise)
        per_lsvc_step = train_launches_of(spec.module.schedule(TRAIN_GOP - 1).depth)
        want = {**zero_counts, **{k: n * TRAIN_STEPS for k, n in per_lsvc_step.items()}}
        log(f"launches in {TRAIN_STEPS} steps: {train_launches}; a step: "
            f"{ {k: v / TRAIN_STEPS for k, v in train_launches.items() if v} } (want "
            f"{per_lsvc_step}); plain warp calls {plain_calls} (want none)")
        require(train_launches == want, f"training launches {train_launches}, want {want}")
        require(not plain_calls, f"the training steps called plain warps: {plain_calls}")
        moved = sum(not torch.equal(p.detach(), start_params[n]) for n, p in params.items())
        log(f"parameters moved: {moved} of {len(params)}")
        require(moved > 0.9 * len(params), "the parameters did not move")
        training["train_256_gop16"] = {**run_summary("train", metrics, times, enqueue, peak, 4),
                                       "launches": train_launches, "moved": moved}
        del start_params

        # one more step with the backward kernels' inputs captured
        captured = {b: [] for b in FLOW_BACKWARD}
        with capture_backward(captured):
            step_fn(params, opt_state, clips[TRAIN_STEPS], noise)
        del spec, params, opt_state, clips
        torch.cuda.empty_cache()

    with phase(f"lsvc-tpu batched train {BATCH_CLIPS} x {BATCH_GOP} x {TRAIN_SIZE}x{TRAIN_SIZE} "
               f"f32, {BATCH_STEPS} steps, checkpoint round trip"):
        # cli/train.py's default batch, under its staircase decay (one
        # "epoch" of half the steps)
        rng = np.random.default_rng(1)
        batches = [torch.stack([nchw_clip(synth_gop_multi(rng, size=TRAIN_SIZE, gop=BATCH_GOP))
                                for _ in range(BATCH_CLIPS)]).cuda()
                   for _ in range(BATCH_STEPS + 1)]
        spec, params = train_spec("cuda")
        cfg = TrainConfig(learning_rate=TRAIN_LR)
        tx = make_optimizer(cfg, learning_rate=exponential_decay(
            TRAIN_LR, BATCH_STEPS // 2, 0.5, staircase=True))
        init_fn, step_fn = make_train_step(spec, cfg, optimizer=tx, batched=True)
        noise = UniformNoise(1)
        try:
            params, opt_state, metrics, times, enqueue, launches, plain_calls, peak = train_run(
                "batched train", step_fn, params, init_fn(params), batches[:BATCH_STEPS], noise)
        except torch.cuda.OutOfMemoryError as e:
            log(f"batched train does not fit ({smi}): {e}")
            raise
        per_clip = train_launches_of(spec.module.schedule(BATCH_GOP - 1).depth)
        want = {**zero_counts, **{k: n * BATCH_STEPS * BATCH_CLIPS for k, n in per_clip.items()}}
        log(f"launches in {BATCH_STEPS} steps of {BATCH_CLIPS} clips: {launches}; plain warp "
            f"calls {plain_calls}")
        require(launches == want, f"batched launches {launches}, want {want}")
        require(not plain_calls, f"the batched steps called plain warps: {plain_calls}")
        require(opt_state["main"]["count"] == BATCH_STEPS, "optimizer count")
        training["batched_4x7x256"] = run_summary("batched train", metrics, times, enqueue,
                                                  peak, 2)
        score = metrics[-1]["bpp"] + metrics[-1]["img_loss"]
        state = {"params": {n: p.detach() for n, p in params.items()}, "opt_state": opt_state,
                 "epoch": 0, "score": score}
        with tempfile.TemporaryDirectory() as d:
            save_checkpoint(d, state, best=True)
            loaded = load_checkpoint(d)

        def equal_trees(a, b):
            if isinstance(a, dict):
                return a.keys() == b.keys() and all(equal_trees(a[k], b[k]) for k in a)
            if isinstance(a, torch.Tensor):
                return torch.equal(a.cpu(), b.cpu())
            return a == b

        require(equal_trees(loaded, state), "the checkpoint did not round-trip bit for bit")
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(loaded["params"][n])
        opt_state = {g: {"count": s["count"], **{k: {n: t.cuda() for n, t in s[k].items()}
                                                   for k in ("mu", "nu")}}
                     for g, s in loaded["opt_state"].items()}
        params, opt_state, m = step_fn(params, opt_state, batches[BATCH_STEPS], noise)
        m = {k: float(v) for k, v in m.items()}
        require(all(np.isfinite(v) for v in m.values()), f"step after the round trip {m}")
        log(f"checkpoint: params, optimizer state, epoch and score equal bit for bit after "
            f"save_checkpoint/load_checkpoint; the next step ran: {m}")
        del spec, params, opt_state, batches, state, loaded
        torch.cuda.empty_cache()

    def grid_sample_fb(img, grid, grad, need_img, need_flow):
        """F.grid_sample's forward and backward on the same inputs (the
        flow's sampling grid built beforehand): the gradients of the image
        and of the grid."""
        i = img.detach().requires_grad_(need_img)
        g = grid.detach().requires_grad_(need_flow)
        wrt = [t for t in (i, g) if t.requires_grad]
        return torch.autograd.grad(grid_sample(i, g), wrt, grad)

    with phase("backward kernel timing (f32, one training step's launches)"):
        flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
        for bname, name in FLOW_BACKWARD.items():
            inputs = captured[bname]
            require(len(inputs) == per_lsvc_step[bname],
                    f"{bname}: captured {len(inputs)} launches")
            r = rows[bname] = {"ms": 0.0, "cold_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                               "floor_ms": 0.0, "launches": []}
            lib[bname] = 0.0 if name == "flow_warp" else None
            for img, flow, grad, need_img, need_flow in inputs:
                hold_backward(bname, img, flow, grad, need_img, f"{bname} on training inputs")
                warm = cuda_ms(torch, backward_kernels[bname], img, flow, grad, need_img,
                               need_flow)
                cold = cold_ms(torch, backward_kernels[bname], img, flow, grad, need_img,
                               need_flow, flush=flush)
                r["ms"] += warm
                r["cold_ms"] += cold
                r["plain_ms"] += cuda_ms(torch, backward_plains[bname], img, flow, grad,
                                         need_img, need_flow, iters=5)
                r["bound_ms"] += backward_bound_ms(img, flow, need_img, need_flow)
                r["launches"].append(f"{tuple(img.shape)} image grad {need_img}: "
                                     f"{warm:.4f} / {cold:.4f}")
                r["floor_ms"] += cold_ms(torch, kw.launch_backward_floor, name, img, flush=flush)
                if name == "flow_warp":
                    lib[bname] += cuda_ms(torch, grid_sample_fb, img, sample_grid(flow), grad,
                                          need_img, need_flow)
            r["device_ms"] = device_ms(torch, backward_kernels[bname], inputs)[0]
            log(f"{bname} ({smi}): kernel {r['ms']:.4f} ms per training step's "
                f"{len(inputs)} launches (L2 flushed before each: {r['cold_ms']:.4f}; device "
                f"time under the profiler {r['device_ms']}), plain "
                f"vjp {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} (bytes at 3.35 TB/s), "
                f"launch floor {r['floor_ms']:.4f} (an empty kernel on each launch's grid, L2 "
                f"flushed), library {lib[bname]} "
                f"({'F.grid_sample forward + backward' if lib[bname] is not None else 'none'}); "
                f"ptxas {ptxas_report(build.build_log(), BACKWARD_ENTRY[bname])}")
            log(f"{bname} per launch, img shape: warm / L2-flushed ms: {r['launches']}")
        del captured
    training["backward_timing"] = {b: {**rows[b], "library_ms": lib[b]} for b in FLOW_BACKWARD}

    # ---- training: SSF and ELFVC at full width, float32 ----
    from fastvideocodec_torch.train import make_elfvc_stage_optimizer

    def seeded_train_spec(name, device, dtype=torch.float32):
        """``name`` at full width on seeded_flat(name, 0) (sp_stage 1 for the
        ELFVC-SP forms, as cli/train.py builds them), readied for training
        in ``dtype``: (spec, params)."""
        spec = get_codec_model(name, device=device)
        load_flat(spec.module, seeded_flat(name, 0))
        return spec, ready_for_training(spec, dtype)

    def zero_flow_gradient(launch, scale=0.0):
        """``launch`` (a warp's backward launcher) with its flow gradient
        zeroed (or times ``scale``): the control of phase 46."""
        def zeroed(img, flow, grad, need_img, need_flow):
            grad_img, grad_flow = launch(img, flow, grad, need_img, need_flow)
            if grad_flow is not None:
                grad_flow = torch.zeros_like(grad_flow) if scale == 0 else grad_flow * scale
            return grad_img, grad_flow
        return zeroed

    with phase("elfvc-sp-tpu and elfvc-sp training step, card vs cpu, 64x128 GOP4 f32"):
        clip = synth_gop_multi(np.random.default_rng(0), size=128, gop=4)[:, :64, :128]
        control = {f"launch_{b}": zero_flow_gradient(getattr(kw, f"launch_{b}"))
                   for b in PIXEL_BACKWARD}
        training["elfvc_card_vs_cpu"] = {
            name: step_card_vs_cpu(name, lambda device, name=name: seeded_train_spec(name, device),
                                   nchw_clip(clip), control)
            for name in ("ELFVC-SP-TPU", "ELFVC-SP")}

    pixel_captured = {}  # path: {backward name: one training step's inputs}
    pixel_launches = {k: 0 for k in kw.LAUNCHES}  # over the runs of phases 47 and 48
    pixel_per_step = {}  # path: launches of one training step

    def masked_by_stage(params) -> dict:
        """JAX's masking check (tests/test_models.py, TestStagedTraining) on
        unit gradients: each stage's groups get nonzero updates, every other
        parameter none. Returns the trainable count by stage."""
        out = {}
        for stage in (0, 1, 2):
            tx = make_elfvc_stage_optimizer(TrainConfig(learning_rate=TRAIN_LR), stage)
            ones = {n: torch.ones_like(p) for n, p in params.items()}
            updates, _ = tx.update(ones, tx.init(params), params)
            trainable = {n for n in params if tx.label(n) != "frozen"}
            require(set(updates) == trainable and all(
                float(u.abs().min()) > 0 for u in updates.values()), f"stage {stage} masking")
            require(any(".y_predictor." in n for n in trainable), f"stage {stage}: no SPnet")
            out[stage] = len(trainable)
        return out

    with phase(f"elfvc-sp train {BATCH_CLIPS} x {BATCH_GOP} x {TRAIN_SIZE}x{TRAIN_SIZE} f32: "
               f"default stage {ELFVC_TRAIN_STEPS} steps, stages 0, 1, 2 {ELFVC_STAGE_STEPS} "
               f"steps each"):
        # cli/train.py's default codec and batch, then JAX's staged recipe
        # shortened; one synth_gop_multi clip an item from default_rng(2)
        rng = np.random.default_rng(2)
        runs = [("default", None, ELFVC_TRAIN_STEPS)] + [
            (f"stage {k}", k, ELFVC_STAGE_STEPS) for k in (0, 1, 2)]
        batches = [torch.stack([nchw_clip(synth_gop_multi(rng, size=TRAIN_SIZE, gop=BATCH_GOP))
                                for _ in range(BATCH_CLIPS)]).cuda()
                   for _ in range(sum(n for _, _, n in runs) + 1)]
        spec, params = seeded_train_spec("ELFVC-SP", "cuda")
        cfg = TrainConfig(learning_rate=TRAIN_LR)
        noise = UniformNoise(2)
        per_step = pixel_per_step["elfvc-sp"] = pixel_train_launches(
            "ELFVC-SP", BATCH_CLIPS * (BATCH_GOP - 1))
        log(f"elfvc-sp launches a step, stated beforehand: {per_step}")
        elfvc_train, at = {}, 0
        for label, stage, n in runs:
            tx = make_optimizer(cfg) if stage is None else make_elfvc_stage_optimizer(cfg, stage)
            init_fn, step_fn = make_train_step(spec, cfg, optimizer=tx, batched=True)
            before = {k: p.detach().clone() for k, p in params.items()}
            params, _, metrics, times, enqueue, launches, plain_calls, peak = train_run(
                f"elfvc-sp {label}", step_fn, params, init_fn(params), batches[at:at + n], noise)
            at += n
            want = {**zero_counts, **{k: v * n for k, v in per_step.items()}}
            require(launches == want, f"elfvc-sp {label} launches {launches}, want {want}")
            require(not plain_calls, f"elfvc-sp {label} called plain warps: {plain_calls}")
            frozen = [k for k in params if tx.label(k) == "frozen"]
            require((stage is None) == (not frozen), f"elfvc-sp {label}: {len(frozen)} frozen")
            thawed = [k for k in frozen if not torch.equal(params[k].detach(), before[k])]
            require(not thawed, f"elfvc-sp {label}: frozen parameters moved: {thawed}")
            moved = sum(not torch.equal(p.detach(), before[k]) for k, p in params.items())
            degenerate = max(m["grad_norm"] for m in metrics) >= DEGENERATE_GRAD_NORM
            for k, v in launches.items():
                pixel_launches[k] += v
            elfvc_train[label] = {**run_summary(f"elfvc-sp {label}", metrics, times, enqueue,
                                                peak, 2 if n > ELFVC_STAGE_STEPS else 1),
                                  "launches": launches, "moved": moved, "frozen": len(frozen),
                                  "degenerate": degenerate}
            log(f"elfvc-sp {label}: launches {launches}; plain warp calls none; parameters "
                f"moved {moved} of {len(params)}, {len(frozen)} frozen and bit for bit "
                f"unchanged; degenerate (grad_norm from {DEGENERATE_GRAD_NORM:.0e}): {degenerate}")
            del before
        elfvc_train["stage_masking_unit_grads"] = masked_by_stage(params)
        log(f"stage masking on unit gradients (trainable parameters by stage): "
            f"{elfvc_train['stage_masking_unit_grads']} of {len(params)}")
        training["elfvc_sp_4x7x256"] = elfvc_train
        # one more step with the backward kernels' inputs captured
        captured = pixel_captured["elfvc-sp"] = {b: [] for b in PIXEL_BACKWARD}
        init_fn, step_fn = make_train_step(spec, cfg, batched=True)
        with capture_backward(captured):
            step_fn(params, init_fn(params), batches[-1], noise)
        del spec, params, batches
        torch.cuda.empty_cache()

    with phase(f"ssf-tpu and elfvc-sp-tpu train {TRAIN_SIZE}x{TRAIN_SIZE} GOP{TRAIN_GOP} f32, "
               f"{TPU_FORM_STEPS} steps each"):
        rng = np.random.default_rng(3)
        clips = [nchw_clip(synth_gop_multi(rng, size=TRAIN_SIZE, gop=TRAIN_GOP)).cuda()
                 for _ in range(TPU_FORM_STEPS + 1)]
        cfg = TrainConfig(learning_rate=TRAIN_LR)
        for name in ("SSF-TPU", "ELFVC-SP-TPU"):
            label = name.lower()
            spec, params = seeded_train_spec(name, "cuda")
            start = {k: p.detach().clone() for k, p in params.items()}
            init_fn, step_fn = make_train_step(spec, cfg)
            noise = UniformNoise(3)
            per_step = pixel_per_step[label] = pixel_train_launches(name, TRAIN_GOP - 1)
            log(f"{label} launches a step, stated beforehand: {per_step}")
            params, opt_state, metrics, times, enqueue, launches, plain_calls, peak = train_run(
                label, step_fn, params, init_fn(params), clips[:TPU_FORM_STEPS], noise)
            want = {**zero_counts, **{k: v * TPU_FORM_STEPS for k, v in per_step.items()}}
            require(launches == want, f"{label} launches {launches}, want {want}")
            require(not plain_calls, f"{label} called plain warps: {plain_calls}")
            for k, v in launches.items():
                pixel_launches[k] += v
            # the keyframe's transforms take no part in a rollout
            coded = [k for k in params if not k.startswith("img_")]
            moved = sum(not torch.equal(params[k].detach(), start[k]) for k in coded)
            log(f"{label}: launches {launches}; plain warp calls none; parameters moved {moved} "
                f"of the {len(coded)} outside the keyframe's transforms")
            require(moved >= 0.9 * len(coded), f"{label}: the parameters did not move")
            training[f"{label}_256_gop16"] = {**run_summary(label, metrics, times, enqueue, peak,
                                                            2),
                                              "launches": launches, "moved": moved}
            captured = pixel_captured[label] = {b: [] for b in PIXEL_BACKWARD}
            with capture_backward(captured):
                step_fn(params, opt_state, clips[TPU_FORM_STEPS], noise)
            del spec, params, opt_state, start
        del clips
        torch.cuda.empty_cache()

    # ---- training: MCVC-IA and MCVC-IA-OLFT at full width, float32 ----
    from fastvideocodec_torch.models import sample_view_mask
    from fastvideocodec_torch.train import make_olft_step, olft_loss
    from fastvideocodec_torch.train.olft import touchup_bytes

    def mcvc_train_spec(name, views, device, dtype=torch.float32):
        """``name`` at full width on seeded_flat(name, 0) over ``views``
        views, readied for training in ``dtype``: (spec, params)."""
        spec = get_codec_model(name, device=device, num_views=views)
        load_flat(spec.module, seeded_flat(name, 0))
        return spec, ready_for_training(spec, dtype)

    def views_nchw(frames) -> "torch.Tensor":
        """synth_mv_gop's [T, V, H, W, 3] as MCVC's gop [T, V, 3, H, W]."""
        return torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 1, 4, 2, 3)))

    with phase("mcvc-ia and mcvc-ia-olft training step, card vs cpu, 3x64x128 GOP4 f32, "
               "view 2 failed"):
        small = views_nchw(synth_mv_gop(np.random.default_rng(0), views=3, size=128,
                                        gop=4)[:, :, :64])
        failed2 = np.array([1, 1, 0], np.float32)
        control = {"launch_pixel_warp_backward": zero_flow_gradient(kw.launch_pixel_warp_backward)}
        mcvc_losses = {
            "MCVC-IA": lambda spec, clip, noise: gop_loss(spec, clip, True, noise, TrainConfig(),
                                                          failed2),
            "MCVC-IA-OLFT": lambda spec, clip, noise: olft_loss(spec, clip, noise, failed2,
                                                                OLFT_RATIO)}
        training["mcvc_card_vs_cpu"] = {
            name: step_card_vs_cpu(name, lambda device, name=name: mcvc_train_spec(name, 3, device),
                                   small, control, loss_fn)
            for name, loss_fn in mcvc_losses.items()}

    def price_touchups(gop, m):
        """The CLI's host pricing of one OLFT step's touch-up labels: bits a
        pixel of the GOP."""
        n = touchup_bytes(m.pop("touch_refs"), m.pop("touch_labels"), m.pop("touch_mask"))
        return {"touch_bpp": n * 8 / (gop.numel() // 3)}

    with phase(f"mcvc-ia-olft and mcvc-ia train {MCVC_VIEWS}x{MCVC_SIZE}x{MCVC_SIZE} GOP{GOP} f32, "
               f"{MCVC_TRAIN_STEPS} steps each, checkpoint round trip"):
        rng = np.random.default_rng(4)
        clips = [views_nchw(synth_mv_gop(rng, views=MCVC_VIEWS, size=MCVC_SIZE, gop=GOP)).cuda()
                 for _ in range(MCVC_TRAIN_STEPS + 1)]
        host_rng = np.random.default_rng(0)  # the CLI's --seed 0 masks
        masks = [sample_view_mask(host_rng, 1, MCVC_VIEWS, max_failed=MCVC_RESILIENCE)
                 for _ in range(MCVC_TRAIN_STEPS + 1)]
        log(f"view masks: {[m.tolist() for m in masks]}")
        per_step = pixel_per_step["mcvc-ia"] = pixel_train_launches("MCVC-IA", GOP - 1)
        log(f"mcvc launches a step, stated beforehand: {per_step}")
        cfg = TrainConfig(learning_rate=MCVC_TRAIN_LR)
        for name in ("MCVC-IA-OLFT", "MCVC-IA"):
            label = name.lower()
            spec, params = mcvc_train_spec(name, MCVC_VIEWS, "cuda")
            start = {k: p.detach().clone() for k, p in params.items()}
            init_fn, step_fn = (make_olft_step(spec, cfg, OLFT_RATIO) if spec.olft
                                else make_train_step(spec, cfg))
            noise = UniformNoise(4)
            params, opt_state, metrics, times, enqueue, launches, plain_calls, peak = train_run(
                label, step_fn, params, init_fn(params), clips[:MCVC_TRAIN_STEPS], noise,
                masks[:MCVC_TRAIN_STEPS], price_touchups if spec.olft else None)
            want = {**zero_counts, **{k: v * MCVC_TRAIN_STEPS for k, v in per_step.items()}}
            require(launches == want, f"{label} launches {launches}, want {want}")
            require(not plain_calls, f"{label} called plain warps: {plain_calls}")
            for k, v in launches.items():
                pixel_launches[k] += v
            moved = {k for k, p in params.items() if not torch.equal(p.detach(), start[k])}
            # OLFT's loss reaches neither the plain decoders (their frames are
            # only the detached references the labels are built from) nor the
            # hyperpriors (no rate term, and the means reach y_hat through the
            # straight-through round alone): those stay bit for bit
            unreached = {k for k in params if spec.olft and k.startswith(OLFT_UNREACHED)}
            log(f"{label}: launches {launches}; plain warp calls none; parameters moved "
                f"{len(moved)} of {len(params)}, of them {len(moved & unreached)} of the "
                f"{len(unreached)} OLFT's loss does not reach")
            require(not moved & unreached, f"{label}: {sorted(moved & unreached)} moved")
            require(len(moved) >= 0.9 * (len(params) - len(unreached)),
                    f"{label}: the parameters did not move")
            moved = len(moved)
            row = training[f"{label}_{MCVC_VIEWS}x{MCVC_SIZE}_gop{GOP}"] = {
                **run_summary(label, metrics, times, enqueue, peak, 2), "launches": launches,
                "moved": moved}
            if spec.olft:
                row["touch_bpp"] = [m["touch_bpp"] for m in metrics]
                log(f"{label}: touch-up bits a pixel by step {row['touch_bpp']}")
                state = {"params": {n: p.detach() for n, p in params.items()},
                         "opt_state": opt_state}
                with tempfile.TemporaryDirectory() as d:
                    save_checkpoint(d, state, best=True)
                    loaded = load_checkpoint(d)
                require(equal_trees(loaded, state),
                        f"{label}: the checkpoint did not round-trip bit for bit")
                with torch.no_grad():
                    for n, p in params.items():
                        p.copy_(loaded["params"][n])
                opt_state = {g: {"count": v["count"], **{k: {n: t.cuda() for n, t in v[k].items()}
                                                        for k in ("mu", "nu")}}
                             for g, v in loaded["opt_state"].items()}
                params, opt_state, m = step_fn(params, opt_state, clips[MCVC_TRAIN_STEPS], noise,
                                               masks[MCVC_TRAIN_STEPS])
                m = {**price_touchups(clips[MCVC_TRAIN_STEPS], m),
                     **{k: float(v) for k, v in m.items()}}
                require(all(np.isfinite(v) for v in m.values()), f"step after the round trip {m}")
                require(opt_state["main"]["count"] == MCVC_TRAIN_STEPS + 1, "optimizer count")
                log(f"{label} checkpoint: params and optimizer state equal bit for bit after "
                    f"save_checkpoint/load_checkpoint; the next step ran: {m}")
                del state, loaded
            else:
                captured = pixel_captured["mcvc-ia"] = {b: [] for b in PIXEL_BACKWARD}
                with capture_backward(captured):
                    step_fn(params, opt_state, clips[MCVC_TRAIN_STEPS], noise,
                            masks[MCVC_TRAIN_STEPS])
            del spec, params, opt_state, start
        del clips
        torch.cuda.empty_cache()

    with phase(f"mcvc-ia-olft-tiny online fine-tuning on a shifted category, {OLFT_STEPS} "
               f"steps, held-out psnr"):
        # JAX's tests/test_aux.py TestOlftImprovesHeldout on the card
        spec = get_codec_model("MCVC-IA-OLFT-TINY", num_views=3)
        load_asset(spec.module, "tiny_mcvc_l3")
        every_view = np.ones(3, np.float32)

        def shifted(rng):
            return views_nchw(synth_mv_gop(rng) ** OLFT_GAMMA).cuda()  # the "new category"

        def heldout_psnr():
            rng = np.random.default_rng(555)
            return float(np.mean([float(torch.mean(rollout(spec, shifted(rng), every_view)[1]
                                                   ["psnr"])) for _ in range(3)]))

        base = heldout_psnr()
        params = ready_for_training(spec)
        init_fn, step_fn = make_olft_step(spec, TrainConfig(learning_rate=1e-5), OLFT_RATIO)
        opt_state, rng, noise = init_fn(params), np.random.default_rng(77), UniformNoise(77)
        kw.reset_launches()
        for _ in range(OLFT_STEPS):
            params, opt_state, m = step_fn(params, opt_state, shifted(rng), noise, every_view)
        torch.cuda.synchronize()
        olft_launches = {k: v for k, v in kw.LAUNCHES.items() if v}
        after = heldout_psnr()
        log(f"olft on the card ({smi}): held-out psnr {base:.4f} -> {after:.4f} dB "
            f"({after - base:+.4f}; bar +{OLFT_GAIN_DB}, JAX measured +1.32 on the CPU) after "
            f"{OLFT_STEPS} steps; launches {olft_launches}; last step "
            f"{ {k: float(v) for k, v in m.items() if v.dim() == 0} }")
        require(olft_launches == {k: 3 * OLFT_STEPS for k in ("pixel_warp", "pixel_warp_backward")},
                f"olft launches {olft_launches}")
        require(after - base > OLFT_GAIN_DB, f"OLFT gained {after - base:.4f} dB")
        training["olft_heldout"] = {"base_psnr": base, "after_psnr": after, "gain_db": after - base,
                                    "launches": olft_launches}
        del spec, params, opt_state

    with phase("pixel warps' backward kernel timing (f32, one training step's launches)"):
        # pixel_warp_s2d has no caller: time it on the sflow's inputs, its
        # phase flow unpacked to full resolution
        for path in ("ssf-tpu", "elfvc-sp-tpu"):
            c = pixel_captured[path]
            c["pixel_warp_s2d_backward"] = [
                (img, _full_res_flow(flow).contiguous(), grad, ni, nf)
                for img, flow, grad, ni, nf in c["pixel_warp_s2d_sflow_backward"]]
        # the kernel's own row: ELFVC-SP's (cli/train.py's default) for
        # pixel_warp, ELFVC-SP-TPU's for the s2d forms; the others by path
        top_path = {"pixel_warp_backward": "elfvc-sp", "pixel_warp_s2d_backward": "elfvc-sp-tpu",
                    "pixel_warp_s2d_sflow_backward": "elfvc-sp-tpu"}
        pixel_timing = {b: {} for b in PIXEL_BACKWARD}
        for path, captured in pixel_captured.items():
            for bname, inputs in captured.items():
                # pixel_warp_s2d_backward's inputs are the sflow's, unpacked
                want_n = (len(inputs) if bname == "pixel_warp_s2d_backward"
                          else pixel_per_step[path].get(bname, 0))
                require(len(inputs) == want_n, f"{bname} on {path}: captured {len(inputs)}")
                if not inputs:
                    continue
                name = PIXEL_BACKWARD[bname]
                require(all(not ni and nf for *_, ni, nf in inputs),
                        f"{bname} on {path}: an image gradient was asked for")
                r = {"ms": 0.0, "cold_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "floor_ms": 0.0, "library_ms": 0.0 if name == "pixel_warp" else None,
                     "launches": len(inputs),
                     "shape": f"{tuple(inputs[0][0].shape)} flow {tuple(inputs[0][1].shape)}"}
                for img, flow, grad, need_img, need_flow in inputs:
                    hold_backward(bname, img, flow, grad, need_img, f"{bname} on {path}'s inputs",
                                  need_flow=need_flow)
                    args = (img, flow, grad, need_img, need_flow)
                    r["ms"] += cuda_ms(torch, backward_kernels[bname], *args, iters=10)
                    r["cold_ms"] += cold_ms(torch, backward_kernels[bname], *args, flush=flush,
                                            reps=3)
                    r["plain_ms"] += cuda_ms(torch, backward_plains[bname], *args, iters=2,
                                             warmup=1)
                    r["bound_ms"] += backward_bound_ms(img, flow, need_img, need_flow)
                    r["floor_ms"] += cold_ms(torch, kw.launch_backward_floor, name, img,
                                             flush=flush, reps=3)
                    if name == "pixel_warp":
                        r["library_ms"] += cuda_ms(torch, grid_sample_fb, img, pixel_grid(flow),
                                                   grad, need_img, need_flow, iters=10)
                r["device_ms"] = device_ms(torch, backward_kernels[bname], inputs)[0]
                pixel_timing[bname][path] = r
                library = ("F.grid_sample forward + backward, prepared grid"
                           if name == "pixel_warp" else "none: no single PyTorch call")
                log(f"{bname} on {path}'s training step ({smi}): {r['launches']} launches of "
                    f"{r['shape']}, flow gradient only: kernel {r['ms']:.4f} ms (L2 flushed "
                    f"before each: {r['cold_ms']:.4f}; device time under the profiler "
                    f"{r['device_ms']}), bound {r['bound_ms']:.4f} (bytes at 3.35 TB/s), launch "
                    f"floor {r['floor_ms']:.4f} (an empty kernel on each launch's grid, L2 "
                    f"flushed), plain vjp {r['plain_ms']:.4f}, library {r['library_ms']} "
                    f"({library}); ptxas {ptxas_report(build.build_log(), BACKWARD_ENTRY[bname])}")
        for bname, path in top_path.items():
            rows[bname] = pixel_timing[bname][path]
            lib[bname] = rows[bname]["library_ms"]
        del pixel_captured, flush
    training["pixel_backward_timing"] = pixel_timing

    # ---- training: DVC, RLVC (RLVC2, RLVC-HP) and Base-EC-ER at full width, float32 ----
    from fastvideocodec_torch.cli import train as train_cli
    from fastvideocodec_torch.ops import ms_ssim
    from fastvideocodec_torch.train.trainer import msssim_distortion

    def chain_train_spec(name, device, loss_type="P", dtype=torch.float32):
        """``name`` at full width on seeded_flat(name, 0) with the pretrained
        SpyNet, readied for training in ``dtype``: (spec, params)."""
        spec = get_codec_model(name, device=device, loss_type=loss_type)
        load_flat(spec.module, seeded_flat(name, 0))
        load_pretrained_spynet(spec.module.optic_flow)
        return spec, ready_for_training(spec, dtype)

    def chain_cfg(name):
        return TrainConfig(learning_rate=TRAIN_LR, soft2hard=name in SOFT2HARD)

    with phase("dvc, rlvc and base-ec-er training step, card vs cpu, 64x128 GOP4 f32, "
               "soft2hard on, deterministic cuDNN"), deterministic_convs():
        # cuDNN's deterministic algorithms on the card: with its default
        # (atomic) backward algorithms the seeded DVC step's SpyNet gradient,
        # a small sum of large terms, moved 4.0e-2 of its max from one card
        # run to the next on an H100; deterministic, card runs are bit for
        # bit equal and 3.8e-5 from the CPU on the card's branches
        clip = synth_gop_multi(np.random.default_rng(0), size=128, gop=4)[:, :64, :128]
        control = {"launch_flow_warp_backward": zero_flow_gradient(kw.launch_flow_warp_backward)}
        training["chain_card_vs_cpu"] = {
            name: step_card_vs_cpu(
                name, lambda device, name=name: chain_train_spec(name, device), nchw_clip(clip),
                control, lambda spec, c, noise, name=name: gop_loss(spec, c, True, noise,
                                                                     chain_cfg(name)))
            for name in ("DVC", "RLVC", "Base-EC-ER")}

    chain_per_step, chain_train_counts = {}, {}
    with phase(f"dvc, rlvc, base-ec-er, rlvc2, rlvc-hp train {BATCH_CLIPS} x {BATCH_GOP} x "
               f"{TRAIN_SIZE}x{TRAIN_SIZE} f32, steps {CHAIN_TRAIN}"):
        # cli/train.py's default batch; one synth_gop_multi clip an item
        rng = np.random.default_rng(5)
        batches = [torch.stack([nchw_clip(synth_gop_multi(rng, size=TRAIN_SIZE, gop=BATCH_GOP))
                                for _ in range(BATCH_CLIPS)]).cuda()
                   for _ in range(max(CHAIN_TRAIN.values()) + 1)]
        for name, steps in CHAIN_TRAIN.items():
            label = name.lower()
            spec, params = chain_train_spec(name, "cuda")
            init_fn, step_fn = make_train_step(spec, chain_cfg(name), batched=True)
            per_step = chain_per_step[label] = chain_train_launches(
                name, BATCH_CLIPS * (BATCH_GOP - 1))
            log(f"{label} launches a step, stated beforehand: {per_step}")
            start = {k: p.detach().clone() for k, p in params.items()}
            params, opt_state, metrics, times, enqueue, launches, plain_calls, peak = train_run(
                label, step_fn, params, init_fn(params), batches[:steps], UniformNoise(5))
            want = {**zero_counts, **{k: v * steps for k, v in per_step.items()}}
            require(launches == want, f"{label} launches {launches}, want {want}")
            require(not plain_calls, f"{label} called plain warps: {plain_calls}")
            chain_train_counts[label] = launches
            moved = sum(not torch.equal(p.detach(), start[k]) for k, p in params.items())
            log(f"{label}: launches {launches}; plain warp calls none; parameters moved {moved} "
                f"of {len(params)}")
            require(moved >= 0.9 * len(params), f"{label}: the parameters did not move")
            training[f"{label}_4x7x256"] = {**run_summary(label, metrics, times, enqueue, peak,
                                                          2 if steps > 3 else 1),
                                            "launches": launches, "moved": moved}
            if name == "DVC":  # one more step with the warps' inputs captured
                chain_bwd, chain_fwd = {"flow_warp_backward": []}, {}
                with capture_backward(chain_bwd), capture_warp_inputs(chain_fwd):
                    step_fn(params, opt_state, batches[steps], UniformNoise(6))
                chain_fwd = [(img.detach(), flow.detach()) for img, flow in chain_fwd["flow_warp"]]
                chain_bwd = chain_bwd["flow_warp_backward"]
            del spec, params, opt_state, start
        del batches
        torch.cuda.empty_cache()

    with phase(f"cli/train.py --codec DVC --loss-type M, {CLI_CLIPS} clips of 7 x 256x448 PNGs, "
               f"1 epoch of {CLI_STEPS} steps, MS-SSIM card vs cpu"):
        from PIL import Image

        step_metrics = []

        def recording(spec, cfg, **kw_args):
            init_fn, step_fn = make_train_step(spec, cfg, **kw_args)

            def step(*args):
                out = step_fn(*args)
                step_metrics.append({k: float(v) for k, v in out[2].items()})
                return out
            return init_fn, step

        rng = np.random.default_rng(7)
        with tempfile.TemporaryDirectory() as d:
            root = Path(d) / "vimeo"
            names = []
            for k in range(CLI_CLIPS):
                seq = root / "sequences" / f"{k:05d}" / "0001"
                seq.mkdir(parents=True)
                for i, frame in enumerate(synth_gop_multi(rng, size=448, gop=7)[:, :256],
                                          start=1):
                    Image.fromarray((frame * 255).astype(np.uint8)).save(seq / f"im{i}.png")
                names.append(f"{k:05d}/0001")
            (root / "sep_trainlist.txt").write_text("\n".join(names) + "\n")
            saved = train_cli.make_train_step
            train_cli.make_train_step = recording
            kw.reset_launches()
            try:
                train_cli.main(["--codec", "DVC", "--loss-type", "M", "--dataset-dir", str(root),
                                "--epochs", "1", "--steps-per-epoch", str(CLI_STEPS),
                                "--ckpt-dir", str(Path(d) / "ckpt")])
            finally:
                train_cli.make_train_step = saved
            torch.cuda.synchronize()
            cli_launches = {k: v for k, v in kw.LAUNCHES.items() if v}
            state = load_checkpoint(str(Path(d) / "ckpt" / "DVC-2M"), prefer_best=False)
        want = chain_train_launches("DVC", CLI_STEPS * BATCH_CLIPS * (BATCH_GOP - 1))
        log(f"cli --codec DVC --loss-type M ({smi}): steps {step_metrics}; launches "
            f"{cli_launches} (want {want}); checkpoint epoch {state['epoch']} score "
            f"{state['score']}")
        require(len(step_metrics) == CLI_STEPS and all(
            np.isfinite(v) for m in step_metrics for v in m.values()), "cli: a metric")
        require(cli_launches == want, f"cli launches {cli_launches}, want {want}")
        require(state["opt_state"]["main"]["count"] == CLI_STEPS and np.isfinite(state["score"]),
                "cli: the checkpoint")
        # img_loss under M is 1 - ms_ssim of the recon: the checkpoint's
        # weights on one clip, the metric against the recon's MS-SSIM on the
        # card and on the CPU (the same recon)
        spec = get_codec_model("DVC", loss_type="M")
        with torch.no_grad():
            for n, p in spec.module.named_parameters():
                p.copy_(state["params"][n])
        clip = nchw_clip(synth_gop_multi(np.random.default_rng(8), size=TRAIN_SIZE,
                                         gop=BATCH_GOP)).cuda()
        _, m = gop_loss(spec, clip, False, None, TrainConfig())
        recon, _ = rollout(spec, clip)
        card_q = float(ms_ssim(recon.float(), clip[1:]))
        cpu_q = float(ms_ssim(recon.float().cpu(), clip[1:].cpu()))
        rel = abs(card_q - cpu_q) / cpu_q
        log(f"cli checkpoint: img_loss {float(m['img_loss']):.7f} = 1 - ms_ssim "
            f"{1 - card_q:.7f}; ms_ssim of one recon card {card_q:.7f} cpu {cpu_q:.7f} (rel "
            f"{rel:.2e}, tolerance {MSSSIM_CARD_CPU_REL}); msssim_distortion "
            f"{float(msssim_distortion(spec, recon, clip)):.7f}")
        require(abs(float(m["img_loss"]) - (1 - card_q)) <= MSSSIM_CARD_CPU_REL,
                "cli: img_loss is not 1 - ms_ssim")
        require(rel <= MSSSIM_CARD_CPU_REL, f"ms_ssim card vs cpu {rel}")
        training["cli_dvc_msssim"] = {"steps": step_metrics, "launches": cli_launches,
                                      "score": state["score"], "ms_ssim_card": card_q,
                                      "ms_ssim_cpu": cpu_q, "ms_ssim_rel": rel}
        del spec, state, clip, recon

    with phase("flow_warp and flow_warp_backward on DVC's training step (f32, 4 x 7 x "
               "256x256: 120 and 96 launches)"):
        flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
        per_dvc = chain_per_step["dvc"]
        require(len(chain_fwd) == per_dvc["flow_warp"] and
                len(chain_bwd) == per_dvc["flow_warp_backward"],
                f"captured {len(chain_fwd)} forward and {len(chain_bwd)} backward launches")
        require(all(not ni and nf for *_, ni, nf in chain_bwd), "an image gradient was asked for")

        def by_shape(inputs):
            groups = {}
            for args in inputs:
                groups.setdefault(tuple(args[0].shape[-2:]), []).append(args)
            return groups

        fwd_rows, bwd_rows = {}, {}
        for hw, inputs in sorted(by_shape(chain_fwd).items()):
            drows, dlib = {}, {}
            time_kernels(("flow_warp",), {"flow_warp": inputs}, drows, dlib,
                         lambda name, img, flow: cuda_ms(torch, grid_sample, img,
                                                         sample_grid(flow)))
            t = fwd_rows[f"{hw[0]}x{hw[1]}"] = {
                **{k: drows["flow_warp"][k] for k in ("ms", "cold_ms", "plain_ms", "bound_ms",
                                                      "smooth_ms", "random_ms")},
                "library_ms": dlib["flow_warp"], "launches": len(inputs),
                "device_ms": device_ms(torch, kernels["flow_warp"], inputs)[0],
                "library_device_ms": device_ms(torch, grid_sample, [
                    (img, sample_grid(flow)) for img, flow in inputs])[0]}
            log(f"flow_warp forward, DVC training step, {len(inputs)} launches of "
                f"{tuple(inputs[0][0].shape)} ({smi}): warm {t['ms']:.4f} ms, L2 flushed "
                f"{t['cold_ms']:.4f}, device {t['device_ms']}, bound {t['bound_ms']:.4f}, plain "
                f"{t['plain_ms']:.4f}, F.grid_sample {t['library_ms']:.4f} (device "
                f"{t['library_device_ms']})")
        for hw, inputs in sorted(by_shape(chain_bwd).items()):
            r = bwd_rows[f"{hw[0]}x{hw[1]}"] = {
                "ms": 0.0, "cold_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "floor_ms": 0.0,
                "library_ms": 0.0, "launches": len(inputs)}
            for img, flow, grad, need_img, need_flow in inputs:
                hold_backward("flow_warp_backward", img, flow, grad, need_img,
                              "flow_warp_backward on DVC's training inputs")
                args = (img, flow, grad, need_img, need_flow)
                r["ms"] += cuda_ms(torch, backward_kernels["flow_warp_backward"], *args, iters=10)
                r["cold_ms"] += cold_ms(torch, backward_kernels["flow_warp_backward"], *args,
                                        flush=flush, reps=3)
                r["plain_ms"] += cuda_ms(torch, backward_plains["flow_warp_backward"], *args,
                                         iters=2, warmup=1)
                r["bound_ms"] += backward_bound_ms(*args[:2], need_img, need_flow)
                r["floor_ms"] += cold_ms(torch, kw.launch_backward_floor, "flow_warp", img,
                                         flush=flush, reps=3)
                r["library_ms"] += cuda_ms(torch, grid_sample_fb, img, sample_grid(flow), grad,
                                           need_img, need_flow, iters=10)
            r["device_ms"] = device_ms(torch, backward_kernels["flow_warp_backward"], inputs)[0]
            log(f"flow_warp_backward, DVC training step, {len(inputs)} launches of "
                f"{tuple(inputs[0][0].shape)}, flow gradient only ({smi}): warm {r['ms']:.4f} "
                f"ms, L2 flushed {r['cold_ms']:.4f}, device {r['device_ms']}, bound "
                f"{r['bound_ms']:.4f}, launch floor {r['floor_ms']:.4f}, plain vjp "
                f"{r['plain_ms']:.4f}, F.grid_sample forward + backward {r['library_ms']:.4f}")
        for what, table in (("forward", fwd_rows), ("backward", bwd_rows)):
            keys = [k for k in next(iter(table.values())) if k != "launches"]
            total = table["step"] = {
                k: None if any(t[k] is None for t in table.values()) else
                sum(t[k] for t in table.values()) for k in keys + ["launches"]}
            log(f"flow_warp {what} over DVC's training step ({smi}): {total}")
        training["dvc_train_flow_warp"] = {"forward": fwd_rows, "backward": bwd_rows}
        del chain_fwd, chain_bwd, flush

    # ---- training in bf16: flax's mixed precision (float32 masters) ----
    from fastvideocodec_torch.layers.blocks import cast_once

    def bf16_case(name, device, dtype):
        """(spec, params, clip, mask, cfg) of a BF16_CASES codec at 64x128,
        GOP 4, as phases 42-53 build it in float32: LSVC-TPU on
        hd_lsvctpuf2_l2, the others on seeded_flat (MCVC-IA over 3 views
        with view 2 failed, DVC with the pretrained SpyNet)."""
        if name == "LSVC-TPU":
            spec, params = train_spec(device, dtype)
        elif name == "MCVC-IA":
            spec, params = mcvc_train_spec(name, 3, device, dtype)
        elif name == "DVC":
            spec, params = chain_train_spec(name, device, dtype=dtype)
        else:
            spec, params = seeded_train_spec(name, device, dtype)
        if name == "MCVC-IA":
            clip = views_nchw(synth_mv_gop(np.random.default_rng(0), views=3, size=128,
                                           gop=4)[:, :, :64])
            mask = np.array([1, 1, 0], np.float32)
        else:
            clip = nchw_clip(synth_gop_multi(np.random.default_rng(0), size=128,
                                             gop=4)[:, :64, :128])
            mask = None
        return spec, params, clip.to(device), mask, TrainConfig(learning_rate=TRAIN_LR)

    def bf16_grads(name, device, dtype, launchers=None):
        """One gop_loss backward of ``name`` (``bf16_case``) on ``device``
        in ``dtype``, the masters cast once as make_train_step casts them,
        the noise drawn on the host from seed 0; ``launchers`` put in place
        of kernel launchers for the run: (float32 gradients on the host,
        the loss)."""
        saved = {n: getattr(kw, n) for n in launchers or {}}
        try:
            for n, fn in (launchers or {}).items():
                setattr(kw, n, fn)
            spec, params, clip, mask, cfg = bf16_case(name, device, dtype)
            with cast_once():
                loss, _ = gop_loss(spec, clip, True, UniformNoise(0, device="cpu"), cfg, mask)
                loss.backward()
        finally:
            for n, fn in saved.items():
                setattr(kw, n, fn)
        require(all(p.dtype == torch.float32 for p in params.values()), f"{name}: a master")
        return {n: g.detach().float().cpu() for n, g in grads_of(params).items()}, float(loss)

    bf16_rows = {"card": smi}
    with phase("bf16 training step, card against its own float32 step and the cpu's drift, "
               "64x128 GOP4, deterministic cuDNN"), deterministic_convs():
        for name in BF16_CASES:
            scale = BF16_MCVC_CONTROL_SCALE if name == "MCVC-IA" else 0.0
            control = {f"launch_{b}": zero_flow_gradient(getattr(kw, f"launch_{b}"), scale)
                       for b in BACKWARD}
            card32, loss32 = bf16_grads(name, "cuda", torch.float32)
            card16, loss16 = bf16_grads(name, "cuda", torch.bfloat16)
            cpu32, _ = bf16_grads(name, "cpu", torch.float32)
            cpu16, _ = bf16_grads(name, "cpu", torch.bfloat16)
            ctl16, _ = bf16_grads(name, "cuda", torch.bfloat16, control)
            card, cpu = grad_drifts(torch, card16, card32), grad_drifts(torch, cpu16, cpu32)
            cross, gap32 = grad_drifts(torch, card16, cpu16), grad_drifts(torch, card32, cpu32)
            ctl = grad_drifts(torch, ctl16, card32)
            misses, ctl_misses = bf16_misses(card, cpu, cross, gap32), bf16_misses(ctl, cpu)
            log(f"{name} bf16 step ({smi}): loss f32 {loss32:.6f} bf16 {loss16:.6f}; bf16 "
                f"gradient's relative L2 distance from float32 on the card {card['whole']:.4e}, "
                f"on the cpu {cpu['whole']:.4e} (bar {BF16_DRIFT} x the cpu's); by submodule "
                f"card / cpu {({k: f'{card[k]:.3e} / {cpu[k]:.3e}' for k in cpu if k != 'whole'})}")
            log(f"{name} bf16 card from the cpu's bf16 gradient {cross['whole']:.4e} (bar "
                f"{1 + BF16_DRIFT} x the cpu's drift + the float32 gap {gap32['whole']:.2e}); "
                f"by submodule {({k: f'{cross[k]:.3e}' for k in cross if k != 'whole'})}")
            log(f"{name} bf16 control (flow gradient {'x ' + str(scale) if scale else 'zeroed'})"
                f": whole {ctl['whole']:.4e}; misses {ctl_misses}")
            require(not misses, f"{name}: the bf16 card step misses {misses}")
            require(ctl_misses, f"{name}: the bf16 control passed every bar")
            bf16_rows[f"{name}_card_vs_cpu_drift"] = {"card": card, "cpu": cpu, "control": ctl,
                                                      "card_from_cpu": cross, "gap32": gap32,
                                                      "loss": [loss32, loss16]}
            del card32, card16, cpu32, cpu16, ctl16
        torch.cuda.empty_cache()

    def moments_f32(opt_state) -> bool:
        return all(t.dtype == torch.float32 for g in ("main", "aux") for k in ("mu", "nu")
                   for t in opt_state[g][k].values())

    # the float32 phases' shapes: (label, make(dtype) -> (spec, params),
    # batches, masks, batched, cfg)
    rng = np.random.default_rng(9)
    clips256 = [nchw_clip(synth_gop_multi(rng, size=TRAIN_SIZE, gop=TRAIN_GOP)).cuda()
                for _ in range(BF16_STEPS + 1)]
    views256 = [views_nchw(synth_mv_gop(rng, views=MCVC_VIEWS, size=MCVC_SIZE, gop=GOP)).cuda()
                for _ in range(BF16_STEPS + 1)]
    batches256 = [torch.stack([nchw_clip(synth_gop_multi(rng, size=TRAIN_SIZE, gop=BATCH_GOP))
                               for _ in range(BATCH_CLIPS)]).cuda()
                  for _ in range(BF16_STEPS + 1)]
    alive = [np.ones(MCVC_VIEWS, np.float32)] * (BF16_STEPS + 1)
    cfg = TrainConfig(learning_rate=TRAIN_LR)
    bf16_runs = [
        ("lsvc-tpu", lambda dtype: train_spec("cuda", dtype), clips256, None, False),
        ("ssf-tpu", lambda dtype: seeded_train_spec("SSF-TPU", "cuda", dtype), clips256, None,
         False),
        ("elfvc-sp-tpu", lambda dtype: seeded_train_spec("ELFVC-SP-TPU", "cuda", dtype),
         clips256, None, False),
        ("mcvc-ia", lambda dtype: mcvc_train_spec("MCVC-IA", MCVC_VIEWS, "cuda", dtype),
         views256, alive, False),
        ("dvc", lambda dtype: chain_train_spec("DVC", "cuda", dtype=dtype), batches256, None,
         True),
    ]
    bf16_captured = {}
    with phase(f"bf16 training at the float32 phases' shapes, {BF16_STEPS} steps each beside "
               f"{BF16_STEPS} float32 steps: lsvc-tpu and ssf-tpu and elfvc-sp-tpu "
               f"{TRAIN_SIZE}x{TRAIN_SIZE} GOP{TRAIN_GOP}, mcvc-ia {MCVC_VIEWS}x{MCVC_SIZE}x"
               f"{MCVC_SIZE} GOP{GOP}, dvc {BATCH_CLIPS} x {BATCH_GOP} x {TRAIN_SIZE}x"
               f"{TRAIN_SIZE}"):
        for label, make, batches, masks, batched in bf16_runs:
            row = {}
            for dtype in (torch.float32, torch.bfloat16):
                dname = "bf16" if dtype == torch.bfloat16 else "f32"
                spec, params = make(dtype)
                init_fn, step_fn = make_train_step(spec, cfg, batched=batched)
                params, opt_state, metrics, times, enqueue, launches, plain_calls, peak = \
                    train_run(f"{label} {dname}", step_fn, params, init_fn(params),
                              batches[:BF16_STEPS], UniformNoise(9),
                              None if masks is None else masks[:BF16_STEPS])
                require(not plain_calls, f"{label} {dname} called plain warps: {plain_calls}")
                require(all(p.dtype == torch.float32 for p in params.values())
                        and moments_f32(opt_state), f"{label} {dname}: a parameter or an Adam "
                        f"moment is not float32")
                row[dname] = {**run_summary(f"{label} {dname}", metrics, times, enqueue, peak, 1),
                              "launches": {k: v for k, v in launches.items() if v}}
                if dtype == torch.bfloat16:  # one more step, its backward inputs captured
                    captured = {b: [] for b in BACKWARD}
                    with capture_backward(captured):
                        step_fn(params, opt_state, batches[BF16_STEPS], UniformNoise(10),
                                *([] if masks is None else [masks[BF16_STEPS]]))
                    row["bf16_backward_dtypes"] = {
                        b: sorted({str(x[0].dtype).split(".")[1] for x in v})
                        for b, v in captured.items() if v}
                    bf16_captured[label] = {  # the launches of the bf16 kernels
                        b: [x for x in v if x[0].dtype == torch.bfloat16]
                        for b, v in captured.items()}
                    del captured
                del spec, params, opt_state
            require(row["bf16"]["launches"] == row["f32"]["launches"],
                    f"{label}: bf16 launches {row['bf16']['launches']}, float32 "
                    f"{row['f32']['launches']}")
            log(f"{label} ({smi}): ms/step median f32 {row['f32']['ms_median']:.3f} bf16 "
                f"{row['bf16']['ms_median']:.3f}; enqueue f32 {row['f32']['enqueue_median']:.3f} "
                f"bf16 {row['bf16']['enqueue_median']:.3f}; peak GiB f32 "
                f"{row['f32']['peak_gib']:.3f} bf16 {row['bf16']['peak_gib']:.3f}; launches "
                f"{row['bf16']['launches']} (equal); the bf16 step's backward kernels' image "
                f"dtypes {row['bf16_backward_dtypes']}")
            bf16_rows[f"{label}_train"] = row
            torch.cuda.empty_cache()
        del clips256, views256, batches256

    bf16_timing = {}  # backward name: {path: the bf16 kernel's numbers on that step}
    with phase("bf16 backward kernels on the bf16 training steps' bf16 launches, against "
               "the float32 plain vjp"):
        require(bf16_captured["mcvc-ia"]["pixel_warp_backward"],
                "MCVC-IA's bf16 step launched no bf16 pixel_warp_backward")
        flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
        bf16 = torch.bfloat16
        for label, captured in bf16_captured.items():
            for bname, inputs in captured.items():
                if not inputs:
                    continue
                name = BACKWARD[bname]
                r = {"ms": 0.0, "cold_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "library_ms": 0.0 if name in NCHW_KERNELS else None,
                     "launches": len(inputs), "max_abs_err": 0.0}
                for img, flow, grad, need_img, need_flow in inputs:
                    args = (img, flow, grad, need_img, need_flow)
                    r["max_abs_err"] = max(r["max_abs_err"], hold_backward(
                        bname, img, flow, grad, need_img, f"{bname} bf16 on {label}'s step",
                        "bfloat16", need_flow))
                    r["ms"] += cuda_ms(torch, backward_kernels[bname], *args, iters=10)
                    r["cold_ms"] += cold_ms(torch, backward_kernels[bname], *args, flush=flush,
                                            reps=3)
                    r["plain_ms"] += cuda_ms(torch, backward_plains[bname], *args, iters=2,
                                             warmup=1)
                    r["bound_ms"] += backward_bound_ms(img, flow, need_img, need_flow)
                    if r["library_ms"] is not None:
                        grid = sample_grid(flow) if name == "flow_warp" else pixel_grid(flow)
                        r["library_ms"] += cuda_ms(torch, grid_sample_fb, img, grid.to(bf16),
                                                   grad, need_img, need_flow, iters=10)
                r["device_ms"] = device_ms(torch, backward_kernels[bname], inputs)[0]
                bf16_timing.setdefault(bname, {})[label] = r
                log(f"{bname} bf16 on {label}'s training step ({smi}), {len(inputs)} launches "
                    f"of {tuple(inputs[0][0].shape)}: warm "
                    f"{r['ms']:.4f} ms, L2 flushed {r['cold_ms']:.4f}, device {r['device_ms']}, "
                    f"bound {r['bound_ms']:.4f} (bytes at bf16), plain vjp {r['plain_ms']:.4f}, "
                    f"F.grid_sample forward + backward in bf16 {r['library_ms']}, max abs err "
                    f"{r['max_abs_err']:.3e} (tolerance GRAD_TOL bfloat16 {GRAD_TOL['bfloat16']})")
        del bf16_captured, flush
    bf16_rows["backward_timing"] = bf16_timing

    with phase(f"cli/train.py --bf16 --codec LSVC-TPU, {CLI_CLIPS} clips of 7 x 256x448 PNGs, "
               f"1 epoch of {CLI_STEPS} steps, then --resume for a second"):
        from PIL import Image

        rng = np.random.default_rng(11)
        with tempfile.TemporaryDirectory() as d:
            root = Path(d) / "vimeo"
            names = []
            for k in range(CLI_CLIPS):
                seq = root / "sequences" / f"{k:05d}" / "0001"
                seq.mkdir(parents=True)
                for i, frame in enumerate(synth_gop_multi(rng, size=448, gop=7)[:, :256],
                                          start=1):
                    Image.fromarray((frame * 255).astype(np.uint8)).save(seq / f"im{i}.png")
                names.append(f"{k:05d}/0001")
            (root / "sep_trainlist.txt").write_text("\n".join(names) + "\n")
            args = ["--codec", "LSVC-TPU", "--bf16", "--dataset-dir", str(root),
                    "--steps-per-epoch", str(CLI_STEPS), "--ckpt-dir", str(Path(d) / "ckpt")]
            ckpt = str(Path(d) / "ckpt" / "LSVC-TPU-2P")
            kw.reset_launches()
            train_cli.main([*args, "--epochs", "1"])
            torch.cuda.synchronize()
            cli_launches = {k: v for k, v in kw.LAUNCHES.items() if v}
            first = load_checkpoint(ckpt, prefer_best=False)
            train_cli.main([*args, "--epochs", "2", "--resume"])
            second = load_checkpoint(ckpt, prefer_best=False)
        per_clip = train_launches_of(get_codec_model("LSVC-TPU", device="cpu").module
                                     .schedule(BATCH_GOP - 1).depth)
        want = {k: n * CLI_STEPS * BATCH_CLIPS for k, n in per_clip.items()}
        dtypes = {t.dtype for s in (first, second) for t in s["params"].values()}
        log(f"cli --bf16 --codec LSVC-TPU ({smi}): launches {cli_launches} (want {want}); "
            f"checkpoint after epoch 0: count {first['opt_state']['main']['count']}, score "
            f"{first['score']}; after the resumed epoch 1: count "
            f"{second['opt_state']['main']['count']}, score {second['score']}; parameter "
            f"dtypes {dtypes}")
        require(cli_launches == want, f"cli --bf16 launches {cli_launches}, want {want}")
        require(first["opt_state"]["main"]["count"] == CLI_STEPS and np.isfinite(first["score"])
                and second["epoch"] == 1 and
                second["opt_state"]["main"]["count"] == 2 * CLI_STEPS and
                np.isfinite(second["score"]), "cli --bf16: the checkpoints")
        require(dtypes == {torch.float32}, f"cli --bf16 checkpointed {dtypes}")
        bf16_rows["cli_lsvc_tpu"] = {"launches": cli_launches, "scores": [first["score"],
                                                                         second["score"]]}
        del first, second
    training["bf16"] = bf16_rows
    log(json.dumps({"training": training}))

    # ---- the evaluation path (phases 61-64, tools/eval_smoke.py), then the
    # tools and the last library modules (phases 65-68, tools/tools_smoke.py)
    # on phases 61-62's files ----
    from fastvideocodec_torch.tools import eval_smoke, tools_smoke

    eval_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_eval_"))
    try:
        evaluation = eval_smoke.run(smi, workdir=eval_dir)
        log(json.dumps({"evaluation": evaluation}, default=str))
        tools = tools_smoke.run(smi, eval_dir)
        log(json.dumps({"tools": tools}, default=str))
    finally:
        shutil.rmtree(eval_dir, ignore_errors=True)
    evaluation["launches"].update(tools["launches"])

    # ---- multi-device (phases 69-70, tools/multichip_smoke.py): the four
    # halves of the dry run on gloo ranks time-sharing the card, then a
    # world of one over NCCL ----
    from fastvideocodec_torch.tools import multichip_smoke

    multi = multichip_smoke.run(smi)
    multi_launches = multi.pop("launches")
    log(json.dumps({"multi_device": multi}))

    log(json.dumps({"lsvc_forms": lsvc_rows, "timing": {
        k: {path: {key: t[key] for key in ("ms", "cold_ms", "plain_ms", "bound_ms",
                                           "library_ms", "launches")}
            for path, t in v.items()} for k, v in lsvc_timing.items()}}))

    by_path = {name: {"lsvc_rollout": rollout_launches[name],
                      "lsvc_decode_graph": decode_launches[name],
                      "ssf_rollout": ssf_launches[name],
                      "elfvc_rollout": elfvc_launches[name],
                      "elfvc_real_bits_encode": elfvc_enc[name],
                      "elfvc_real_bits_decode": elfvc_dec[name],
                      "mcvc_rollout": mcvc_launches[name],
                      "mcvc_real_bits_encode": mcvc_enc[name],
                      "mcvc_real_bits_decode": mcvc_dec[name],
                      **{path: n[name] for path, n in stock_launches.items()},
                      **{path: n[name] for path, n in chain_launches.items()},
                      **{path: n[name] for path, n in lsvc_launches.items()},
                      **{f"{path}_train": n[name] for path, n in chain_train_counts.items()},
                      **{path: n.get(name, 0) for path, n in evaluation["launches"].items()},
                      **{path: n.get(name, 0) for path, n in multi_launches.items()}}
                for name in kernels}
    # each kernel's top-level numbers stay on the path that defined them in
    # earlier slices (LSVC-TPU's rollout for the two flow warps, SSF-TPU's
    # timing and ELFVC-SP-TPU's launches for the pixel warps); pixel_warp's
    # C = 18 numbers on MCVC-IA's rollouts stand only under timing_by_path
    launches = {**{k: rollout_launches[k] for k in LSVC_KERNELS},
                **{k: elfvc_launches[k] for k in SSF_KERNELS}}
    timing = {f"mcvc_rollout_{k}": {**v, "launches": mcvc_rows[f"{k} alive"]["launches"]}
              for k, v in mcvc_timing.items()}
    timing.update(stock_timing)
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "launches")
    by_kernel_timing = {"pixel_warp": timing,
                        "flow_warp": {**chain_timing, **lsvc_timing["flow_warp"],
                                      "dvc_train_step": fwd_rows["step"]},
                        "flow_warp_s2d": lsvc_timing["flow_warp_s2d"]}
    report = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": rows[name]["ms"],
            "plain_ms": rows[name]["plain_ms"],
            "bound_ms": rows[name]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": lib[name],
            "launches_by_path": by_path[name],
            **({"timing_by_path": {path: {k: t[k] for k in keys}
                                   for path, t in by_kernel_timing[name].items()}}
               if name in by_kernel_timing else {}),
        }
        for name in kernels
    ] + [
        # the backward kernels: launches over the training runs (the flow
        # warps' over LSVC-TPU's TRAIN_STEPS steps, the pixel warps' over phases 47,
        # 48 and 50), times per step's launches on one step's inputs
        {
            "name": bname,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES[bname],
            "launches": (train_launches if bname in FLOW_BACKWARD else pixel_launches)[bname],
            "max_abs_err": max_err[bname],
            "ms": rows[bname]["ms"],
            "plain_ms": rows[bname]["plain_ms"],
            "bound_ms": rows[bname]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": lib[bname],
            "launches_by_eval_path": {path: n[bname] for path, n in
                                      evaluation["launches"].items() if n.get(bname)},
            # the multi-device steps (phases 69-70): one step, summed over ranks
            "launches_by_path": {path: n.get(bname, 0) for path, n in multi_launches.items()},
            "launches_per_training_step": (
                per_lsvc_step[bname] if bname in FLOW_BACKWARD
                else {path: n.get(bname, 0) for path, n in pixel_per_step.items()}),
            **({"timing_by_path": {path: {k: t[k] for k in keys}
                                   for path, t in pixel_timing[bname].items()}}
               if bname in PIXEL_BACKWARD else {}),
            # DVC, RLVC and Base's training runs (phase 54): launches by codec,
            # and the times of DVC's step's launches
            **({"launches_by_training_path": {path: n[bname]
                                              for path, n in chain_train_counts.items()},
                "timing_by_path": {"dvc_train_step": {k: bwd_rows["step"][k] for k in keys}}}
               if bname == "flow_warp_backward" else {}),
            # the bf16 instantiation on the bf16 training steps' bf16
            # launches, by codec
            **({"bf16_timing_by_path": {path: {k: t[k] for k in (*keys, "cold_ms", "device_ms")}
                                        for path, t in bf16_timing[bname].items()}}
               if bname in bf16_timing else {}),
        }
        for bname in BACKWARD
    ]}
    log(json.dumps(report))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
