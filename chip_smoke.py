#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pnp_vcve_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases (any failure raises and the script exits non-zero):

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build the kernels from pnp_vcve_torch/kernels/csrc (nvcc, sm_90a)
   and print the compiler's register / shared-memory / spill report, each
   model kernel's shared memory by width (and type, for K2-K5), the
   one-launch widths of K3 and K4, and, where the toolkit has cuobjdump,
   the count of tensor-core instructions (HMMA/HGMMA) in each device
   function of the tensor-core kernels K2-K5 (a function with none, or a
   name found nowhere, fails the run); the wgmma designs at 64 channels
   (K2 ``input_conv_wg``, K3 and K3s ``drt_block_wg``, K4 ``head_wg``)
   must hold HGMMA in each of their device functions (2, 4 and 2) and
   spill nothing: their registers, stack and spills are printed, and a
   spill, or fewer such functions in the compiler's report, fails the run;
   the copy probes K13 (``ring_copy_kernel``, ``stream_copy_kernel``) and
   K6 (``window_copy_kernel``) spill nothing, K13's bulk-copy design
   (``ring_copy_kernel``) holds the bulk copy's SASS (``UBLKCP``), and
   ``ring_copy``'s shared memory at depths 0..9 is its wrapper's mirror's
   (``probes.ring_schedule``) and fits; K10's int8 wgmma design
   (``tapconv8_wg``, 4- and 8-row items) holds the integer warpgroup MMA
   (``IGMMA``) and no ``mma.sync`` (``IMMA``) in each of its 2 device
   functions, spills nothing, and its shared memory at the probe's 16 x
   320 x 128 -> 128 is its wrapper's mirror's (``probes.tapconv8_schedule``);
   K11 (``gather2_kernel``) spills nothing;
3. each kernel against its plain PyTorch version at the main path's shapes
   (b=1, 720x1280, 64 channels), at b=4 on a smaller frame (256x448) and at
   ragged sizes (36x52; 40x56 for K1b, which needs multiples of 8), in
   float32 (TF32 off; max|diff| <= 1e-4 std) and bfloat16 (max < 0.02 std,
   mean < 0.002 std; the warps 0.08 / 0.01; the input conv's and K5's max
   0.04 std, see BF16_BOUNDS); K1b on block-constant flows up to +-24 px,
   so that its +-16 px clamp bites; K3s's new_last_key bitwise equal to ``torch.where``
   on its own out for a keyframe sample and a non-keyframe one; K3 also
   called with the argument order of the TPU's per-block DRT kernels
   (``drt_block_pallas``, ``drt_block_packed``); K5 (the per-sample 3x3
   conv) at 64 -> 64, at 720p also for b=2 with its own kernels per
   sample, and at the ragged size for c_in in {3, 8, 64, 131} and c_out in
   {8, 64, 128}; K1, K1b, K2, K3 and K4 also at the widths 8, 24 and 128 at
   the ragged sizes in both types (weights scaled by 8 / sqrt(c)), K3 at
   216 and 392 and K4 at 192 (above their one-launch widths: two launches
   through a scratch, K3 at 216 in bfloat16 one) at the ragged size in both
   types and at 720p in float32 (K3 216, K4 192), and K2, K3 and K4 at
   720p at 128 channels, timed beside their bounds (K3s runs at 64 only,
   the pf path's width); the wrappers' width limits (``launch.MAX_WIDTH``,
   ``launch.ONE_LAUNCH_WIDTH``) must be the widest blocks the sources'
   shared memory formulas fit (phase 2). At 720p each is timed with CUDA
   events in turns (plain, kernel, kernel, plain) in float32 and bfloat16,
   beside one PyTorch call that computes the same function where there is
   one (``F.grid_sample`` for the warps, one channels-last ``F.conv2d``
   over the concatenated parts in the same type for the input conv, one
   ``F.conv2d`` with ``groups=b`` for K5), its yardsticks (K1b: K1 on the
   same flow; K3s: K3 plus ``torch.where``; K2 (both part counts), K3, K3s
   and K4 at 64 channels: the mma.sync design their wgmma design replaced,
   ``mma_sync_ms``, through the C entries ``pnp_input_conv_mma_sync``,
   ``pnp_drt_block_mma_sync`` and ``pnp_head_mma_sync`` that no model path
   calls, held to the plain version under the same bounds; each yardstick
   timed between the kernel's two timings, kernel, yardstick, yardstick,
   kernel) and the
   card's bounds for the
   work: bytes over 3.35 TB/s, and operations over 67 TFLOP/s (float32
   CUDA cores), three TF32 products each over 495 TFLOP/s (3xTF32, the
   route of the float32 K2-K5) and 989 TFLOP/s (bf16 tensor
   cores); a kernel's bound is the larger of its bytes and the operations
   of its route;
4. the main path: ``tools/torch_test.py`` with the port's flagship serving
   config (``warp_impl='pf'``) and the parity fixture's weights on a
   REDS4-layout fixture of 4 clips x 8 frames at 720x1280 (PNG frames, MV
   sidecars, qp.json) that tools/data/make_protocol_fixture.py writes under
   build/chip_smoke/; the launch counts must be, per frame, 2 block warps
   (K1b), 2 input convs, 14 DRT blocks, 2 key-select blocks (K3s), 1 head
   and no per-pixel warp (K1); then one 720p clip of 8 frames through the
   serving generator in float32 and in bfloat16 under ``torch.profiler``:
   frames/s, device busy time and idle share, and each kernel's share of
   the device time (a kernel the profiled run launched whose device
   functions the profile does not name fails the run, here and in the
   profiles of phases 7 and 11);
5. the serving model's kernel path against its plain path on one clip of
   8 frames at 256x448 with block-constant MVs up to +-24 px
   (max|diff| <= 3e-3, float32), and, on the same inputs, its output
   against the ``block8`` model's on the MVs clamped to +-16 px beforehand
   (the same bound); then the flagship generator (use_pallas_kernels) at
   mid_channels 8 and 128 (2 blocks, 2 experts, seeded weights), with
   ``padgather`` and ``block8``, kernel path against plain path on the same
   clip (the same bound) and each pass's launch counts;
6. gradients at the flagship width (64 channels, 8 blocks, 6 experts): one
   Charbonnier loss on b=2 clips of 4 frames at 192x256, backpropagated
   through the kernels and through the plain path (float32, TF32 off);
   every parameter's gradient within 1e-3 of its largest plain entry, the
   losses within 1e-5 relative. The frames are not smaller because the
   partition 1x1 convs' weight gradients (sums of x * par / 255 over a third
   of the pixels, gated by a ReLU) shift with the float rounding of the
   forward by an amount that falls with the pixel count: at 64x96 it
   reached 1.2e-3 of the largest entry;
7. training: ``tools/torch_train.py`` with the port's flagship training
   config (b=5, 15 frames, 128x128 crops, Adam, cosine restart, remat) on a
   DAVIS-layout fixture of 2 clips x 20 frames at 256x256 (CRF 15/25/35 and
   sharp) under build/chip_smoke/train: 4 iterations with a checkpoint at 2,
   then a resume from 2 for 2 more, with cuDNN and PyTorch held to
   deterministic algorithms; the loss must be finite, the launch counts
   those of the forward and the remat recompute (K1, not K1b or K3s), and
   the resumed weights equal to the uninterrupted run's. Seconds per
   iteration, iterations/s and peak device memory are printed, and
   ``torch.profiler``'s split of the resumed run's last iteration: device
   time by kernel, the share of the port's kernels and the device's idle
   share;
8. batched serving: ``pnp_vcve_torch.serving.StreamScheduler`` with
   ``batched_forward_executor`` (max_batch 4) on the serving config and the
   parity weights; three streams submit 2 clips each, 6 clips of 8 frames
   at 720x1280 with their own I/P/B slices and 16x16-block MVs; each
   stream must complete in order, one dispatch must carry >= 3 clips, each
   clip must be within 1e-4 (float32) of the same clip enhanced alone, and
   the launch counts those of 8 frames per dispatch (one launch serves all
   the clips of a dispatch). Dispatch sizes and walls, per-clip
   latency p50/p95, aggregate frames/s and peak device memory are printed;
9. the latency/throughput curve: ``tools/torch_serving_curve.py --max-b 4
   --t 8 --iters 2`` (720p, bfloat16) in a subprocess, a row for each b;
10. the HTTP handler: a servable packed by ``tools/torch_pnp2servable.py``
   from the serving config and the parity weights, served by
   ``tools/torch_serving_handler.py`` on a free local port; 3 POSTed PNG
   frames of 720x1280 must come back as PNGs equal, as uint8, to
   ``pnp_vcve_torch.apis.restoration_inference`` on the same frames, with
   the serving path's launches per frame; the health check must answer;
11. the block forms: the training config at full width (64 channels,
   8 blocks, 6 experts) built through ``build_restorer`` with
   blocktype='drt_woqp', one_layer=False and channel_first=False in turn,
   the parity fixture's weights where they fit: each kernel path against
   its plain path on one clip of 8 frames at 256x448 (max|diff| <= 3e-3),
   then a 720p clip of 8 frames, once untimed and twice timed, with the
   last run's launch counts, and for the K5 forms once more under
   ``torch.profiler`` (device busy time, idle share, K5's share) (per
   frame 2 K1, 2 K2, 1 K4 and 16 K3 under 'drt_woqp', 32 K5 in the other
   two); for one_layer=False also phase 6's gradient check at 192x256;
12. the probes (B10a): ``tools/torch_int8_probe.py``,
   ``tools/torch_warp_kernel_probe2.py`` and ``tools/torch_warp_bisect.py``
   (all five stages) at their JAX files' shapes on the card, the probe
   kernels' counts (``kernels/probes.py: LAUNCHES``) zeroed before and read
   after, each of K6-K10 launched; then every stage's output against its
   plain version on the same inputs (K6, the int8 forms of K8 and K10, and
   K9's q and s bitwise; the bf16 forms of K8 and K10 max|diff| <= 1e-5
   max|ref|; K7 phase 3's bf16 bounds), timed in turns beside it, beside
   ``torch.matmul`` (k1, bf16 out), ``torch._int_mm`` (k2), ``F.conv2d``
   (k5, bf16 out) or ``torch.mul`` on the strided window (K6 without a
   period) and beside its bound (``tools/torch_kernel_bounds.py``'s work
   functions on this run's shapes and, for K7, the non-zeros of its S and
   vm), each stage three ways (PROBE TIMING below); and K10 in bf16 and
   int8 at K5's geometry (720x1280, 64 -> 64) beside K5 and one cuDNN
   conv, a measurement only. K10's int8 form counts apart
   (``tapconv_int8``): it is held bitwise at ``TAPCONV8_EDGES`` (ragged
   rows and columns, cin 32-320, cout 8-128), timed alone on k4's quantized
   band at 16 x 320 (device time, its headline) and beside the ``mma.sync``
   design it replaced (``pnp_tapconv`` with nm 0, the yardstick) there and
   at K5's geometry;
13. the probes that move data (B10b): ``tools/torch_warp_kernel_probe.py``
   and ``tools/torch_dma_probe.py`` (manual, then pipelined) at their JAX
   files' shapes on the card, the probe counts zeroed before and read
   after, each of K6, K11, K12 and K13 (``ring_copy`` and ``stream_copy``)
   launched; then every stage's output bitwise against its plain version
   on the same inputs, timed in turns beside it, beside ``torch.mul`` on
   the strided window (probe_floor) or ``z.clone()`` (the copies that
   write the array out), and beside its bound (K11's and K12's input bytes
   the distinct pixels this run's tables pick), each stage three ways
   (PROBE TIMING below); ``ring_copy`` also at depths 0 and 9 (split 4,
   both outputs). K11 is also held bitwise on ``GATHER_EDGES`` (shifts
   reaching -1, 34 and 35, xp as small as the wrapper takes) and timed
   on the probe's first ``GATHER_L2_BANDS`` bands too, whose 39 MB fit the
   L2, also warm (``warm_device_ms``: what the L2 allows; not held to the
   bound).

   PROBE TIMING (phases 12 and 13). (i) ``ms``: the old method, CUDA
   events over the JAX file's n back-to-back calls on one input after a
   warm-up: what the host enqueues as much as what the card does, and the
   input warm in the 50 MB L2 where it fits or half fits. (ii)
   ``cold_ms``, for a stage whose inputs pass the L2 (50 MB): the same
   events over calls that rotate over copies of the inputs (and so of the
   outputs) totalling at least 150 MB, at least three, so that every call
   finds its input and output cold, kernel, plain version and library call
   in turns. (iii) ``device_ms``, for a stage whose kernel reads under 0.1
   ms by (i): the kernel's calls over the rotated copies captured in one
   CUDA graph (at least n, at least one round of the copies) after a
   warm-up and replayed, and the library call's likewise: the device's
   time without the host's. A kernel reading above 105% of its bound by
   (ii) or (iii), or by (i) where neither applies, fails the phase (the
   plain versions are exempt: without ``write_out`` K13's reads 2 KB);
14. the generator's other forms, built through ``build_generator`` from the
   training config at full width (64 channels, 8 blocks, 6 experts,
   deform_groups 16) with seeded weights, each DCN aligner's offset head
   given seeded weights in its zero-initialised last conv: vsr=True through
   ``tools/torch_test.py`` (``--cfg-options model.generator.vsr=True``) on
   one clip of 8 frames at 180x320 (REDS-LR) with GT at 720x1280 written
   under build/chip_smoke/vsr, then on one such clip kernel path against
   plain path (max|diff| <= 3e-3, K4 at 720x1280 every frame), timed and
   profiled; deform='basic' and 'fvc' kernel path against plain path on
   phase 5's 256x448 clip (<= 3e-3), then one timed and one profiled 720p
   clip each, and the plain DCN and the aligner timed alone at 720p (CUDA
   events); flow_inter='nearest' kernel path against plain path on phase
   5's clip; the chunk API: one 8-frame 720p clip as 3 + 5 frames (the
   boundary on a B frame), the backward sweep right to left and the
   forward sweep left to right with carries and the clip's keyframe mask,
   under the serving config (parity weights) and the training config
   ('padgather'), chunked against full (max|diff| <= 1e-5, bitwise
   equality printed). Every run's launch counts must be its form's (per
   frame 2 K1, 2 K2, 16 K3, 1 K4; fvc and nearest no K1; 'pf' as phase 4);
15. the exact two-sweep pipeline (``pnp_vcve_torch/parallel/seqpar.py``) on
   the one card, each chunk's device ``cuda:0``: (a) one 8-frame 720p clip
   under the serving config (parity weights) over D = 2 and 4 chunks, and
   under the training config ('padgather') over 2, bitwise equal to the
   full sweep; (b) three clips through the stream at D = 2, bitwise equal to
   three single-clip pipelines, f/s of each mode beside the full sweep's
   (one card: the chunks run one after another, so this is the pipeline's
   overhead, not a speedup); (c) one 100-frame 720p clip made on the card
   (the protocol fixture's texture, motion, slices and rasterised MVs)
   through the flagship generator ('padgather', parity weights, float32) at
   full context, f/s and peak device memory, then in windows of 20 frames:
   max|diff| and the PSNR delta against the GT (uint8 levels, on the card);
   (d) ``tools/torch_dist_test.sh`` with two ranks on the card (torchrun,
   gloo) over a 3-clip 256x256 fixture (a 2/1 share): its dataset mean
   within 1e-6 relative of the single-process ``tools/torch_test.py``
   run's; (e) ``tools/torch_test.py --frame-parallel exact --stream-clips
   2`` over ``cuda:0,cuda:0`` on that fixture writes PNGs bitwise equal to
   the plain run's, with equal metrics. The launches of (a), (b), (c) and
   (e) must be those of their frames;
16. the eval entry point's last two modes, float32, TF32 off: (a) the
   cascade, ``tools/torch_test.py --cascade`` with the serving config on
   the parity weights into vanilla BasicVSR++ at its published widths (64
   channels, 7 blocks, 16 deform groups, x4; seeded, offset heads seeded
   non-zero, loaded through ``--cascade_ckpt``) on 2 clips x 8 frames at
   176x320 (REDS-LR's width; 176 rows because 'pf' needs sides that are
   multiples of 16) with a x4 GT written under build/chip_smoke/baselines:
   finite metrics, x4 PNGs, the launches of the flagship's frames plus
   BasicVSR++'s K1 (4 x (2t - 3) a clip); then one clip through both
   models, kernel path against plain path (max|diff| <= 3e-3), each
   stage's f/s, peak device memory, and a profiled clip (BasicVSR++'s
   device time split into the DCN, the convolutions, K1 and the rest);
   (b) the port's BasicVSR++ PQF v2 config (64 channels, 7 blocks,
   full-size input) through ``tools/torch_test.py`` on one 8-frame 720p
   clip (phase 4's first, linked), K1 only, then kernel path against plain path (3e-3) and its f/s;
   (c) the MFQE joint protocol, ``--joint-pqf-config`` with the port's
   MFQEv2 configs (nf 32, seeded, BatchNorm statistics away from 0 / 1) on
   that clip, no kernel launched, then the protocol on a 128x128 crop on
   the card against the CPU (max|diff| <= 1e-4) and its f/s;
17. data-parallel training and KITTI: (a) ``tools/torch_dist_train.sh``
   with 2 ranks sharing the card over gloo (5 samples each) and
   ``tools/torch_train.py`` in this process at 10 samples, phase 7's
   fixture and published settings for 4 iterations, ``--deterministic``,
   TF32 off in cuDNN and cuBLAS: the ranks' final weights and logged losses
   (unrounded, from each run's scalars.json) within 1e-5 of the one
   process's; (b) each rank's launches (rank 0 logs every rank's) and
   the one process's equal phase 7's; (c) seconds per iteration of both
   runs (iterations 2-4, from their logs) and rank 0's all-reduce time a
   step (``--time-allreduce``); (d) ``tools/torch_test_kitti.py`` with the training config and the
   parity weights on a KITTI-layout fixture of 2 sequences x 2 frames at
   375x1242 (tools/data/make_kitti_fixture.py): finite metrics, frames/s,
   the launches of 2 frames a sequence, then the first pair kernel path
   against plain path (max|diff| <= 3e-3, float32, TF32 off);
18. export and deployment, float32, TF32 off: (a)
   ``tools/torch_export_model.py --verify`` on the serving config and the
   parity weights at (3, 720, 1280): the reloaded artifact within 1e-4 of
   the eager forward, its launches for one window (K1b, K2, K3, K3s, K4
   through the registered ops ``torch.ops.pnp_vcve.*``) equal to the eager
   kernel path's, the export's and the save's seconds, the size, and both
   paths' frames/s timed in turns; (b) the training config (K1) and
   one_layer=False (K5), each cut to 2 blocks with seeded weights, exported
   at 256x448, each
   reloaded artifact launching its kernels and within 3e-3 of the plain
   path; (c) ``tools/torch_deploy_test.py`` with (a)'s artifact on clip 000
   of phase 4's fixture (2 windows of 3 frames): its per-clip PSNR / SSIM
   within the parity gate's bounds of the eager path's on the same windows;
   (d) ``tools/torch_parity_check.py --fixture`` on the kernel path passes
   and ``--tamper`` fails; (e) ``tools/torch_get_flops.py`` at JAX's default
   shape and at 720p, and ``tools/torch_publish_model.py`` on a training
   checkpoint of the flagship, the published weights equal to it;
19. the centre-frame baselines, float32, TF32 off, no kernel of the port on
   their path: (a) STDF (radius 3, 32/3, 64 out, QE 48x6), DCNGAN's
   generator and its discriminator (d 128), MW-GAN's PSNR generator (64/6,
   5 frames) and SIDECVSR (64/7/4), built through the builder with seeded
   weights: each on a 128x128 window (SIDECVSR 64x64 LR) on the card and on
   the CPU with the same weights (max|diff| <= 1e-4), then a 720p window
   (SIDECVSR 180x320 -> 720x1280) once untimed and twice timed: centre
   frames/s, peak device memory and a profiled window's device time split
   into the DCN, the convolutions, PAC and the rest; (b) STDF through
   ``apis.init_model`` and ``restoration_video_inference(window_size=7)``
   on clip 000 of phase 4's fixture: each frame within 1e-6 of the
   generator on its own reflect-padded window, and frames/s; (c)
   ``evaluate_center_frame_dataset`` (STDF, radius 1) over the non-PQF LDP
   triples of phase 7's fixture: finite metrics, its first sample on the
   card within 1e-4 of the CPU; (d) ``tools/torch_train.py`` on a DCNGAN
   config (phase 7's fixture, 3-frame windows, b=5, 128x128 crops, Adam
   1e-4 for both networks, JAX's gan_weight 0.01, 4 iterations,
   ``--deterministic``): finite losses, both networks' weights changed, the
   checkpoint holding ``disc``, seconds per iteration over iterations 2-4;
   then iteration 1 at b=2 on the card and on the CPU, ``loss_g`` and
   ``loss_d`` within 1e-4 relative; (e) the kernel counts unchanged across
   (a)-(d);
20. the super-resolution zoo downstream of the enhancer, float32, TF32 off,
   mmediting's published widths (seeded; every DCN offset head non-zero):
   (a) BasicVSR 64/30, IconVSR 64/30 (keyframe stride 5, padding 2, EDVR-M
   inside), RealBasicVSR 64/20/20, EDVR-M (64, 5 frames, 8 groups, 5/10),
   TDAN 64/5/10 and TOFlow, each on a small window on the card and on the
   CPU (5 frames at 64x64, the window models' own length; max|diff| <=
   1e-4), BasicVSR, IconVSR and RealBasicVSR also through K1 against the
   plain warp on an 8-frame 180x320 clip (<= 3e-3) with exactly 2 (t - 1)
   K1 launches a clip, then an 8-frame 180x320 -> 720x1280 clip (EDVR and
   TDAN one window of it, TOFlow its 7-frame window bicubically upsampled
   to 720x1280) once untimed, twice timed and once profiled: frames/s
   (centre frames/s), peak memory and the device split into the DCN, the
   convolutions, K1 and the rest, the four runs' launches gated (K1 only in
   the recurrent three); (b) EDSR 64/16, RRDBNet 64/23/32, MSRResNet 64/16,
   SRCNN 9-1-5 and RDN 64/16/8/64 likewise on 32x32 and one 180x320 frame;
   (c) ``tools/torch_test.py --cascade`` from the serving config (parity
   weights) into BasicVSR and into IconVSR on clip 000 of phase 16's
   176x320 fixture with its x4 GT: finite metrics, the flagship's launches
   and K1's 2 (t - 1); (d) EDVR through
   ``apis.restoration_video_inference(window_size=5)`` on that clip's PNGs
   and EDSR through ``apis.restoration_inference`` on its first frame, each
   within 1e-6 of the generator on the same frames.

Each phase prints its wall time.
The line before the last is a JSON object with each kernel's launches
(``launches``: all the driven paths together, each path's counts zeroed just
before it and read just after; then each path's own: the serving path of
phase 4, the batched path of phase 8, the handler of phase 10, training in
phase 7, each block form's last 720p run in phase 11, phase 14's driven
runs (the vsr CLI drive, basic's and fvc's timed 720p clips, the chunked
clips), phase 15's pipeline-driven runs (``exact_pipeline_launches``: (a),
(b), (c) and (e)), phase 16's cascade through ``tools/torch_test.py``
(``cascade_launches``: the flagship's kernels and K1 inside BasicVSR++),
phase 17's ranks (``ddp_train_launches``: the two ranks' counts summed; each
rank's equals ``train_launches``) and its KITTI CLI run (``kitti_launches``),
phase 18's exported artifacts (``export_launches``: (a)'s window, (b)'s
runs and (c)'s deploy-test CLI), phase 20's driven runs (``sr_zoo_launches``:
each model's four runs of (a) and (b), the two cascades of (c), the APIs
of (d));
the probe tools' runs of phases 12 and 13 for K6-K13),
its error, its time beside the plain
version's, the library call's, its yardsticks' and the bounds (K2-K5:
also the bfloat16 row under ``bf16``; K1-K4: also the worst error at
the other widths, K2-K4's 720p row at 128 channels, and K3's and K4's
two-launch forms under ``two_launch``;
K6-K13: the headline stage, every stage under ``forms``), phase 5's
errors at the other widths, phase 14's per form, phase 16's and phase 19's gates
(``center_frame_max_abs_err``; DCNGAN's first iteration as a relative
difference) and phase 20's (``sr_zoo_max_abs_err``); the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIGS = ROOT / "pnp_vcve_torch" / "configs"

SEED = 0
MAIN_HW = (720, 1280)
RAGGED_HW = (36, 52)
BLOCK_RAGGED_HW = (40, 56)  # K1b needs multiples of 8
BATCH_B, BATCH_HW = 4, (256, 448)
CLIPS, FRAMES = 4, 8
TOL_MODEL = 3e-3
MV_REACH = 24.0  # block-constant MVs up to +-24 px: K1b's +-16 px clamp bites
# phase 8: three streams of two clips each, max_batch 4
STREAMS, CLIPS_PER_STREAM, MAX_BATCH, TOL_BATCHED = 3, 2, 4, 1e-4
HANDLER_FRAMES = 3
# bfloat16 (max, mean) bounds in units of std(ref): tests/test_tpu_parity.py
# :43-51, the warp's :71 and the input conv's max from :137 -- its leaky-ReLU
# output reaches ~9.6 std, where bfloat16's own half-ulp rounding of the
# output is already 0.019-0.038 std. K5's max takes the same 0.04: its output
# (no residual) reaches 5.5 std, and an output in [2, 4) at std 0.378 rounds
# by up to 2^-7 = 0.0207 std (measured 0.00777)
BF16_BOUNDS = {"warp": (0.08, 0.01), "warp_block": (0.08, 0.01), "input_conv": (0.04, 0.002),
               "drt_block": (0.02, 0.002), "drt_block_select": (0.02, 0.002),
               "head": (0.02, 0.002), "conv3x3": (0.04, 0.002)}
# K5 at the ragged size: the 3-channel frame, 8 channels, the model's 64 and
# 131 (an input conv's 3 + 2 x 64, not a multiple of 8), into one narrow
# group, one group and two
CONV_RAGGED_CHANNELS = [(ci, co) for ci in (3, 8, 64, 131) for co in (8, 64, 128)]
# K1-K4 at widths other than the flagship's 64: at the ragged sizes (one
# narrow group, a group of 24, two full groups), and K2-K4 timed at 720p at 128
WIDTHS, WIDE = (8, 24, 128), 128
# K3 and K4 above their one-launch widths (launch.ONE_LAUNCH_WIDTH): at the
# ragged size in both types (K3 at 216 is two launches in float32, one in
# bfloat16; at 392 two in both) and timed at 720p in float32
TWO_LAUNCH = {"drt_block": (216, 392), "head": (192,)}
# phase 5: the flagship generator at other widths (random weights, seeded)
MODEL_WIDTHS, MODEL_WIDTH_BLOCKS, MODEL_WIDTH_EXPERTS = (8, 128), 2, 2


GRAD_TOL, LOSS_RTOL = 1e-3, 1e-5
TRAIN_FRAMES, TRAIN_HW, TRAIN_ITERS = 20, (256, 256), 4

KERNEL_INFO = {  # name -> (source, TPU kernel it replaces)
    "warp": ("pnp_vcve_torch/kernels/csrc/warp.cu", "pnp_vcve_tpu/kernels/warp_pf.py:488"),
    "warp_block": ("pnp_vcve_torch/kernels/csrc/warp_block.cu",
                   "pnp_vcve_tpu/kernels/warp_pf.py:552"),
    "input_conv": ("pnp_vcve_torch/kernels/csrc/input_conv.cu",
                   "pnp_vcve_tpu/kernels/drt_stack.py:649"),
    "drt_block": ("pnp_vcve_torch/kernels/csrc/drt_block.cu",
                  "pnp_vcve_tpu/kernels/drt_stack.py:305"),
    "drt_block_select": ("pnp_vcve_torch/kernels/csrc/drt_block.cu",
                         "pnp_vcve_tpu/kernels/drt_stack.py:278"),
    "head": ("pnp_vcve_torch/kernels/csrc/head.cu", "pnp_vcve_tpu/kernels/drt_stack.py:1058"),
    "conv3x3": ("pnp_vcve_torch/kernels/csrc/conv3x3.cu",
                "pnp_vcve_tpu/kernels/conv_block.py:86"),
}
# the other TPU functions a kernel computes (B8, B9): the same math in another layout
ALSO_REPLACES = {
    "drt_block": ["pnp_vcve_tpu/kernels/drt_packed.py:149",
                  "pnp_vcve_tpu/kernels/conv_block.py:180"],
    "conv3x3": ["pnp_vcve_tpu/kernels/conv_packed.py:48",
                "pnp_vcve_tpu/kernels/conv_packed.py:118"],
}
# phase 11: the block forms of the training config (models/bae.py)
BLOCK_FORMS = {"drt_woqp": dict(blocktype="drt_woqp"), "one_layer_false": dict(one_layer=False),
               "channel_first_false": dict(channel_first=False)}
FORMS_HW = (256, 448)
GRAD_B, GRAD_T, GRAD_HW = 2, 4, (192, 256)  # phases 6 and 11
# phase 12: the probe kernels K6-K10 -> (source, the TPU function it
# replaces, the others), each at its pallas_call
PROBE_INFO = {
    "window_copy": ("pnp_vcve_torch/kernels/csrc/probe_copy.cu", "tools/warp_kernel_probe2.py:78",
                    ["tools/warp_bisect.py:52", "tools/warp_bisect.py:72",
                     "tools/warp_kernel_probe.py:69"]),
    "mmsel": ("pnp_vcve_torch/kernels/csrc/probe_mmsel.cu", "tools/warp_kernel_probe2.py:126",
              ["tools/warp_bisect.py:105"]),
    "matmul": ("pnp_vcve_torch/kernels/csrc/probe_matmul.cu", "tools/int8_probe.py:70",
               ["tools/int8_probe.py:80", "tools/int8_probe.py:100"]),
    "absmax_quantize": ("pnp_vcve_torch/kernels/csrc/probe_matmul.cu", "tools/int8_probe.py:100",
                        ["tools/int8_probe.py:127"]),
    "tapconv": ("pnp_vcve_torch/kernels/csrc/probe_tapconv.cu", "tools/int8_probe.py:148", []),
    # K10's int8 form, its own device function (tapconv8_wg) and count
    "tapconv_int8": ("pnp_vcve_torch/kernels/csrc/probe_tapconv.cu", "tools/int8_probe.py:127",
                     []),
    # phase 13: the probes that move data (B10b)
    "gather2": ("pnp_vcve_torch/kernels/csrc/probe_gather.cu", "tools/warp_kernel_probe.py:124",
                []),
    "block_windows": ("pnp_vcve_torch/kernels/csrc/probe_blockdma.cu",
                      "tools/warp_kernel_probe.py:179", []),
    "ring_copy": ("pnp_vcve_torch/kernels/csrc/probe_ring.cu", "tools/dma_probe.py:104", []),
    "stream_copy": ("pnp_vcve_torch/kernels/csrc/probe_ring.cu", "tools/dma_probe.py:173", []),
}
K5_GEOMETRY = (720, 1280, 64)  # K10 timed at K5's frame, 64 -> 64 (measurement only)
# phase 14: the generator's other forms on the training config at full width
# (64 channels, 8 blocks, 6 experts; deform_groups 16), seeded weights
MODEL_FORMS = {"vsr": dict(vsr=True), "basic": dict(deform="basic"),
               "fvc": dict(deform="fvc"), "nearest": dict(flow_inter="nearest")}
VSR_LR_HW = (180, 320)  # REDS-LR: 720x1280 out
OFFSET_SCALE = 0.1  # conv_offset's last conv (zero at init): offsets of ~1 px
CHUNK_SPLIT, TOL_CHUNK = 3, 1e-5  # an 8-frame clip as 3 + 5 frames (frame 3 a B frame)
# phase 15: the exact two-sweep pipeline (parallel/seqpar.py) on the one card:
# pipeline depths over [cuda:0] * D, the stream, the 100-frame full-context
# clip and its chunked run, the 2-rank world and the exact CLI's fixture
PIPE_DEPTHS, STREAM_B, STREAM_D = (2, 4), 3, 2
FULL_T, FULL_CHUNK_T, FULL_MOTION = 100, 20, (2, 1)
DIST_CLIPS, DIST_HW, DIST_RANKS, DIST_RTOL = 3, (256, 256), 2, 1e-6
# phase 17: data-parallel training against one process on the global batch
# (the bound of the 5-step Adam test against JAX), KITTI's frame size
DDP_RANKS, DDP_TOL = 2, 1e-5
KITTI_HW, KITTI_SEQS = (375, 1242), ("000000", "000001")
PARITY_WEIGHTS = ROOT / "tests" / "fixtures" / "parity" / "state_dict.npz"
# phase 18: the exported program's fixed window (JAX's t), the small size of
# the training config's and the block form's exports and their depth, timed
# calls a path. Export time grows with the depth (the sweeps unroll): on the
# card 31.2 s for the training config at 8 blocks after phases 1-17, 27.5 s
# for one_layer=False at 8 (8.4 s at 2)
EXPORT_T, EXPORT_SMALL_HW, EXPORT_SMALL_BLOCKS, EXPORT_REPS = 3, (256, 448), 2, 3
# phase 16: the eval entry point's last modes. The cascade: the serving
# config into vanilla BasicVSR++ at its published widths on REDS-LR-width
# clips (176 rows: 'pf' needs sides that are multiples of 16, REDS-LR's 180
# is not) with a x4 GT; BasicVSR++ PQF v2 (the port's config) and the MFQE
# joint protocol (nf 32) on one 720p clip; the joint gate on a crop
CASCADE_CLIPS, CASCADE_HW = 2, (176, 320)
BVPP = dict(type="BasicVSRPlusPlus", mid_channels=64, num_blocks=7, deform_groups=16,
            is_low_res_input=True)
BVPP_OFFSET_SCALE = 0.01  # conv_offset.6 (zero at init): offsets of about a pixel
JOINT_CROP, TOL_JOINT = 128, 1e-4
# the tensor-core kernels (K2-K5) and the names of their device functions
# (K4's two-launch form: head_hidden_tc, then head_last_kernel on the CUDA
# cores)
TC_KERNELS = ("input_conv", "drt_block", "drt_block_select", "head", "conv3x3")
TC_SASS_NAMES = ("input_conv_tc", "input_conv_wg", "drt_block_tc", "drt_block_wg", "head_tc",
                 "head_wg", "head_hidden_tc", "conv3x3_tc", "conv3x3_wg")
# the wgmma designs at 64 channels (K2 csrc/input_conv.cu, K3 / K3s
# csrc/drt_block.cu, K4 csrc/head.cu, K5 csrc/conv3x3.cu at 64 -> 64) and
# how many device functions each has (two types; K3 with and without the
# select; K5 with its input by cp.async and by tensor-map boxes): each must
# hold HGMMA and spill nothing
WG_SASS_NAMES = {"input_conv_wg": 2, "drt_block_wg": 4, "head_wg": 2, "conv3x3_wg": 4}
# the probes' wgmma designs and their device functions: K7 (csrc/probe_mmsel.cu,
# the V and the H mode), K8 bf16 (csrc/probe_matmul.cu) and K10 bf16
# (csrc/probe_tapconv.cu, 4- and 8-row items); the same gates
PROBE_WG_SASS_NAMES = {"mmsel_wg": 2, "matmul_wg": 1, "tapconv_wg": 2}
# K10's int8 wgmma design (csrc/probe_tapconv.cu, 4- and 8-row items): each
# device function must hold the integer warpgroup MMA, no mma.sync (IMMA),
# and spill nothing; K11's design (csrc/probe_gather.cu) must spill nothing
INT8_WG_SASS_NAMES = {"tapconv8_wg": 2}
INT8_WG_SASS_OP, INT8_SYNC_SASS_OP = "IGMMA", "IMMA"
GATHER_NAMES = {"gather2_kernel": 1}
# the probe kernels that only move data (K13's two, K6); K13's ring_copy
# moves them with the bulk-copy engine
COPY_NAMES = ("ring_copy_kernel", "stream_copy_kernel", "window_copy_kernel")
BULK_SASS_NAMES = ("ring_copy_kernel",)
BULK_SASS_OP = "UBLKCP"  # cp.async.bulk, both ways, on sm_90a
# each model kernel's device functions as the profiler names them (K3 and
# K3s are one kernel with other template arguments; K2-K5 run their *_wg
# function at 64 channels, their *_tc ones at the other widths)
DEVICE_FUNCS = {
    "warp": ("pnp::warp_kernel",), "warp_block": ("pnp::warp_block_kernel",),
    "input_conv": ("pnp::tc::input_conv_wg", "pnp::tc::input_conv_tc"),
    "drt_block": ("pnp::tc::drt_block_wg", "pnp::tc::drt_block_tc"),
    "head": ("pnp::tc::head_wg", "pnp::tc::head_tc", "pnp::tc::head_hidden_tc",
             "pnp::tc::head_last_kernel"),
    "conv3x3": ("pnp::tc::conv3x3_wg", "pnp::tc::conv3x3_tc"),
}


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    return torch.device("cuda", 0), smi


def _smem(lib, name, c, dtype_code):
    """A model kernel's (one-launch) block's dynamic shared memory at width c."""
    from pnp_vcve_torch.kernels.build import SMEM_REPORT

    fn = getattr(lib.lib, f"pnp_{name}_smem")
    return fn(c, dtype_code) if SMEM_REPORT[name] else fn(c)


def _sass(lib):
    """The built library's SASS from cuobjdump, where the toolkit has it
    (None where it does not)."""
    from pnp_vcve_torch.kernels.build import nvcc_path

    nvcc = nvcc_path()
    tool = Path(nvcc).parent / "cuobjdump" if nvcc else None
    if tool is None or not tool.exists():
        return None
    return subprocess.run([str(tool), "-sass", str(lib.path)], capture_output=True, text=True,
                          check=True).stdout


def _sass_ops(sass, names):
    """{device function: {opcode: count}} of the functions whose name holds
    one of ``names`` (an opcode without its predicate and modifiers)."""
    import re

    ops, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            cur = cur if any(k in cur for k in names) else None
            if cur:
                ops.setdefault(cur, {})
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if cur and m:
            ops[cur][m.group(1)] = ops[cur].get(m.group(1), 0) + 1
    return ops


def _ptxas_report(log, name):
    """{device function: {"registers": n, "stack": bytes, "spill_stores":
    bytes, "spill_loads": bytes}} from the compiler's -v report, for the
    entry functions whose mangled name holds ``name``."""
    import re

    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1) if name in m.group(1) else None
            if cur:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            out[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            cur = None
    return out


def phase_build():
    from pnp_vcve_torch.kernels.build import PROBE_SMEM_REPORT, SMEM_REPORT, library
    from pnp_vcve_torch.kernels.launch import MAX_WIDTH, ONE_LAUNCH_WIDTH, SMEM_MAX

    t0 = time.perf_counter()
    lib = library()
    print(f"[build] {lib.path} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {lib.build_seconds:.1f} s)")
    for line in lib.log.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line) or "spill" in line:
            print("[build]", line.strip())
    smem = {n: {c: _smem(lib, n, c, 0) for c in (64, *WIDTHS)} for n in SMEM_REPORT}
    for n in (n for n, typed in SMEM_REPORT.items() if typed):
        smem[f"{n} bfloat16"] = {c: _smem(lib, n, c, 1) for c in (64, *WIDTHS)}
    smem.update({n: getattr(lib.lib, f"pnp_{n}_smem")() for n in PROBE_SMEM_REPORT})
    print(f"[build] dynamic shared memory per block (bytes, model kernels by width; float32 "
          f"unless named): {smem}")
    print(f"[build] one-launch widths (K3, K4; two launches above): "
          f"{ {f'{n} {str(d)[6:]}': c for (n, d), c in ONE_LAUNCH_WIDTH.items()} }")
    from pnp_vcve_torch.kernels import probes

    text = _sass(lib)
    tc_names = TC_SASS_NAMES + tuple(PROBE_WG_SASS_NAMES)
    wg_names = {**WG_SASS_NAMES, **PROBE_WG_SASS_NAMES}
    sass = None if text is None else {
        fn: {"HMMA": o.get("HMMA", 0), "HGMMA": o.get("HGMMA", 0)}
        for fn, o in _sass_ops(text, tc_names).items()}
    if sass is None:
        print("[build] cuobjdump not found: no HMMA/HGMMA count")
    else:
        for fn, count in sass.items():
            print(f"[build] tensor-core instructions in {fn}: HMMA {count['HMMA']}, "
                  f"HGMMA {count['HGMMA']}")
        missing = [n for n in tc_names if not any(n in fn for fn in sass)]
        if missing or not all(sum(c.values()) for c in sass.values()):
            raise AssertionError(f"K2-K5, K7, K8, K10 kernels without tensor-core instructions: "
                                 f"{sass}; no device function named {missing}")
        no_wgmma = [fn for fn, c in sass.items()
                    if any(n in fn for n in wg_names) and not c["HGMMA"]]
        if no_wgmma:
            raise AssertionError(f"wgmma designs without HGMMA: {no_wgmma}")
    # the wgmma designs: their registers, shared memory and spills; none may
    # spill. The probes' shared memory at their probe shapes (K7's V mode at
    # 720p, K10 at 16 x 320; K8's at any) must be their wrappers' mirrors'
    # (kernels/probes.py: mmsel_schedule, tapconv_schedule, MATMUL_SMEM)
    probe_smem = {"mmsel_wg": (lib.lib.pnp_mmsel_smem(),
                               probes.mmsel_schedule(90, 10, 64, 40, True, 132)["smem"]),
                  "matmul_wg": (lib.lib.pnp_matmul_smem(), probes.MATMUL_SMEM),
                  "tapconv_wg": (lib.lib.pnp_tapconv_smem(),
                                 probes.tapconv_schedule(16, 320, 128, 128, 132)["smem"])}
    off = {n: v for n, v in probe_smem.items() if v[0] != v[1] or v[0] > SMEM_MAX}
    if off:
        raise AssertionError(f"probe shared memory (source, mirror) disagree or pass {SMEM_MAX}: "
                             f"{off}")
    smem_of = {"input_conv_wg": "input_conv", "drt_block_wg": "drt_block", "head_wg": "head",
               "conv3x3_wg": "conv3x3"}
    for name, want in wg_names.items():
        wg = _ptxas_report(lib.log, name)
        for fn, r in wg.items():
            dtype = 1 if "bfloat16" in fn else 0
            nbytes = (probe_smem[name][0] if name in probe_smem
                      else _smem(lib, smem_of[name], 64, dtype))
            regs = ("" if name == "matmul_wg"  # one warpgroup and a warp: no setmaxnreg
                    else " (setmaxnreg: consumers 232, producer 40)")
            print(f"[build] {fn}: {r.get('registers')} registers at launch{regs}, "
                  f"{nbytes} bytes of dynamic shared memory"
                  f"{' at the probe' if name in probe_smem else ''}, stack {r.get('stack')} B, "
                  f"spill stores {r.get('spill_stores')} B, spill loads {r.get('spill_loads')} B")
        spills = {fn: r for fn, r in wg.items() if r.get("spill_stores") or r.get("spill_loads")}
        if len(wg) != want or spills:
            raise AssertionError(f"{name}: {len(wg)} device functions in the compiler's report "
                                 f"(want {want}); spilling: {spills}")

    # the copy kernels K13 and K6: none may spill; ring_copy must hold the
    # bulk copy's SASS (UBLKCP), and its shared memory is the wrapper's
    # mirror's (kernels/probes.py: ring_schedule)
    copy = {fn: r for name in COPY_NAMES for fn, r in _ptxas_report(lib.log, name).items()}
    for fn, r in copy.items():
        print(f"[build] {fn}: {r.get('registers')} registers, stack {r.get('stack')} B, spill "
              f"stores {r.get('spill_stores')} B, spill loads {r.get('spill_loads')} B")
    spills = {fn: r for fn, r in copy.items() if r.get("spill_stores") or r.get("spill_loads")}
    if len(copy) != len(COPY_NAMES) or spills:
        raise AssertionError(f"copy kernels: {sorted(copy)} in the compiler's report (want one "
                             f"each of {COPY_NAMES}); spilling: {spills}")
    if text is not None:
        ops = _sass_ops(text, BULK_SASS_NAMES)
        for fn, o in ops.items():
            print(f"[build] {fn}: {BULK_SASS_OP} {o.get(BULK_SASS_OP, 0)}, SYNCS "
                  f"{o.get('SYNCS', 0)}, LDG {o.get('LDG', 0)}, STG {o.get('STG', 0)}")
        if len(ops) != len(BULK_SASS_NAMES) or not all(o.get(BULK_SASS_OP) for o in ops.values()):
            raise AssertionError(f"bulk-copy design without {BULK_SASS_OP}: "
                                 f"{ {fn: o.get(BULK_SASS_OP, 0) for fn, o in ops.items()} }")
    _int8_and_gather_gates(lib, text, probes)
    ring_smem = [lib.lib.pnp_ring_copy_smem(128, d, 4) for d in range(probes.RING_MAX_DEPTH + 1)]
    mirror = [probes.ring_schedule((1, 8, 8, 128), 4, d, 1)["smem"]
              for d in range(probes.RING_MAX_DEPTH + 1)]
    print(f"[build] ring_copy shared memory by depth 0..9: {ring_smem}")
    if ring_smem != mirror or max(ring_smem) > SMEM_MAX:
        raise AssertionError(f"ring_copy's shared memory {ring_smem} is not its mirror's {mirror} "
                             f"or passes {SMEM_MAX}")

    # the wrappers' width limits are the widest blocks the sources' formulas fit
    def fits(n, c, code=0):
        return _smem(lib, n, c, code) <= SMEM_MAX

    off = [(n, top) for n, top in MAX_WIDTH.items()
           if n in SMEM_REPORT and top is not None and not (fits(n, top) and not fits(n, top + 8))]
    off += [(n, d, top) for (n, d), top in ONE_LAUNCH_WIDTH.items()  # dtype code 1: bf16
            if not (fits(n, top, d.itemsize == 2) and not fits(n, top + 8, d.itemsize == 2))]
    if off:
        raise AssertionError(f"launch.MAX_WIDTH / ONE_LAUNCH_WIDTH is not the widest block that "
                             f"fits: {off}")


def _int8_and_gather_gates(lib, text, probes):
    """K10's int8 wgmma design: IGMMA and no IMMA in each device function
    (where cuobjdump is found), no spills, its shared memory at the probe
    its mirror's; K11's design: no spills."""
    from pnp_vcve_torch.kernels.launch import SMEM_MAX

    if text is not None:
        ops = _sass_ops(text, tuple(INT8_WG_SASS_NAMES))
        for fn, o in ops.items():
            mma = {k: v for k, v in o.items() if "MMA" in k}
            print(f"[build] {fn}: matrix instructions {mma}")
        bad = [fn for fn, o in ops.items()
               if not o.get(INT8_WG_SASS_OP) or o.get(INT8_SYNC_SASS_OP)]
        if bad or len(ops) != sum(INT8_WG_SASS_NAMES.values()):
            raise AssertionError(f"int8 wgmma design: {len(ops)} device functions, without "
                                 f"{INT8_WG_SASS_OP} or with {INT8_SYNC_SASS_OP}: {bad}")
    smem = (lib.lib.pnp_tapconv8_smem(), probes.tapconv8_schedule(16, 320, 128, 128, 132)["smem"])
    for names in (INT8_WG_SASS_NAMES, GATHER_NAMES):
        rep = {fn: r for n in names for fn, r in _ptxas_report(lib.log, n).items()}
        for fn, r in rep.items():
            print(f"[build] {fn}: {r.get('registers')} registers at launch, stack "
                  f"{r.get('stack')} B, spill stores {r.get('spill_stores')} B, spill loads "
                  f"{r.get('spill_loads')} B")
        count = sum(names.values())
        spills = {fn: r for fn, r in rep.items() if r.get("spill_stores") or r.get("spill_loads")}
        if len(rep) != count or spills:
            raise AssertionError(f"{sorted(names)}: {len(rep)} device functions in the compiler's "
                                 f"report (want {count}); spilling: {spills}")
    print(f"[build] tapconv8_wg: {smem[0]} bytes of dynamic shared memory at the probe (mirror "
          f"{smem[1]})")
    if smem[0] != smem[1] or smem[0] > SMEM_MAX:
        raise AssertionError(f"tapconv8_wg's shared memory (source, mirror) {smem} disagree or "
                             f"pass {SMEM_MAX}")


def _timed(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _compare(name, got, ref, dtype, bounds):
    import torch

    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    sd = float(ref.std()) or 1.0
    diff = (got - ref).abs()
    mx, mean = float(diff.max()), float(diff.mean())
    if dtype == torch.float32:
        ok = mx <= 1e-4 * sd
        bound = f"<= 1e-4 std = {1e-4 * sd:.3g}"
    else:
        max_rel, mean_rel = bounds
        ok = mx < max_rel * sd and mean < mean_rel * sd
        bound = (f"< {max_rel} std = {max_rel * sd:.3g}, mean < {mean_rel * sd:.3g}; "
                 f"{mx / (max_rel * sd):.3f} and {mean / (mean_rel * sd):.3f} of the bounds")
    print(f"[kernel] {name}: max|diff| {mx:.3g} mean {mean:.3g} ({bound})")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return mx


def _mma_sync(x, par, blk, last_key=None, is_key=None):
    """K3 (K3s with last_key and is_key) through the mma.sync design at any
    width, the one the wgmma design replaced at 64 channels: the yardstick
    of phase 3. Its launches count nowhere."""
    import torch

    from pnp_vcve_torch.kernels import drt_stack as kd
    from pnp_vcve_torch.kernels.launch import call

    weights = kd.drt_block_args(x, par, *blk)
    out = torch.empty_like(x)
    nlk = None if last_key is None else torch.empty_like(x)
    key = None if is_key is None else is_key.to(torch.float32, copy=True)
    call("drt_block", "pnp_drt_block_mma_sync", x.device, int(last_key is not None),
         0 if x.dtype == torch.float32 else 1, x, par, *weights, last_key, key, out, nlk,
         *x.shape, counts={"drt_block": 0})
    return out if last_key is None else (out, nlk)


def _mma_sync_input_conv(parts, ks, bias):
    """K2 through its mma.sync design (conv_tc) at any width, the one the
    wgmma design replaced at 64 channels: phase 3's yardstick. Its launches
    count nowhere."""
    import torch

    from pnp_vcve_torch.kernels import drt_stack as kd
    from pnp_vcve_torch.kernels.launch import call

    ops, bias_f, c = kd.input_conv_args(parts, ks, bias)
    lr, wide = parts[0], list(parts[1:])
    out = torch.empty((*lr.shape[:3], c), dtype=lr.dtype, device=lr.device)
    pad = [None] * (3 - len(wide))
    call("input_conv", "pnp_input_conv_mma_sync", lr.device,
         0 if lr.dtype == torch.float32 else 1, lr, *wide, *pad, *ops, *pad, bias_f, out,
         *lr.shape[:3], len(wide), c, counts={"input_conv": 0})
    return out


def _mma_sync_head(x, hd):
    """K4 through its mma.sync design (head_tc, stage 2 on the CUDA cores)
    at any width: phase 3's yardstick at 64 channels. Its launches count
    nowhere."""
    import torch

    from pnp_vcve_torch.kernels import drt_stack as kd
    from pnp_vcve_torch.kernels.launch import call

    weights = kd.head_args(x, *hd)
    out = torch.empty((*x.shape[:3], 3), dtype=x.dtype, device=x.device)
    call("head", "pnp_head_mma_sync", x.device, 0 if x.dtype == torch.float32 else 1, x,
         *weights, None, out, *x.shape, counts={"head": 0})
    return out


def _conv3x3_yardstick(entry, x, k, bias, g):
    """K5 through C entry ``entry``: "pnp_conv3x3_mma_sync", the mma.sync
    design (conv_tc) at any widths, the one the wgmma design replaced at 64
    -> 64 (the yardstick of phases 3 and 12), on conv3x3_args' operands; or
    "pnp_conv3x3_wg_alt_staging", the wgmma design at 64 -> 64 with the
    other staging of its input chunks (bf16 by tensor-map boxes, float32 by
    cp.async), on conv3x3_operands'. Its launches count nowhere."""
    import torch

    from pnp_vcve_torch.kernels.conv_block import conv3x3_args, conv3x3_operands
    from pnp_vcve_torch.kernels.launch import call

    prep = conv3x3_args if entry == "pnp_conv3x3_mma_sync" else conv3x3_operands
    out = torch.empty((*x.shape[:3], k.shape[-1]), dtype=x.dtype, device=x.device)
    call("conv3x3", entry, x.device, 0 if x.dtype == torch.float32 else 1, x,
         *prep(x, k, bias, g), out, *x.shape, k.shape[-1], counts={"conv3x3": 0})
    return out


def _mma_sync_matmul(a, b):
    """K8 bf16 through its mma.sync design, the one the wgmma design
    replaced: phase 12's yardstick. Its launches count nowhere."""
    import torch

    from pnp_vcve_torch.kernels.launch import call

    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    call("matmul", "pnp_matmul_mma_sync", a.device, 1, a, b, None, out, m, n, k,
         counts={"matmul": 0})
    return out


def _mma_sync_tapconv(q, w, s, rows, cols):
    """K10 int8 through its mma.sync design, the one the wgmma design
    replaced (``pnp_tapconv`` with nm 0, grid 0): phase 12's yardstick. Its
    launches count nowhere."""
    import torch

    from pnp_vcve_torch.kernels.launch import call

    bh, bw, cin = q.shape
    out = torch.empty((rows, cols, w.shape[3]), dtype=torch.float32, device=q.device)
    call("tapconv_int8", "pnp_tapconv", q.device, 2, q, w, s, out, bh, bw, cin, w.shape[3], rows,
         cols, 0, 0, counts={"tapconv_int8": 0})
    return out


def _grid(flow, h, w, dtype):
    """grid_sample's normalised grid for a pixel flow (align_corners=True)."""
    import torch

    dev = flow.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    return torch.stack([(xs + flow[..., 0].float()) * 2 / (w - 1) - 1,
                        (ys + flow[..., 1].float()) * 2 / (h - 1) - 1], -1).to(dtype)


def _cases(dev, dtype, b, h, w, gen, c=64):
    """One dict per case at width c: label, kernel name, the kernel call,
    the plain call in float32 on the same values, the plain call in the
    working type, the library call (or None), yardsticks to time beside it,
    an extra check (or None), reps for timing, and the bytes the function
    must move (each input read once, each output written once). K5 and K3
    in the TPU's per-block argument order only at 64 (K5 has its own
    widths); weights scaled by 8 / sqrt(c), 0.03 at 64 as before."""
    import torch
    import torch.nn.functional as F

    from pnp_vcve_torch.kernels import KERNELS, PLAIN
    from pnp_vcve_torch.kernels.drt_stack import part_kernels
    from pnp_vcve_torch.ops.warp import PF_MAX_MV, block_flow

    def feat(c):
        return torch.randn((b, h, w, c), generator=gen).to(dev, dtype)

    def wt(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    f32 = lambda ts: [t.float() for t in ts]  # noqa: E731
    sc = 8 / c ** 0.5  # weight scale: 1 at the flagship's 64
    x = feat(c)
    # block-constant motion vectors as the rasterizer emits them, +-24 px
    fb = torch.rand((b, -(-h // 8), -(-w // 8), 2), generator=gen) * (2 * MV_REACH) - MV_REACH
    flow = fb.repeat_interleave(8, 1).repeat_interleave(8, 2)[:, :h, :w].contiguous()
    flow = flow.to(dev, dtype)
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    grid = _grid(flow, h, w, dtype)
    cases = [dict(
        label="warp", name="warp", kern=lambda: KERNELS.flow_warp(x, flow),
        ref32=lambda: PLAIN.flow_warp(x.float(), flow.float()),
        plain=lambda: PLAIN.flow_warp(x, flow),
        library=lambda: F.grid_sample(x_nchw, grid, mode="bilinear", padding_mode="zeros",
                                      align_corners=True),
        yardsticks={}, check=None, reps=20, bytes=nbytes(x, flow, x))]
    if h % 8 == 0 and w % 8 == 0:
        table = block_flow(flow, PF_MAX_MV)
        # grid_sample on the same flow: the clamped table expanded per pixel
        grid_b = _grid(table.repeat_interleave(8, 1).repeat_interleave(8, 2), h, w, dtype)
        cases.append(dict(
            label="warp_block", name="warp_block",
            kern=lambda: KERNELS.flow_warp_block(x, flow, PF_MAX_MV),
            ref32=lambda: PLAIN.flow_warp_block(x.float(), flow.float(), PF_MAX_MV),
            plain=lambda: PLAIN.flow_warp_block(x, flow, PF_MAX_MV),
            library=lambda: F.grid_sample(x_nchw, grid_b, mode="bilinear",
                                          padding_mode="zeros", align_corners=True),
            yardsticks={"k1_ms": lambda: KERNELS.flow_warp(x, flow)}, check=None, reps=20,
            bytes=nbytes(x, table, x)))
    gate = torch.ones(b, device=dev)
    for n_parts, tag in ((3, "backward"), (4, "forward")):
        parts = [feat(3)] + [feat(c) for _ in range(n_parts - 1)]
        kernel = wt((3, 3, 3 + c * (n_parts - 1), c), 0.03 * sc)
        bias = wt((c,), 0.1)
        ks = part_kernels(kernel, [p.shape[-1] for p in parts], b, gate)
        # the yardstick: one cuDNN conv over the concatenated parts,
        # channels-last (the port's layout), in the same type, TF32 off
        cat = torch.cat(parts, -1).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        w_oihw = kernel.permute(3, 2, 0, 1).to(dtype).contiguous(
            memory_format=torch.channels_last)
        label = f"input_conv ({tag}, {n_parts} parts)"

        # at 64 channels the wgmma design runs; the mma.sync design it
        # replaced is its yardstick, held to the same plain version
        def ic_check(p=parts, k=ks, bb=bias, label=label):
            _compare(f"{label} (mma.sync yardstick) {str(dtype)[6:]} b={b} {h}x{w}",
                     _mma_sync_input_conv(p, k, bb), PLAIN.input_conv(f32(p), k, bb), dtype,
                     BF16_BOUNDS["input_conv"])
            return "the mma.sync yardstick agrees with the plain version"

        cases.append(dict(
            label=label, name="input_conv",
            kern=lambda p=parts, k=ks, bb=bias: KERNELS.input_conv(p, k, bb),
            ref32=lambda p=parts, k=ks, bb=bias: PLAIN.input_conv(f32(p), k, bb),
            plain=lambda p=parts, k=ks, bb=bias: PLAIN.input_conv(p, k, bb),
            library=lambda c=cat, k=w_oihw, bb=bias.to(dtype): F.conv2d(c, k, bb, padding=1),
            yardsticks={} if c != 64 else {
                "mma_sync_ms": lambda p=parts, k=ks, bb=bias: _mma_sync_input_conv(p, k, bb)},
            check=ic_check if c == 64 else None, reps=5, bytes=nbytes(*parts, *ks, bias, x)))
    par = (torch.rand((b, h, w, 3), generator=gen) > 0.5).to(dev, dtype)
    blk = (wt((b, 3, 3, c, c), 0.03 * sc), wt((b, c), 0.1),
           torch.rand((b, c), generator=gen).to(dev),
           wt((c, 3, c), 0.03 * sc), wt((3, 3, c, c), 0.03 * sc), wt((c,), 0.1))
    # K3 and K3s at 64 channels run the wgmma design; the mma.sync design
    # they replaced is their yardstick, held to the same plain version
    mma_sync = {} if c != 64 else {"mma_sync_ms": lambda: _mma_sync(x, par, blk)}

    def mma_sync_check():
        _compare(f"drt_block (mma.sync yardstick) {str(dtype)[6:]} b={b} {h}x{w}",
                 _mma_sync(x, par, blk), PLAIN.drt_block(x.float(), par.float(), *blk), dtype,
                 BF16_BOUNDS["drt_block"])
        return "the mma.sync yardstick agrees with the plain version"

    cases.append(dict(
        label="drt_block", name="drt_block", kern=lambda: KERNELS.drt_block(x, par, *blk),
        ref32=lambda: PLAIN.drt_block(x.float(), par.float(), *blk),
        plain=lambda: PLAIN.drt_block(x, par, *blk), library=None, yardsticks=mma_sync,
        check=mma_sync_check if c == 64 else None, reps=5, bytes=nbytes(x, par, *blk, x)))
    if c == 64:  # K3s runs at the pf path's width only
        last_key = feat(c)
        is_key = (torch.arange(b, device=dev) % 2 == 0).float()  # keyframes and not

        def select_check():
            """new_last_key is bitwise torch.where on K3s's own out, for each
            sample's flag and its opposite."""
            for key in (is_key, 1.0 - is_key):
                out, new_lk = KERNELS.drt_block_select(x, par, *blk, last_key, key)
                want = torch.where(key.reshape(-1, 1, 1, 1) > 0.5, out, last_key)
                if not torch.equal(new_lk.view(torch.int16 if dtype == torch.bfloat16 else
                                               torch.int32),
                                   want.view(torch.int16 if dtype == torch.bfloat16 else
                                             torch.int32)):
                    raise AssertionError("drt_block_select: new_last_key is not the select of out")
            return "new_last_key == where(is_key, out, last_key) bitwise, both flags"

        cases.append(dict(
            label="drt_block_select", name="drt_block_select",
            kern=lambda: KERNELS.drt_block_select(x, par, *blk, last_key, is_key)[0],
            ref32=lambda: PLAIN.drt_block(x.float(), par.float(), *blk),
            plain=lambda: PLAIN.drt_block_select(x, par, *blk, last_key, is_key),
            library=None,
            yardsticks={"k3_where_ms": lambda: torch.where(
                is_key.reshape(-1, 1, 1, 1) > 0.5, KERNELS.drt_block(x, par, *blk), last_key),
                "mma_sync_ms": lambda: _mma_sync(x, par, blk, last_key, is_key)},
            check=select_check, reps=5, bytes=nbytes(x, par, *blk, last_key, is_key, x, x)))
    if (h, w) in (MAIN_HW, RAGGED_HW) and c == 64:
        # K3 called with drt_block_pallas's / drt_block_packed's argument order
        # (x, par, dyn_kernels, dyn_biases, par_kernel, conv1_kernel, conv1_bias,
        # gamma), the B8/B9 entry: the same wrapper, its arguments reordered
        def pallas_order(fn):
            return lambda x_, p_, dk, db, pk, k1, b1, g: fn(x_, p_, dk, db, g, pk, k1, b1)

        jargs = (blk[0], blk[1], blk[3], blk[4], blk[5], blk[2])
        cases.append(dict(
            label="drt_block (drt_block_pallas argument order)", name="drt_block",
            kern=lambda: pallas_order(KERNELS.drt_block)(x, par, *jargs),
            ref32=lambda: pallas_order(PLAIN.drt_block)(x.float(), par.float(), *jargs),
            plain=lambda: pallas_order(PLAIN.drt_block)(x, par, *jargs), library=None,
            yardsticks={}, check=None, reps=5, time=False, bytes=nbytes(x, par, *blk, x)))
    hd = (wt((3, 3, c, c), 0.03 * sc), wt((c,), 0.1), wt((3, 3, c, 3), 0.06 * sc), wt((3,), 0.1))

    def head_check():
        _compare(f"head (mma.sync yardstick) {str(dtype)[6:]} b={b} {h}x{w}",
                 _mma_sync_head(x, hd), PLAIN.head(x.float(), *hd), dtype, BF16_BOUNDS["head"])
        return "the mma.sync yardstick agrees with the plain version"

    cases.append(dict(
        label="head", name="head", kern=lambda: KERNELS.head(x, *hd),
        ref32=lambda: PLAIN.head(x.float(), *hd), plain=lambda: PLAIN.head(x, *hd),
        library=None, yardsticks={} if c != 64 else {"mma_sync_ms": lambda: _mma_sync_head(x, hd)},
        check=head_check if c == 64 else None, reps=5,
        bytes=nbytes(x, *hd) + b * h * w * 3 * x.element_size()))

    def conv_case(bb, c_in, c_out, timed):
        """K5 with per-sample kernels, biases and gains (the gain folded into
        the library call's weights and bias, in the type). The library call:
        at one sample one channels-last F.conv2d of the NHWC frame; at
        several one grouped F.conv2d (groups=bb) on an NCHW-contiguous copy,
        the grouped-conv form of ops/dynamic_conv.py: per_sample_conv. At 64
        -> 64 the wgmma design runs; the mma.sync design it replaced is its
        yardstick, held to the same plain version."""
        xc = x if (bb, c_in) == (b, 64) else torch.randn((bb, h, w, c_in), generator=gen).to(
            dev, dtype)
        k, bias = wt((bb, 3, 3, c_in, c_out), 0.03), wt((bb, c_out), 0.1)
        g = torch.rand((bb, c_out), generator=gen).to(dev)
        kg = (k * g[:, None, None, None, :]).permute(0, 4, 3, 1, 2).to(dtype)  # (bb, o, i, 3, 3)
        bg = (bias * g).to(dtype)
        if bb == 1:  # the NHWC frame seen as NCHW is channels-last: cuDNN takes it as it is
            w_cl = kg[0].contiguous(memory_format=torch.channels_last)
            library = lambda: F.conv2d(xc.permute(0, 3, 1, 2), w_cl, bg[0], padding=1)  # noqa: E731
            library_label = "channels-last F.conv2d"
        else:
            xg = xc.permute(0, 3, 1, 2).reshape(1, bb * c_in, h, w).contiguous()
            wg = kg.reshape(bb * c_out, c_in, 3, 3).contiguous()
            library = lambda: F.conv2d(xg, wg, bg.reshape(-1), padding=1, groups=bb)  # noqa: E731
            library_label = f"grouped NCHW F.conv2d (groups={bb})"
        main = (bb, c_in, c_out) == (b, 64, 64)
        square = (c_in, c_out) == (64, 64)
        tag = f"conv3x3 (mma.sync yardstick) {str(dtype)[6:]} b={bb} {h}x{w}"

        def check():
            _compare(tag, _conv3x3_yardstick("pnp_conv3x3_mma_sync", xc, k, bias, g),
                     PLAIN.conv3x3(xc.float(), k, bias, g), dtype, BF16_BOUNDS["conv3x3"])
            return "the mma.sync yardstick agrees with the plain version"

        return dict(
            label="conv3x3" if main else f"conv3x3 ({c_in}->{c_out}, b={bb})", name="conv3x3",
            kern=lambda: KERNELS.conv3x3(xc, k, bias, g),
            ref32=lambda: PLAIN.conv3x3(xc.float(), k, bias, g),
            plain=lambda: PLAIN.conv3x3(xc, k, bias, g), library=library,
            library_label=library_label,
            yardsticks={} if not square else {
                "mma_sync_ms": lambda: _conv3x3_yardstick("pnp_conv3x3_mma_sync", xc, k, bias,
                                                          g)},
            check=check if square else None, reps=5, time=timed,
            bytes=nbytes(xc, k, bias, g) + bb * h * w * c_out * xc.element_size())

    if c != 64:
        return cases
    # K5 at the model's 64 -> 64; at 720p and the ragged size also two
    # samples with their own kernels; at the ragged size every pair of
    # CONV_RAGGED_CHANNELS
    cases.append(conv_case(b, 64, 64, True))
    if (b, h, w) in ((1, *MAIN_HW), (1, *RAGGED_HW)):
        cases.append(conv_case(2, 64, 64, False))
    if (h, w) == RAGGED_HW:
        cases += [conv_case(b, ci, co, False) for ci, co in CONV_RAGGED_CHANNELS
                  if (ci, co) != (64, 64)]
    return cases


def _time_case(c, tag, b, h, w, width=64):
    """Time case c in turns (plain, kernel, its yardsticks, its yardsticks
    again in reverse, kernel, plain) and its library call; print the line with its bounds (float32 on the CUDA
    cores, 3xTF32 and bf16 on the tensor cores, bytes) and return the row."""
    import torch_kernel_bounds as kb  # tools/, on sys.path from phase_kernels

    # in turns: plain, kernel, each yardstick, each yardstick again, kernel, plain
    p1, k1 = _timed(c["plain"], c["reps"]), _timed(c["kern"], c["reps"])
    yards = list(c["yardsticks"].items())
    y1 = {k: _timed(f, c["reps"]) for k, f in yards}
    y2 = {k: _timed(f, c["reps"]) for k, f in yards[::-1]}
    k2, p2 = _timed(c["kern"], c["reps"]), _timed(c["plain"], c["reps"])
    lib = _timed(c["library"], c["reps"]) if c["library"] else None
    yard = {k: (y1[k] + y2[k]) / 2 for k, _ in yards}
    flop = kb.model_flop_per_pixel(c["label"], width) * b * h * w
    bd = kb.conv_bounds(flop, c["bytes"])
    t_bytes, t_ops, t_tf32x3, t_bf16 = bd["bytes_ms"], bd["f32_ms"], bd["tf32x3_ms"], bd["bf16_ms"]
    rate = f"{flop / (k1 + k2) * 2e-9:.1f} TFLOP/s, " if flop else ""
    yard_txt = "".join(f", {k[:-3]} {v:.3f} ms" for k, v in yard.items())
    lib_label = f" ({c['library_label']})" if c.get("library_label") else ""
    print(f"[time] {tag}: kernel {k1:.3f} / {k2:.3f} ms, "
          f"plain {p1:.3f} / {p2:.3f} ms, library "
          f"{'none' if lib is None else f'{lib:.3f} ms'}{lib_label}{yard_txt}; {rate}"
          f"{c['bytes'] / ((k1 + k2) / 2) * 1e-6:.0f} GB/s; bounds: bytes {t_bytes:.3f} ms, "
          f"float32 CUDA-core ops {t_ops:.3f}, 3xTF32 ops {t_tf32x3:.3f}, bf16 tensor-core ops "
          f"{t_bf16:.3f}")
    return dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=lib, t_bytes=t_bytes,
                t_ops=t_ops, t_tf32x3=t_tf32x3, t_bf16=t_bf16, **yard)


def phase_kernels(dev):
    """Returns {kernel: row} in float32 at 720p: the worst error, the mean
    times of the kernel, its plain version, the library call and the
    yardsticks, and the bounds (``bound_ms`` by the route the kernel takes:
    3xTF32 for the tensor-core K2-K5, the CUDA cores for K1 and K1b); for
    K2-K5 the same in bfloat16 under ``bf16``. The
    input conv's row covers its two forms (worst error, mean time and
    bound). K1-K4 also at WIDTHS at the ragged sizes (the worst error there
    under ``width_max_abs_err``), K3 and K4 at TWO_LAUNCH's widths (their
    two-launch forms, under ``two_launch``: the worst error at the ragged
    size in both types, the time at 720p in float32), and K2-K4 timed at
    720p at width WIDE (under ``wide``)."""
    import torch

    sys.path.insert(0, str(ROOT / "tools"))  # tools/torch_kernel_bounds.py: the bounds
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)
    rows, rows_bf16, wide, width_err, two = {}, {}, {}, {}, {}
    sizes = ((1, MAIN_HW, True), (BATCH_B, BATCH_HW, False), (1, RAGGED_HW, False),
             (1, BLOCK_RAGGED_HW, False))
    for dtype in (torch.float32, torch.bfloat16):
        for b, (h, w), timed in sizes:
            for c in _cases(dev, dtype, b, h, w, gen):
                tag = f"{c['label']} {str(dtype)[6:]} b={b} {h}x{w}"
                err = _compare(tag, c["kern"](), c["ref32"](), dtype, BF16_BOUNDS[c["name"]])
                if c["check"] is not None:
                    print(f"[kernel] {tag}: {c['check']()}")
                if not (timed and c.get("time", True)):
                    continue
                row = _time_case(c, tag, b, h, w)
                if dtype == torch.float32:
                    rows.setdefault(c["name"], []).append(dict(err=err, **row))
                elif c["name"] in TC_KERNELS:
                    rows_bf16.setdefault(c["name"], []).append(dict(err=err, **row))
            torch.cuda.empty_cache()
        # the other widths: every case at the ragged sizes (K1b at its own)
        for width in WIDTHS:
            for h, w in (RAGGED_HW, BLOCK_RAGGED_HW):
                for c in _cases(dev, dtype, 1, h, w, gen, width):
                    if (c["name"] == "warp_block") != ((h, w) == BLOCK_RAGGED_HW):
                        continue
                    tag = f"{c['label']} c={width} {str(dtype)[6:]} b=1 {h}x{w}"
                    err = _compare(tag, c["kern"](), c["ref32"](), dtype, BF16_BOUNDS[c["name"]])
                    if c["check"] is not None:
                        print(f"[kernel] {tag}: {c['check']()}")
                    if dtype == torch.float32:
                        width_err[c["name"]] = max(width_err.get(c["name"], 0.0), err)
        # K3 and K4 above their one-launch widths
        for name, widths in TWO_LAUNCH.items():
            for width in widths:
                h, w = RAGGED_HW
                for c in _cases(dev, dtype, 1, h, w, gen, width):
                    if c["name"] != name:
                        continue
                    tag = (f"{c['label']} c={width} {str(dtype)[6:]} b=1 {h}x{w} "
                           f"({_form(name, width, dtype)})")
                    err = _compare(tag, c["kern"](), c["ref32"](), dtype, BF16_BOUNDS[name])
                    t = two.setdefault(name, {"widths": list(widths)})
                    key = f"max_abs_err_{str(dtype)[6:]}"
                    t[key] = max(t.get(key, 0.0), err)
    h, w = MAIN_HW
    # the two-launch forms at 720p, float32
    for name, widths in TWO_LAUNCH.items():
        for c in _cases(dev, torch.float32, 1, h, w, gen, widths[0]):
            if c["name"] != name:
                continue
            tag = (f"{c['label']} c={widths[0]} float32 b=1 {h}x{w} "
                   f"({_form(name, widths[0], torch.float32)})")
            err = _compare(tag, c["kern"](), c["ref32"](), torch.float32, None)
            row = _time_case(dict(c, reps=2), tag, 1, h, w, widths[0])
            two[name]["720p"] = {"c": widths[0], "max_abs_err": err,
                                 **_summary([dict(err=err, **row)], name)}
        torch.cuda.empty_cache()
    # K2-K4 at 720p at width WIDE, float32, timed beside their bounds
    for c in _cases(dev, torch.float32, 1, h, w, gen, WIDE):
        if c["name"] not in ("input_conv", "drt_block", "head"):
            continue
        tag = f"{c['label']} c={WIDE} float32 b=1 {h}x{w}"
        err = _compare(tag, c["kern"](), c["ref32"](), torch.float32, None)
        wide.setdefault(c["name"], []).append(dict(err=err, **_time_case(c, tag, 1, h, w, WIDE)))
    torch.cuda.empty_cache()

    out = {name: _summary(rs, name) for name, rs in rows.items()}
    for name, rs in rows_bf16.items():
        out[name]["bf16"] = _summary(rs, name, bf16=True)
    for name, err in width_err.items():
        out[name]["width_max_abs_err"] = {"widths": list(WIDTHS), "max_abs_err": err}
    for name, t in two.items():
        out[name]["two_launch"] = t
    for name, rs in wide.items():
        out[name]["wide"] = {"c": WIDE, **_summary(rs, name)}
    return out


def _form(name, c, dtype):
    from pnp_vcve_torch.kernels.launch import launch_form

    n = launch_form(name, c, dtype)
    return "one launch" if n == 1 else "two launches"


def _summary(rs, name, bf16=False):
    """Phase 3's rows of one kernel merged: the worst error, the mean times
    and bounds; ``bound_ms`` over the operations of the route the kernel
    takes (bf16 or 3xTF32 tensor cores for K2-K5; else float32 CUDA
    cores) and its bytes."""
    def mean(k):
        return None if rs[0][k] is None else sum(r[k] for r in rs) / len(rs)

    t_bytes = mean("t_bytes")
    t_ops = mean("t_bf16" if bf16 else "t_tf32x3" if name in TC_KERNELS else "t_ops")
    extra = {k: mean(k) for k in rs[0] if k.endswith("_ms") and k != "library_ms"}
    return dict(
        max_abs_err=max(r["err"] for r in rs), ms=mean("ms"), plain_ms=mean("plain_ms"),
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=mean("library_ms"), bound_f32_cuda_ms=mean("t_ops"),
        bound_tf32x3_ms=mean("t_tf32x3"), bound_bf16_tensor_ms=mean("t_bf16"),
        bound_bytes_ms=t_bytes,
        **{k: v for k, v in extra.items() if k not in ("ms", "plain_ms")})


def write_main_fixture():
    """Phase 4's REDS4-layout 720p fixture (PNG frames, MV sidecars,
    qp.json), written by tools/data/make_protocol_fixture.py under
    build/chip_smoke/data."""
    sys.path[:0] = [str(ROOT / "tools" / "data")]
    from make_protocol_fixture import REDS4_CLIPS, write_fixture

    h, w = MAIN_HW
    write_fixture(ROOT / "build" / "chip_smoke" / "data", clips=REDS4_CLIPS[:CLIPS],
                  frames=FRAMES, height=h, width=w, crf=15, seed=SEED, quiet=True)


def start_main_fixture():
    """write_main_fixture in a child process (PNG encoding on one host core),
    so that it runs beside phases 2-3; phase 4 waits for it."""
    return subprocess.Popen([sys.executable, "-c",
                             "import chip_smoke; chip_smoke.write_main_fixture()"], cwd=ROOT)


def phase_main_path(dev, fixture=None):
    """tools/torch_test.py on phase 4's fixture: written here, or by the
    child process ``fixture`` (start_main_fixture), which this waits for."""
    import numpy as np
    import torch

    from pnp_vcve_torch.core.config import Config
    from pnp_vcve_torch.kernels import LAUNCHES, reset_launches
    from pnp_vcve_torch.models.pnp_vcve import PnPVCVE

    sys.path[:0] = [str(ROOT / "tools")]
    import torch_test

    work = ROOT / "build" / "chip_smoke"
    h, w = MAIN_HW
    t0 = time.perf_counter()
    if fixture is None:
        write_main_fixture()
    elif fixture.wait() != 0:
        raise AssertionError(f"phase 4's fixture writer exited {fixture.returncode}")
    cfg = work / "serving_720p.py"
    # the flagship serving config, pointed at the fixture (its qp.json sits
    # inside the test pipeline, which --testdir_* do not reach)
    cfg.write_text(
        f"_base_ = [{str(CONFIGS / 'HR_davis_LR_128x128_serving.py')!r}]\n"
        "from pnp_vcve_torch.core.presets import flagship_data\n"
        f"data = flagship_data(test_lq={str(work / 'data/crf15/png')!r}, "
        f"test_gt={str(work / 'data/sharp/png')!r}, "
        f"test_qp_json={str(work / 'data/qp.json')!r})\n"
        f"data['test']['num_input_frames'] = {FRAMES}\n"
    )
    print(f"[main] fixture: {CLIPS} clips x {FRAMES} frames at {h}x{w} "
          f"{'written in' if fixture is None else 'waited for'} {time.perf_counter() - t0:.1f} s")

    fwd_s = []  # generator forward time per clip, device-synchronised

    def tic(module, args):
        if isinstance(module, PnPVCVE):
            torch.cuda.synchronize()
            fwd_s.append(-time.perf_counter())

    def toc(module, args, out):
        if isinstance(module, PnPVCVE):
            torch.cuda.synchronize()
            fwd_s[-1] += time.perf_counter()

    pre = torch.nn.modules.module.register_module_forward_pre_hook(tic)
    post = torch.nn.modules.module.register_module_forward_hook(toc)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out_dir = work / "out"
    metrics = torch_test.main([
        str(cfg), str(ROOT / "tests/fixtures/parity/state_dict.npz"), "--device", dev.type,
        "--save-path", str(out_dir), "--save-image",
    ])
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    pre.remove()
    post.remove()

    gen_cfg = Config.fromfile(cfg).model["generator"]
    n = CLIPS * FRAMES
    want = _launches_per_pass(n, gen_cfg["num_blocks"], gen_cfg.get("warp_impl", "padgather"))
    print(f"[main] launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError("main path did not run every step through the kernels")
    if set(metrics) != {"PSNR", "SSIM"} or not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"main path metrics missing or not finite: {metrics}")
    pngs = sorted(out_dir.glob("*/*.png"))
    if len(pngs) != n:
        raise AssertionError(f"expected {n} enhanced frames under {out_dir}, found {len(pngs)}")
    print(f"[main] {n} frames at {h}x{w}: generator {sum(fwd_s):.3f} s = "
          f"{n / sum(fwd_s):.3f} frames/s (per clip "
          f"{', '.join(f'{v:.3f}' for v in fwd_s)} s); tools/torch_test.py incl. loading and "
          f"host metrics {wall:.3f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    _serving_profile(dev)
    return counts


def _serving_profile(dev):
    """Where the serving generator's device time goes: one 720p clip of
    FRAMES frames (b=1, the serving config, the parity weights) in float32
    and in bfloat16, once untimed, once timed (synchronised host clock) and
    once under ``torch.profiler``: device busy time, idle share against the
    timed clip, and the kernels' shares. Its launches are not the main
    path's (those were read above)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pnp_vcve_torch.kernels import LAUNCHES, reset_launches

    model, _ = _flagship_generator("HR_davis_LR_128x128_serving.py", dev)
    h, w = MAIN_HW
    inputs = _clip_inputs(np.random.default_rng(SEED), 1, FRAMES, h, w, dev)
    for dtype in (torch.float32, torch.bfloat16):
        model.feature_dtype = dtype
        with torch.inference_mode():
            model(**inputs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(**inputs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            reset_launches()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                model(**inputs)
                torch.cuda.synchronize()
            counts = dict(LAUNCHES)
        tag = f"[profile] serving {str(dtype)[6:]}, {FRAMES} frames {h}x{w}"
        found = _device_time(prof)
        if found is None:
            print(f"{tag}: {FRAMES / wall:.3f} frames/s; profiler recorded no device events, "
                  f"breakdown not measured")
            continue
        busy, by_name = found
        total = sum(by_name.values())
        share = _kernel_times(by_name, counts, ("warp_block", "input_conv", "drt_block", "head"))
        print(f"{tag}: {FRAMES / wall:.3f} frames/s, clip {wall:.4f} s; device busy {busy:.4f} s, "
              f"idle share {max(0.0, 1 - busy / wall):.4f}; of device time "
              + ", ".join(f"{k} {v / total:.4f}" for k, v in share.items())
              + f", the rest {1 - sum(share.values()) / total:.4f} (drt_block: K3 and K3s)")
        for name, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"[profile]   {v:.4f} s {v / total:.4f}  {name[:110]}")
    model.feature_dtype = torch.float32


def _kernel_times(by_name, counts, names):
    """{kernel: device seconds} of each model kernel in ``names`` in a
    profile's kernel times by name (DEVICE_FUNCS; "drt_block" is K3 and
    K3s). A kernel that the profiled run launched (``counts``) and whose
    device functions the profile does not name fails the run: a renamed
    function would otherwise drop out of the breakdown unseen."""
    out = {}
    for k in names:
        out[k] = sum(v for n, v in by_name.items() if any(f in n for f in DEVICE_FUNCS[k]))
        launched = counts[k] + (counts["drt_block_select"] if k == "drt_block" else 0)
        if launched and not out[k]:
            raise AssertionError(f"the profile names no device function of {k} "
                                 f"({DEVICE_FUNCS[k]}), launched {launched} times")
    return out


def _clip_inputs(rng, b, t, h, w, dev, mv_reach=None, mv_block=8):
    """b clips of t frames: MVs constant over mv_block x mv_block blocks
    (normal, 6 px std; or uniform up to +-mv_reach), one-hot partitions,
    I/P/B slices, as the rasterizer and the codec give them."""
    import numpy as np
    import torch

    up = lambda a, k=8: np.repeat(np.repeat(a, k, 2), k, 3)  # noqa: E731
    slices = np.full((b, t), 66.0, np.float32)
    slices[:, ::4] = 80.0
    slices[:, 0] = 73.0
    shape = (b, t, h // mv_block, w // mv_block, 4)
    mv = (rng.standard_normal(shape) * 6 if mv_reach is None
          else rng.uniform(-mv_reach, mv_reach, shape))
    inputs = dict(
        lrs=rng.random((b, t, h, w, 3), dtype=np.float32),
        qps=(rng.integers(20, 40, (b, t)) / 255.0).astype(np.float32),
        slices=slices,
        mvs=up(mv.astype(np.float32), mv_block),
        base_qps=np.full((b, t), 35 / 255.0, np.float32),
        par_map=up(np.eye(3, dtype=np.float32)[rng.integers(0, 3, (b, t, h // 8, w // 8))]
                   / 255.0),
    )
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in inputs.items()}


def _flagship_generator(config, dev):
    """The config's generator with the parity fixture's weights, and the
    config."""
    from pnp_vcve_torch.core.builder import build_generator
    from pnp_vcve_torch.core.checkpoint import load_generator_weights
    from pnp_vcve_torch.core.config import Config

    cfg = Config.fromfile(CONFIGS / config)
    model = build_generator(cfg.model["generator"], device=dev)
    load_generator_weights(model, str(ROOT / "tests/fixtures/parity/state_dict.npz"))
    return model, cfg


def _launches_per_pass(t, num_blocks, warp_impl="padgather", fused_blocks=True):
    """Kernel launches of one forward over t frames: each sweep step warps
    (K1b under 'pf' and 'block8' on frames of multiples of 8, K1 in
    training), runs the input conv and the blocks (under 'pf' the last is
    K3s; the unfused block forms run two K5 per block instead of one K3);
    the forward sweep's steps run the head."""
    pf = warp_impl == "pf"
    k1b = warp_impl in ("pf", "block8")
    k3 = 2 * (num_blocks - pf) * t if fused_blocks else 0
    return {"warp": 0 if k1b else 2 * t, "warp_block": 2 * t if k1b else 0,
            "input_conv": 2 * t, "drt_block": k3, "drt_block_select": 2 * t if pf else 0,
            "head": t, "conv3x3": 0 if fused_blocks else 4 * num_blocks * t}


def phase_model_vs_plain(dev):
    """The serving model ('pf') through its kernels against its plain path
    on MVs up to +-24 px, and against the 'block8' model on the MVs clamped
    to +-16 px beforehand."""
    import numpy as np
    import torch

    from pnp_vcve_torch.kernels import KERNELS, LAUNCHES, PLAIN, reset_launches
    from pnp_vcve_torch.ops.warp import PF_MAX_MV

    model, cfg = _flagship_generator("HR_davis_LR_128x128_serving.py", dev)
    t, h, w = FRAMES, 256, 448
    inputs = _clip_inputs(np.random.default_rng(SEED), 1, t, h, w, dev, mv_reach=MV_REACH)
    clamped = {**inputs, "mvs": inputs["mvs"].clamp(-PF_MAX_MV, PF_MAX_MV)}
    with torch.inference_mode():
        reset_launches()
        got = model(**inputs)
        counts = dict(LAUNCHES)
        model.ops = PLAIN
        want = model(**inputs)
        model.ops = KERNELS
        model.warp_impl = "block8"
        block8 = model(**clamped)
        model.warp_impl = "pf"
    if got.shape != (1, t, h, w, 3) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"model output {tuple(got.shape)} not finite/of the expected shape")
    gen_cfg = cfg.model["generator"]
    expected = _launches_per_pass(t, gen_cfg["num_blocks"], gen_cfg.get("warp_impl", "padgather"))
    if counts != expected:
        raise AssertionError(f"pf launches {counts}, expected {expected}")
    err = float((got - want).abs().max())
    err8 = float((got - block8).abs().max())
    print(f"[model] pf kernel path vs plain path, {t} frames {h}x{w} float32, MVs to "
          f"+-{MV_REACH:g} px: max|diff| {err:.3g}; vs the block8 kernel path on MVs clamped "
          f"to +-{PF_MAX_MV:g} px: max|diff| {err8:.3g} (each <= {TOL_MODEL})")
    if not (err <= TOL_MODEL and err8 <= TOL_MODEL):
        raise AssertionError("pf model kernel path disagrees with its plain path or block8")
    return _model_widths(dev, inputs, t, h, w)


def _model_widths(dev, inputs, t, h, w):
    """The flagship generator (use_pallas_kernels, 'padgather' and 'block8')
    at MODEL_WIDTHS channels, MODEL_WIDTH_BLOCKS blocks and
    MODEL_WIDTH_EXPERTS experts, weights from a seed: kernel path against
    plain path on phase 5's clip, with each pass's launch counts. Returns
    {c: {warp_impl: max|diff|}}."""
    import torch

    from pnp_vcve_torch.core.builder import build_generator
    from pnp_vcve_torch.kernels import LAUNCHES, PLAIN, reset_launches

    errs = {}
    for c in MODEL_WIDTHS:
        for warp_impl in ("padgather", "block8"):
            model = build_generator(dict(
                type="PnPVCVE", mid_channels=c, num_blocks=MODEL_WIDTH_BLOCKS,
                num_experts=MODEL_WIDTH_EXPERTS, use_pallas_kernels=True, warp_impl=warp_impl),
                device=dev, seed=SEED + c)
            with torch.inference_mode():
                reset_launches()
                got = model(**inputs)
                counts = dict(LAUNCHES)
                model.ops = PLAIN
                want = model(**inputs)
            expected = _launches_per_pass(t, MODEL_WIDTH_BLOCKS, warp_impl)
            err = float((got - want).abs().max())
            print(f"[model] c={c} {warp_impl} ({MODEL_WIDTH_BLOCKS} blocks, "
                  f"{MODEL_WIDTH_EXPERTS} experts) kernel path vs plain path, {t} frames {h}x{w} "
                  f"float32: max|diff| {err:.3g} (<= {TOL_MODEL}); launches {counts}")
            if counts != expected:
                raise AssertionError(f"c={c} {warp_impl}: launches {counts}, expected {expected}")
            if not (bool(torch.isfinite(got).all()) and err <= TOL_MODEL):
                raise AssertionError(f"c={c} {warp_impl}: kernel path disagrees with plain path")
            errs.setdefault(c, {})[warp_impl] = err
    return errs


def phase_grads(dev):
    """One Charbonnier loss at the flagship width through the kernels
    (forward kernels, plain-version backward in each Function, the remat
    recompute) and through the plain path; every parameter's gradient is
    held to the plain one."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model, cfg = _flagship_generator("HR_davis_LR_128x128.py", dev)
    gen_cfg = cfg.model["generator"]
    return _grad_check("grad", model, gen_cfg,
                       _launches_per_pass(GRAD_T, gen_cfg["num_blocks"]), SEED + 6, dev)


def _grad_check(tag, model, gen_cfg, per_pass, seed, dev):
    """One Charbonnier loss on GRAD_B clips of GRAD_T frames at GRAD_HW
    through the kernels and through the plain path (float32, TF32 off):
    the kernel path's launches must be ``per_pass`` (twice with remat; none
    in the backward), every parameter's gradient within GRAD_TOL of its
    largest plain entry and the losses within LOSS_RTOL. Returns the worst
    ratio."""
    import math

    import numpy as np
    import torch

    from pnp_vcve_torch.kernels import KERNELS, LAUNCHES, PLAIN, reset_launches
    from pnp_vcve_torch.train.losses import charbonnier_loss

    rng = np.random.default_rng(seed)
    (b, t), (h, w) = (GRAD_B, GRAD_T), GRAD_HW
    inputs = _clip_inputs(rng, b, t, h, w, dev)
    gt = torch.from_numpy(rng.random((b, t, h, w, 3), dtype=np.float32)).to(dev)
    runs = {}
    for ops in (KERNELS, PLAIN):
        model.ops = ops
        model.zero_grad()
        reset_launches()
        loss = charbonnier_loss(model(**inputs), gt)
        loss.backward()
        torch.cuda.synchronize()
        runs[ops is KERNELS] = (float(loss.detach()), dict(LAUNCHES),
                                {n: p.grad.clone() for n, p in model.named_parameters()})
    model.ops = KERNELS
    (loss_k, counts, g_k), (loss_p, _, g_p) = runs[True], runs[False]
    passes = 2 if gen_cfg.get("remat", True) else 1
    want = {k: passes * v for k, v in per_pass.items()}
    print(f"[{tag}] launches {counts} (expected {want}: the forward"
          f"{' and the remat recompute' if passes == 2 else ''}; none in the backward)")
    if counts != want:
        raise AssertionError("the gradient run did not go through the kernels as expected")
    ratios = {}
    for n, ref in g_p.items():
        if not bool(torch.isfinite(g_k[n]).all()):
            raise AssertionError(f"gradient of {n} not finite")
        # a gradient the kernel path dropped shows as a zero tensor: ratio 1
        diff, scale = float((g_k[n] - ref).abs().max()), float(ref.abs().max())
        ratios[n] = diff / scale if scale else (0.0 if diff == 0 else math.inf)
    worst = max(ratios, key=ratios.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"[{tag}] {len(ratios)} parameter tensors, b={b} t={t} {h}x{w} float32 (TF32 off): "
          f"loss {loss_k:.7f} vs plain {loss_p:.7f} (relative {loss_rel:.3g} <= {LOSS_RTOL}); "
          f"worst tensor {worst}: max|g_kern - g_plain| = {ratios[worst]:.3g} x max|g_plain| "
          f"(<= {GRAD_TOL})")
    if not (loss_rel <= LOSS_RTOL and ratios[worst] <= GRAD_TOL):
        raise AssertionError("kernel-path gradients disagree with the plain path")
    return ratios[worst]


def _train_fixture(work):
    """Phase 7's DAVIS-layout fixture under ``work/data`` (2 clips x
    TRAIN_FRAMES frames at TRAIN_HW, CRF 15/25/35 and sharp) and the port's
    flagship training config with data.train pointed at it through the
    DAVIS type, every other setting as published. Returns the config's
    path. The fixture is rewritten unless ``data/fixture.json`` records
    these same parameters: a fixture left by a run at other sizes (a CPU
    rehearsal shrinks TRAIN_HW) would otherwise be trained on as it is."""
    import shutil

    sys.path.insert(0, str(ROOT / "tools" / "data"))
    from make_protocol_fixture import write_fixture

    data = work / "data"
    stamp = json.dumps({"clips": ["bear", "boat"], "frames": TRAIN_FRAMES, "hw": list(TRAIN_HW),
                        "crf": [15, 25, 35], "seed": SEED})
    if not (data / "fixture.json").exists() or (data / "fixture.json").read_text() != stamp:
        if data.exists():
            shutil.rmtree(data)
        t0 = time.perf_counter()
        qp = {}
        # one CRF per call; each call rewrites qp.json, so the three are merged
        for crf in (15, 25, 35):
            write_fixture(data, clips=("bear", "boat"), frames=TRAIN_FRAMES, height=TRAIN_HW[0],
                          width=TRAIN_HW[1], crf=crf, seed=SEED, quiet=True)
            qp.update(json.loads((data / "qp.json").read_text()))
        (data / "qp.json").write_text(json.dumps(qp))
        (data / "fixture.json").write_text(stamp)
        print(f"[train] fixture: 2 clips x {TRAIN_FRAMES} frames at {TRAIN_HW[0]}x"
              f"{TRAIN_HW[1]}, CRF 15/25/35 + sharp, in {time.perf_counter() - t0:.1f} s")
    cfg_path = work / "train_davis.py"
    cfg_path.write_text(
        f"_base_ = [{str(CONFIGS / 'HR_davis_LR_128x128.py')!r}]\n"
        "from pnp_vcve_torch.core.presets import train_dataset\n"
        f"data = dict(train=[train_dataset('DAVISMultipleGTMixCompressDataset', {str(data)!r}, "
        f"'sharp', {str(data / 'qp.json')!r})])\n"
    )
    return cfg_path


def _fixture_digest(data):
    """sha256 of every file under ``data`` (relative path and bytes, sorted),
    its first 16 hex digits."""
    import hashlib

    h = hashlib.sha256()
    for f in sorted(p for p in data.rglob("*") if p.is_file()):
        h.update(str(f.relative_to(data)).encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _backend_flags():
    """The process-wide settings a float32 training run's numbers depend on."""
    import torch

    return {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision(),
            "cudnn.benchmark": torch.backends.cudnn.benchmark,
            "cudnn.deterministic": torch.backends.cudnn.deterministic,
            "deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
            "CUBLAS_WORKSPACE_CONFIG": os.environ.get("CUBLAS_WORKSPACE_CONFIG")}


def phase_train(dev, smi):
    """tools/torch_train.py at the flagship training settings on a DAVIS
    fixture: 4 iterations with a checkpoint at 2, then a resume from 2."""
    import math
    import shutil
    import warnings

    import torch
    from torch.optim.optimizer import register_optimizer_step_post_hook
    from torch.profiler import ProfilerActivity, profile, schedule

    from pnp_vcve_torch.core.config import Config
    from pnp_vcve_torch.kernels import LAUNCHES, reset_launches

    sys.path[:0] = [str(ROOT / "tools"), str(ROOT / "tools" / "data")]
    import torch_train

    work = ROOT / "build" / "chip_smoke" / "train"
    if work.exists():
        shutil.rmtree(work)
    cfg_path = _train_fixture(work)
    cfg = Config.fromfile(cfg_path)

    # training keeps PyTorch's defaults (cuDNN convolutions in TF32); the
    # resume check needs deterministic algorithms (cuDNN's weight gradients
    # and the warp's scatter-add otherwise sum with atomics in no fixed order)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    step_end, profiled = [], []

    def on_step(optimizer, args, kwargs):
        torch.cuda.synchronize()
        step_end.append(time.perf_counter())
        for step in profiled:
            step()

    hook = register_optimizer_step_post_hook(on_step)
    options = ["--device", dev.type,
               "--cfg-options", "checkpoint_config.interval=2", "log_config.interval=1"]
    # the profiler records the resumed run's last iteration: it waits
    # through iteration 3 and records from its optimizer step to iteration
    # 4's (the hook steps it); a warm-up step would need a third iteration
    warnings.filterwarnings("ignore", "Profiler won't be using warmup")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=1, warmup=0, active=1, repeat=1))
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        torch_train.main([str(cfg_path), "--work-dir", str(work / "full"),
                          "--total-iters", str(TRAIN_ITERS), *options])
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        steady = (step_end[TRAIN_ITERS - 1] - step_end[0]) / (TRAIN_ITERS - 1)
        reset_launches()
        profiled.append(prof.step)
        prof.start()
        torch_train.main([str(cfg_path), "--work-dir", str(work / "resumed"),
                          "--total-iters", str(TRAIN_ITERS),
                          "--resume-from", str(work / "full" / "ckpt" / "2.pth"), *options])
        prof.stop()
        resumed_counts = dict(LAUNCHES)
    finally:
        hook.remove()
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    _print_breakdown(prof, step_end[-1] - step_end[-2], steady, resumed_counts)

    gen_cfg = cfg.model["generator"]
    t = cfg.data["train"][0]["dataset"]["num_input_frames"]
    per_iter = {k: (2 if gen_cfg.get("remat", True) else 1) * v
                for k, v in _launches_per_pass(t, gen_cfg["num_blocks"]).items()}
    want = {k: TRAIN_ITERS * v for k, v in per_iter.items()}
    want_resumed = {k: (TRAIN_ITERS - 2) * v for k, v in per_iter.items()}
    print(f"[train] launches {counts} (expected {want}: per iteration the forward and the "
          f"remat recompute, {t} frames); resumed run {resumed_counts} (expected {want_resumed})")
    if counts != want or resumed_counts != want_resumed:
        raise AssertionError("training did not run every step through the kernels")

    losses = [float(line.split("loss=")[1].split()[0])
              for line in (work / "full" / "train.log").read_text().splitlines()
              if " loss=" in line]
    if len(losses) != TRAIN_ITERS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training losses missing or not finite: {losses}")
    full = torch.load(work / "full" / "ckpt" / f"{TRAIN_ITERS}.pth", weights_only=True)
    resumed = torch.load(work / "resumed" / "ckpt" / f"{TRAIN_ITERS}.pth", weights_only=True)
    diff = max(float((full["model"][k] - v).abs().max()) for k, v in resumed["model"].items())
    moved = max(float((full["model"][k] - v).abs().max())
                for k, v in torch.load(work / "full" / "ckpt" / "2.pth",
                                       weights_only=True)["model"].items())
    print(f"[train] losses {losses}; resumed run vs uninterrupted run after {TRAIN_ITERS} "
          f"iterations: max|dw| {diff:.3g} (must be 0 under deterministic algorithms; "
          f"the weights moved {moved:.3g} over iterations 3-4)")
    if diff != 0 or not resumed["step"] == full["step"] == TRAIN_ITERS:
        raise AssertionError("the resumed run does not end where the uninterrupted run ends")
    # steady: iterations 2-4 of the first run (the first iteration includes
    # cuDNN's and the allocator's warm-up)
    b = cfg.data["train_dataloader"]["samples_per_gpu"]
    print(f"[train] {smi}: b={b}, {t} frames, 128x128 crops, float32 (cuDNN TF32 on, "
          f"deterministic algorithms): {steady:.4f} s per iteration over iterations "
          f"2-{TRAIN_ITERS} = {1 / steady:.4f} it/s; {TRAIN_ITERS} iterations incl. start-up "
          f"{wall:.2f} s; peak device memory {peak / 2**30:.3f} GiB")
    return counts


def _serving_sample(rng, t, h, w, block=16):
    """One clip as a client submits it (time first): its own I/P/B slice
    pattern (first frame I), MVs constant over 16x16 blocks (6 px std),
    one-hot partitions over 8x8 blocks."""
    import numpy as np

    up = lambda a, k: np.repeat(np.repeat(a, k, 1), k, 2)  # noqa: E731
    slices = rng.choice(np.array([73.0, 80.0, 66.0], np.float32), size=t)
    slices[0] = 73.0
    return dict(
        lq=rng.random((t, h, w, 3), dtype=np.float32),
        qps=(rng.integers(20, 40, t) / 255.0).astype(np.float32),
        slices=slices,
        mvs=up((rng.standard_normal((t, h // block, w // block, 4)) * 6).astype(np.float32),
               block),
        base_qps=np.full(t, 35 / 255.0, np.float32),
        partitions=up(np.eye(3, dtype=np.float32)[rng.integers(0, 3, (t, h // 8, w // 8))]
                      / 255.0, 8),
    )


def phase_batched(dev, smi):
    """StreamScheduler + batched_forward_executor on the serving config:
    three streams of two 720p clips each; per-stream order, a batch of >= 3,
    each clip against itself enhanced alone, the launch counts."""
    import numpy as np
    import torch

    from pnp_vcve_torch.kernels import LAUNCHES, reset_launches
    from pnp_vcve_torch.serving import StreamScheduler, batched_forward_executor
    from pnp_vcve_torch.train.train_step import MODEL_INPUT_KEYS, make_eval_step

    model, cfg = _flagship_generator("HR_davis_LR_128x128_serving.py", dev)
    h, w = MAIN_HW
    rng = np.random.default_rng(SEED + 8)
    streams = [f"s{i}" for i in range(STREAMS)]
    # submission order: each stream's first clip, then each stream's second
    order = [(sid, k) for k in range(CLIPS_PER_STREAM) for sid in streams]
    samples = {key: _serving_sample(rng, FRAMES, h, w) for key in order}
    n_frames = len(order) * FRAMES
    sched = StreamScheduler(batched_forward_executor(model), max_batch=MAX_BATCH,
                            max_wait_s=1.0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    tickets = {key: sched.submit(key[0], samples[key]) for key in order}
    sched.close(drain=True)
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    outs = {key: t.wait() for key, t in tickets.items()}
    st = sched.stats()

    for sid in streams:
        done = [tickets[(sid, k)].done_at for k in range(CLIPS_PER_STREAM)]
        seqs = [tickets[(sid, k)].seq for k in range(CLIPS_PER_STREAM)]
        if seqs != list(range(CLIPS_PER_STREAM)) or done != sorted(done):
            raise AssertionError(f"stream {sid} completed out of order: seq {seqs}, done {done}")
    sizes = [d["batch"] for d in st["dispatches"]]
    if max(sizes) < 3:
        raise AssertionError(f"no dispatch carried 3 or more clips: {sizes}")
    # one launch per kernel and step serves every clip of a dispatch
    steps = FRAMES * len(sizes)
    gen_cfg = cfg.model["generator"]
    want = _launches_per_pass(steps, gen_cfg["num_blocks"], gen_cfg.get("warp_impl", "padgather"))
    print(f"[batched] launches {counts} (expected {want}: {len(sizes)} dispatches x {FRAMES} "
          f"steps, each launch covering its dispatch's clips; {n_frames} clip frames)")
    if counts != want:
        raise AssertionError("the batched path did not run every step through the kernels")

    # each clip alone (b=1), against its batched output
    eval_step = make_eval_step(model)
    errs, alone_s = [], 0.0
    for key in order:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = eval_step({k: samples[key][k][None] for k in MODEL_INPUT_KEYS})[0]
        alone_s += time.perf_counter() - t1
        out = outs[key]
        if out.shape != (FRAMES, h, w, 3) or not np.isfinite(out).all():
            raise AssertionError(f"clip {key}: output {out.shape} not finite/of the expected shape")
        errs.append(float(np.abs(out - ref).max()))
    lat = np.array([t.latency_s for t in tickets.values()])
    print(f"[batched] {smi}: {len(order)} clips x {FRAMES} frames at {h}x{w}, float32, "
          f"max_batch {MAX_BATCH}: dispatches "
          + ", ".join(f"b={d['batch']} {d['wall_s']:.3f} s" for d in st["dispatches"])
          + f"; per-clip latency p50 {np.percentile(lat, 50):.3f} s p95 "
          f"{np.percentile(lat, 95):.3f} s; aggregate {n_frames / wall:.3f} frames/s over "
          f"{wall:.3f} s (submit to drain); the same clips one at a time "
          f"{n_frames / alone_s:.3f} frames/s ({alone_s:.3f} s, host copies included); "
          f"peak device memory {peak / 2**30:.3f} GiB")
    print(f"[batched] each clip batched vs alone at b=1: max|diff| {max(errs):.3g} "
          f"(per clip {', '.join(f'{e:.3g}' for e in errs)}; <= {TOL_BATCHED})")
    if not max(errs) <= TOL_BATCHED:
        raise AssertionError("a batched clip differs from the same clip enhanced alone")
    return counts


def phase_curve():
    """tools/torch_serving_curve.py in a subprocess: a row for each b."""
    import torch

    torch.cuda.empty_cache()  # the subprocess needs the card's memory
    cmd = [sys.executable, str(ROOT / "tools" / "torch_serving_curve.py"), "--max-b", "4",
           "--t", str(FRAMES), "--iters", "2"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=ROOT)
    for line in proc.stdout.splitlines():
        print("[curve]", line)
    if proc.returncode != 0:
        raise AssertionError(f"torch_serving_curve.py failed ({proc.returncode}):\n"
                             f"{proc.stderr[-3000:]}")
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    if [r["b"] for r in rows] != [1, 2, 3, 4]:
        raise AssertionError(f"the curve has no row for each b = 1..4: {rows}")


def phase_handler(dev):
    """A servable of the serving config and the parity weights behind the
    HTTP handler on a free local port: 3 POSTed 720p PNGs come back as the
    PNGs of apis.restoration_inference; the health check answers."""
    import io
    import urllib.request

    import numpy as np
    import torch
    from PIL import Image

    from pnp_vcve_torch import apis
    from pnp_vcve_torch.kernels import LAUNCHES, reset_launches
    from pnp_vcve_torch.metrics import tensor2img

    sys.path.insert(0, str(ROOT / "tools"))
    import torch_pnp2servable
    import torch_serving_handler

    servable = torch_pnp2servable.pnp2servable(
        str(CONFIGS / "HR_davis_LR_128x128_serving.py"),
        str(ROOT / "tests/fixtures/parity/state_dict.npz"),
        str(ROOT / "build" / "chip_smoke" / "servables"), model_name="pnp_vcve", force=True)
    handler = torch_serving_handler.PnPServingHandler()
    handler.initialize(servable, device=dev.type)
    srv, port = torch_serving_handler.serve_background(handler, 0)
    rng = np.random.default_rng(SEED + 10)
    h, w = MAIN_HW
    # smooth content with noise, as a decoded frame: a gradient plus grain
    base = np.linspace(0, 200, w, dtype=np.float32)[None, :, None] + np.zeros((h, 1, 3))
    frames = [np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
              for _ in range(HANDLER_FRAMES)]
    answers, walls = [], []
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/ping", timeout=30) as r:
            if r.status != 200 or json.loads(r.read()) != {"status": "Healthy"}:
                raise AssertionError("the health check did not answer")
        reset_launches()
        for f in frames:
            buf = io.BytesIO()
            Image.fromarray(f).save(buf, format="PNG")
            req = urllib.request.Request(f"http://127.0.0.1:{port}/predictions/pnp_vcve",
                                         data=buf.getvalue(), method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as r:
                if r.status != 200 or r.headers["Content-Type"] != "image/png":
                    raise AssertionError(f"POST answered {r.status} {r.headers['Content-Type']}")
                answers.append(np.asarray(Image.open(io.BytesIO(r.read()))))
            walls.append(time.perf_counter() - t0)
        counts = dict(LAUNCHES)
    finally:
        srv.shutdown()
        srv.server_close()
    with torch.inference_mode():
        wants = [tensor2img(apis.restoration_inference(handler.model, f)) for f in frames]
    for got, want in zip(answers, wants):
        if got.shape != (h, w, 3) or not np.array_equal(got, want):
            raise AssertionError("a POST's PNG differs from apis.restoration_inference")
    gen_cfg = handler.model.cfg.model["generator"]
    expected = _launches_per_pass(HANDLER_FRAMES, gen_cfg["num_blocks"],
                                  gen_cfg.get("warp_impl", "padgather"))
    print(f"[handler] {HANDLER_FRAMES} POSTs of {h}x{w} PNGs: 200 image/png, equal as uint8 "
          f"to restoration_inference; request walls "
          f"{', '.join(f'{x:.3f}' for x in walls)} s (PNG decode and encode included); "
          f"launches {counts} (expected {expected}); /ping healthy")
    if counts != expected:
        raise AssertionError("the handler did not run every request through the kernels")
    return counts


def _block_form_generator(form, dev):
    """The training config's generator in a block form, through the builder
    and the restorer (``build_restorer``), with the parity fixture's weights
    where their names and shapes fit (the forms' own conv2 or conv1 keep
    their seeded init); returns the generator, its config and the count of
    tensors loaded out of all."""
    from pnp_vcve_torch.core.builder import build_restorer
    from pnp_vcve_torch.core.checkpoint import read_state_dict
    from pnp_vcve_torch.core.config import Config

    cfg = Config.fromfile(CONFIGS / "HR_davis_LR_128x128.py")
    gen_cfg = {**cfg.model["generator"], **BLOCK_FORMS[form]}
    model = build_restorer({**cfg.model, "generator": gen_cfg}, device=dev).generator
    own = model.state_dict()
    fit = {k: v for k, v in read_state_dict(ROOT / "tests/fixtures/parity/state_dict.npz").items()
           if k in own and own[k].shape == v.shape}
    model.load_state_dict(fit, strict=False)
    return model, gen_cfg, len(fit), len(own)


def phase_block_forms(dev, smi):
    """The training config in the block forms 'drt_woqp', one_layer=False and
    channel_first=False at full width: each kernel path against its plain
    path on one clip of 8 frames at 256x448 (TOL_MODEL), then a 720p clip
    of 8 frames, once to warm up and twice timed, with the last run's
    launch counts (the fused 'drt_woqp' on K3, the other two on K5); one_layer=False's gradients through the Functions
    (K5's Conv3x3Function among them) against the plain path. Returns the
    launches of each form's last 720p run, summed over the forms."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pnp_vcve_torch.kernels import KERNELS, LAUNCHES, PLAIN, reset_launches

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t = FRAMES
    repack_ms = _k5_repack_ms(dev)
    rng = np.random.default_rng(SEED + 11)
    small = _clip_inputs(rng, 1, t, *FORMS_HW, dev)
    big = _clip_inputs(rng, 1, t, *MAIN_HW, dev)
    total = {}
    for form in BLOCK_FORMS:
        model, gen_cfg, n_fit, n_all = _block_form_generator(form, dev)
        want = _launches_per_pass(t, gen_cfg["num_blocks"],
                                  fused_blocks=gen_cfg.get("one_layer", True)
                                  and gen_cfg.get("channel_first", True))
        with torch.inference_mode():
            reset_launches()
            got = model(**small)
            counts_small = dict(LAUNCHES)
            model.ops = PLAIN
            ref = model(**small)
            model.ops = KERNELS
            err = float((got - ref).abs().max())
            del got, ref
            # one untimed 720p clip first: the allocator's first 720p blocks
            # cost a quarter of a clip's time, which no later clip pays
            model(**big)
            walls = []
            for _ in range(2):
                torch.cuda.synchronize()
                reset_launches()
                t0 = time.perf_counter()
                out = model(**big)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                counts = dict(LAUNCHES)
            if not want["drt_block"]:
                reset_launches()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    model(**big)
                    torch.cuda.synchronize()
                prof_counts = dict(LAUNCHES)
        ok = bool(torch.isfinite(out).all()) and out.shape == (1, t, *MAIN_HW, 3)
        del out
        print(f"[forms] {form}: {n_fit} of {n_all} tensors from the parity fixture; kernel path "
              f"vs plain path, {t} frames {FORMS_HW[0]}x{FORMS_HW[1]} float32: max|diff| "
              f"{err:.3g} (<= {TOL_MODEL}); {smi}: {t} frames at {MAIN_HW[0]}x{MAIN_HW[1]} "
              f"float32 in {walls[0]:.3f} / {walls[1]:.3f} s = "
              f"{t / walls[0]:.3f} / {t / walls[1]:.3f} frames/s; launches {counts} "
              f"(expected {want})")
        if not ok or err > TOL_MODEL:
            raise AssertionError(f"{form}: kernel path disagrees with its plain path or 720p "
                                 "output not finite/of the expected shape")
        if counts != want or counts_small != want or (want["conv3x3"] and not counts["conv3x3"]):
            raise AssertionError(f"{form}: the forward did not run through the kernels")
        if not want["drt_block"]:
            _print_form_profile(form, prof, walls[-1], prof_counts, repack_ms)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        if form == "one_layer_false":
            _grad_check("forms grad", model, gen_cfg,
                        _launches_per_pass(GRAD_T, gen_cfg["num_blocks"], fused_blocks=False),
                        SEED + 12, dev)
        del model
        torch.cuda.empty_cache()
    return total


def _device_time(prof):
    """``(busy s, {kernel name: s})`` of the device in a profile (busy: the
    union of the kernels' intervals), or None where it recorded no device
    event."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.events():
        # the ProfilerStep annotation is mirrored on the device's timeline
        if e.device_type != DeviceType.CUDA or e.name.startswith("ProfilerStep"):
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (end - start) * 1e-6
    if not spans:
        return None
    busy, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    return busy * 1e-6, by_name


def _k5_repack_ms(dev):
    """Device milliseconds of K5's wrapper preparing one launch's operands
    for the block forms (b = 1, 720p, 64 -> 64, float32): the per-sample
    taps transposed, split for 3xTF32 and laid out as the kernel reads
    them, the bias and gain as float32 (one CUDA graph of 20 calls)."""
    import torch

    from pnp_vcve_torch.kernels import conv_block

    # a tree without K5's wgmma design hands the kernel conv3x3_args' operands
    prep = getattr(conv_block, "conv3x3_operands", conv_block.conv3x3_args)
    gen = torch.Generator().manual_seed(SEED + 13)
    c = 64
    args = (torch.empty((1, *MAIN_HW, c), device=dev),
            (torch.randn((1, 3, 3, c, c), generator=gen) * 0.03).to(dev),
            (torch.randn((1, c), generator=gen) * 0.1).to(dev),
            torch.rand((1, c), generator=gen).to(dev))
    ms = _graph_ms(lambda a: prep(*a), [args], 20)
    print(f"[forms] K5's wrapper repacking one launch's operands (b=1, {c} -> {c}, float32): "
          f"{ms:.4f} device ms")
    return ms


def _print_form_profile(form, prof, wall_s, counts, repack_ms):
    """Device time of one profiled 720p clip of an unfused block form
    (``counts``: its launches): busy time and idle share against the
    unprofiled clip, K5's share and the port's kernels' share of the device
    time, K5's device time a launch beside its wrapper's repacking
    (``repack_ms``, device ms a launch), the top kernels."""
    found = _device_time(prof)
    if found is None:
        print(f"[forms] {form}: profiler recorded no device events; breakdown not measured")
        return
    busy, by_name = found
    total = sum(by_name.values())
    times = _kernel_times(by_name, counts, DEVICE_FUNCS)
    k5, ours = times["conv3x3"], sum(times.values())
    k5_ms = k5 * 1e3 / counts["conv3x3"]
    print(f"[forms] {form}, one profiled 720p clip: device busy {busy:.4f} s, idle share "
          f"{max(0.0, 1 - busy / wall_s):.4f} of the unprofiled {wall_s:.4f} s clip; K5 "
          f"{k5:.4f} s = {k5 / total:.4f} of device time, K1-K5 {ours / total:.4f}, the rest "
          f"{total - ours:.4f} s (the partition path, ReLU, residual and premix as torch ops)")
    print(f"[forms] {form}: K5 {k5_ms:.4f} device ms a launch ({counts['conv3x3']} launches); "
          f"its wrapper's repacking {repack_ms:.4f} ms a launch = {repack_ms / k5_ms:.4f} of it")
    for name, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[forms]   {v:.4f} s {v / total:.4f}  {name[:110]}")


def _print_breakdown(prof, window_s, steady_s, counts):
    """Device time of the profiled iteration by kernel: the device's busy
    time and idle share in the profiled window and against an unprofiled
    iteration, each of K1-K5's and their share of the device time (``counts``:
    the profiled run's launches), the top kernels."""
    found = _device_time(prof)
    if found is None:
        print("[train] profiler: no device events recorded; breakdown not measured")
        return
    busy, by_name = found
    total = sum(by_name.values())
    times = _kernel_times(by_name, counts, DEVICE_FUNCS)
    k = sum(times.values())
    print(f"[train] profiled iteration (resumed run, iteration {TRAIN_ITERS}): device busy "
          f"{busy:.4f} s; idle share {max(0.0, 1 - busy / window_s):.4f} of the profiled "
          f"{window_s:.4f} s, {max(0.0, 1 - busy / steady_s):.4f} of an unprofiled "
          f"{steady_s:.4f} s iteration; K1-K5 {k:.4f} s = {k / total:.4f} of device time "
          f"(forward and remat recompute: "
          + ", ".join(f"{n} {v / total:.4f}" for n, v in times.items())
          + f"); the rest {total - k:.4f} s (the Functions' plain replay and its backward, the "
          f"loss, Adam)")
    for name, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[train]   {v:.4f} s {v / total:.4f}  {name[:110]}")


def _probe_check(tag, got, ref, rule):
    """Hold a probe kernel's output to its plain version's: "bitwise" (every
    tensor of a tuple), "rel" (max|diff| <= 1e-5 max|ref|) or "bf16"
    (phase 3's bf16 bounds). A bf16 ``got`` against a float32 ``ref`` under
    "rel" (cuDNN's bf16 conv against K10's float32 output) is also allowed
    its own rounding to bf16: half a bf16 ulp of the larger of the two
    values. Returns max|diff|."""
    import torch

    torch.cuda.synchronize()
    if rule == "bf16":
        return _compare(tag, got, ref, torch.bfloat16, (0.02, 0.002))
    if rule == "conv3x3":  # K5: phase 3's bounds in the output's type
        return _compare(tag, got, ref, got.dtype, BF16_BOUNDS["conv3x3"])
    pairs = list(zip(got, ref)) if isinstance(got, tuple) else [(got, ref)]
    err = max(float((g.double() - r.double()).abs().max()) for g, r in pairs)
    if rule == "bitwise":
        ok = all(g.dtype == r.dtype and g.shape == r.shape and torch.equal(g, r) for g, r in pairs)
        bound = "bitwise"
    elif got.dtype == torch.bfloat16 and ref.dtype == torch.float32:
        scale = float(ref.double().abs().max())
        g, r = got.double(), ref.double()
        big = torch.maximum(g.abs(), r.abs()).clamp_min(torch.finfo(torch.float32).tiny)
        half_ulp = torch.exp2(torch.floor(torch.log2(big)) - 8)  # bf16: 8 significant bits
        ok = bool(torch.isfinite(got).all()) and bool(((g - r).abs() <= half_ulp
                                                        + 1e-5 * scale).all())
        bound = f"<= half a bf16 ulp + 1e-5 max|ref| = {1e-5 * scale:.3g}"
    else:
        scale = float(ref.double().abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= 1e-5 * scale
        bound = f"<= 1e-5 max|ref| = {1e-5 * scale:.3g}"
    print(f"[probes] {tag}: max|diff| {err:.3g} ({bound})")
    if not ok:
        raise AssertionError(f"{tag}: kernel disagrees with its plain version")
    return err


def _probe_cases(int8, warp2, bisect):
    """One dict per stage of the three probe tools: the kernel it times, its
    TPU function, the timed call and its inputs, its plain version, the
    comparison rule, one PyTorch call computing the same function (or None)
    and, where it gives the kernel's dtype, the part of the kernel's output
    it gives (held to it by the same rule), the reps the JAX file times
    over, and the work (bytes, operations by type) of this run's inputs
    (tools/torch_kernel_bounds.py). The plain version and the library call
    take the inputs as one tuple, so that they can run on copies of them."""
    import torch
    import torch.nn.functional as F

    from pnp_vcve_torch.kernels import probes as P
    import torch_kernel_bounds as kb

    cases = []

    def add(kernel, tpu, res, plain, rule, library, reps, work, out=None, lib_of=None):
        cases.append(dict(kernel=kernel, tpu=tpu, out=res["out"] if out is None else out,
                          fn=res["fn"], args=res["args"], plain=plain, rule=rule,
                          library=library, lib_of=lib_of, reps=reps, work=work))

    # tools/int8_probe.py; every K8 form also on device time, k1 (the wgmma
    # design) beside the mma.sync design it replaced
    r = int8["bf16 matmul"]
    a, b = r["args"]
    m, k = a.shape
    n = b.shape[1]
    add("matmul", "k1 bf16 matmul (:70)", r, lambda a: P.matmul_plain(*a), "rel",
        lambda a: torch.matmul(*a), 100, kb.matmul_work(m, k, n, "bf16"))
    cases[-1]["device"] = True
    if _has_entry("pnp_matmul_mma_sync"):
        add("matmul", "k1 bf16 matmul (:70), the mma.sync yardstick",
            dict(out=_mma_sync_matmul(a, b), fn=_mma_sync_matmul, args=(a, b)),
            lambda a: P.matmul_plain(*a), "rel", lambda a: torch.matmul(*a), 100,
            kb.matmul_work(m, k, n, "bf16"))
        cases[-1]["device"] = True
    r = int8["int8 matmul"]
    add("matmul", "k2 int8 matmul (:80)", r, lambda a: P.matmul_plain(*a), "bitwise",
        lambda a: torch._int_mm(*a), 100, kb.matmul_work(m, k, n, "int8", out_bytes=4),
        lib_of=lambda o: o)
    cases[-1]["device"] = True
    r = int8["quantize-in-kernel + int8 matmul"]
    a3, _ = r["args"]

    def k3_plain(a):
        q, s = P.absmax_quantize_plain(a[0])
        return P.matmul_plain(q, a[1], s)

    add("matmul", "k3 K9 + int8 matmul (:100)", r, k3_plain, "bitwise", None, 100,
        kb.quantized_matmul_work(m, k, n))
    cases[-1]["device"] = True
    res_q = dict(fn=P.absmax_quantize, args=(a3,), out=None)
    add("absmax_quantize", "k3's quantize (:100)", res_q, lambda a: P.absmax_quantize_plain(*a),
        "bitwise", None, 100, kb.quantize_work(a3.numel()), out=P.absmax_quantize(a3))
    r = int8["bf16 tap-conv (same geometry)"]  # K10's headline: it has a library call
    band_bf, w_bf = r["args"]
    c2 = band_bf.shape[2]
    rows, cols, cout = r["out"].shape
    w_oihw = w_bf.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    add("tapconv", "k5 bf16 tap conv (:148)", r,
        lambda a: P.tapconv_plain(*a, rows, cols), "rel",
        # an NCHW view, channels last, of the band's first rows + 2 x cols + 2;
        # its bf16 output seen as (rows, cols, cout)
        lambda a: F.conv2d(a[0].permute(2, 0, 1)[None, :, :rows + 2, :cols + 2],
                           w_oihw)[0].permute(1, 2, 0), 50,
        kb.tapconv_work(rows, cols, c2, cout, "bf16"), lib_of=lambda o: o)

    r = int8["int8 tap-conv (strided slices)"]
    band, wq = r["args"]

    def k4_plain(a):
        q, s = P.absmax_quantize_plain(a[0])
        return P.tapconv_plain(q, a[1], rows, cols, s)

    # K10 int8 alone on k4's quantized band (its headline), on device time;
    # beside it the mma.sync design it replaced; then k4 as the probe runs it
    q, s = P.absmax_quantize(band)

    def k10_int8(q_, wq_, s_):
        return P.tapconv(q_, wq_, rows, cols, s_)

    add("tapconv_int8", "k4's int8 tap conv alone (:127), s given",
        dict(out=k10_int8(q, wq, s), fn=k10_int8, args=(q, wq, s)),
        lambda a: P.tapconv_plain(*a[:2], rows, cols, a[2]), "bitwise", None, 50,
        kb.tapconv_work(rows, cols, c2, cout, "int8"))
    cases[-1]["device"] = True

    def yard(q_, wq_, s_):
        return _mma_sync_tapconv(q_, wq_, s_, rows, cols)

    add("tapconv_int8", "k4's int8 tap conv alone (:127), s given, the mma.sync yardstick",
        dict(out=yard(q, wq, s), fn=yard, args=(q, wq, s)),
        lambda a: P.tapconv_plain(*a[:2], rows, cols, a[2]), "bitwise", None, 50,
        kb.tapconv_work(rows, cols, c2, cout, "int8"))
    cases[-1].update(device=True, plain_timed=False)
    add("tapconv_int8", "k4 K9 + int8 tap conv (:127)", r, k4_plain, "bitwise", None, 50,
        kb.quantized_tapconv_work(*band.shape[:2], rows, cols, c2, cout))
    cases[-1]["device"] = True
    add("absmax_quantize", "k4's quantize (:127)", dict(fn=P.absmax_quantize, args=(band,)),
        lambda a: P.absmax_quantize_plain(*a), "bitwise", None, 50,
        kb.quantize_work(band.numel()), out=P.absmax_quantize(band))
    # tools/warp_kernel_probe2.py
    r = warp2["band DMA floor (128-lane)"]
    src, oh, ow, y0, x0 = r["args"]
    add("window_copy", "probe_floor128 (:78)", r, lambda a: P.window_copy_plain(*a),
        "bitwise", lambda a: torch.mul(a[0][:, a[3]:a[3] + a[1], a[4]:a[4] + a[2]], 2),
        30, kb.copy_work(1, oh, oh, ow, src.shape[3]), lib_of=lambda o: o)
    r = warp2["matmul-select H + dense V"]
    xp, s_all, vm = r["args"]
    nb, nt, _, kw = s_all.shape
    add("mmsel", "probe_mmsel (:126)", r, lambda a: P.mmsel_warp_plain(*a), "bf16",
        None, 30, kb.mmsel_work(nb, nt, kw, xp.shape[3], vm.shape[2] + 7, nt * 128, vm.shape[2],
                                s_nnz=int((s_all != 0).sum()), vm_nnz=int((vm != 0).sum())))

    # tools/warp_bisect.py
    for name, r in bisect.items():
        form = name.rstrip("0123456789")
        x = r["args"][0]
        lanes = x.shape[3]
        if form == "fori":  # the library's (rows, 128, lanes) is columns 0..127 of the output
            _, s1, nbb, j0, w_out = r["args"]
            kw = s1.shape[3]
            add("mmsel", f"k_fori_dot({lanes}) (:105)", r, lambda a: P.mmsel_h_plain(*a), "bf16",
                lambda a, kw=kw: torch.matmul(a[1][0, 0], a[0][0, a[3]:a[3] + 8 * a[2], :kw]),
                30, kb.mmsel_work(nbb, 1, kw, lanes, 8, w_out, s_bands=1,
                                  s_nnz=int((s1 != 0).sum())),
                lib_of=lambda o: o[0, :, :P.TILE])
        else:  # the period form repeats rows y0 .. y0 + period: a broadcast view
            _, oh, ow, y0, x0, *period = r["args"]
            period = period[0] if period else 0
            rows_in = min(period, oh) if period else oh
            add("window_copy", f"k_{form}({lanes}) (:{52 if form == 'dma' else 72})", r,
                lambda a: P.window_copy_plain(*a), "bitwise",
                lambda a, y0=y0, x0=x0, oh=oh, ow=ow, n=rows_in, c=lanes: torch.mul(
                    a[0][:, y0:y0 + n, x0:x0 + ow].unsqueeze(1).expand(-1, oh // n, -1, -1, -1),
                    2).reshape(1, oh, ow, c),
                30, kb.copy_work(1, rows_in, oh, ow, lanes), lib_of=lambda o: o)
    return cases


def _k5_geometry_cases(dev):
    """K10 in bf16 and int8 (with K9) at K5's 720p 64 -> 64 geometry, beside
    one cuDNN conv of the band, and K5 itself there (a 'same' conv of the
    frame, b = 1, with bias and gain) in float32 and bf16 beside one
    channels-last cuDNN conv of the same function, as _probe_cases makes
    its cases: K10 bf16 within 1e-5 of max|ref| and cuDNN's bf16 output held
    to it by the same rule (and its own rounding), int8 bitwise, K5 by phase
    3's bounds against its plain version in float32; K5 also on device time
    (one CUDA graph) though it takes more than 0.1 ms, and beside it its
    mma.sync design, the yardstick, and its wgmma design with the other
    staging of its input (bf16 by tensor-map boxes, float32 by cp.async)."""
    import torch
    import torch.nn.functional as F

    from pnp_vcve_torch.kernels import KERNELS
    from pnp_vcve_torch.kernels import probes as P
    from pnp_vcve_torch.kernels.conv_block import conv3x3_plain
    import torch_kernel_bounds as kb

    h, w, c = K5_GEOMETRY
    gen = torch.Generator().manual_seed(SEED + 12)
    band = torch.randn((h + 2, w + 2, c), generator=gen).to(dev, torch.bfloat16)
    wt = (torch.randn((3, 3, c, c), generator=gen) * 0.05).to(dev)
    w_bf = wt.to(torch.bfloat16)
    wq, _ = P.absmax_quantize(w_bf)
    q, s = P.absmax_quantize(band)
    x = band[1:h + 1, 1:w + 1][None].contiguous()  # K5 pads the frame itself
    w_oihw = w_bf.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    cases = []

    def add(kernel, tpu, fn, args, plain, rule, library, work, lib_of=None):
        cases.append(dict(kernel=kernel, tpu=f"{tpu} at K5's geometry {h}x{w}, {c} -> {c}",
                          out=fn(*args), fn=fn, args=args, plain=plain, rule=rule,
                          library=library, lib_of=lib_of, reps=20, work=work))

    def k9_k10(b, wq_):
        q_, s_ = P.absmax_quantize(b)
        return P.tapconv(q_, wq_, h, w, s_)

    def k9_k10_plain(a):
        q_, s_ = P.absmax_quantize_plain(a[0])
        return P.tapconv_plain(q_, a[1], h, w, s_)

    add("tapconv", "K10 bf16", lambda b, w_: P.tapconv(b, w_, h, w), (band, w_bf),
        lambda a: P.tapconv_plain(*a, h, w), "rel",
        # the band's NCHW view, channels last; the bf16 output seen as (h, w, c)
        lambda a: F.conv2d(a[0].permute(2, 0, 1)[None], w_oihw)[0].permute(1, 2, 0),
        kb.tapconv_work(h, w, c, c, "bf16"), lib_of=lambda o: o)
    add("tapconv_int8", "K10 int8 (s given)", lambda q_, wq_, s_: P.tapconv(q_, wq_, h, w, s_),
        (q, wq, s), lambda a: P.tapconv_plain(*a[:2], h, w, a[2]), "bitwise", None,
        kb.tapconv_work(h, w, c, c, "int8"))
    add("tapconv_int8", "K10 int8 (s given), the mma.sync yardstick",
        lambda q_, wq_, s_: _mma_sync_tapconv(q_, wq_, s_, h, w), (q, wq, s),
        lambda a: P.tapconv_plain(*a[:2], h, w, a[2]), "bitwise", None,
        kb.tapconv_work(h, w, c, c, "int8"))
    cases[-1]["plain_timed"] = False
    add("tapconv_int8", "K9 + K10 int8", k9_k10, (band, wq), k9_k10_plain, "bitwise", None,
        kb.quantized_tapconv_work(h + 2, w + 2, h, w, c, c))
    # K5 itself at b = 1 in both types, with its bias and gain: against its
    # plain version in float32 (TF32 off) by phase 3's bounds, timed cold
    # and on device time (the wrapper's weight repacking included) beside
    # one channels-last cuDNN conv of the same function, the gain folded
    # into its weights and bias (in the type, prepared once)
    for dtype in (torch.float32, torch.bfloat16):
        xk = (x if dtype == torch.bfloat16
              else torch.randn((1, h, w, c), generator=gen).to(dev))
        k5 = ((torch.randn((1, 3, 3, c, c), generator=gen) * 0.03).to(dev),
              (torch.randn((1, c), generator=gen) * 0.1).to(dev),
              torch.rand((1, c), generator=gen).to(dev))
        k, bias, g = k5
        w_cl = ((k * g[:, None, None, None, :])[0].permute(3, 2, 0, 1).to(dtype)
                .contiguous(memory_format=torch.channels_last))
        b_cl = (bias * g)[0].to(dtype)
        name = str(dtype)[6:]
        designs = {"": lambda *a: KERNELS.conv3x3(*a)}
        for label, entry in ((", the mma.sync yardstick", "pnp_conv3x3_mma_sync"),
                             (", the other input staging", "pnp_conv3x3_wg_alt_staging")):
            if _has_entry(entry):
                designs[label] = lambda *a, e=entry: _conv3x3_yardstick(e, *a)
        for label, fn in designs.items():
            add("conv3x3", f"K5 {name} (bias and gain, b=1){label}", fn, (xk, *k5),
                lambda a: conv3x3_plain(a[0].float(), *a[1:]), "conv3x3",
                # the NHWC frame seen as NCHW is channels-last: cuDNN takes it as it is
                lambda a, w_=w_cl, b_=b_cl: F.conv2d(a[0].permute(0, 3, 1, 2), w_, b_,
                                                     padding=1),
                kb.conv3x3_work(1, h, w, c, c, "bf16" if dtype == torch.bfloat16 else "tf32x3",
                                xk.element_size()))
            cases[-1]["device"] = True
    return cases


def _has_entry(entry):
    """Whether the built library has C entry ``entry``: a tree without the
    wgmma designs of K5 and K8 has no entry for their mma.sync yardsticks
    (tools/torch_probe_turns.py runs phase 12 on such a tree)."""
    from pnp_vcve_torch.kernels.build import library

    return hasattr(library().lib, entry)


def phase_probes(dev, smi):
    """Phase 12: the three probe tools at their full shapes on the card (the
    probe path: every launch of K6-K10 counted), then each stage's kernel
    against its plain version on the same inputs and timed beside it, the
    library call and the bound; K10 at K5's geometry the same way, beside
    K5 and cuDNN (launches there not counted in the path's)."""
    import torch

    sys.path.insert(0, str(ROOT / "tools"))
    import torch_int8_probe
    import torch_warp_bisect
    import torch_warp_kernel_probe2

    from pnp_vcve_torch.kernels import probes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[probes] {smi}")
    probes.reset_launches()
    int8 = torch_int8_probe.main([])
    warp2 = torch_warp_kernel_probe2.main([])
    bisect = torch_warp_bisect.main(list(torch_warp_bisect.STAGES))
    torch.cuda.synchronize()
    counts = dict(probes.LAUNCHES)
    print(f"[probes] launches of the three tools: {counts}")
    failed = [k for res in (int8, warp2, bisect) for k, v in res.items() if v["out"] is None]
    if failed or not all(counts[k] for k in ("window_copy", "mmsel", "matmul", "absmax_quantize",
                                             "tapconv", "tapconv_int8")):
        raise AssertionError(f"probe stages failed: {failed}; launches {counts}")
    _tapconv_int8_edges(dev)
    rows = _probe_rows(_probe_cases(int8, warp2, bisect), smi)
    k5 = _probe_rows(_k5_geometry_cases(dev), smi)
    out = _probe_summary(rows, counts, "phase12_launches")
    out["tapconv"]["k5_geometry"] = k5["tapconv"] + k5["conv3x3"]
    out["tapconv_int8"]["k5_geometry"] = k5["tapconv_int8"]
    return out


# K10 int8's edge shapes (rows, cols, cin, cout): ragged rows and columns,
# cin 32, 96 (a chunk half past cin), 256 (four chunks, 4-row items) and
# 320 (past the resident weights: the mma.sync design), cout 8-128
TAPCONV8_EDGES = ((5, 18, 32, 8), (13, 45, 96, 72), (9, 33, 64, 128), (21, 70, 128, 24),
                  (37, 100, 256, 64), (6, 40, 320, 16))


def _tapconv_int8_edges(dev):
    """K10 int8 bitwise against its plain version at ``TAPCONV8_EDGES``, the
    band 3 rows and 5 columns larger than the output needs."""
    import torch

    from pnp_vcve_torch.kernels import probes as P

    gen = torch.Generator().manual_seed(SEED + 21)
    for rows, cols, cin, cout in TAPCONV8_EDGES:
        q = torch.randint(-127, 128, (rows + 5, cols + 7, cin), generator=gen,
                          dtype=torch.int8).to(dev)
        w = torch.randint(-127, 128, (3, 3, cin, cout), generator=gen, dtype=torch.int8).to(dev)
        s = torch.tensor([0.0123], device=dev)
        _probe_check(f"tapconv_int8: edge {rows}x{cols}, {cin} -> {cout}",
                     P.tapconv(q, w, rows, cols, s), P.tapconv_plain(q, w, rows, cols, s),
                     "bitwise")


L2_BYTES = 50 * 2**20     # the H100's L2
COLD_BYTES = 150 * 10**6  # rotated copies of a stage's inputs total at least this
DEVICE_BELOW_MS = 0.1     # a kernel this fast by the old method also gets its device time
BOUND_GATE = 1.05         # no kernel reading may pass its bound by more than 5%


def _nbytes(args):
    import torch

    return sum(a.nbytes for a in args if isinstance(a, torch.Tensor))


def _rotation(args):
    """``args`` and copies of it (every tensor cloned): at least three, and
    at least ``COLD_BYTES`` of inputs together."""
    import torch

    k = max(3, -(-COLD_BYTES // max(_nbytes(args), 1)))
    return [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
                     for _ in range(k - 1)]


def _rotated_ms(f, sets, n):
    """Milliseconds a call of ``f`` over n calls that take the argument sets
    in turn (CUDA events), after one call on each set; the last k outputs
    stay alive, so the outputs rotate as well."""
    import torch

    outs = [f(a) for a in sets]
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        outs[i % len(sets)] = f(sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _graph_ms(f, sets, n, replays=3):
    """Device milliseconds a call of ``f``: max(n, len(sets)) calls over the
    argument sets in turn, captured in one CUDA graph (each output kept, so
    none is reused) after a warm-up on every set, replayed once, then timed
    over ``replays`` replays."""
    import torch

    calls = max(n, len(sets))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in sets:
            f(a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(calls):
            outs.append(f(sets[i % len(sets)]))
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph, outs
    return ms


def _probe_rows(cases, smi):
    """Each case's kernel output against its plain version (and the library
    call's against the kernel's, where it gives the kernel's dtype), then
    timed in turns beside the library call and the bound, by the old
    method, cold and on the device where each applies (PROBE TIMING in the
    module's notes); a kernel reading above ``BOUND_GATE`` times what its
    bound allows fails: {kernel: [row]}. A case with ``plain_timed`` False
    (a yardstick: another design of the same kernel) is held to its plain
    version but not timed beside it; one with ``warm`` is also timed on
    device time over its one input set (``warm_device_ms``: its inputs and
    outputs left in the L2 by the call before), a reading of the L2, not
    held to the bound."""
    import torch

    import torch_kernel_bounds as kb

    rows = {}
    for c in cases:
        tag = f"{c['kernel']}: {c['tpu']}"
        args = c["args"]
        kern = lambda a, fn=c["fn"]: fn(*a)  # noqa: E731
        err = _probe_check(tag, c["out"], c["plain"](args), c["rule"])
        if c["lib_of"]:
            _probe_check(f"{tag}: library call", c["library"](args), c["lib_of"](c["out"]),
                         c["rule"])
        plain = c["plain"] if c.get("plain_timed", True) else None
        # (i) the old method: back to back on one input, host enqueue included
        p1, k1, k2, p2 = (None if f is None else _timed(lambda f=f: f(args), c["reps"])
                          for f in (plain, kern, kern, plain))
        lib = _timed(lambda: c["library"](args), c["reps"]) if c["library"] else None
        b_ms, by, t_bytes, t_ops = kb.bound(c["work"])
        in_bytes = _nbytes(args)
        sets = _rotation(args)
        cold = dict(cold_ms=None, plain_cold_ms=None, library_cold_ms=None)
        if in_bytes > L2_BYTES:  # (ii) cold, in turns
            fns = {"plain": plain, "kernel": kern, "library": c["library"]}
            t = {n: [] for n in fns}
            for n in ("plain", "kernel", "library", "library", "kernel", "plain"):
                if fns[n] is not None:
                    t[n].append(_rotated_ms(fns[n], sets, c["reps"]))
            cold = dict(cold_ms=sum(t["kernel"]) / 2,
                        plain_cold_ms=sum(t["plain"]) / 2 if t["plain"] else None,
                        library_cold_ms=sum(t["library"]) / 2 if t["library"] else None)
        dev = dict(device_ms=None, library_device_ms=None)
        if min(k1, k2) < DEVICE_BELOW_MS or c.get("device"):  # (iii) the device's time
            dev["device_ms"] = _graph_ms(kern, sets, c["reps"])
            if c["library"] is not None:
                try:
                    dev["library_device_ms"] = _graph_ms(c["library"], sets, c["reps"])
                except RuntimeError as e:  # a library call that a graph cannot hold
                    print(f"[probes] {tag}: the library call in a CUDA graph failed: "
                          f"{repr(e)[:300]}; its device time not measured")
                    torch.cuda.synchronize()
        if c.get("warm"):  # the L2's reading: one input set, left there by the call before
            dev["warm_device_ms"] = _graph_ms(kern, [args], c["reps"])
        ncopies = len(sets)
        del sets
        row = dict(tpu=c["tpu"], max_abs_err=err, ms=(k1 + k2) / 2,
                   plain_ms=None if p1 is None else (p1 + p2) / 2,
                   bound_ms=b_ms, bound_by=by, library_ms=lib, **cold, **dev,
                   in_bytes=in_bytes, **c.get("extra", {}))
        rows.setdefault(c["kernel"], []).append(row)

        def f4(v):
            return "not measured" if v is None else f"{v:.4f} ms"

        warm = (f", warm device (its one input set in the L2) {f4(dev['warm_device_ms'])}"
                if c.get("warm") else "")
        print(f"[time] {tag}: host-enqueue (warm, back to back) kernel {k1:.4f} / {k2:.4f} ms, "
              f"plain {f4(p1)} / {f4(p2)}, library {f4(lib)}; cold (rotated over "
              f"{ncopies} x {in_bytes / 1e6:.1f} MB) kernel "
              f"{f4(cold['cold_ms'])}, plain {f4(cold['plain_cold_ms'])}, library "
              f"{f4(cold['library_cold_ms'])}; device (CUDA graph) kernel "
              f"{f4(dev['device_ms'])}, library {f4(dev['library_device_ms'])}{warm}; bound "
              f"{b_ms:.4f} ms ({by}: bytes {t_bytes:.4f}, ops {t_ops:.4f}); {smi}")
        readings = [v for v in (cold["cold_ms"], dev["device_ms"]) if v is not None]
        over = [v for v in readings or [row["ms"]] if b_ms > BOUND_GATE * v]
        if over:
            raise AssertionError(f"{tag}: kernel reading {over} ms is above {BOUND_GATE:.0%} of "
                                 f"its bound {b_ms:.4f} ms: a measurement error")
    return rows


def _probe_summary(rows, counts, path):
    """{kernel: its JSON row}: the first stage is the headline, every stage
    under ``forms``; ``launches`` the path's count (``path`` names it too)."""
    return {name: dict(max_abs_err=max(r["max_abs_err"] for r in rs),
                       **{k: rs[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "library_ms", "cold_ms", "device_ms")},
                       forms=rs, launches=counts[name], **{path: counts[name]})
            for name, rs in rows.items()}


def _probe_cases_b10b(wkp, dma):
    """One dict per stage of tools/torch_warp_kernel_probe.py and per
    configuration of tools/torch_dma_probe.py, as _probe_cases makes them:
    every rule bitwise (K11 by its test's rule: the same fused multiply-adds
    in the same order); the library calls ``torch.mul`` on the strided
    window (probe_floor) and ``z.clone()`` (the copies that write the
    array out)."""
    import torch

    from pnp_vcve_torch.kernels import probes as P
    import torch_kernel_bounds as kb

    cases = []

    def add(kernel, tpu, res, plain, library, reps, work, extra=None):
        cases.append(dict(kernel=kernel, tpu=tpu, out=res["out"], fn=res["fn"],
                          args=res["args"], plain=plain, rule="bitwise", library=library,
                          lib_of=(lambda o: o) if library else None, reps=reps, work=work,
                          extra=extra or {}))

    r = wkp["band DMA floor"]
    src, oh, ow, y0, x0 = r["args"]
    add("window_copy", "probe_floor (:69)", r, lambda a: P.window_copy_plain(*a),
        lambda a: torch.mul(a[0][:, a[3]:a[3] + a[1], a[4]:a[4] + a[2]], 2), 30,
        kb.copy_work(1, oh, oh, ow, src.shape[3]))
    # K11 and K12: the input bytes are the distinct pixels this run's tables pick
    cases += _gather2_cases(wkp)
    r = wkp["per-block window DMAs (320/band)"]
    xp, sy, sx = r["args"][:3]
    add("block_windows", "probe_dma (:179)", r, lambda a: P.block_windows_plain(*a), None, 30,
        kb.block_windows_work(sy.cpu().numpy(), sx.cpu().numpy(), *xp.shape[1:]))

    def writes_out(res):
        return res["args"][1 if res["fn"] is P.stream_copy else 2]

    # the configurations that write the array out first: each kernel's
    # headline has a library call (z.clone())
    for label, res in sorted(dma.items(), key=lambda kv: not writes_out(kv[1])):
        z, write_out = res["args"][0], writes_out(res)
        kernel = "stream_copy" if res["fn"] is P.stream_copy else "ring_copy"
        line = 173 if kernel == "stream_copy" else 104
        add(kernel, f"{'run_pipelined' if line == 173 else 'run'} {label} (:{line})", res,
            lambda a, wo=write_out: P.ring_copy_plain(a[0], wo),
            (lambda a: a[0].clone()) if write_out else None, 30,
            kb.chunk_copy_work(*z.shape[1:], write_out),
            extra=dict(chained_ms=res["ms"]))
    return cases


GATHER_L2_BANDS = 12  # K11 on this many bands: its 39 MB of input and output fit the L2


def _gather2_cases(wkp):
    """K11's cases, as _probe_cases_b10b makes them: the probe's stage (the
    headline), then the probe's tables on its first ``GATHER_L2_BANDS``
    bands, whose input and output fit the L2, also timed warm (its
    ``warm_device_ms``: what the L2 allows)."""
    from pnp_vcve_torch.kernels import probes as P
    import torch_kernel_bounds as kb

    cases = []

    def add(tpu, fn, args, work, **extra):
        cases.append(dict(kernel="gather2", tpu=tpu, out=fn(*args), fn=fn, args=args,
                          plain=lambda a: P.gather2_plain(*a), rule="bitwise", library=None,
                          lib_of=None, reps=30, work=work, **extra))

    r = wkp["dense select (35H+35V)"]
    xp, shidx, wx0, wx1, dyidx, wy0, wy1, x0 = r["args"]
    work = kb.gather2_work(shidx.cpu().numpy(), dyidx.cpu().numpy(), *xp.shape[1:], x0)
    add("probe_select (:124)", r["fn"], r["args"], work)
    nb = GATHER_L2_BANDS
    small = (xp[:, :8 * (nb - 1) + P.GATHER_BAND].contiguous(),
             *(t[:nb].contiguous() for t in (shidx, wx0, wx1, dyidx, wy0, wy1)), x0)
    work = kb.gather2_work(small[1].cpu().numpy(), small[4].cpu().numpy(), *small[0].shape[1:], x0)
    add(f"probe_select (:124), its first {nb} bands", r["fn"], small, work, warm=True)
    return cases


# K11's edge tables: (nb, w, c, x0), xp as small as the wrapper takes (hp = 8
# nb + 34, wp = w + x0 + 34) and 6 rows / 30 columns larger; shifts drawn
# from -2 .. 36 with -1, 34 and 35 set in every band
GATHER_EDGES = ((3, 200, 24, 15), (5, 77, 8, 1), (2, 300, 64, 15))


def _gather2_edges(dev):
    """K11 bitwise against its plain version on ``GATHER_EDGES``."""
    import torch

    from pnp_vcve_torch.kernels import probes as P

    gen = torch.Generator().manual_seed(SEED + 22)
    for nb, w, c, x0 in GATHER_EDGES:
        for pad_h, pad_w in ((0, 0), (6, 30)):
            hp, wp = 8 * nb + 34 + pad_h, w + x0 + 34 + pad_w
            xp = torch.randn((1, hp, wp, c), generator=gen).to(dev, torch.bfloat16)
            tabs = [torch.randint(-2, 37, (nb, w), generator=gen, dtype=torch.int32)
                    for _ in range(2)]
            for t in tabs:
                t[:, :3] = torch.tensor([-1, 34, 35], dtype=torch.int32)
            shidx, dyidx = (t.to(dev) for t in tabs)
            wts = [torch.rand((nb, w), generator=gen).to(dev) for _ in range(4)]
            args = (xp, shidx, wts[0], wts[1], dyidx, wts[2], wts[3], x0)
            _probe_check(f"gather2: edge tables, {nb} bands x {w}, {c} channels, xp {hp}x{wp}, "
                         f"x0 {x0}", P.gather2(*args), P.gather2_plain(*args), "bitwise")


def phase_gather2(dev, smi):
    """K11 alone as phase 13 runs it (tools/torch_probe_turns.py): the warp
    probe's three stages, K11's launches counted, its edge tables, then its
    cases timed: {"gather2": its JSON row}."""
    import torch

    sys.path.insert(0, str(ROOT / "tools"))
    import torch_warp_kernel_probe

    from pnp_vcve_torch.kernels import probes

    probes.reset_launches()
    wkp = torch_warp_kernel_probe.main([])
    torch.cuda.synchronize()
    counts = dict(probes.LAUNCHES)
    if wkp["dense select (35H+35V)"]["out"] is None or not counts["gather2"]:
        raise AssertionError(f"K11's stage failed; launches {counts}")
    _gather2_edges(dev)
    return _probe_summary(_probe_rows(_gather2_cases(wkp), smi), counts, "phase13_launches")


def phase_probes_b10b(dev, smi):
    """Phase 13: tools/torch_warp_kernel_probe.py and tools/torch_dma_probe.py
    (both modes; the ring at depth 3, then at depths 0 and 9 at split 4) at
    their JAX files' shapes on the card (the probe path: every launch of K6
    and K11-K13 counted), then each stage's kernel against its plain
    version on the same inputs, bitwise, timed beside it, the library call
    and the bound."""
    import torch

    sys.path.insert(0, str(ROOT / "tools"))
    import torch_dma_probe
    import torch_warp_kernel_probe

    from pnp_vcve_torch.kernels import probes

    print(f"[probes] {smi}")
    probes.reset_launches()
    wkp = torch_warp_kernel_probe.main([])
    dma = torch_dma_probe.main([])
    for depth in (0, 9):
        dma.update(torch_dma_probe.main(["--split", "4", "--depth", str(depth)]))
    dma.update(torch_dma_probe.main(["--mode", "pipelined"]))
    torch.cuda.synchronize()
    counts = dict(probes.LAUNCHES)
    print(f"[probes] launches of the two tools: {counts}")
    failed = [k for res in (wkp, dma) for k, v in res.items() if v["out"] is None]
    needed = ("window_copy", "gather2", "block_windows", "ring_copy", "stream_copy")
    if failed or not all(counts[k] for k in needed):
        raise AssertionError(f"probe stages failed: {failed}; launches {counts}")
    _gather2_edges(dev)
    return _probe_summary(_probe_rows(_probe_cases_b10b(wkp, dma), smi), counts,
                          "phase13_launches")


def _form_generator(form, dev):
    """The training config's generator in a phase-14 form through
    ``build_generator`` (seeded weights), each sweep's offset head given
    seeded weights in its zero-initialised last conv; and its config."""
    import torch

    from pnp_vcve_torch.core.builder import build_generator
    from pnp_vcve_torch.core.config import Config

    gen_cfg = {**Config.fromfile(CONFIGS / "HR_davis_LR_128x128.py").model["generator"],
               "deform_groups": 16, **MODEL_FORMS[form]}
    model = build_generator(gen_cfg, device=dev, seed=SEED + 14)
    gen = torch.Generator().manual_seed(SEED + 14)
    for m in (model.backward_deform_align, model.forward_deform_align):
        if m is not None:
            w = m.conv_offset[2].weight
            with torch.no_grad():
                w.copy_(torch.randn(w.shape, generator=gen) * OFFSET_SCALE)
    return model, gen_cfg


def _forms_inputs(rng, t, h, w, dev):
    """One clip of t frames at h x w (any h, w): phase 5's priors drawn at
    the next multiple of 8 and cropped."""
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    inp = _clip_inputs(rng, 1, t, hp, wp, dev)
    return {k: (v[:, :, :h, :w].contiguous() if v.dim() == 5 else v) for k, v in inp.items()}


def _kernel_vs_plain(model, inputs, ops=None):
    """The model's output through the kernels (``ops``, default KERNELS) and
    through the plain path, and the launch counts of the kernel run."""
    from pnp_vcve_torch.kernels import KERNELS, LAUNCHES, PLAIN, reset_launches

    reset_launches()
    model.ops = ops or KERNELS
    got = model(**inputs)
    counts = dict(LAUNCHES)
    model.ops = PLAIN
    want = model(**inputs)
    model.ops = KERNELS
    return got, want, counts


def _profiled(model, inputs):
    """One clip under ``torch.profiler``: ``(profile, launch counts)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pnp_vcve_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(**inputs)
        torch.cuda.synchronize()
    return prof, dict(LAUNCHES)


def _timed_clip(model, inputs):
    """Seconds of one clip (host clock, synchronised), after one untimed
    clip, and the timed clip's launch counts."""
    import torch

    from pnp_vcve_torch.kernels import LAUNCHES, reset_launches

    model(**inputs)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = model(**inputs)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, dict(LAUNCHES), out


def _print_forms_profile(tag, prof, wall_s, counts):
    """Busy time, idle share against the unprofiled clip, each model
    kernel's share of the device time (a launched kernel the profile does
    not name fails), the rest, the top device functions."""
    found = _device_time(prof)
    if found is None:
        print(f"[forms14] {tag}: profiler recorded no device events; breakdown not measured")
        return None
    busy, by_name = found
    total = sum(by_name.values())
    times = _kernel_times(by_name, counts, ("warp", "input_conv", "drt_block", "head"))
    print(f"[forms14] {tag}, profiled: launches {counts}; device busy {busy:.4f} s, idle share "
          f"{max(0.0, 1 - busy / wall_s):.4f} of the unprofiled {wall_s:.4f} s clip; of device "
          f"time " + ", ".join(f"{k} {v / total:.4f}" for k, v in times.items())
          + f", the rest (torch ops) {1 - sum(times.values()) / total:.4f}")
    for name, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[forms14]   {v:.4f} s {v / total:.4f}  {name[:110]}")
    return busy


def _vsr_through_cli(dev, smi):
    """vsr=True through tools/torch_test.py (``--cfg-options
    model.generator.vsr=True``) on one REDS-LR-geometry clip written at run
    time: LR VSR_LR_HW, GT 4x (the fixture's sharp frames resized). Returns
    the launch counts of the run."""
    import numpy as np
    from PIL import Image

    from pnp_vcve_torch.kernels import LAUNCHES, reset_launches

    sys.path[:0] = [str(ROOT / "tools"), str(ROOT / "tools" / "data")]
    import torch_test
    from make_protocol_fixture import REDS4_CLIPS, write_fixture

    work = ROOT / "build" / "chip_smoke" / "vsr"
    h, w = VSR_LR_HW
    write_fixture(work / "data", clips=REDS4_CLIPS[:1], frames=FRAMES, height=h, width=w,
                  crf=15, seed=SEED + 14, quiet=True)
    for f in sorted((work / "data" / "sharp" / "png").glob("*/*.png")):
        out = work / "data" / "x4" / "png" / f.parent.name / f.name
        out.parent.mkdir(parents=True, exist_ok=True)
        Image.open(f).resize((4 * w, 4 * h), Image.BICUBIC).save(out)
    cfg = work / "vsr.py"
    # the training config (vsr is refused under 'pf'), every clip folder of
    # the fixture, its qp.json
    cfg.write_text(
        f"_base_ = [{str(CONFIGS / 'HR_davis_LR_128x128.py')!r}]\n"
        "from pnp_vcve_torch.core.presets import flagship_data\n"
        f"data = flagship_data(test_lq={str(work / 'data/crf15/png')!r}, "
        f"test_gt={str(work / 'data/x4/png')!r}, "
        f"test_qp_json={str(work / 'data/qp.json')!r})\n"
        "data['test']['type'] = 'SRFolderMultipleGTDataset'\n"
        f"data['test']['num_input_frames'] = {FRAMES}\n"
    )
    reset_launches()
    t0 = time.perf_counter()
    metrics = torch_test.main([str(cfg), "-", "--device", dev.type, "--cfg-options",
                               "model.generator.vsr=True", "--save-path", str(work / "out"),
                               "--save-image"])
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    want = _launches_per_pass(FRAMES, 8)
    pngs = sorted((work / "out").glob("*/*.png"))
    shape = np.asarray(Image.open(pngs[0])).shape if pngs else None
    print(f"[forms14] vsr through tools/torch_test.py: {FRAMES} frames {h}x{w} -> "
          f"{4 * h}x{4 * w}, {metrics}, {wall:.3f} s with loading, host metrics and PNGs; "
          f"launches {counts} (expected {want}); {len(pngs)} PNGs of {shape}")
    if counts != want:
        raise AssertionError("the vsr run through tools/torch_test.py did not run every step "
                             "through the kernels")
    if (set(metrics) != {"PSNR", "SSIM"} or not all(np.isfinite(v) for v in metrics.values())
            or len(pngs) != FRAMES or shape != (4 * h, 4 * w, 3)):
        raise AssertionError(f"vsr metrics or output frames wrong: {metrics}, {len(pngs)}, {shape}")
    return counts


def phase_model_forms(dev, smi):
    """The generator's forms beyond the flagship's (phase 14): vsr=True on
    the REDS-LR geometry (through tools/torch_test.py, then kernel path vs
    plain path, f/s and a profile with K4 at 720x1280), deform='basic' and
    'fvc' (kernel vs plain path at 256x448, a timed and a profiled 720p
    clip, the plain DCN's time), flow_inter='nearest' (kernel vs plain
    path), and the chunk API (an 8-frame 720p clip as 3 + 5 frames under
    'pf' and 'padgather', chunked vs full). Returns the launches of the
    driven runs (the CLI drive, the timed 720p clips, the chunked clips),
    summed."""
    import types

    import numpy as np
    import torch

    from pnp_vcve_torch.kernels import KERNELS, LAUNCHES, reset_launches
    from pnp_vcve_torch.models.pnp_vcve import keyframe_indices
    from pnp_vcve_torch.ops.deform_conv import modulated_deform_conv2d

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t = FRAMES
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def check(tag, got, want, counts, expected, shape):
        err = float((got - want).abs().max())
        ok = bool(torch.isfinite(got).all()) and tuple(got.shape) == shape
        print(f"[forms14] {tag}: kernel path vs plain path, float32: max|diff| {err:.3g} "
              f"(<= {TOL_MODEL}); launches {counts} (expected {expected})")
        if not ok or err > TOL_MODEL or counts != expected:
            raise AssertionError(f"{tag}: kernel path disagrees with its plain path, output "
                                 f"{tuple(got.shape)} not finite/of shape {shape}, or launches")
        return err

    errs = {}
    # vsr: the CLI drive, then the model on one clip at the REDS-LR size
    add(_vsr_through_cli(dev, smi))
    model, gen_cfg = _form_generator("vsr", dev)
    n = gen_cfg["num_blocks"]
    h, w = VSR_LR_HW
    inputs = _forms_inputs(np.random.default_rng(SEED + 14), t, h, w, dev)
    head_shapes = []
    ops = types.SimpleNamespace(**vars(KERNELS))
    ops.head = lambda x, *a: head_shapes.append(tuple(x.shape)) or KERNELS.head(x, *a)
    with torch.inference_mode():
        got, want, counts = _kernel_vs_plain(model, inputs, ops)
        errs["vsr"] = check(f"vsr, {t} frames {h}x{w} -> {4 * h}x{4 * w}", got, want, counts,
                            _launches_per_pass(t, n), (1, t, 4 * h, 4 * w, 3))
        if head_shapes != [(1, 4 * h, 4 * w, 64)] * t:
            raise AssertionError(f"K4 ran at {head_shapes}, not at 4h x 4w")
        del got, want
        wall, counts, _ = _timed_clip(model, inputs)
        prof, prof_counts = _profiled(model, inputs)
    print(f"[forms14] vsr {smi}: {t} frames {h}x{w} -> {4 * h}x{4 * w} float32 in {wall:.4f} s "
          f"= {t / wall:.3f} frames/s (generator, synchronised); K4 at {head_shapes[0][1:3]}")
    _print_forms_profile("vsr", prof, wall, prof_counts)
    del model
    torch.cuda.empty_cache()

    # deform basic and fvc; nearest
    rng = np.random.default_rng(SEED + 15)
    small = _clip_inputs(rng, 1, t, *FORMS_HW, dev)
    big = _clip_inputs(rng, 1, t, *MAIN_HW, dev)
    for form in ("basic", "fvc", "nearest"):
        model, gen_cfg = _form_generator(form, dev)
        expected = _launches_per_pass(t, n)
        if form != "basic":  # fvc warps nothing; nearest runs the plain warp
            expected["warp"] = 0
        with torch.inference_mode():
            got, want, counts = _kernel_vs_plain(model, small)
            errs[form] = check(f"{form}, {t} frames {FORMS_HW[0]}x{FORMS_HW[1]}", got, want,
                               counts, expected, (1, t, *FORMS_HW, 3))
            del got, want
            if form == "nearest":
                break
            wall, counts, out = _timed_clip(model, big)
            if counts != expected or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{form} 720p: launches {counts} or output not finite")
            del out
            add(counts)
            prof, prof_counts = _profiled(model, big)
            # the plain DCN alone on a step's inputs: the aligner's offsets
            # and mask from a feature map of the carry's size and the flow
            al = model.forward_deform_align
            feat = torch.randn((1, *MAIN_HW, 64), device=dev, generator=torch.Generator(
                device=dev).manual_seed(SEED))
            flow = big["mvs"][:, 0, ..., 0:2].contiguous()
            head_in = (torch.cat([KERNELS.flow_warp(feat, flow), flow], -1) if form == "basic"
                       else torch.cat([feat, flow], -1))
            o1, o2, mask = al._offset_head(head_in).chunk(3, dim=-1)
            offs = torch.cat([o1, o2], -1).reshape(1, *MAIN_HW, 16, 9, 2)
            mask = torch.sigmoid(mask).reshape(1, *MAIN_HW, 16, 9)
            kern = al.weight.permute(2, 3, 1, 0)
            dcn_ms = _timed(lambda: modulated_deform_conv2d(feat, offs, mask, kern, al.bias), 3)
            align_ms = _timed(lambda: al(feat, flow, KERNELS), 3)
        print(f"[forms14] {form} {smi}: {t} frames {MAIN_HW[0]}x{MAIN_HW[1]} float32 in "
              f"{wall:.4f} s = {t / wall:.3f} frames/s (generator, synchronised)")
        busy = _print_forms_profile(form, prof, wall, prof_counts)
        dcn_s = 2 * t * dcn_ms * 1e-3
        print(f"[forms14] {form}: the plain DCN {dcn_ms:.3f} ms a call, the aligner (head and "
              f"DCN{' and K1' if form == 'basic' else ''}) {align_ms:.3f} ms (CUDA events); "
              f"{2 * t} calls a clip = {dcn_s:.4f} s"
              + (f" = {dcn_s / busy:.4f} of the profiled clip's device busy time"
                 if busy else ""))
        del model, prof, feat, offs, mask, head_in
        torch.cuda.empty_cache()

    # the chunk API: 8 frames of 720p as 3 + 5, backward right to left, then
    # forward left to right, each chunk from the carry before it
    inputs = _clip_inputs(np.random.default_rng(SEED + 16), 1, t, *MAIN_HW, dev)
    km = keyframe_indices(inputs["slices"])[0]
    if bool(km[0, CHUNK_SPLIT]):
        raise AssertionError("the chunk boundary fell on a keyframe")
    for config in ("HR_davis_LR_128x128_serving.py", "HR_davis_LR_128x128.py"):
        model, cfg = _flagship_generator(config, dev)
        gen_cfg = cfg.model["generator"]
        impl = gen_cfg.get("warp_impl", "padgather")
        with torch.inference_mode():
            full = model(**inputs)
            torch.cuda.synchronize()
            reset_launches()
            part = lambda s, e: {k: v[:, s:e] for k, v in inputs.items()}  # noqa: E731
            left, right = part(0, CHUNK_SPLIT), part(CHUNK_SPLIT, t)
            feats_r, carry = model(**right, sweep="backward", keyframe_mask=km[:, CHUNK_SPLIT:])
            feats_l, _ = model(**left, sweep="backward", carry=carry,
                               keyframe_mask=km[:, :CHUNK_SPLIT])
            ys_l, carry = model(**left, sweep="forward", bwd_feats=feats_l,
                                keyframe_mask=km[:, :CHUNK_SPLIT])
            ys_r, _ = model(**right, sweep="forward", carry=carry, bwd_feats=feats_r,
                            keyframe_mask=km[:, CHUNK_SPLIT:])
            torch.cuda.synchronize()
            counts = dict(LAUNCHES)
            got = torch.cat([ys_l, ys_r], dim=1)
        add(counts)
        err = float((got - full).abs().max())
        expected = _launches_per_pass(t, gen_cfg["num_blocks"], impl)
        print(f"[forms14] chunk API, {impl}: {t} frames {MAIN_HW[0]}x{MAIN_HW[1]} as "
              f"{CHUNK_SPLIT} + {t - CHUNK_SPLIT}, chunked vs full max|diff| {err:.3g} "
              f"(<= {TOL_CHUNK}), bitwise equal {bool(torch.equal(got, full))}; bwd_feats "
              f"{feats_l.dtype}; launches {counts} (expected {expected})")
        if err > TOL_CHUNK or counts != expected or feats_l.dtype != model.feature_dtype:
            raise AssertionError(f"chunked {impl} clip disagrees with the full clip or launches")
        errs[f"chunk_{impl}"] = err
        del model, full, got, feats_l, feats_r, carry
        torch.cuda.empty_cache()
    return total, errs


def _full_context_clip(dev, t, h, w):
    """One clip of t frames of the protocol fixture's kind, made on the card:
    a periodic texture (tools/data/make_protocol_fixture.py) rolled by
    FULL_MOTION a frame (GT, as uint8 levels), blurred, quantised and noised
    (LQ), with the fixture's slices, QPs and MV records rasterised as the
    loader does. Returns the time-first numpy sample and the GT on the card."""
    import numpy as np
    import torch

    sys.path[:0] = [str(ROOT / "tools" / "data")]
    from make_protocol_fixture import block_mv_records, slice_type, synth_texture

    from pnp_vcve_torch.data.mv_raster import rasterize_clip

    dx, dy = FULL_MOTION
    tex = torch.from_numpy(synth_texture(np.random.default_rng(SEED + 15), h, w)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    gt = torch.stack([torch.roll(tex, (i * dy, i * dx), (0, 1)) for i in range(t)])
    gt = (gt * 255).round().clamp(0, 255) / 255
    k = (0.25, 0.5, 0.25)
    lq = gt
    for ax in (1, 2):
        lq = k[0] * lq.roll(1, ax) + k[1] * lq + k[2] * lq.roll(-1, ax)
    lq = (lq * 64).round() / 64 + 0.004 * torch.randn(lq.shape, device=dev, generator=gen)
    lq = (lq.clamp(0, 1) * 255).round() / 255
    kinds = [slice_type(i) for i in range(t)]
    mv_ip, par_ip = rasterize_clip([np.zeros((0, 10), np.float32),
                                    block_mv_records(h, w, dx, dy)], ["I", "P"], h, w)
    pick = np.array([0 if s == "I" else 1 for s in kinds])
    sample = dict(lq=lq.cpu().numpy(), qps=np.array([(25 + i % 5) / 255 for i in range(t)],
                                                    np.float32),
                  slices=np.array([float(ord(s)) for s in kinds], np.float32),
                  mvs=mv_ip[pick], base_qps=np.full(t, 15 / 255, np.float32),
                  partitions=par_ip[pick] / 255)
    return sample, gt


def _psnr_u8(out, gt):
    """Per-frame PSNR on uint8 levels (the harness's tensor2img and psnr),
    averaged over the frames, on the card."""
    import torch

    q = (out.clamp(0, 1) * 255).round()
    mse = ((q - gt * 255) ** 2).mean(dim=(1, 2, 3))
    return float((20 * torch.log10(255 / mse.sqrt())).mean())


def phase_exact_pipeline(dev, smi):
    """The exact two-sweep pipeline on one card (phase 15): (a) one 720p clip
    of FRAMES frames over [cuda:0] * D for each of PIPE_DEPTHS under the
    serving config, and at D = 2 under the training config ('padgather'),
    bitwise equal to the full sweep; (b) STREAM_B clips through the stream
    at D = STREAM_D, bitwise equal to single-clip pipelines, f/s of each
    mode beside the full sweep's; (c) one FULL_T-frame 720p clip through the
    flagship generator at full context (float32), f/s and peak memory, then
    in FULL_CHUNK_T windows, max|diff| and the PSNR delta against the GT;
    (d) tools/torch_dist_test.sh with DIST_RANKS ranks on the card over a
    DIST_CLIPS-clip fixture against the single-process CLI run; (e)
    tools/torch_test.py --frame-parallel exact --stream-clips 2 writing the
    plain run's PNGs. Returns the launches of the pipeline-driven runs (a,
    b, c and e)."""
    import pickle

    import numpy as np
    import torch

    from pnp_vcve_torch.core.config import Config
    from pnp_vcve_torch.kernels import LAUNCHES, reset_launches
    from pnp_vcve_torch.parallel.seqpar import (
        enhance_clip_exact_pipeline,
        enhance_clips_exact_stream,
    )
    from pnp_vcve_torch.train.eval import enhance_clip
    from pnp_vcve_torch.train.train_step import MODEL_INPUT_KEYS, make_eval_step

    sys.path[:0] = [str(ROOT / "tools"), str(ROOT / "tools" / "data")]
    import torch_test
    from make_protocol_fixture import REDS4_CLIPS, write_fixture

    total = {}

    def counted(fn, expected, tag):
        """Run fn with the counts zeroed before and read after; the counts
        must be ``expected``; returns (fn's result, seconds)."""
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        if counts != expected:
            raise AssertionError(f"{tag}: launches {counts}, expected {expected}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return out, dt

    def times(per_pass, n):
        return {k: v * n for k, v in per_pass.items()}

    cuda = [dev]
    h, w = MAIN_HW
    t = FRAMES
    rng = np.random.default_rng(SEED + 15)
    clips = [_serving_sample(rng, t, h, w) for _ in range(STREAM_B)]
    fps = {}
    for config in ("HR_davis_LR_128x128_serving.py", "HR_davis_LR_128x128.py"):
        model, cfg = _flagship_generator(config, dev)
        gen_cfg = cfg.model["generator"]
        impl = gen_cfg.get("warp_impl", "padgather")
        per_pass = _launches_per_pass(t, gen_cfg["num_blocks"], impl)
        step = make_eval_step(model)
        step({k: clips[0][k][None] for k in MODEL_INPUT_KEYS})  # warm-up
        full = []
        t0 = time.perf_counter()
        for c in clips if impl == "pf" else clips[:1]:
            full.append(step({k: c[k][None] for k in MODEL_INPUT_KEYS})[0])
        fps[f"{impl} full sweep"] = len(full) * t / (time.perf_counter() - t0)
        # (a) the pipeline at each depth against the full sweep, bitwise
        for D in PIPE_DEPTHS if impl == "pf" else (2,):
            got, dt = counted(lambda: enhance_clip_exact_pipeline(model, clips[0], cuda * D),
                              per_pass, f"{impl} pipeline D={D}")
            eq = bool(np.array_equal(got, full[0]))
            err = float(np.abs(got - full[0]).max())
            fps[f"{impl} pipeline D={D}"] = t / dt
            print(f"[exact15] (a) {impl}, one {t}-frame {h}x{w} clip over [{dev}] x {D}: "
                  f"bitwise equal to the full sweep {eq} (max|diff| {err:.3g}); {dt:.3f} s")
            if not eq:
                raise AssertionError(f"the exact pipeline ({impl}, D={D}) is not bitwise "
                                     "equal to the full sweep")
        if impl != "pf":
            del model, step
            torch.cuda.empty_cache()
            continue
        # (b) the stream against single-clip pipelines, bitwise
        single, dt = counted(lambda: [enhance_clip_exact_pipeline(model, c, cuda * STREAM_D)
                                      for c in clips], times(per_pass, STREAM_B),
                             "single-clip pipelines")
        fps[f"pf pipeline D={STREAM_D}, {STREAM_B} clips one by one"] = STREAM_B * t / dt
        streamed, dt = counted(lambda: enhance_clips_exact_stream(model, clips,
                                                                  cuda * STREAM_D),
                               times(per_pass, STREAM_B), "stream")
        fps[f"pf stream B={STREAM_B} D={STREAM_D}"] = STREAM_B * t / dt
        eq = [bool(np.array_equal(a, b)) for a, b in zip(streamed, single)]
        eq_full = [bool(np.array_equal(a, b)) for a, b in zip(streamed, full)]
        print(f"[exact15] (b) pf, stream of {STREAM_B} clips at D={STREAM_D}: bitwise equal "
              f"to single-clip pipelines {eq}, to full sweeps {eq_full}")
        if not all(eq) or not all(eq_full):
            raise AssertionError("the stream is not bitwise equal to single-clip pipelines")
        del model, step, single, streamed, full
        torch.cuda.empty_cache()
    print(f"[exact15] {smi}: {t} frames {h}x{w} float32, frames/s (host clock, synchronised, "
          "host staging and copies included): "
          + "; ".join(f"{k} {v:.3f}" for k, v in fps.items()))

    # (c) full context: FULL_T frames in one pass, then FULL_CHUNK_T windows
    model, cfg = _flagship_generator("HR_davis_LR_128x128.py", dev)
    per_pass = _launches_per_pass(FULL_T, cfg.model["generator"]["num_blocks"])
    sample, gt = _full_context_clip(dev, FULL_T, h, w)
    step = make_eval_step(model)
    res = {}
    for tag, chunk_t in (("full context", None), (f"chunk_t={FULL_CHUNK_T}", FULL_CHUNK_T)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out, dt = counted(lambda: enhance_clip(step, sample, chunk_t=chunk_t), per_pass, tag)
        res[tag] = dict(peak=torch.cuda.max_memory_allocated() / 2**30, s=dt,
                        out=torch.from_numpy(out).to(dev))
        res[tag]["psnr"] = _psnr_u8(res[tag]["out"], gt)
        if not bool(torch.isfinite(res[tag]["out"]).all()) or out.shape != (FULL_T, h, w, 3):
            raise AssertionError(f"{tag}: output {out.shape} not finite or of the wrong shape")
        del out
    a, b = res["full context"], res[f"chunk_t={FULL_CHUNK_T}"]
    err = float((a["out"] - b["out"]).abs().max())
    for tag, r in res.items():
        print(f"[exact15] (c) {smi}: {FULL_T} frames {h}x{w}, flagship (padgather, parity "
              f"weights), float32, {tag}: {r['s']:.3f} s = {FULL_T / r['s']:.3f} frames/s "
              f"(enhance_clip, host staging included), peak device memory {r['peak']:.3f} "
              f"GiB, PSNR against the GT {r['psnr']:.4f} dB")
    print(f"[exact15] (c) chunk_t={FULL_CHUNK_T} against full context: max|diff| {err:.4g}, "
          f"PSNR delta (full - chunked) {a['psnr'] - b['psnr']:+.4f} dB")
    del model, step, res, a, b, gt, sample
    torch.cuda.empty_cache()

    # (d) two ranks on the card against one process; (e) the exact CLI's PNGs
    work = ROOT / "build" / "chip_smoke" / "exact"
    dh, dw = DIST_HW
    write_fixture(work / "data", clips=REDS4_CLIPS[:DIST_CLIPS], frames=t, height=dh,
                  width=dw, crf=15, seed=SEED + 15, quiet=True)
    cfg = work / "serving.py"
    cfg.write_text(
        f"_base_ = [{str(CONFIGS / 'HR_davis_LR_128x128_serving.py')!r}]\n"
        "from pnp_vcve_torch.core.presets import flagship_data\n"
        f"data = flagship_data(test_lq={str(work / 'data/crf15/png')!r}, "
        f"test_gt={str(work / 'data/sharp/png')!r}, "
        f"test_qp_json={str(work / 'data/qp.json')!r})\n"
        "data['test']['type'] = 'SRFolderMultipleGTDataset'\n"
        f"data['test']['num_input_frames'] = {t}\n"
    )
    ckpt = str(ROOT / "tests/fixtures/parity/state_dict.npz")
    plain = torch_test.main([str(cfg), ckpt, "--device", dev.type, "--save-path",
                             str(work / "plain"), "--save-image"])
    t0 = time.perf_counter()
    proc = subprocess.run(
        ["bash", str(ROOT / "tools" / "torch_dist_test.sh"), str(cfg), ckpt, str(DIST_RANKS),
         "--device", dev.type, "--out", str(work / "dist.pkl")],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHON=sys.executable))
    wall = time.perf_counter() - t0
    if proc.returncode:
        print(proc.stdout[-3000:], proc.stderr[-3000:])
        raise AssertionError(f"tools/torch_dist_test.sh exited {proc.returncode}")
    with open(work / "dist.pkl", "rb") as f:
        dist = pickle.load(f)
    rel = {k: abs(dist[k] - v) / abs(v) for k, v in plain.items()}
    shares = [ln for ln in proc.stdout.splitlines() if ln.startswith("[eval] ")
              and "dataset mean" not in ln]
    print(f"[exact15] (d) tools/torch_dist_test.sh, {DIST_RANKS} ranks on one card, "
          f"{DIST_CLIPS} clips x {t} frames {dh}x{dw}: {len(shares)} clip lines, mean {dist} "
          f"against one process {plain}, relative diff {rel} (<= {DIST_RTOL}); {wall:.1f} s "
          "with the ranks' start-up")
    if set(dist) != set(plain) or max(rel.values()) > DIST_RTOL or len(shares) != DIST_CLIPS:
        raise AssertionError("the 2-rank run's dataset mean differs from one process's")
    per_pass = _launches_per_pass(t, Config.fromfile(cfg).model["generator"]["num_blocks"], "pf")
    exact, _ = counted(lambda: torch_test.main([
        str(cfg), ckpt, "--device", dev.type, "--save-path", str(work / "exact"), "--save-image",
        "--frame-parallel", "exact", "--stream-clips", "2", "--pipeline-devices",
        f"{dev},{dev}"]), times(per_pass, DIST_CLIPS), "exact CLI")
    pngs = sorted((work / "plain").glob("*/*.png"))
    same = [f.read_bytes() == (work / "exact" / f.parent.name / f.name).read_bytes()
            for f in pngs]
    print(f"[exact15] (e) tools/torch_test.py --frame-parallel exact --stream-clips 2 over "
          f"{dev},{dev}: {sum(same)} of {len(pngs)} PNGs bitwise equal to the plain run's; "
          f"metrics {exact} against {plain}")
    if len(pngs) != DIST_CLIPS * t or not all(same) or exact != plain:
        raise AssertionError("the exact CLI run's PNGs or metrics differ from the plain run's")
    return total


def _bvpp_launches(clips, t):
    """K1 launches of BasicVSR++ over ``clips`` clips of t frames: per branch
    t - 1 first-order and t - 2 second-order feature warps, four branches."""
    return clips * 4 * (2 * t - 3)


def _seed_offset_heads(model, seed):
    """Seeded weights in every second-order aligner's zero-initialised last
    offset conv."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for align in model.deform_align.values():
            w = align.conv_offset[6].weight
            w.copy_(torch.randn(w.shape, generator=gen).to(w.device) * BVPP_OFFSET_SCALE)
    return model


def _fixture_cfg(path, base, work, gt_sub, t, extra=""):
    """A config on ``base`` whose test set is the fixture under ``work``."""
    path.write_text(
        f"_base_ = [{str(base)!r}]\n"
        "from pnp_vcve_torch.core.presets import flagship_data\n"
        f"data = flagship_data(test_lq={str(work / 'crf15/png')!r}, "
        f"test_gt={str(work / gt_sub)!r}, test_qp_json={str(work / 'qp.json')!r})\n"
        "data['test']['type'] = 'SRFolderMultipleGTDataset'\n"
        f"data['test']['num_input_frames'] = {t}\n" + extra)
    return path


def _labeled(fn, label, sync):
    """``fn`` inside ``torch.profiler.record_function(label)``, the device
    synchronised before and after (so that its kernels run inside the
    label's host interval too)."""
    import torch

    def run(*args, **kwargs):
        sync()
        with torch.profiler.record_function(label):
            out = fn(*args, **kwargs)
            sync()
        return out
    return run


def _label_times(prof, labels):
    """Device seconds of the kernels under each label of ``labels`` (the
    innermost that holds a kernel's start), from the device's mirror of the
    labels where the profile has it, else their host intervals; and the
    kernel times by name."""
    from torch.autograd import DeviceType

    spans = {lb: {"cuda": [], "cpu": []} for lb in labels}
    kernels = []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.name in spans:
            spans[e.name]["cuda" if e.device_type == DeviceType.CUDA else "cpu"].append(
                (start, end))
        elif e.device_type == DeviceType.CUDA and not e.name.startswith("ProfilerStep"):
            kernels.append((start, end - start, e.name))
    where = {lb: (v["cuda"] or v["cpu"]) for lb, v in spans.items()}
    mirrored = all(v["cuda"] for v in spans.values())
    times, by_name = {lb: 0.0 for lb in labels}, {}
    for start, dur, name in kernels:
        inside = [(e - s, lb) for lb, iv in where.items() for s, e in iv if s <= start <= e]
        if inside:
            times[min(inside)[1]] += dur * 1e-6
        by_name[name] = by_name.get(name, 0.0) + dur * 1e-6
    return times, by_name, mirrored


def _cascade_profile(flagship, vsr, inputs, counts_of):
    """One profiled cascade clip: the flagship stage, then BasicVSR++ with its
    DCN and its convolutions labelled. Prints BasicVSR++'s device time by
    part (the DCN, K1, the convolutions, the rest) and fails when a kernel
    that ran matches no device-function name."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from pnp_vcve_torch.models.baselines import basicvsr_pp

    sync = torch.cuda.synchronize
    conv, dcn = F.conv2d, basicvsr_pp.modulated_deform_conv2d
    labels = ("cascade.flagship", "cascade.bvpp", "bvpp.dcn", "bvpp.conv")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            enhanced = _labeled(lambda: flagship(**inputs), labels[0], sync)()
            F.conv2d = _labeled(conv, labels[3], sync)
            basicvsr_pp.modulated_deform_conv2d = _labeled(dcn, labels[2], sync)
            _labeled(lambda: vsr(enhanced), labels[1], sync)()
    finally:
        F.conv2d, basicvsr_pp.modulated_deform_conv2d = conv, dcn
    counts = counts_of()
    times, by_name, mirrored = _label_times(prof, labels)
    if not by_name:
        print("[cascade16] profiler recorded no device events; breakdown not measured")
        return
    kt = _kernel_times(by_name, counts, ("warp", "warp_block", "input_conv", "drt_block", "head"))
    k1 = kt["warp"]  # K1 runs only in BasicVSR++ under 'pf'
    bvpp = times[labels[1]] + times[labels[2]] + times[labels[3]]
    rest = times[labels[1]] - k1
    print(f"[cascade16] profiled clip (labels {'on the device' if mirrored else 'by host interval'}"
          f"; launches {counts}): flagship stage {times[labels[0]]:.4f} s of device time, "
          f"BasicVSR++ {bvpp:.4f} s: the DCN {times[labels[2]] / bvpp:.4f}, the convolutions "
          f"{times[labels[3]] / bvpp:.4f}, K1 {k1 / bvpp:.4f}, the rest (torch glue: cat, where, "
          f"tanh, the flow warps, resizes, pixel shuffle) {rest / bvpp:.4f}")
    for name, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[cascade16]   {v:.4f} s  {name[:110]}")


def phase_baselines(dev, smi):
    """The eval entry point's last modes (phase 16), float32, TF32 off: (a)
    the cascade through tools/torch_test.py --cascade (the serving config on
    the parity weights into vanilla BasicVSR++ at its published widths,
    seeded, offset heads non-zero) on CASCADE_CLIPS clips of FRAMES frames
    at CASCADE_HW with a x4 GT; kernel path vs plain path, each stage's f/s,
    a profile and peak memory; (b) the port's BasicVSR++ PQF v2 config as
    the main model on one 720p clip; (c) the MFQE joint protocol (nf 32,
    seeded, BatchNorm statistics away from 0 / 1) through
    --joint-pqf-config, the card against the CPU on a crop. Returns the
    cascade run's launches."""
    import contextlib
    import io

    import numpy as np
    import torch
    from PIL import Image

    from pnp_vcve_torch.core.builder import build_dataset, build_generator
    from pnp_vcve_torch.core.checkpoint import load_generator_weights
    from pnp_vcve_torch.core.config import Config
    from pnp_vcve_torch.kernels import KERNELS, LAUNCHES, PLAIN, reset_launches
    from pnp_vcve_torch.models.baselines import mfqe_joint_enhance
    from pnp_vcve_torch.train.train_step import MODEL_INPUT_KEYS, _model_inputs

    sys.path[:0] = [str(ROOT / "tools"), str(ROOT / "tools" / "data")]
    import torch_test
    from make_protocol_fixture import REDS4_CLIPS, write_fixture

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t = FRAMES
    work = ROOT / "build" / "chip_smoke" / "baselines"
    bconf = CONFIGS / "baselines"

    def clip_inputs(cfg_path):
        """Clip 0 of a config's test set as model inputs on the card."""
        sample = build_dataset(dict(Config.fromfile(cfg_path).data["test"])).load_clip(0)
        batch = {k: np.asarray(sample[k])[None] for k in MODEL_INPUT_KEYS}
        return sample, {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
                        for k, v in _model_inputs(batch).items()}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def check(tag, got, want, counts, expected, tol=TOL_MODEL):
        err = float((got - want).abs().max())
        print(f"[cascade16] {tag}: kernel path vs plain path max|diff| {err:.3g} (<= {tol}); "
              f"launches {counts} (expected {expected})")
        if not bool(torch.isfinite(got).all()) or err > tol or counts != expected:
            raise AssertionError(f"{tag}: kernel path disagrees with its plain path, output not "
                                 "finite, or launches")
        return err

    # (a) the cascade: serving config -> vanilla BasicVSR++, x4 GT
    h, w = CASCADE_HW
    t0 = time.perf_counter()
    write_fixture(work / "data", clips=REDS4_CLIPS[:CASCADE_CLIPS], frames=t, height=h,
                  width=w, crf=15, seed=SEED + 16, quiet=True)
    for f in sorted((work / "data" / "sharp" / "png").glob("*/*.png")):
        out = work / "data" / "x4" / "png" / f.parent.name / f.name
        out.parent.mkdir(parents=True, exist_ok=True)
        Image.open(f).resize((4 * w, 4 * h), Image.BICUBIC).save(out)
    cfg = _fixture_cfg(work / "serving.py", CONFIGS / "HR_davis_LR_128x128_serving.py",
                       work / "data", "x4/png", t)
    vsr_cfg = work / "bvpp.py"
    vsr_cfg.write_text(f"model = dict(type='BasicVSR', generator={BVPP!r})\n"
                       "test_cfg = dict(metrics=['PSNR', 'SSIM'], crop_border=0)\n")
    vsr_ckpt = work / "bvpp.pth"
    vsr = _seed_offset_heads(build_generator(BVPP, device="cpu", seed=SEED + 16), SEED + 16)
    torch.save(vsr.state_dict(), vsr_ckpt)
    print(f"[cascade16] fixture: {CASCADE_CLIPS} clips x {t} frames at {h}x{w}, x4 GT, "
          f"in {time.perf_counter() - t0:.1f} s")
    parity = str(ROOT / "tests/fixtures/parity/state_dict.npz")
    gen_cfg = Config.fromfile(cfg).model["generator"]
    expected = _launches_per_pass(CASCADE_CLIPS * t, gen_cfg["num_blocks"], "pf")
    expected["warp"] = _bvpp_launches(CASCADE_CLIPS, t)
    reset_launches()
    t0 = time.perf_counter()
    metrics = torch_test.main([str(cfg), parity, "--device", dev.type, "--cascade",
                               "--cascade_config", str(vsr_cfg), "--cascade_ckpt", str(vsr_ckpt),
                               "--save-path", str(work / "out"), "--save-image"])
    wall = time.perf_counter() - t0
    counts = cascade_counts = dict(LAUNCHES)
    pngs = sorted((work / "out").glob("*/*.png"))
    shape = np.asarray(Image.open(pngs[0])).shape if pngs else None
    print(f"[cascade16] tools/torch_test.py --cascade: {metrics} against the x4 GT, {wall:.2f} s "
          f"with loading, host metrics and PNGs; {len(pngs)} PNGs of {shape}; launches {counts} "
          f"(expected {expected})")
    if (counts != expected or set(metrics) != {"PSNR", "SSIM"}
            or not all(np.isfinite(v) for v in metrics.values())
            or len(pngs) != CASCADE_CLIPS * t or shape != (4 * h, 4 * w, 3)):
        raise AssertionError("the cascade through tools/torch_test.py: launches, metrics or frames")

    flagship, _ = _flagship_generator("HR_davis_LR_128x128_serving.py", dev)
    vsr = load_generator_weights(build_generator(BVPP, device=dev), str(vsr_ckpt))
    _, inputs = clip_inputs(cfg)
    with torch.inference_mode():
        reset_launches()
        got = vsr(flagship(**inputs))
        counts = dict(LAUNCHES)
        flagship.ops = vsr.ops = PLAIN
        want = vsr(flagship(**inputs))
        flagship.ops = vsr.ops = KERNELS
        per_clip = _launches_per_pass(t, gen_cfg["num_blocks"], "pf")
        per_clip["warp"] = _bvpp_launches(1, t)
        err = check(f"cascade, {t} frames {h}x{w} -> {4 * h}x{4 * w}", got, want, counts,
                    per_clip)
        del got, want
        torch.cuda.reset_peak_memory_stats()
        enhanced, wall_f = timed(lambda: flagship(**inputs))
        _, wall_v = timed(lambda: vsr(enhanced))
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[cascade16] {smi}: flagship ('pf') {t / wall_f:.3f} f/s ({wall_f:.4f} s), "
              f"BasicVSR++ 64/7/16 {t / wall_v:.3f} f/s ({wall_v:.4f} s), the cascade "
              f"{t / (wall_f + wall_v):.3f} f/s at {h}x{w} -> {4 * h}x{4 * w}, float32; peak "
              f"device memory {peak:.3f} GiB")
        reset_launches()
        _cascade_profile(flagship, vsr, inputs, lambda: dict(LAUNCHES))
    del flagship, vsr, enhanced
    torch.cuda.empty_cache()

    # (b) BasicVSR++ PQF v2 (the port's config) as the main model, 720p: the
    # first clip of phase 4's fixture, linked, where that phase wrote it
    mh, mw = MAIN_HW
    t0 = time.perf_counter()
    main_data, clip = ROOT / "build" / "chip_smoke" / "data", REDS4_CLIPS[0]
    if len(list((main_data / "crf15" / "png" / clip).glob("*.png"))) == t:
        for sub in ("crf15/png", "crf15/mv", "sharp/png"):
            (work / "data720" / sub).mkdir(parents=True, exist_ok=True)
            (work / "data720" / sub / clip).symlink_to(main_data / sub / clip)
        (work / "data720" / "qp.json").write_bytes((main_data / "qp.json").read_bytes())
        made = "phase 4's first clip, linked"
    else:
        write_fixture(work / "data720", clips=[clip], frames=t, height=mh, width=mw, crf=15,
                      seed=SEED, quiet=True)
        made = "written"
    print(f"[pqf16] fixture: 1 clip x {t} frames at {mh}x{mw} ({made}) in "
          f"{time.perf_counter() - t0:.1f} s")
    pqf_cfg = _fixture_cfg(work / "pqf_v2.py", bconf / "basicvsr_pp_pqf_v2.py",
                           work / "data720", "sharp/png", t)
    pqf_gen = Config.fromfile(pqf_cfg).model["generator"]
    pqf = _seed_offset_heads(build_generator(pqf_gen, device="cpu", seed=SEED + 17), SEED + 17)
    torch.save(pqf.state_dict(), work / "pqf_v2.pth")
    expected = {k: 0 for k in counts}
    expected["warp"] = _bvpp_launches(1, t)
    reset_launches()
    t0 = time.perf_counter()
    metrics = torch_test.main([str(pqf_cfg), str(work / "pqf_v2.pth"), "--device", dev.type])
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    print(f"[pqf16] tools/torch_test.py, {pqf_gen['type']} 64/7 on {t} frames {mh}x{mw}: "
          f"{metrics}, {wall:.2f} s with loading and host metrics; launches {counts}")
    if counts != expected or not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError("BasicVSR++ PQF v2 through tools/torch_test.py: launches or metrics")
    pqf = load_generator_weights(build_generator(pqf_gen, device=dev), str(work / "pqf_v2.pth"))
    _, inputs = clip_inputs(pqf_cfg)
    with torch.inference_mode():
        reset_launches()
        got = pqf(inputs["lrs"], slices=inputs["slices"])
        counts = dict(LAUNCHES)
        pqf.ops = PLAIN
        want = pqf(inputs["lrs"], slices=inputs["slices"])
        pqf.ops = KERNELS
        err_pqf = check(f"PQF v2, {t} frames {mh}x{mw}", got, want, counts, expected)
        del got, want
        _, wall = timed(lambda: pqf(inputs["lrs"], slices=inputs["slices"]))
    print(f"[pqf16] {smi}: BasicVSR++ PQF v2 64/7 {t / wall:.3f} f/s ({wall:.4f} s) on "
          f"{mh}x{mw} input (features {mh // 4}x{mw // 4}), float32")
    del pqf
    torch.cuda.empty_cache()

    # (c) the MFQE joint protocol, nf 32, BatchNorm statistics away from 0 / 1
    joint = {}
    for name, seed in (("mfqev2_pqf", SEED + 18), ("mfqev2_nonpqf", SEED + 19)):
        jcfg = _fixture_cfg(work / f"{name}.py", bconf / f"{name}.py", work / "data720",
                            "sharp/png", t)
        m = build_generator(Config.fromfile(jcfg).model["generator"], device="cpu", seed=seed)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for i in range(5):
                bn = getattr(m, f"rec{i}").bn
                bn.running_mean.copy_(torch.randn(bn.running_mean.shape, generator=gen) * 0.1)
                bn.running_var.copy_(torch.rand(bn.running_var.shape, generator=gen) * 1.5 + 0.5)
        torch.save(m.state_dict(), work / f"{name}.pth")
        joint[name] = (jcfg, m)
    reset_launches()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        metrics = torch_test.main([
            str(joint["mfqev2_nonpqf"][0]), str(work / "mfqev2_nonpqf.pth"), "--device", dev.type,
            "--joint-pqf-config", str(joint["mfqev2_pqf"][0]), "--joint-pqf-ckpt",
            str(work / "mfqev2_pqf.pth")])
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    lines = [ln for ln in log.getvalue().splitlines() if ln.startswith("[mfqe-joint]")]
    print("\n".join(lines))
    print(f"[joint16] tools/torch_test.py --joint-pqf-config, MFQEv2 nf 32 on {t} frames "
          f"{mh}x{mw}: {metrics}, {wall:.2f} s with loading and host metrics; launches {counts}")
    if (any(counts.values()) or len(lines) != 2
            or not all(np.isfinite(v) for v in metrics.values())):
        raise AssertionError("the MFQE joint protocol: launches, [mfqe-joint] lines or metrics")
    sample, _ = clip_inputs(joint["mfqev2_nonpqf"][0])
    frames = np.asarray(sample["lq"], np.float32)
    letters = [chr(int(round(float(c)))) for c in np.asarray(sample["slices"])]

    def apply(model):
        device = next(model.parameters()).device

        def run(lrs):
            with torch.inference_mode():
                return model(torch.as_tensor(lrs, device=device)).float().cpu().numpy()
        return run

    cpu = [joint[n][1] for n in ("mfqev2_pqf", "mfqev2_nonpqf")]
    card = [build_generator(dict(type="MFQEv2", nf=32), device=dev) for _ in cpu]
    for c, m in zip(card, cpu):
        c.load_state_dict(m.state_dict())
    crop = frames[:, :JOINT_CROP, :JOINT_CROP]
    got = mfqe_joint_enhance(apply(card[0]), apply(card[1]), crop, letters)
    want = mfqe_joint_enhance(apply(cpu[0]), apply(cpu[1]), crop, letters)
    err_joint = float(np.abs(got - want).max())
    print(f"[joint16] {t} frames ({''.join(letters)}) cropped to {JOINT_CROP}x{JOINT_CROP}: "
          f"the card against the CPU max|diff| {err_joint:.3g} (<= {TOL_JOINT})")
    if not np.isfinite(got).all() or err_joint > TOL_JOINT:
        raise AssertionError("the MFQE joint protocol on the card disagrees with the CPU")
    _, wall = timed(lambda: mfqe_joint_enhance(apply(card[0]), apply(card[1]), frames, letters))
    print(f"[joint16] {smi}: MFQEv2 joint protocol {t / wall:.3f} f/s ({wall:.4f} s) on "
          f"{mh}x{mw}, float32, host copies included")
    return cascade_counts, {"cascade": err, "pqf_v2": err_pqf, "joint_cpu": err_joint}


def _log_iterations(log_path):
    """Per logged iteration: ``(seconds, all-reduce seconds or None)`` from
    the ``iter N/M loss=... (x it/s[; all-reduce y s/it ...])`` lines (log
    interval 1)."""
    out = []
    for ln in Path(log_path).read_text().splitlines():
        if " loss=" not in ln:
            continue
        rate = ln.split("(", 1)[1]
        red = float(rate.split("all-reduce ")[1].split()[0]) if "all-reduce" in rate else None
        out.append((1.0 / float(rate.split()[0]), red))
    return out


def phase_ddp_train(dev, smi):
    """Phase 17: (a) tools/torch_dist_train.sh with DDP_RANKS ranks on the
    card (gloo; on a machine with more cards, a rank a card over NCCL)
    against one process (tools/torch_train.py in this process)
    on the global batch, both at the published settings for TRAIN_ITERS
    iterations with --deterministic and TF32 off (the ranks through
    NVIDIA_TF32_OVERRIDE=0): the weights and the logged losses within
    DDP_TOL; (b) each rank's
    launches equal phase 7's one-process counts, and so do the one
    process's; (c) seconds per iteration of both
    runs and rank 0's all-reduce time; (d) tools/torch_test_kitti.py on a
    KITTI-layout fixture at KITTI_HW (the training config, parity weights):
    its frames/s and launches, then the first pair kernel path against
    plain path (TOL_MODEL). Returns ``(the ranks' summed launches, the KITTI
    run's launches)``."""
    import shutil

    import numpy as np
    import torch

    from pnp_vcve_torch.core.config import Config
    from pnp_vcve_torch.data.extra_datasets import KittiPairDataset
    from pnp_vcve_torch.kernels import LAUNCHES, reset_launches

    sys.path[:0] = [str(ROOT / "tools"), str(ROOT / "tools" / "data")]
    import torch_test_kitti
    import torch_train
    from make_kitti_fixture import write_kitti_fixture

    work = ROOT / "build" / "chip_smoke" / "ddp"
    if work.exists():
        shutil.rmtree(work)
    # what this phase's numbers depend on is pinned here, whatever ran
    # before it in the process: the backend flags (phase 7 leaves cuDNN's
    # TF32 on), cuBLAS's workspace (main() sets it; a script that calls
    # this phase alone may not; the ranks inherit it) and the fixture
    # (rewritten unless stamped with phase 7's parameters)
    entry = _backend_flags()
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = False
    torch.use_deterministic_algorithms(False)
    cfg_path = _train_fixture(ROOT / "build" / "chip_smoke" / "train")
    digest = _fixture_digest(ROOT / "build" / "chip_smoke" / "train" / "data")
    cfg = Config.fromfile(cfg_path)
    gen_cfg = cfg.model["generator"]
    t = cfg.data["train"][0]["dataset"]["num_input_frames"]
    b = cfg.data["train_dataloader"]["samples_per_gpu"]
    per_iter = {k: 2 * v for k, v in _launches_per_pass(t, gen_cfg["num_blocks"]).items()}
    want = {k: TRAIN_ITERS * v for k, v in per_iter.items()}  # phase 7's counts
    n = max(DDP_RANKS, torch.cuda.device_count())
    shared = "sharing the card" if n > torch.cuda.device_count() else "a card each"

    # (a) the same run twice: n ranks x b samples through the
    # launcher, one process x n * b here; deterministic algorithms
    # and no TF32 in cuDNN and cuBLAS (the kernels' float32 is 3xTF32
    # regardless), so what differs is the batch split and the order of the
    # gradient sums
    opts = ["--device", dev.type, "--total-iters", str(TRAIN_ITERS), "--deterministic",
            "--cfg-options", "log_config.interval=1", f"checkpoint_config.interval={TRAIN_ITERS}"]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    torch_train.main([str(cfg_path), "--work-dir", str(work / "one"), *opts,
                      f"data.train_dataloader.samples_per_gpu={n * b}"])
    torch.cuda.synchronize()
    walls = {"one": time.perf_counter() - t0}
    single = dict(LAUNCHES)
    torch.cuda.empty_cache()  # the ranks need the card's memory
    t0 = time.perf_counter()
    proc = subprocess.run(
        ["bash", str(ROOT / "tools" / "torch_dist_train.sh"), str(cfg_path), str(n),
         "--work-dir", str(work / "ranks"), *opts, "--time-allreduce"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHON=sys.executable, NVIDIA_TF32_OVERRIDE="0"))
    walls["ranks"] = time.perf_counter() - t0
    if proc.returncode:
        print(proc.stdout[-3000:], proc.stderr[-3000:])
        raise AssertionError(f"tools/torch_dist_train.sh exited {proc.returncode}")
    backend = [ln for ln in proc.stdout.splitlines() if ln.startswith("[dist]")]
    runs = ("one", "ranks")
    one, ranks = (torch.load(work / tag / "ckpt" / f"{TRAIN_ITERS}.pth", weights_only=True)
                  for tag in ("one", "ranks"))
    diff = max(float((one["model"][k] - v).abs().max()) for k, v in ranks["model"].items())
    scale = max(float(v.abs().max()) for v in one["model"].values())
    # the logged losses unrounded: Adam's update barely moves with the
    # gradients' scale, so the losses are what shows a wrong average
    losses = {tag: [json.loads(ln)["loss"]
                    for ln in (work / tag / "scalars.json").read_text().splitlines()]
              for tag in runs}
    dloss = max((abs(a - c) for a, c in zip(losses["ranks"], losses["one"])), default=np.inf)
    print(f"[ddp17] entry flags {entry}, pinned to {_backend_flags()}; fixture sha256 "
          f"{digest}; first loss {losses['one'][0]!r} (one process), {losses['ranks'][0]!r} "
          f"(ranks)")
    print(f"[ddp17] (a) {backend}; {n} ranks x {b} samples against one process x "
          f"{n * b}, {t} frames, 128x128 crops, {TRAIN_ITERS} iterations, "
          f"deterministic, TF32 off: max|dw| {diff:.4g} (<= {DDP_TOL}; largest weight "
          f"{scale:.4g}); logged losses {losses['ranks']} against {losses['one']}: "
          f"max|dloss| {dloss:.4g} (<= {DDP_TOL})")
    if diff > DDP_TOL or not ranks["step"] == one["step"] == TRAIN_ITERS:
        raise AssertionError("the ranks' weights differ from one process's on the global batch")
    if len(losses["ranks"]) != TRAIN_ITERS or len(losses["one"]) != TRAIN_ITERS \
            or dloss > DDP_TOL:
        raise AssertionError("the ranks' logged losses differ from one process's")

    # (b) launches: each rank's (rank 0 logs them all) and the one process's
    key = "kernel launches by rank: "
    by_rank = json.loads(next(ln for ln in (work / "ranks" / "train.log").read_text()
                              .splitlines() if key in ln).split(key, 1)[1])
    print(f"[ddp17] (b) launches by rank {by_rank}, one process {single}; phase 7's counts "
          f"{want}")
    if len(by_rank) != n or any(c != want for c in by_rank) or single != want:
        raise AssertionError("a rank did not launch phase 7's kernels as often as one process")

    # (c) seconds per iteration (iterations 2 on: the first holds the
    # allocator's and cuDNN's warm-up) and rank 0's all-reduce
    it = {tag: _log_iterations(work / tag / "train.log")[1:] for tag in runs}
    sec = {tag: sum(s for s, _ in v) / len(v) for tag, v in it.items()}
    red = sum(r for _, r in it["ranks"]) / len(it["ranks"])
    print(f"[ddp17] (c) {smi}: seconds per iteration over iterations 2-{TRAIN_ITERS}: "
          f"{n} ranks {shared} {sec['ranks']:.4f} s (global batch "
          f"{n * b}), one process {sec['one']:.4f} s (batch {n * b}); rank 0's "
          f"all-reduce {red:.4f} s an iteration = {red / sec['ranks']:.4f} of it (flat float32 "
          f"gradients; rank 0 synchronises the card before and after it to time it); walls "
          f"with start-up: ranks {walls['ranks']:.1f} s, one {walls['one']:.1f} s")

    # (d) KITTI pairs at KITTI_HW through the CLI, then kernel vs plain
    t0 = time.perf_counter()
    root = write_kitti_fixture(work / "kitti", seqs=KITTI_SEQS, height=KITTI_HW[0],
                               width=KITTI_HW[1], seed=SEED + 17)
    fixture_s = time.perf_counter() - t0
    args = [str(CONFIGS / "HR_davis_LR_128x128.py"), str(PARITY_WEIGHTS), "--device", dev.type,
            "--testdir_lr", str(root / "crf15" / "png"), "--testdir_gt", str(root / "clean"),
            "--qp-slice-file", str(root / "qp.json")]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch_test_kitti.main(args)  # warm-up: cuDNN's plans at this size
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    metrics = torch_test_kitti.main(args)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    kitti = dict(LAUNCHES)
    kitti_want = {k: len(KITTI_SEQS) * v
                  for k, v in _launches_per_pass(2, gen_cfg["num_blocks"]).items()}
    model, _ = _flagship_generator("HR_davis_LR_128x128.py", dev)
    sample = KittiPairDataset(str(root / "crf15" / "png"), str(root / "clean"),
                              str(root / "qp.json")).load_clip(0)
    inputs = {k: torch.from_numpy(np.ascontiguousarray(sample[v][None])).to(dev)
              for k, v in dict(lrs="lq", qps="qps", slices="slices", mvs="mvs",
                               base_qps="base_qps", par_map="partitions").items()}
    with torch.no_grad():
        gen_s, _, out = _timed_clip(model, inputs)
        got, ref, counts = _kernel_vs_plain(model, inputs)
    err = float((got - ref).abs().max())
    frames = 2 * len(KITTI_SEQS)
    print(f"[ddp17] (d) {smi}: tools/torch_test_kitti.py, {len(KITTI_SEQS)} sequences x 2 frames "
          f"at {KITTI_HW[0]}x{KITTI_HW[1]} (KITTI's size; the training config's padgather, "
          f"parity weights, float32, TF32 off): {metrics}; {cli_s:.3f} s = "
          f"{frames / cli_s:.3f} frames/s with PNG loading and SSIM; the generator alone "
          f"{gen_s:.4f} s a pair = {2 / gen_s:.3f} frames/s; launches {kitti} (expected "
          f"{kitti_want}); kernel path vs plain path max|diff| {err:.4g} (<= {TOL_MODEL}); "
          f"fixture {fixture_s:.1f} s")
    if kitti != kitti_want or counts != {k: v // len(KITTI_SEQS) for k, v in kitti_want.items()}:
        raise AssertionError("the KITTI run did not go through the kernels")
    if err > TOL_MODEL or not all(np.isfinite(v) for v in metrics.values()) or \
            tuple(out.shape) != (1, 2, *KITTI_HW, 3):
        raise AssertionError("the KITTI pair's kernel path differs from its plain path")
    summed = {k: sum(c[k] for c in by_rank) for k in want}
    return summed, kitti


def _export_window_runs(fn, inputs, reps):
    """Seconds of one call of ``fn(*inputs)`` (synchronised host clock,
    the mean of ``reps`` calls after one untimed)."""
    import torch

    with torch.no_grad():
        fn(*inputs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*inputs)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def _counted(fn, *args):
    """``(fn(*args) under no_grad, the model kernels' launches of the call)``."""
    import torch

    from pnp_vcve_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    with torch.no_grad():
        out = fn(*args)
    torch.cuda.synchronize()
    return out, dict(LAUNCHES)


def _write_cfg(path, base, generator=None, data=""):
    path.write_text(f"_base_ = [{str(CONFIGS / base)!r}]\n"
                    + (f"model = dict(generator={generator!r})\n" if generator else "") + data)
    return path


def phase_export(dev, smi):
    """Phase 18: (a) tools/torch_export_model.py on the serving config and
    the parity weights at (EXPORT_T, 720, 1280) with --verify (1e-4), the
    reloaded artifact's launches for one window equal to the eager kernel
    path's (K1b, K2, K3, K3s, K4), export wall time, size and both paths'
    frames/s; (b) the training config (K1) and the block form
    one_layer=False (K5), each EXPORT_SMALL_BLOCKS blocks deep with seeded
    weights, exported at EXPORT_SMALL_HW, each
    reloaded artifact launching its kernels and within TOL_MODEL of the
    plain path; (c) tools/torch_deploy_test.py with (a)'s artifact on clip
    000 of phase 4's fixture, per-clip metrics equal to the eager path's on
    the same windows within the parity gate's bounds; (d)
    tools/torch_parity_check.py --fixture on the kernel path (float32, TF32
    off) passes and --tamper fails; (e) tools/torch_get_flops.py at JAX's
    default shape and at 720p, and tools/torch_publish_model.py on a
    training checkpoint. Returns the artifacts' launches ((a)'s window,
    (b)'s runs, (c)'s CLI run)."""
    import shutil

    import numpy as np
    import torch

    from pnp_vcve_torch.kernels import KERNELS, PLAIN

    sys.path[:0] = [str(ROOT / "tools")]
    import torch_deploy_test
    import torch_export_model
    import torch_get_flops
    import torch_parity_check
    import torch_publish_model

    work = ROOT / "build" / "chip_smoke" / "export"
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    total = dict.fromkeys(KERNEL_INFO, 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    # (a) the serving config at 720p
    h, w = MAIN_HW
    serving = str(CONFIGS / "HR_davis_LR_128x128_serving.py")
    pt2 = work / "serving_720p.pt2"
    res = torch_export_model.main([serving, str(PARITY_WEIGHTS), str(pt2), "--shape",
                                   str(EXPORT_T), str(h), str(w), "--verify"])
    program = res["loaded"].module()
    eager = torch_export_model.load_model(serving, str(PARITY_WEIGHTS), dev)
    inputs = tuple(_clip_inputs(np.random.default_rng(SEED), 1, EXPORT_T, h, w, dev).values())
    got, counts = _counted(program, *inputs)
    want, eager_counts = _counted(eager, *inputs)
    add(counts)
    err = float((got - want).abs().max())
    blocks = len(eager.backward_resblocks.main)
    expected = _launches_per_pass(EXPORT_T, blocks, "pf")
    secs = {}
    for tag in ("eager", "export", "export", "eager"):
        fn = program if tag == "export" else eager
        secs.setdefault(tag, []).append(_export_window_runs(fn, inputs, EXPORT_REPS))
    fps = {k: EXPORT_T / min(v) for k, v in secs.items()}
    print(f"[export18] (a) {smi}: serving config, parity weights, ({EXPORT_T}, {h}, {w}): "
          f"export {res['seconds']:.3f} s, save {res['save_seconds']:.3f} s, "
          f"{res['bytes'] / 1e6:.3f} MB, ops {res['ops']}; "
          f"--verify {res['max_abs_err']:.3g}; seeded window artifact vs eager max|diff| "
          f"{err:.3g}; launches artifact {counts} eager {eager_counts} (expected {expected}); "
          f"frames/s artifact {fps['export']:.3f} eager {fps['eager']:.3f} (ratio "
          f"{fps['export'] / fps['eager']:.4f}; float32, TF32 off, b=1)")
    if counts != eager_counts or counts != expected or not err <= 1e-4:
        raise AssertionError("the serving artifact differs from the eager kernel path")

    # (b) the training config (K1) and a block form (K5) at a small size
    sh, sw = EXPORT_SMALL_HW
    small_inputs = tuple(_clip_inputs(np.random.default_rng(SEED + 1), 1, EXPORT_T, sh, sw,
                                      dev).values())
    for form, extra in {"padgather": {}, "one_layer_false": dict(one_layer=False)}.items():
        cfg = _write_cfg(work / f"{form}.py", "HR_davis_LR_128x128.py",
                         dict(num_blocks=EXPORT_SMALL_BLOCKS, **extra))
        out = work / f"{form}.pt2"
        r = torch_export_model.main([str(cfg), "-", str(out), "--shape", str(EXPORT_T),
                                     str(sh), str(sw)])
        loaded = torch.export.load(str(out)).module()
        got, counts = _counted(loaded, *small_inputs)
        add(counts)
        model = torch_export_model.load_model(str(cfg), "-", dev)
        model.ops = PLAIN
        with torch.no_grad():
            ref = model(*small_inputs)
        model.ops = KERNELS
        err = float((got - ref).abs().max())
        want = _launches_per_pass(EXPORT_T, len(model.backward_resblocks.main), "padgather",
                                  fused_blocks=not extra)
        print(f"[export18] (b) {form}: ({EXPORT_T}, {sh}, {sw}) export {r['seconds']:.3f} s, "
              f"save {r['save_seconds']:.3f} s, {r['bytes'] / 1e6:.3f} MB, ops {r['ops']}; "
              f"artifact vs plain path max|diff| {err:.3g} (<= {TOL_MODEL}); launches {counts} "
              f"(expected {want})")
        if counts != want or not err <= TOL_MODEL:
            raise AssertionError(f"the {form} artifact does not launch its kernels or differs")

    # (c) the deploy test of (a)'s artifact on clip 000 of phase 4's fixture
    data, view = ROOT / "build" / "chip_smoke" / "data", work / "view"
    for sub in ("crf15/png", "crf15/mv", "sharp/png"):
        (view / sub).mkdir(parents=True)
        (view / sub / "000").symlink_to(data / sub / "000", target_is_directory=True)
    deploy_cfg = _write_cfg(
        work / "deploy.py", "HR_davis_LR_128x128_serving.py", data=(
            "from pnp_vcve_torch.core.presets import flagship_data\n"
            f"data = flagship_data(test_lq={str(view / 'crf15/png')!r}, "
            f"test_gt={str(view / 'sharp/png')!r}, test_qp_json={str(data / 'qp.json')!r})\n"
            f"data['test'].update(type='SRFolderMultipleGTDataset', num_input_frames={FRAMES})\n"))
    t0 = time.perf_counter()
    (per_clip, mean), counts = _counted(torch_deploy_test.main, [str(deploy_cfg), str(pt2)])
    deploy_s = time.perf_counter() - t0
    add(counts)
    from pnp_vcve_torch.core.builder import build_dataset
    from pnp_vcve_torch.core.config import Config

    dataset = build_dataset(dict(Config.fromfile(deploy_cfg).data["test"]))
    eager_clip, _ = torch_deploy_test.score(eager, dataset, EXPORT_T, h, w, dev, verbose=False)
    windows = FRAMES // EXPORT_T
    want = _launches_per_pass(windows * EXPORT_T, blocks, "pf")
    print(f"[export18] (c) tools/torch_deploy_test.py, clip 000 of phase 4's fixture "
          f"({windows} windows of {EXPORT_T} frames at {h}x{w}): artifact {per_clip}, eager "
          f"{eager_clip}; mean {mean}; launches {counts} (expected {want}); {deploy_s:.1f} s")
    if counts != want or per_clip.keys() != eager_clip.keys() or not per_clip or any(
            abs(per_clip[c]["PSNR"] - eager_clip[c]["PSNR"]) > 0.05
            or abs(per_clip[c]["SSIM"] - eager_clip[c]["SSIM"]) > 0.001 for c in per_clip):
        raise AssertionError("the deploy test's metrics differ from the eager path's")

    # (d) the parity gate on the kernel path
    codes = {}
    for tag, extra in (("fixture", []), ("tamper", ["--tamper"])):
        try:
            torch_parity_check.main(["--fixture", str(ROOT / "tests" / "fixtures" / "parity"),
                                     "--device", dev.type, *extra])
        except SystemExit as e:
            codes[tag] = e.code
    print(f"[export18] (d) tools/torch_parity_check.py --fixture exit {codes['fixture']}, "
          f"--tamper exit {codes['tamper']}")
    if codes != {"fixture": 0, "tamper": 1}:
        raise AssertionError(f"the parity gate on the kernel path: {codes}")

    # (e) parameters and FLOPs; publish
    train_cfg = str(CONFIGS / "HR_davis_LR_128x128.py")
    flops = {}
    for shape in ((3, 256, 256), (3, *MAIN_HW)):
        print(f"[export18] (e) tools/torch_get_flops.py --shape {' '.join(map(str, shape))}:")
        flops[shape] = torch_get_flops.main([train_cfg, "--shape", *map(str, shape)])
    from pnp_vcve_torch.train.state import TrainState, state_payload

    model = torch_export_model.load_model(train_cfg, str(PARITY_WEIGHTS), dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    ckpt = work / "ckpt" / "1.pth"
    ckpt.parent.mkdir()
    torch.save(state_payload(TrainState(1, model, opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lambda s: 1.0))), ckpt)
    pub = torch_publish_model.main([str(ckpt), str(work / "published" / "flagship")])
    held = torch.load(pub, weights_only=True)
    same = list(held) == ["state_dict"] and all(
        torch.equal(held["state_dict"][k].cpu(), v.cpu()) for k, v in model.state_dict().items())
    print(f"[export18] (e) published {pub.name} ({pub.stat().st_size / 1e6:.3f} MB, from a "
          f"{ckpt.stat().st_size / 1e6:.3f} MB training checkpoint): weights only, equal "
          f"{same}; params {flops[(3, 256, 256)][0]}, FLOPs a frame at 256x256 "
          f"{flops[(3, 256, 256)][1] / 3 / 1e9:.4f} G, at 720p "
          f"{flops[(3, *MAIN_HW)][1] / 3 / 1e9:.4f} G")
    if not same:
        raise AssertionError("the published checkpoint lost or changed weights")
    return total


# phase 19: the centre-frame baselines at their published widths (seeded),
# float32 with TF32 off: card against CPU on a small window, then a 720p
# window timed and profiled; STDF through the video API's sliding window;
# the dataset evaluation on LDP triples; DCNGAN's adversarial training
CENTER_MODELS = {
    "stdf": (dict(type="STDFNet"), 7),
    "dcngan": (dict(type="DCNGANNet"), 3),
    "mwgan": (dict(type="DenseMWNet_Mini_PSNR"), 5),
    "sidecvsr": (dict(type="SIDECVSR", nf=64, nframes=7, scg_n=4), 7),
}
CENTER_DISC = dict(type="DCNGANDiscriminator", d=128)
CENTER_SMALL_HW, SIDE_SMALL_HW, SIDE_LR_HW = (128, 128), (64, 64), (180, 320)
CENTER_TOL, WINDOW_TOL, WINDOW_SIZE = 1e-4, 1e-6, 7
GAN_B, GAN_CHECK_B, GAN_ITERS, GAN_RTOL = 5, 2, 4, 1e-4


def _center_inputs(name, t, h, w, seed):
    """One window's seeded inputs (numpy): frames in [0, 1]; SIDECVSR's Y
    frames, MVs of ~1.6 px after its x32 and side maps."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if name != "sidecvsr":
        return (rng.random((1, t, h, w, 3), np.float32),)
    return (rng.random((1, t, h, w, 1), np.float32),
            (rng.standard_normal((1, t, h, w, 2)) * 0.05).astype(np.float32),
            *(rng.random((1, t, h, w, 1), np.float32) for _ in range(3)))


def _center_out(out):
    """The enhanced frame of a model's output (SIDECVSR also returns its
    frame features), as float32 numpy."""
    if isinstance(out, tuple):
        out = out[0]
    if isinstance(out, dict):
        out = out["prediction"]
    return out.float().cpu().numpy()


def _center_profile(model, inputs):
    """One profiled 720p window: device seconds in the DCN, the
    convolutions (cuDNN), PAC and the rest (labels mirrored on the device
    where the profile has them)."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from pnp_vcve_torch.models.baselines import mwgan, stdf

    sync = torch.cuda.synchronize
    saved = (F.conv2d, F.conv_transpose2d, stdf.modulated_deform_conv2d, mwgan.pac_conv2d)
    labels = ("center.model", "center.dcn", "center.conv", "center.pac")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            F.conv2d = _labeled(saved[0], labels[2], sync)
            F.conv_transpose2d = _labeled(saved[1], labels[2], sync)
            stdf.modulated_deform_conv2d = _labeled(saved[2], labels[1], sync)
            mwgan.pac_conv2d = _labeled(saved[3], labels[3], sync)
            with torch.inference_mode():
                _labeled(lambda: model(*inputs), labels[0], sync)()
    finally:
        F.conv2d, F.conv_transpose2d, stdf.modulated_deform_conv2d, mwgan.pac_conv2d = saved
    times, by_name, mirrored = _label_times(prof, labels)
    if not by_name:
        return None
    total = sum(times.values())
    return {"device_s": total, "dcn": times[labels[1]] / total, "conv": times[labels[2]] / total,
            "pac": times[labels[3]] / total, "rest": times[labels[0]] / total,
            "labels_on_device": mirrored}


def _center_alone(dev, smi, name, cfg, t, seed):
    """(a) One model: card against CPU on the small window (a hard gate),
    then the 720p window once untimed and twice timed, peak memory and a
    profile. Returns the small window's max|diff|."""
    import numpy as np
    import torch

    from pnp_vcve_torch.core.builder import build_discriminator, build_generator

    build = build_discriminator if cfg["type"] == CENTER_DISC["type"] else build_generator
    cpu = build(cfg, device="cpu", seed=seed).eval()
    card = build(cfg, device=dev, seed=seed).eval()
    small = SIDE_SMALL_HW if name == "sidecvsr" else CENTER_SMALL_HW
    if name == "disc":  # the discriminator scores (b, h, w, 3) frames
        inputs = (_center_inputs("stdf", 1, *small, seed)[0][:, 0],)
    else:
        inputs = _center_inputs(name, t, *small, seed)
    with torch.inference_mode():
        want = _center_out(cpu(*map(torch.from_numpy, inputs)))
        got = _center_out(card(*(torch.from_numpy(a).to(dev) for a in inputs)))
    err = float(np.abs(got - want).max())
    print(f"[center19] (a) {name} ({sum(p.numel() for p in cpu.parameters()) / 1e6:.3f} M "
          f"params) on {small[0]}x{small[1]}{' LR' if name == 'sidecvsr' else ''}: the card "
          f"against the CPU max|diff| {err:.3g} (<= {CENTER_TOL}), output {got.shape}")
    if not np.isfinite(got).all() or err > CENTER_TOL:
        raise AssertionError(f"phase 19 (a): {name} on the card disagrees with the CPU")
    del cpu
    if name == "disc":
        return err
    hw = SIDE_LR_HW if name == "sidecvsr" else MAIN_HW
    big = [torch.from_numpy(a).to(dev) for a in _center_inputs(name, t, *hw, seed + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        out = card(*big)  # untimed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            out = card(*big)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 2
    out = _center_out(out)
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = _center_profile(card, big)
    split = ("not measured (the profiler recorded no device events)" if prof is None else
             f"device {prof['device_s']:.4f} s: DCN {prof['dcn']:.4f}, convolutions "
             f"{prof['conv']:.4f}, PAC {prof['pac']:.4f}, rest {prof['rest']:.4f} (labels "
             f"{'on the device' if prof['labels_on_device'] else 'by host interval'})")
    print(f"[center19] (a) {smi}: {name} {hw[0]}x{hw[1]} window of {t} -> {out.shape[1:3]}: "
          f"{1.0 / wall:.3f} centre frames/s ({wall:.4f} s), peak {peak:.3f} GiB, float32; "
          f"profiled window {split}")
    if not np.isfinite(out).all():
        raise AssertionError(f"phase 19 (a): {name} at 720p is not finite")
    del card, big
    torch.cuda.empty_cache()
    return err


def _gan_losses(work):
    """``{iteration: (loss_g, loss_d)}`` of a run's scalars.json (unrounded)."""
    out = {}
    for ln in (work / "scalars.json").read_text().splitlines():
        row = json.loads(ln)
        if "loss_g" in row:
            out[row["step"]] = (row["loss_g"], row["loss_d"])
    return out


def phase_center_frame(dev, smi):
    """Phase 19: the centre-frame baselines. (a) STDF, DCNGAN and its
    discriminator, MW-GAN and SIDECVSR built through the builder (seeded,
    published widths): card vs CPU on a small window, then a 720p window
    (SIDECVSR 180x320 -> 720x1280) timed and profiled; (b) STDF through
    apis.init_model / restoration_video_inference(window_size=7) on clip 000
    of phase 4's fixture, each frame against the generator on its own padded
    window; (c) evaluate_center_frame_dataset over LDPNonPQFDataset on phase
    7's fixture, its first sample card vs CPU; (d) tools/torch_train.py on
    a DCNGAN config (phase 7's fixture, 3-frame windows, b=5, 128x128, Adam
    1e-4 for both networks, 4 iterations, --deterministic) and its first
    iteration at b=2 on the card against the CPU; (e) no kernel launched.
    Float32, TF32 off. Returns the gates' errors."""
    import shutil

    import numpy as np
    import torch

    from pnp_vcve_torch import apis
    from pnp_vcve_torch.core.builder import (
        build_dataset,
        build_discriminator,
        build_generator,
    )
    from pnp_vcve_torch.kernels import LAUNCHES
    from pnp_vcve_torch.models.restorer import CenterFrameRestorer, evaluate_center_frame_dataset

    sys.path[:0] = [str(ROOT / "tools"), str(ROOT / "tools" / "data")]
    import torch_train
    from make_protocol_fixture import REDS4_CLIPS, write_fixture

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    launches_before = dict(LAUNCHES)
    work = ROOT / "build" / "chip_smoke" / "center"
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    errs = {}

    # (a) each model alone
    for i, (name, (cfg, t)) in enumerate(CENTER_MODELS.items()):
        errs[name] = _center_alone(dev, smi, name, cfg, t, SEED + 190 + i)
        if name == "dcngan":
            errs["disc"] = _center_alone(dev, smi, "disc", CENTER_DISC, 1, SEED + 199)

    # (b) the video API's sliding window on clip 000 of phase 4's fixture
    clip = ROOT / "build" / "chip_smoke" / "data" / "crf15" / "png" / REDS4_CLIPS[0]
    if not clip.is_dir():
        write_fixture(clip.parents[2], clips=REDS4_CLIPS[:1], frames=FRAMES, height=MAIN_HW[0],
                      width=MAIN_HW[1], crf=15, seed=SEED, quiet=True)
    model = apis.init_model(dict(model=dict(type="STDF", generator=dict(type="STDFNet"))),
                            device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = apis.restoration_video_inference(model, str(clip), window_size=WINDOW_SIZE)
    wall = time.perf_counter() - t0
    lq = apis._read_frame_dir(str(clip), "{:08d}.png", 0)
    pad = WINDOW_SIZE // 2
    padded = np.concatenate([lq[1:1 + pad][::-1], lq, lq[-1 - pad:-1][::-1]])
    err = 0.0
    with torch.inference_mode():
        for i in range(lq.shape[0]):
            win = torch.from_numpy(np.ascontiguousarray(padded[None, i:i + WINDOW_SIZE]))
            ref = model.generator(win.to(dev))[0].cpu().numpy()
            err = max(err, float(np.abs(out[i] - ref).max()))
    errs["window"] = err
    print(f"[center19] (b) {smi}: apis.restoration_video_inference(window_size={WINDOW_SIZE}), "
          f"STDF (radius 3, 32/3, 64, QE 48x6, seeded) on {lq.shape[0]} frames of "
          f"{lq.shape[1]}x{lq.shape[2]}: {lq.shape[0] / wall:.3f} f/s ({wall:.3f} s with PNG "
          f"loading); each frame against the generator on its padded window max|diff| "
          f"{err:.3g} (<= {WINDOW_TOL})")
    if out.shape != lq.shape or not np.isfinite(out).all() or err > WINDOW_TOL:
        raise AssertionError("phase 19 (b): the sliding window disagrees with the generator")
    del model, out

    # (c) evaluate_center_frame_dataset on phase 7's fixture's non-PQF triples
    cfg_path = _train_fixture(ROOT / "build" / "chip_smoke" / "train")
    data = ROOT / "build" / "chip_smoke" / "train" / "data"
    dataset = build_dataset(dict(
        type="LDPNonPQFDataset", lq_folder=str(data / "crf15" / "png"),
        gt_folder=str(data / "sharp" / "png"), cprs15_folder=str(data / "crf15" / "png"),
        cprs25_folder=str(data / "crf25" / "png"), cprs35_folder=str(data / "crf35" / "png"),
        sequence_length=TRAIN_FRAMES,
        pipeline=[dict(type="LoadImageFromFileList_Mix_Compress_ipb", key="lq",
                       qp_slice_file=str(data / "qp.json"))]))
    gcfg = dict(type="STDFNet", radius=1)
    card = build_generator(gcfg, device=dev, seed=SEED + 195).eval()
    t0 = time.perf_counter()
    metrics = evaluate_center_frame_dataset(CenterFrameRestorer(generator=card),
                                            dataset.iter_test(), verbose=False)
    wall = time.perf_counter() - t0
    n = sum(1 for _ in dataset.iter_test())
    first = next(dataset.iter_test())
    cpu = build_generator(gcfg, device="cpu", seed=SEED + 195).eval()
    with torch.inference_mode():
        want = cpu(torch.from_numpy(first["lq"][None])).numpy()
        got = card(torch.from_numpy(first["lq"][None]).to(dev)).cpu().numpy()
    errs["dataset"] = float(np.abs(got - want).max())
    print(f"[center19] (c) {smi}: evaluate_center_frame_dataset, STDF radius 1 (seeded) over "
          f"{n} non-PQF triples of {TRAIN_HW[0]}x{TRAIN_HW[1]} at CRF 15: {metrics}, "
          f"{n / wall:.3f} triples/s with PNG loading and host metrics; first sample the card "
          f"against the CPU max|diff| {errs['dataset']:.3g} (<= {CENTER_TOL})")
    if (n == 0 or not all(np.isfinite(v) for v in metrics.values())
            or errs["dataset"] > CENTER_TOL):
        raise AssertionError("phase 19 (c): the dataset evaluation")
    del card, cpu

    # (d) DCNGAN's adversarial training through tools/torch_train.py
    from pnp_vcve_torch.core.presets import train_dataset

    train = train_dataset("DAVISMultipleGTMixCompressDataset", str(data), "sharp",
                          str(data / "qp.json"))
    train["dataset"]["num_input_frames"] = 3
    gan_cfg = work / "dcngan_train.py"
    gan_cfg.write_text(
        f"_base_ = [{str(CONFIGS / 'HR_davis_LR_128x128.py')!r}]\n"
        "model = dict(type='DCNGAN', generator=dict(type='DCNGANNet'),\n"
        f"             discriminator={CENTER_DISC!r})\n"
        f"data = dict(train=[{train!r}], train_dataloader=dict(samples_per_gpu={GAN_B}))\n"
        "optimizers = dict(generator=dict(type='Adam', lr=1e-4, betas=(0.9, 0.999)),\n"
        "                  discriminator=dict(type='Adam', lr=1e-4, betas=(0.9, 0.999)))\n"
        "lr_config = dict(policy='Fixed')\n"
        "log_config = dict(interval=1)\n"
        f"checkpoint_config = dict(interval={GAN_ITERS}, save_optimizer=False)\n")
    run = work / "gan"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch_train.main([str(gan_cfg), "--device", dev.type, "--work-dir", str(run),
                      "--total-iters", str(GAN_ITERS), "--deterministic"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = _gan_losses(run)
    rates = [float(ln.split("(")[1].split()[0]) for ln in (run / "train.log").read_text()
             .splitlines() if " loss_g=" in ln]
    ckpt = torch.load(run / "ckpt" / f"{GAN_ITERS}.pth", map_location="cpu", weights_only=True)
    g0 = build_generator(dict(type="DCNGANNet"), device="cpu", seed=0).state_dict()
    d0 = build_discriminator(CENTER_DISC, device="cpu", seed=1).state_dict()
    moved = {"generator": sum(not torch.equal(v, ckpt["model"][k]) for k, v in g0.items()),
             "discriminator": sum(not torch.equal(v, ckpt["disc"]["model"][k])
                                  for k, v in d0.items())}
    sec = [1.0 / r for r in rates[1:]]
    print(f"[center19] (d) {smi}: tools/torch_train.py DCNGAN (generator 32/3 + QE, "
          f"discriminator d=128; b={GAN_B}, 3-frame windows, 128x128, Adam 1e-4 each, "
          f"--deterministic, TF32 off) {GAN_ITERS} iterations in {wall:.2f} s: losses "
          f"{losses}; {np.mean(sec):.4f} s an iteration over iterations 2-{GAN_ITERS} "
          f"({[round(x, 4) for x in sec]}); tensors changed {moved}; checkpoint keys "
          f"{sorted(ckpt)}")
    if (len(losses) != GAN_ITERS or not np.isfinite(list(losses.values())).all()
            or "disc" not in ckpt or not all(moved.values())):
        raise AssertionError("phase 19 (d): DCNGAN training (losses, weights or checkpoint)")
    del ckpt
    first = {}
    for d in (dev, torch.device("cpu")):
        sub = work / f"gan_b{GAN_CHECK_B}_{d.type}"
        torch_train.main([str(gan_cfg), "--device", d.type, "--work-dir", str(sub),
                          "--total-iters", "1", "--deterministic", "--cfg-options",
                          f"data.train_dataloader.samples_per_gpu={GAN_CHECK_B}"])
        first[d.type] = _gan_losses(sub)[1]
    rel = max(abs(a - b) / abs(b) for a, b in zip(first[dev.type], first["cpu"]))
    errs["gan_first_iteration_rel"] = rel
    print(f"[center19] (d) iteration 1 at b={GAN_CHECK_B}: card (loss_g, loss_d) "
          f"{first[dev.type]}, CPU {first['cpu']}: max relative diff {rel:.3g} (<= {GAN_RTOL})")
    if rel > GAN_RTOL:
        raise AssertionError("phase 19 (d): DCNGAN's first iteration on the card disagrees "
                             "with the CPU")

    # (e) the centre-frame models run no kernel of the port
    launched = {k: v - launches_before[k] for k, v in LAUNCHES.items()}
    print(f"[center19] (e) kernel launches across (a)-(d): {launched}")
    if any(launched.values()):
        raise AssertionError("phase 19 (e): a kernel of the port was launched")
    shutil.rmtree(work)
    return errs


# phase 20: the super-resolution zoo downstream of the enhancer at
# mmediting's published widths (seeded; the DCN offset heads non-zero),
# float32 with TF32 off: card against CPU on a small window, then an 8-frame
# 180x320 -> 720x1280 clip (a 5- or 7-frame window for the window models;
# TOFlow on the window upsampled to 720x1280, as the reference feeds it)
# timed and profiled; the single-image models on one 180x320 frame; the
# cascade into BasicVSR and IconVSR; EDVR and EDSR through the APIs
ZOO_VIDEO = {  # name -> (config, frames)
    "basicvsr": (dict(type="BasicVSRNet", mid_channels=64, num_blocks=30), 8),
    "iconvsr": (dict(type="IconVSRNet", mid_channels=64, num_blocks=30, keyframe_stride=5,
                     padding=2), 8),
    "realbasicvsr": (dict(type="RealBasicVSRNet", mid_channels=64, num_propagation_blocks=20,
                          num_cleaning_blocks=20), 8),
    "edvr": (dict(type="EDVRNet", mid_channels=64, num_frames=5, deform_groups=8,
                  num_blocks_extraction=5, num_blocks_reconstruction=10), 5),
    "tdan": (dict(type="TDANNet", mid_channels=64, num_blocks_before_align=5,
                  num_blocks_after_align=10), 5),
    "toflow": (dict(type="TOFlow"), 7),
}
ZOO_SISR = {
    "edsr": dict(type="EDSR", mid_channels=64, num_blocks=16),
    "rrdbnet": dict(type="RRDBNet", mid_channels=64, num_blocks=23, growth_channels=32),
    "msrresnet": dict(type="MSRResNet", mid_channels=64, num_blocks=16),
    "srcnn": dict(type="SRCNN", channels=(3, 64, 32, 3), kernel_sizes=(9, 1, 5)),
    "rdn": dict(type="RDN", mid_channels=64, num_blocks=16, num_layers=8, channel_growth=64),
}
ZOO_RECURRENT = ("basicvsr", "iconvsr", "realbasicvsr")
ZOO_LR_HW, ZOO_SMALL_HW, ZOO_SISR_SMALL_HW, ZOO_SMALL_T = (180, 320), (64, 64), (32, 32), 5
ZOO_TOL, ZOO_API_TOL, ZOO_OFFSET_SCALE = 1e-4, 1e-6, 0.01
ZOO_CASCADE = ("basicvsr", "iconvsr")


def _zoo_k1_per_clip(name, t):
    """K1 launches of one clip of t frames: each sweep of the recurrent
    models warps its feature from its second step."""
    return 2 * (t - 1) if name in ZOO_RECURRENT else 0


def _seed_dcn_offsets(model, seed):
    """Seeded weights in every DCN's zero-initialised offset conv (EDVR's,
    TDAN's, IconVSR's EDVR-M): offsets of about a quarter pixel."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            w = getattr(getattr(m, "conv_offset", None), "weight", None)
            if w is not None and w.dim() == 4:
                w.copy_(torch.randn(w.shape, generator=gen).to(w.device) * ZOO_OFFSET_SCALE)
    return model


def _set_ops(model, ops):
    for m in model.modules():
        if hasattr(m, "ops"):
            m.ops = ops


def _zoo_out(out):
    """The frames of a model's output (TDAN's x4 frame of its pair)."""
    return (out[0] if isinstance(out, tuple) else out).float()


def _zoo_profile(model, inputs, counts_of):
    """One profiled run: device seconds in the DCN (EDVR's, TDAN's), the
    convolutions (cuDNN), K1 and the rest (labels mirrored on the device
    where the profile has them). Returns the split or None."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from pnp_vcve_torch.models.baselines import edvr, tdan

    sync = torch.cuda.synchronize
    saved = (F.conv2d, edvr.modulated_deform_conv2d, tdan.modulated_deform_conv2d)
    labels = ("zoo.model", "zoo.dcn", "zoo.conv")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            F.conv2d = _labeled(saved[0], labels[2], sync)
            edvr.modulated_deform_conv2d = _labeled(saved[1], labels[1], sync)
            tdan.modulated_deform_conv2d = _labeled(saved[2], labels[1], sync)
            with torch.inference_mode():
                _labeled(lambda: model(inputs), labels[0], sync)()
    finally:
        F.conv2d, edvr.modulated_deform_conv2d, tdan.modulated_deform_conv2d = saved
    times, by_name, mirrored = _label_times(prof, labels)
    if not by_name:
        return None
    k1 = _kernel_times(by_name, counts_of(), ("warp",))["warp"]
    total = sum(times.values())
    return {"device_s": total, "dcn": times[labels[1]] / total,
            "conv": times[labels[2]] / total, "k1": k1 / total,
            "rest": (times[labels[0]] - k1) / total, "labels_on_device": mirrored}


def _zoo_alone(dev, smi, name, cfg, t, seed):
    """One model: card against CPU on the small window (a hard gate); for
    BasicVSR, IconVSR and RealBasicVSR the card's kernel path against its
    plain path on the 180x320 clip (3e-3) with K1's exact launches; then the
    driven runs (one untimed, two timed, one profiled), their launches
    gated. Returns (errors, the driven runs' launches)."""
    import copy

    import numpy as np
    import torch

    from pnp_vcve_torch.core.builder import build_generator
    from pnp_vcve_torch.kernels import KERNELS, LAUNCHES, PLAIN, reset_launches
    from pnp_vcve_torch.ops.resize import resize_bicubic

    sisr = t == 0
    cpu = _seed_dcn_offsets(build_generator(cfg, device="cpu", seed=seed), seed).eval()
    card = copy.deepcopy(cpu).to(dev).eval()
    rng = np.random.default_rng(seed)
    if sisr:
        small = rng.random((1, *ZOO_SISR_SMALL_HW, 3), np.float32)
    else:
        small = rng.random((1, t if name not in ZOO_RECURRENT else ZOO_SMALL_T,
                            *ZOO_SMALL_HW, 3), np.float32)
    with torch.inference_mode():
        want = _zoo_out(cpu(torch.from_numpy(small))).numpy()
        got = _zoo_out(card(torch.from_numpy(small).to(dev))).cpu().numpy()
    errs = {"card_vs_cpu": float(np.abs(got - want).max())}
    params = sum(p.numel() for p in cpu.parameters()) / 1e6
    print(f"[zoo20] {name} ({params:.3f} M params) on {small.shape[1:-1]}: the card against "
          f"the CPU max|diff| {errs['card_vs_cpu']:.3g} (<= {ZOO_TOL}), output {got.shape}")
    if not np.isfinite(got).all() or errs["card_vs_cpu"] > ZOO_TOL:
        raise AssertionError(f"phase 20 (a): {name} on the card disagrees with the CPU")
    del cpu

    lr_shape = (1, *ZOO_LR_HW, 3) if sisr else (1, t, *ZOO_LR_HW, 3)
    big = torch.from_numpy(np.random.default_rng(seed + 1).random(lr_shape, np.float32)).to(dev)
    if name == "toflow":  # the reference feeds TOFlow bicubically upsampled frames
        big = resize_bicubic(big[0], (4 * ZOO_LR_HW[0], 4 * ZOO_LR_HW[1]))[None]
    per_clip = _zoo_k1_per_clip(name, t)
    if name in ZOO_RECURRENT:
        with torch.inference_mode():
            reset_launches()
            got = card(big)
            counts = dict(LAUNCHES)
            _set_ops(card, PLAIN)
            want = card(big)
            _set_ops(card, KERNELS)
        errs["kernel_vs_plain"] = float((got - want).abs().max())
        expected = {k: (per_clip if k == "warp" else 0) for k in counts}
        print(f"[zoo20] {name} {t} frames {ZOO_LR_HW[0]}x{ZOO_LR_HW[1]}: kernel path vs plain "
              f"path max|diff| {errs['kernel_vs_plain']:.3g} (<= {TOL_MODEL}); launches "
              f"{counts} (expected K1 {per_clip})")
        if (not bool(torch.isfinite(got).all()) or errs["kernel_vs_plain"] > TOL_MODEL
                or counts != expected):
            raise AssertionError(f"phase 20 (a): {name}'s kernel path against its plain path "
                                 "or its K1 launches")
        del got, want

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with torch.inference_mode():
        out = card(big)  # untimed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            out = card(big)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 2
    out = _zoo_out(out)
    peak = torch.cuda.max_memory_allocated() / 2**30
    before = dict(LAUNCHES)
    prof = _zoo_profile(card, big, lambda: {k: v - before[k] for k, v in LAUNCHES.items()})
    counts = dict(LAUNCHES)
    expected = {k: (4 * per_clip if k == "warp" else 0) for k in counts}
    frames = 1 if sisr or name not in ZOO_RECURRENT else t
    unit = "centre frames/s" if name in ("edvr", "tdan", "toflow") else "f/s"
    split = ("not measured (the profiler recorded no device events)" if prof is None else
             f"device {prof['device_s']:.4f} s: DCN {prof['dcn']:.4f}, convolutions "
             f"{prof['conv']:.4f}, K1 {prof['k1']:.4f}, rest {prof['rest']:.4f} (labels "
             f"{'on the device' if prof['labels_on_device'] else 'by host interval'})")
    print(f"[zoo20] {smi}: {name} {tuple(big.shape[1:-1])} -> {tuple(out.shape[-3:-1])}: "
          f"{frames / wall:.3f} {unit} ({wall:.4f} s a {'frame' if sisr else 'clip'}), peak "
          f"{peak:.3f} GiB, float32; launches of the 4 driven runs {counts}; profiled run "
          f"{split}")
    if not bool(torch.isfinite(out).all()) or counts != expected:
        raise AssertionError(f"phase 20 (a/b): {name}'s output is not finite or its launches "
                             f"differ from {expected}")
    del card, big, out
    torch.cuda.empty_cache()
    return errs, counts


def phase_sr_zoo(dev, smi):
    """Phase 20: the super-resolution zoo. (a) BasicVSR 64/30, IconVSR 64/30
    (stride 5, padding 2, EDVR-M inside), RealBasicVSR 64/20/20, EDVR-M
    (64, 5 frames, 8 groups, 5/10), TDAN 64/5/10 and TOFlow built through the
    builder (seeded; DCN offset heads non-zero): card vs CPU on a small
    window (5 frames at 64x64, the window models' own length), the
    recurrent models' kernel path vs plain path at 180x320 with K1's exact
    launches, then an 8-frame 180x320 clip (the window models one window)
    timed and profiled; (b) EDSR 64/16, RRDBNet 64/23/32, MSRResNet 64/16,
    SRCNN 9-1-5 and RDN 64/16/8/64 likewise (32x32, then one 180x320 frame);
    (c) tools/torch_test.py --cascade from the serving config (parity
    weights) into BasicVSR and IconVSR on clip 000 of phase 16's 176x320
    fixture with its x4 GT: finite metrics, the flagship's and K1's
    launches; (d) EDVR through apis.restoration_video_inference(
    window_size=5) on that clip's PNGs and EDSR through
    apis.restoration_inference on its first frame, each equal to the
    generator on the same frames. Float32, TF32 off. Returns (the driven
    runs' launches, the gates' errors)."""
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    from pnp_vcve_torch import apis
    from pnp_vcve_torch.core.builder import build_generator
    from pnp_vcve_torch.core.config import Config
    from pnp_vcve_torch.kernels import LAUNCHES, reset_launches

    sys.path[:0] = [str(ROOT / "tools"), str(ROOT / "tools" / "data")]
    import torch_test
    from make_protocol_fixture import REDS4_CLIPS, write_fixture

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    work = ROOT / "build" / "chip_smoke" / "zoo"
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    total = dict.fromkeys(LAUNCHES, 0)
    errs = {}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    # (a) and (b): each model alone
    models = [(n, c, t) for n, (c, t) in ZOO_VIDEO.items()] + [(n, c, 0)
                                                                for n, c in ZOO_SISR.items()]
    for i, (name, cfg, t) in enumerate(models):
        errs[name], counts = _zoo_alone(dev, smi, name, cfg, t, SEED + 200 + i)
        add(counts)

    # (c) the cascade into BasicVSR and IconVSR on phase 16's clip 000
    h, w = CASCADE_HW
    t = FRAMES
    data = work / "data"
    write_fixture(data, clips=REDS4_CLIPS[:1], frames=t, height=h, width=w, crf=15,
                  seed=SEED + 16, quiet=True)
    for f in sorted((data / "sharp" / "png").glob("*/*.png")):
        out = data / "x4" / "png" / f.parent.name / f.name
        out.parent.mkdir(parents=True, exist_ok=True)
        Image.open(f).resize((4 * w, 4 * h), Image.BICUBIC).save(out)
    cfg = _fixture_cfg(work / "serving.py", CONFIGS / "HR_davis_LR_128x128_serving.py", data,
                       "x4/png", t)
    parity = str(ROOT / "tests/fixtures/parity/state_dict.npz")
    nb = Config.fromfile(cfg).model["generator"]["num_blocks"]
    for i, name in enumerate(ZOO_CASCADE):
        gen_cfg = ZOO_VIDEO[name][0]
        vsr_cfg = work / f"{name}.py"
        vsr_cfg.write_text(f"model = dict(type='BasicVSR', generator={gen_cfg!r})\n"
                           "test_cfg = dict(metrics=['PSNR', 'SSIM'], crop_border=0)\n")
        ckpt = work / f"{name}.pth"
        torch.save(_seed_dcn_offsets(build_generator(gen_cfg, device="cpu", seed=SEED + 220 + i),
                                     SEED + 220 + i).state_dict(), ckpt)
        expected = _launches_per_pass(t, nb, "pf")
        expected["warp"] = _zoo_k1_per_clip(name, t)
        reset_launches()
        t0 = time.perf_counter()
        metrics = torch_test.main([str(cfg), parity, "--device", dev.type, "--cascade",
                                   "--cascade_config", str(vsr_cfg), "--cascade_ckpt",
                                   str(ckpt)])
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        add(counts)
        print(f"[zoo20] (c) {smi}: tools/torch_test.py --cascade into {name} on {t} frames of "
              f"{h}x{w} -> {4 * h}x{4 * w}: {metrics} against the x4 GT, {wall:.2f} s with "
              f"loading and host metrics; launches {counts} (expected {expected})")
        if (counts != expected or set(metrics) != {"PSNR", "SSIM"}
                or not all(np.isfinite(v) for v in metrics.values())):
            raise AssertionError(f"phase 20 (c): the cascade into {name}: launches or metrics")

    # (d) the APIs on the clip's PNGs: EDVR's sliding window, EDSR on one frame
    clip = data / "crf15" / "png" / REDS4_CLIPS[0]
    model = apis.init_model(dict(model=dict(type="BasicVSR", generator=ZOO_VIDEO["edvr"][0])),
                            device=dev)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = apis.restoration_video_inference(model, str(clip), window_size=5)
    wall = time.perf_counter() - t0
    lq = apis._read_frame_dir(str(clip), "{:08d}.png", 0)
    padded = np.concatenate([lq[1:3][::-1], lq, lq[-3:-1][::-1]])
    err = 0.0
    with torch.inference_mode():
        for i in range(lq.shape[0]):
            win = torch.from_numpy(np.ascontiguousarray(padded[None, i:i + 5])).to(dev)
            err = max(err, float(np.abs(out[i] - model.generator(win)[0].cpu().numpy()).max()))
    errs["edvr_video_api"] = err
    print(f"[zoo20] (d) {smi}: apis.restoration_video_inference(window_size=5), EDVR-M "
          f"(init_model's seed-0 weights) on {lq.shape[0]} frames of {h}x{w}: "
          f"{lq.shape[0] / wall:.3f} f/s ({wall:.3f} s with PNG loading); each frame against "
          f"the generator on its padded window max|diff| {err:.3g} (<= {ZOO_API_TOL})")
    if out.shape != (t, 4 * h, 4 * w, 3) or not np.isfinite(out).all() or err > ZOO_API_TOL:
        raise AssertionError("phase 20 (d): EDVR's sliding window disagrees with the generator")
    model = apis.init_model(dict(model=dict(type="BasicRestorer", generator=ZOO_SISR["edsr"])),
                            device=dev)
    png = clip / "00000000.png"
    t0 = time.perf_counter()
    out = apis.restoration_inference(model, str(png))
    wall = time.perf_counter() - t0
    with torch.inference_mode():
        ref = model.generator(torch.from_numpy(lq[None, 0]).to(dev))[0].clamp(0, 1)
    errs["edsr_image_api"] = float(np.abs(out - ref.cpu().numpy()).max())
    counts = dict(LAUNCHES)
    add(counts)
    print(f"[zoo20] (d) apis.restoration_inference, EDSR (init_model's seed-0 weights) on one "
          f"{h}x{w} PNG: {wall:.4f} s with PNG loading; against the generator on the same "
          f"frame max|diff| {errs['edsr_image_api']:.3g} (<= {ZOO_API_TOL}); launches {counts}")
    if (out.shape != (4 * h, 4 * w, 3) or errs["edsr_image_api"] > ZOO_API_TOL
            or any(counts.values())):
        raise AssertionError("phase 20 (d): EDSR's image API disagrees with the generator")
    print(f"[zoo20] the driven runs' launches: {total}")
    shutil.rmtree(work)
    return total, errs


def main():
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    # deterministic cuBLAS for the resume check of phase 7; read when cuBLAS
    # starts, so set before any CUDA work
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev, smi = phase_device()
    import torch

    fixture = start_main_fixture()
    try:
        _phases(dev, smi, fixture, t_start)
    finally:
        if fixture.poll() is None:
            fixture.kill()
        fixture.wait()


def _phases(dev, smi, fixture, t_start):
    import torch

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    phase("2 build", phase_build)
    kern = phase("3 kernels", phase_kernels, dev)
    counts = phase("4 serving path", phase_main_path, dev, fixture)
    model_widths = phase("5 model vs plain", phase_model_vs_plain, dev)
    phase("6 gradients", phase_grads, dev)
    train_counts = phase("7 training", phase_train, dev, smi)
    batched_counts = phase("8 batched serving", phase_batched, dev, smi)
    phase("9 serving curve", phase_curve)
    handler_counts = phase("10 handler", phase_handler, dev)
    forms_counts = phase("11 block forms", phase_block_forms, dev, smi)
    probe_rows = phase("12 probes", phase_probes, dev, smi)
    b10b_rows = phase("13 probes that move data", phase_probes_b10b, dev, smi)
    forms14_counts, forms14_errs = phase("14 model forms", phase_model_forms, dev, smi)
    exact_counts = phase("15 exact pipeline", phase_exact_pipeline, dev, smi)
    cascade_counts, baseline_errs = phase("16 cascade and joint protocol", phase_baselines, dev,
                                          smi)
    ddp_counts, kitti_counts = phase("17 data-parallel training and KITTI", phase_ddp_train,
                                     dev, smi)
    export_counts = phase("18 export and deployment", phase_export, dev, smi)
    center_errs = phase("19 centre-frame baselines", phase_center_frame, dev, smi)
    zoo_counts, zoo_errs = phase("20 SR zoo", phase_sr_zoo, dev, smi)
    # K6 runs in both probe phases: one row, the forms and counts of both
    k6 = b10b_rows.pop("window_copy")
    probe_rows["window_copy"]["forms"] += k6["forms"]
    probe_rows["window_copy"]["launches"] += k6["launches"]
    probe_rows["window_copy"]["phase13_launches"] = k6["launches"]
    probe_rows["window_copy"]["max_abs_err"] = max(probe_rows["window_copy"]["max_abs_err"],
                                                   k6["max_abs_err"])
    probe_rows.update(b10b_rows)

    paths = {"serving_launches": counts, "batched_launches": batched_counts,
             "handler_launches": handler_counts, "train_launches": train_counts,
             "block_forms_launches": forms_counts, "model_forms_launches": forms14_counts,
             "exact_pipeline_launches": exact_counts, "cascade_launches": cascade_counts,
             "ddp_train_launches": ddp_counts, "kitti_launches": kitti_counts,
             "export_launches": export_counts, "sr_zoo_launches": zoo_counts}
    print(f"[chip_smoke] every phase passed in {time.perf_counter() - t_start:.1f} s; {smi}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         **({"also_replaces": ALSO_REPLACES[name]} if name in ALSO_REPLACES else {}),
         "launches": sum(c[name] for c in paths.values()),
         **{k: c[name] for k, c in paths.items()}, **kern[name]}
        for name, (src, rep) in KERNEL_INFO.items()
    ] + [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "also_replaces": also,
         **probe_rows[name]}
        for name, (src, rep, also) in PROBE_INFO.items()
    ], "model_widths_max_abs_err": model_widths, "model_forms_max_abs_err": forms14_errs,
        "baselines_max_abs_err": baseline_errs, "center_frame_max_abs_err": center_errs,
        "sr_zoo_max_abs_err": zoo_errs}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
