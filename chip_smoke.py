#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (satlas_sr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--kernels-only]

Phases, in order; any failure exits non-zero:
1. the card's name and power limit; build the port's CUDA source (rdb.cu:
   wgmma/TMA kernels, bfloat16 and float32 by three TF32 products) and
   print ptxas's register, shared memory and spill report.
2. each kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it (rdb: x [64, 32, 32, 64]; for infer_grid's
   whole-tile mode [1, 512, 512, 64]; for the test CLI's batch 1
   [1, 32, 32, 64]; for infer_grid's chunked and halo modes
   [256, 32, 32, 64]; nf=64, g=32, weights at Kaiming fan-in scale so the
   conv branch is as large as x): float32 with TF32 off (atol 1e-4, rtol
   1e-4) and bfloat16 against the plain version in float32 on the same
   bf16-cast inputs (`bf16_branch_err` <= 3e-2: the error beyond the bf16
   output's own rounding, over the peak of the conv branch out - x); at
   [64, 32, 32, 64] also for one RRDB (three calls and the 0.2 outer
   residual, which catches offsets that differ between calls); times of the
   kernel, the plain version and one cuDNN yardstick (the same five convs as
   F.conv2d), and the bound.
3. the main path: GT-free esrgan_8S2 inference at full width (24 input
   channels, nf 64, 23 blocks, g 32, x4) with seeded random weights saved as
   a reference .pth, over a synthetic tree of 128 chips, through
   satlas_sr_tpu_torch.infer.run_inference, once in float32 and once in
   bfloat16. Kernel launch counts are zeroed just before each run and read
   just after; every sr.png must be 128x128x3 uint8; the float32 generator
   through the kernel must match the plain version within atol 1e-3 on one
   batch; bf16-vs-f32 output PSNR must be >= 30 dB.
4. infer_grid on one synthetic 16x16-chunk tile (8 frames a chunk) with the
   same weights, in the three modes of options/infer_grid_example.yml
   (chunked + stitch), infer_grid_whole_tile.yml and infer_grid_halo.yml, as
   shipped (bfloat16, their batch sizes, halo 6, window 32): launches = 69 x
   forwards, 2048x2048x3 SR and 512x512x3 S2, and the seconds a further
   tile adds (a two-tile run less a one-tile run); whole-tile once more in
   float32 with TF32 off, through the kernel and through the plain trunk,
   within 1 level on <= 0.1% of values; halo against whole-tile printed.
5. the zoo configs zoo/infer_srcnn.yml, zoo/infer_highresnet.yml and
   zoo/infer_esrgan_10m.yml at their widths through the infer CLI on 8
   synthetic chips (band PNGs for 10m): card against the port's CPU run,
   within 1 level on <= 0.1% of values; 10m's launches = 69 x forwards.
6. the PNG codec (the port's own, on zlib alone; it must build where zlib's
   header is, and PIL runs only where it is absent, which is printed), its
   decode rate beside PIL's on the same files and threads, its 2048x2048
   encode size and time beside PIL's, the count of interlaced files handed
   to PIL, and the steady-state end-to-end img/s of run_inference in both
   dtypes: (1280 - 256) chips over the difference of the times of a
   1280-chip and a 256-chip run, which cancels the set-up.
7. the test CLI (satlas_sr_tpu_torch.test) on options/esrgan_s2naip_urban.yml
   at full width over a synthetic S2-NAIP tree of 16 chips (a few with a
   black NAIP pixel or too few frames, which the dataset skips), its
   metrics narrowed to psnr/ssim/cpsnr: as shipped (bf16, batch 1), in
   float32 with TF32 off, in float32 at batch 64 with fast_metrics, and the
   float32 config on the CPU; then as shipped with its metrics in full
   (LPIPS-VGG16 and CLIPScore on siglip-ViT-SO400M-14, seeded random towers
   on the card; the SO400M build timed on its own line). Gates: launches =
   69 x forwards; no metric failed on any chip; float32 card metrics within
   0.01 dB (PSNR, cPSNR) and 1e-4 (SSIM) of the CPU's; float32
   visualization PNGs within 1 level on <= 0.1% of values of the CPU's;
   bf16 PNGs >= 30 dB against float32; device-batched PSNR/SSIM within
   1e-3 dB / 1e-4 of the numpy metrics of the same run; LPIPS and CLIPScore
   of 2 chips on the card in float32 with TF32 off within 1e-4 of the
   CPU's (as shipped, TF32 allowed, printed). Seconds, img/s, the split of
   validation's time (data, forward, metrics, PNG writes) and the tower
   metrics' ms a chip; then the towers on their own by CUDA events (SO400M
   at [1|2, 384, 384, 3], ViT-B-16-SigLIP-256 at [32, 256, 256, 3] forward
   and forward + input backward, LPIPS-VGG16 on a 128x128 pair; as shipped
   and with TF32 off) beside their counted FLOPs over the peak.
8. the ESRGAN GAN trainer (satlas_sr_tpu_torch.train) at full width on
   options/esrgan_s2naip_urban.yml (23 blocks, nf 64, g 32, D nf 64,
   VGG19): one RDB under autograd at x [32, 32, 32, 64] (the kernel's
   forward keeping its concat, the cuDNN backward from it) against
   autograd of the plain version with the kernel's activation pattern,
   every gradient within 1e-4 of its reference's max in float32 with TF32
   off and 5e-2 in bfloat16 (sign flips and the unmasked error printed), timed
   beside cuDNN autograd, cuDNN's own gradient calls for the five convs and
   the bound; one float32 step (batch 2, TF32
   off) on the card against the same step on the CPU: losses within 1e-4
   relative, each network's first gradients within 1e-3 relative L2 and
   every tensor within 1e-2 of its max (the ReLU kinks: see step_check;
   the count over 1e-4 and of RDB sign flips printed), and the RDB after
   the step equal to the plain version on the updated weights;
   then the train CLI on a synthetic S2-NAIP tree with a tile_weights
   JSON, as shipped (bfloat16, batch 32): 4 iterations with a checkpoint
   and a validation at 4 and at the end, then --auto_resume to 6, then 2
   float32 iterations. Gates: losses finite, net_g/net_d .pth and the
   .state written, the resume continuing at 9, rdb launches = 69 x (G
   forwards in training + validation forwards) and backwards = 69 x G
   backwards. Printed with the card's name and power limit: steady-state
   samples/s in both dtypes (batches from the real loader), the host's
   wait on the loader, the step split by CUDA events, peak memory, model
   FLOPs a step (counted on the CPU step) against the bf16 dense peak, and
   last a torch.profiler window of 2 bf16 steps (idle share, top kernels).
9. the other trainer families at full width, as shipped, on synthetic trees
   (the OSM tree with an osm_chips_to_masks.json of 1-4 boxes a chip, some
   degenerate): ops/ssim.ssim_loss on the card under matmul_precision
   default against the CPU on near-constant images (finite, within 1e-6);
   one float32 step (batch 2, TF32 off) of osm_obj_esrgan,
   ssimloss_esrgan_s2naip_urban, srcnn_ and highresnet_s2naip_urban on the
   card against the CPU (the same boxes; the L2 dropout masks shared):
   losses within 1e-4 relative, gradients within 1e-3 relative L2 a
   network (and 1e-2 per tensor for the GAN trainers); then the train CLI:
   osm_obj_esrgan (bf16, batch 32) 4 iterations + validations at 4 and the
   end + checkpoint, --auto_resume to 6; ssimloss_ (bf16) 4 iterations,
   l_g_ssim finite at every step; srcnn_/highresnet_ (f32, batch 32) 8
   iterations + validations + checkpoint. Gates as phase 8: rdb launches =
   69 x (G forwards in training + validation forwards), backwards = 69 x G
   backwards (0 on the L2 paths, which run no RDB). Printed with the card's
   name and power limit: steady-state samples/s, the step split by CUDA
   events (the GAN trainers), peak memory, and a 2-step profiler window
   each (idle share, top kernels).
10. the ESRGAN trainer with the CLIP loss, options/cliploss_esrgan_s2naip_urban.yml
   as shipped (bf16, batch 32, G 23 blocks, the ViT-B-16-SigLIP-256 tower:
   12 layers, width 768, 256 tokens, MAP head), on phase 9's tree: one
   float32 step (batch 2, TF32 off) card vs CPU at full width with the
   gates of phase 9; the train CLI for 4 iterations + validations at 4
   and the end + checkpoint, then --auto_resume to 6. Gates: rdb launches
   = 69 x (G forwards in training + validation forwards), backwards = 69 x
   G backwards, l_clip_sim finite and positive in every metrics.jsonl row.
   Printed: the CLIP term on its own (resize + two tower forwards + the
   output's backward, CUDA events, counted FLOPs, peak memory) and
   l_clip_sim of two images card vs CPU (TF32 off: gate 1e-4 relative; as
   shipped, TF32 allowed: printed), the
   steady-state samples/s with the step split by CUDA events (g_clip is
   the term's forward) and peak memory, in turns with the ESRGAN step
   without the term (esrgan, cliploss, cliploss, esrgan), and a 2-step
   profiler window.
11. export and the serving daemon (satlas_sr_tpu_torch.export, .serve) on
   options/infer_example.yml at full width with phase 3's seeded weights,
   in float32 as shipped and in bfloat16 by compute_dtype: the kernel at
   the serving bucket's [8, 32, 32, 64] against its plain version with
   phase 2's tolerances, graph-timed beside cuDNN's five convs and the
   bound; what the satlas_sr_torch::rdb op costs the host (a bf16 call at
   [1, 32, 32, 64] and the bf16 forward at batch 64, through the op and
   straight to the kernel's launch, in turns: op_overhead);
   export_artifact(buckets=[8], check=True) (bit-exact on the card
   at batch 64 and bucket 8; seconds and MB printed) and a second artifact
   of other seeded weights; build_server in-process on port 0 with the
   live engine, then with the artifact: SERVE_REQUESTS from a closed loop
   of SERVE_CLIENTS keep-alive clients, then a serial client (fill 1, raw
   answers); then /admin/reload to the second artifact under that load.
   Gates: every answer 200 and within 1 level on <= 0.1% of values of the
   engine's output for its formatted input (the count bit-equal to the
   engine at batch 64 and at bucket 8 printed); after the reload every
   request sent after the swap on the new weights, no 5xx, generation 1;
   rdb launches = 69 x (warm-up + dispatched batches) for every server,
   the artifact-backed ones included (their programs launch the kernel).
   Printed with the card's name and power limit: requests/s at saturation,
   p50/p95 under both loads, mean fill, batches by bucket, peak memory and
   the device's idle share over a profiler window at saturation.
12. the arch ops and the run tooling (phase_tools): DCNv2Pack (nf 64,
   random offsets and mask) and flow_warp on x [4, 64, 64, 64] in float32
   with TF32 off, forward and input gradient on the card within 1e-4 of
   their max of the port's CPU run, timed; the kernel at acceptance's
   [4, 32, 32, 64] against its plain version with phase 2's tolerances,
   graph-timed beside cuDNN's five convs and the bound; `acceptance
   --no-download` on phase 3's seeded esrgan_8S2 .pth and a synthetic
   S2-NAIP tree of 16 chips at its defaults (batch 4, fwd-tol 1e-4, psnr-tol
   0.05 dB): exit 0 and pass, or else exit 2 with the forward stage the only
   failure and its max|d| within phase 3's generator bound 1e-3, printed
   with where it comes from (kernel, plain trunk, the oracle on the card and
   on the CPU) as a finding, and then a second run at --fwd-tol 1e-3; the
   run that passes: the CLIP leg skipped (no pretrained tower), rdb launches
   = 69 x the forwards of the port's generator and engines, counted by
   dtype and batch; `profile` on infer_example.yml (float32 as
   shipped, bfloat16 by compute_dtype) and esrgan_s2naip_urban.yml (the bf16
   train step), 2 steps each: the route's RDB kernel named in the summary
   at 5 x 69 launches a step; `warmup` on both configs twice in one process
   (the second finds the kernel built); `doctor --device cuda` (exit 0, the
   card named, the native codec, the kernel build ok); `ckpt` on the .pth
   and on phase 8's .state (exit 0) and on a copy with one byte flipped
   (exit 1); `scan_data --strict` on the tree after two more chips are made
   bad (the report counts exactly the bad chips, exit 1).
13. gradient accumulation, remat, tune, the JAX .msgpack weights and the
   host tools (phase_accum_tools), at full width on phase 8's tree: the RDB
   under autograd at the micro-batch shapes [4|8|16, 32, 32, 64] as phase 8
   checks [32, ...]; one f32 step (TF32 off, GAN weight 0) of
   accum_steps 2 x batch 16 against one native batch-32 step on the same
   32 rows (G params and EMA within rtol 1e-4, atol 2e-5); the train CLI as
   users run accumulation (bf16 as shipped, accum_steps 8 x batch 4, 4
   iterations + checkpoint with net_{g,d}_4.msgpack, --auto_resume to 6;
   rdb launches and backwards = 69 x 8 an iteration), its steady-state
   samples/s, split and peak memory; MIGRATION.md's recipe (batch 32 x
   accum_steps 8, global batch 256) on a tree of 272 chips, two
   iterations; one bf16 batch-32 step with remat False, 'block', 'rdb' and
   False again (cuDNN deterministic): losses and G gradients bit-equal to
   False, launches 69 / 138 / 138 / 69 a step, peak memory; `tune
   --effective_batch 32 --batches 8,16,32 --remat false,rdb --iters 2
   --trials 1` on esrgan_s2naip_urban.yml (every candidate ok; table,
   recommendation, JSON); phase 3's seeded weights as a JAX-layout
   net_g_1.msgpack through `infer` (infer_example.yml) on 64 chips, every
   sr.png byte-equal to the .pth's, then a flipped byte: `ckpt` exit 1
   with "crc mismatch" and loading refused; `prepare chip` of seeded S2
   (two revisits) and NAIP rasters and one batch of the result through the
   port's loader; the seeded VGG19 and LPIPS-VGG16 towers as .pth through
   `tower_dryrun` on the card.
14. data parallelism across processes and the DCP checkpoints
   (phase_multi), at full width on phase 8's tree and phase 3's weights.
   The card machine has one card, so: (0) two runs of the train CLI as
   shipped (bf16, batch 32, 2 iterations) WITHOUT torch's deterministic
   algorithms, cuDNN's deterministic flag on: losses of every iteration and
   net_g/net_d_latest.pth bit-equal (the U-Net D's bilinear x2 is shifted
   sums, with no atomics in its backward); a third run with cuDNN's
   defaults against the first, printed as a record; (1) the train CLI as
   shipped under torch's deterministic algorithms (gates 1 and 5 keep
   them) as torchrun's rank 0 of 1
   over NCCL (--launcher pytorch, torchrun's variables set here) against
   the same run without a launcher: losses of every iteration and
   net_g/net_d_latest.pth bit-equal, rdb launches = 69 x iterations;
   (2) two gloo ranks on the one card (NCCL refuses two ranks on one
   device; each rank initialises its group itself, started as a fresh
   interpreter with its own deadline), each on 16 of the 32 rows of one
   f32 step (TF32 off, GAN term on), against one process at batch 32:
   replicas bit-equal (G, D, u/v, EMA, gradients), gradients within 1e-4
   of each tensor's max, params above the gradient noise floor within
   rtol 1e-4 / atol 2e-5 and the rest within Adam's 2 lr, EMA and u/v
   within rtol 1e-4 / atol 2e-5 (accum_equivalence's bar); the step's ms,
   samples/s and each network's gradient all_reduce ms (CUDA events),
   printed as two processes sharing one card, not a scaling figure;
   (3) infer --launcher pytorch on the two ranks over phase 3's 128 chips:
   every file byte-equal to one process's run, each written by exactly
   one rank, the manifest by rank 0 alone, launches 69 x each rank's
   batches; (4) test --launcher pytorch on the two ranks (16 chips, bf16
   batch 1, psnr/ssim/cpsnr): metrics within 1e-6 dB / 1e-8 of one
   process's, each rank's launches 69 x its own chips and pad;
   (5) checkpoint_backend orbax (torch.distributed.checkpoint): 1
   iteration and a save, --auto_resume to 2, bit-equal to (1)'s
   uninterrupted run, `ckpt` ok on the root; then the blocking ms of
   async_save, wait()'s ms and the MB on disk beside the native .state's.
15. the 'space' row sharding of whole-tile inference (phase_space), at
   full width on phase 3's weights and phase 4's tiles: four gloo ranks
   on the one card (each makes its own group, a fresh interpreter with its
   own deadline, the kernel built once before they start), each running
   `infer_grid --launcher pytorch` on options/infer_grid_whole_tile.yml as
   shipped (bf16, matmul_precision default) with spatial_shards 4 over two
   tiles, then in float32 with TF32 off (matmul_precision highest) over
   one; each rank super-resolves its 128 rows of a tile (five halo rows
   from each neighbour around every RDB launch, one around every head
   conv). Against phase 4's one-process runs on the same tiles:
   stitched_sr.png within 1 level on <= 0.1% of values (the count of
   values apart printed), stitched_s2.png byte-equal, each file written
   once, by rank 0 (space index 0), and rdb launches = 69 x tiles on each
   rank. Printed, as ranks sharing one card through gloo (not a scaling
   figure): each rank's forward ms, the halo exchanges' ms a forward by
   host clock and CUDA events, the bytes sent a forward, measured and
   computed from the shapes (they must agree), peak memory; then the
   kernel at the band shapes [1, 133, 512, 64] (edge) and [1, 138, 512,
   64] (interior) in both dtypes against its plain version with phase 2's
   tolerances, graph-timed beside cuDNN's five convs.
16. the train step on a dp x sp layout (phase_space_train): four gloo
   ranks on the one card (fresh interpreters, each making its own group,
   with a deadline). (a) esrgan_s2naip_urban.yml at full width in float32
   with TF32 off at dp 2 x sp 2, 8 rows a data group (the batch cut from
   32), one step against one process at batch 16 on the same 16 rows;
   (c) the same for srcnn_s2naip_urban.yml (full width, dropout on: the
   masks drawn for the whole batch from one seed on each side) and
   osm_obj_esrgan.yml (each data group draws its own chips' boxes, as the
   one-process reference is handed them; the boxes crossing the band edge
   counted). Gates (space_parity_check): replicas bit-equal, losses
   within 1e-4 relative, each network's gradients within 1e-4 relative L2
   and every tensor within 1e-3 of its max, the tensors beyond phase 14's
   1e-4 counted (LeakyReLU kinks: a band's convs run at other shapes; D's
   last bias, one cancelling sum, against the float64 sum of its terms
   within 1e-3), params above the gradient noise floor within rtol 1e-4 /
   atol 2e-5 and the rest within Adam's 2 lr, EMA and u/v; rdb launches
   and backwards 69 a step on each rank (0 for SRCNN).
   (b) the train CLI --launcher pytorch as shipped (bf16, matmul_precision
   default) at dp 1 x sp 4, batch_size_per_gpu 8 (32 rows a data group),
   2 iterations on a synthetic tree of 40 chips, then validation on bands
   (8 chips) and the checkpoint: logs of every iteration bit-equal on the
   four ranks and finite; per rank the step's ms, the halo exchanges' count,
   host and CUDA-event ms forward and backward, and the bytes sent, which
   must equal space_train_bytes' count from the shapes; rdb launches = 69 x
   (steps + validation forwards) and backwards = 69 x steps; peak memory
   beside phase 8's one-process 3.56 GB. Then the kernel at the band train
   shapes, forward and backward against autograd of its plain version
   (rdb_train_check): bf16 [32, 13|18, 32, 64] (edge and interior bands at
   sp 4) and f32 [8, 21, 32, 64] (sp 2), and at validation's [1, 13|18, 32,
   64] (phase_kernels_at). Printed as ranks sharing one card through gloo,
   not a scaling figure.
17. the port's tooling modules on the card (phase_evidence), each through
   its own entry point. (a) `train_evidence`'s ESRGAN leg: the JAX
   protocol's learnable corpus (48 train / 8 val chips from RandomState(0)),
   the production recipe (bf16, batch 32, nf 64, 23 blocks, VGG19, U-Net SN
   D), 300 iterations, SIGTERM once metrics.jsonl reaches 120 and
   --auto_resume to 300, the two train processes started through
   `counting_command` (the train CLI's main, its rdb LAUNCHES, BACKWARDS and
   wall seconds written at exit). Gates: resumed_ok; the pixel loss fell
   20%; the D-loss bounds finite and within 50; the trained generator's val
   PSNR (each validation iteration's net_g_{iter}.pth `params`, run as the
   trainer's validation runs it: `checkpoint_val_psnrs`) rose >= 0.05 dB
   pointwise or by fit (`_psnr_gate`); the EMA generator replayed from the
   same checkpoints within 0.01 dB of the trainer's val rows; across the two
   processes backwards = 69 x iterations trained and launches = 69 x
   (iterations trained + validation forwards), the iterations from each
   process's log (its resume and stop lines) and the validation forwards
   from metrics.jsonl's rows x 8 chips. The protocol's own val-PSNR verdict
   (the EMA generator's, decay 0.999) is printed, not gated: at 300
   iterations the EMA has moved ~15% of the way from its init, whose
   outputs lie mostly outside [0, 1], so its val PSNR sits near the
   level of a clipped output (5.7-5.9 dB in the port's run, 5.4-5.6 in
   the JAX record) and whether it rises there depends on the init draw
   (the port's seed 0: -0.212 dB; the JAX record's: +0.133 dB); at the
   module's default 1200 iterations the same run rises +3.739 dB (PERF.md
   section 5). Printed beside: the JAX record's rise (TRAIN_EVIDENCE_r05.json,
   a TPU run, never gated), each process's wall seconds and the steady
   seconds a step from the log. (b) `dtype_train_equiv --family l2 --iters 300` on the same
   corpus (HighResNet hidden 128, f32 and bf16, no preemption). Gates: both
   runs complete with finite losses, and the f32 run's val PSNR passes
   `_psnr_gate` at 0.05 dB; the bf16-vs-f32 final val-PSNR delta against the
   module's 0.05 dB bar, the speedup and the module's exit code (1 when the
   delta is over the bar) are printed, not gated. (c) `band_order_search` at
   options/zoo/infer_esrgan_10m.yml's widths (num_in_ch 32 = 8 frames x
   (tci + b08), nf 64, 23 blocks, g 32, seeded weights as a reference .pth)
   over 16 chips with bands tci, b08, b05 and b06, each NAIP the plain
   version's SR of the true stacking on the CPU moved by a seeded -2..2
   levels (so every PSNR is finite), searched on the card and on the CPU.
   Gates: both exit 0, the true order wins by >= 3 dB, every candidate's
   card PSNR within 0.01 dB of the CPU's, rdb launches = 69 x candidates;
   then the kernel at the search's [16, 32, 32, 64] against its plain
   version with phase 2's tolerances, timed. (d) `convert_checkpoint`
   from_pth then to_pth on the card for phase 3's esrgan_8S2 .pth and phase
   8's net_d .pth: every tensor of the round trip bit-equal to the
   original; infer_example.yml on 64 chips from the .pth and from the
   converted .msgpack, every sr.png byte-equal, 69 launches each.
18. one JSON line of kernel records, the card line, and the result line.
Each phase's seconds are printed as it ends.

Exits non-zero, printing no result, when CUDA is not available or the port
is not beside this script. Everything is made from --seed.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

NF, G, BATCH, HW = 64, 32, 64, 32
TILE = 512  # a whole 16x16-chunk S2 tile
REPO = os.path.dirname(os.path.abspath(__file__))
N_CHIPS, N_FRAMES, N_LR = 128, 12, 8
NUM_BLOCK, IN_CH = 23, 24
RDBS_PER_FORWARD = NUM_BLOCK * 3
# H100 SXM, dense: bf16 and TF32 tensor cores; float32 runs as three TF32
# products per f32 product. FP32_FMA_PEAK is the CUDA cores' f32 rate.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12}
PRODUCTS = {torch.bfloat16: 1, torch.float32: 3}
FP32_FMA_PEAK = 67e12
PEAK_BYTES = 3.35e12
# steady-state run_inference img/s when PNGs went through PIL (this script on an
# NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md), printed beside the codec's rate
PIL_E2E = {"float32": 155.05, "bfloat16": 177.91}
TRAIN_BATCH, TRAIN_ITERS, RESUME_ITERS, F32_ITERS = 32, 4, 2, 2
N_TRAIN_CHIPS, N_VAL_CHIPS, RATE_STEPS, PROFILE_STEPS = 96, 8, 3, 2
TEST_CHIPS = 16  # phase 7's tree
TRAIN_BF16_BOUND = 5e-2  # bf16 RDB gradients, kernel route against cuDNN autograd
# the shipped towers: CLIPScore's (test.metrics) and the CLIP loss's (clip_opt)
SO400M, SIGLIP = "siglip-ViT-SO400M-14", "ViT-B-16-SigLIP-256"
N_TOWER_CHECK = 2  # chips whose tower metrics are held card against CPU


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


@contextlib.contextmanager
def tf32_off():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fn, iters: int = 20, reps: int = 10) -> float:
    """Mean device time of fn() with the host out of the way: `iters` calls
    captured in one CUDA graph, replayed `reps` times, by CUDA events. A
    Python loop of calls times the host's issue rate wherever that exceeds
    the device time (at batch 1, and for bf16 at batch 64 on a slow host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * iters)


def rdb_bound_ms(dtype: torch.dtype, b: int, h: int = HW, w: int = HW):
    """Least time for one RDB call on x [b, h, w, NF]: each input and output
    moved once, or the route's tensor-core FLOPs at the card's peak for them
    (three TF32 products per f32 FLOP), whichever is larger. Also returns
    the f32 FLOPs."""
    elt = torch.tensor([], dtype=dtype).element_size()
    macs_per_px = sum((NF + k * G) * (G if k < 4 else NF) * 9 for k in range(5))
    flops = 2 * b * h * w * macs_per_px
    nbytes = 2 * b * h * w * NF * elt + macs_per_px * elt + (4 * G + NF) * 4
    t_ops, t_bytes = PRODUCTS[dtype] * flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def allowance_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| as a share of the f32 check's allowance
    1e-4 + 1e-4 |want| (torch.allclose passes at <= 1)."""
    return ((got - want).abs() / (1e-4 + 1e-4 * want.abs())).max().item()


def bf16_branch_err(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor) -> float:
    """Error of a bf16 RDB output against its f32 reference, relative to the
    conv branch: max(|got - want| - 2^-8 |want|, 0) / max |want - x|.

    2^-8 |want| covers rounding the output to bf16 (at most 2^-9 relative),
    which on its own reaches ~1% of the branch where |x| is large. A kernel
    that returned x, or dropped a few input channels of one conv, reads
    0.09 to 1 with the weights of phase_kernels; a right one ~1e-3.
    """
    excess = ((got - want).abs() - 2.0 ** -8 * want.abs()).clamp(min=0).max()
    return (excess / (want - x).abs().max()).item()


def phase_kernels(seed: int) -> dict:
    from satlas_sr_tpu_torch.ops.cuda.rdb import pack_weights, rdb, rdb_reference

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(BATCH, HW, HW, NF, generator=gen).to(dev)
    kernels, biases = [], []
    for k in range(5):
        cin, cout = NF + k * G, (G if k < 4 else NF)
        kernels.append((torch.randn(cout, cin, 3, 3, generator=gen) * math.sqrt(2 / (9 * cin))).to(dev))
        biases.append((torch.randn(cout, generator=gen) * 0.01).to(dev))
    results = {}
    with torch.no_grad(), tf32_off():
        # float32: three TF32 products in the kernel, TF32 off in the plain version
        packed = pack_weights(kernels, biases, NF, G, torch.float32)
        got = rdb(x, kernels, biases, NF, G, packed=packed)
        want = rdb_reference(x, kernels, biases, NF, G)
        torch.cuda.synchronize()
        err32 = (got - want).abs().max().item()
        share32 = allowance_share(got, want)
        branch = (want - x).abs().max().item()
        ok = torch.allclose(got, want, atol=1e-4, rtol=1e-4)
        print(f"rdb f32: max_abs_err {err32:.3e}, {share32:.3f} of the allowance (atol 1e-4, "
              f"rtol 1e-4; conv branch peak {branch:.3f}, max|ref| {want.abs().max().item():.3f}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("rdb f32 kernel disagrees with the plain version")

        # float32 chain: one RRDB, three kernel calls on each other's outputs
        chain = [[(torch.randn(*k.shape, generator=gen) * math.sqrt(2 / (9 * k.shape[1]))).to(dev)
                  for k in kernels] for _ in range(3)]
        h = x
        for kk in chain:
            h = rdb(h, kk, biases, NF, G, packed=pack_weights(kk, biases, NF, G, torch.float32))
        got_c = h * 0.2 + x
        h = x
        for kk in chain:
            h = rdb_reference(h, kk, biases, NF, G)
        want_c = h * 0.2 + x
        torch.cuda.synchronize()
        err32c = (got_c - want_c).abs().max().item()
        share32c = allowance_share(got_c, want_c)
        ok = torch.allclose(got_c, want_c, atol=1e-4, rtol=1e-4)
        print(f"rrdb f32 chain (3 calls): max_abs_err {err32c:.3e}, {share32c:.3f} of the "
              f"allowance (atol 1e-4, rtol 1e-4) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("rdb f32 kernel chain disagrees with the plain chain")

        # bfloat16: against the plain version in f32 on the same bf16-cast inputs
        xb, kb = x.bfloat16(), [k.bfloat16() for k in kernels]
        packed_b = pack_weights(kb, biases, NF, G, torch.bfloat16)
        got_b = rdb(xb, kb, biases, NF, G, packed=packed_b).float()
        want_b = rdb_reference(xb.float(), [k.float() for k in kb], biases, NF, G)
        torch.cuda.synchronize()
        err16 = (got_b - want_b).abs().max().item()
        rel16 = bf16_branch_err(got_b, want_b, xb.float())
        print(f"rdb bf16: max_abs_err {err16:.3e}, bf16_branch_err {rel16:.3e} (bound 3e-2) "
              f"{'ok' if rel16 <= 3e-2 else 'FAIL'}")
        if not rel16 <= 3e-2:
            raise AssertionError("rdb bf16 kernel disagrees with the plain version")

        # bfloat16 chain: one RRDB, three kernel calls on each other's outputs
        chain = [[(torch.randn(*k.shape, generator=gen) * math.sqrt(2 / (9 * k.shape[1])))
                  .to(dev).bfloat16() for k in kernels] for _ in range(3)]
        h = xb
        for kk in chain:
            h = rdb(h, kk, biases, NF, G, packed=pack_weights(kk, biases, NF, G, torch.bfloat16))
        got_c = (h * 0.2 + xb).float()
        h = xb.float()
        for kk in chain:
            h = rdb_reference(h, [k.float() for k in kk], biases, NF, G)
        want_c = h * 0.2 + xb.float()
        torch.cuda.synchronize()
        relc = bf16_branch_err(got_c, want_c, xb.float())
        print(f"rrdb bf16 chain (3 calls): max_abs_err {(got_c - want_c).abs().max().item():.3e}, "
              f"bf16_branch_err {relc:.3e} (bound 3e-2) {'ok' if relc <= 3e-2 else 'FAIL'}")
        if not relc <= 3e-2:
            raise AssertionError("rdb bf16 kernel chain disagrees with the plain chain")

        checks = {"bf16": dict(max_abs_err=err16, bf16_branch_err=rel16,
                               chain_bf16_branch_err=relc),
                  "f32": dict(max_abs_err=err32, allowance_share=share32,
                              chain_max_abs_err=err32c, chain_allowance_share=share32c)}
        for dtype, xx, kk, pk in ((torch.bfloat16, xb, kb, packed_b),
                                  (torch.float32, x, kernels, packed)):
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            results[name] = dict(**checks[name], **time_rdb(xx, kk, biases, pk))
    return results


def time_rdb(x: torch.Tensor, kernels, biases, packed) -> dict:
    """Times of one RDB call on x (kernel, plain version, cuDNN's five convs
    on ready-made dense-concat inputs, a yardstick the port never calls) and
    its bound; printed and returned. All three are timed inside a CUDA graph
    (time_graph_ms), so that no row times the host; the kernel's time in a
    Python loop of calls stands beside them as `eager_ms`, which the host's
    issue rate sets where it exceeds the device time."""
    import torch.nn.functional as F

    from satlas_sr_tpu_torch.ops.cuda.rdb import rdb, rdb_reference

    dtype, (b, h, w, _) = x.dtype, x.shape
    bb = [bias.to(dtype) for bias in biases]
    feats = [torch.randn(b, NF + k * G, h, w, device=x.device, dtype=dtype)
             .contiguous(memory_format=torch.channels_last) for k in range(5)]
    kcl = [k.contiguous(memory_format=torch.channels_last) for k in kernels]
    lib = lambda: [F.conv2d(feats[k], kcl[k], bb[k], padding=1) for k in range(5)]
    kernel = lambda: rdb(x, kernels, biases, NF, G, packed=packed)
    with torch.no_grad(), tf32_off():
        ms = time_graph_ms(kernel)
        plain_ms = time_graph_ms(lambda: rdb_reference(x, kernels, biases, NF, G))
        library_ms = time_graph_ms(lib)
        extra = {"eager_ms": time_ms(kernel)}
    bound_ms, bound_by, flops = rdb_bound_ms(dtype, b, h, w)
    if dtype == torch.float32:
        extra["fp32_fma_bound_ms"] = 1e3 * flops / FP32_FMA_PEAK
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    shape = f"B={b}" if (h, w) == (HW, HW) else f"x [{b}, {h}, {w}, {NF}]"
    print(f"rdb {name} {shape} (CUDA graph): "
          f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
          f"plain {plain_ms:.4f} ms, cuDNN five convs {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f}%)"
          + "".join(f", {k} {v:.4f} ms ({100 * v / ms:.1f}%)" for k, v in extra.items()))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, **extra)


def phase_kernels_at(seed: int, b: int, hw: int, w: Optional[int] = None) -> dict:
    """The rdb kernel at x [b, hw, w (default hw), 64] in both dtypes against
    its plain version (one call each), then timed: whole-tile mode's
    [1, 512, 512, 64], the test CLI's batch-1 [1, 32, 32, 64] and the row
    bands of a whole tile split over 4 ranks, [1, 133|138, 512, 64]."""
    from satlas_sr_tpu_torch.ops.cuda.rdb import pack_weights, rdb, rdb_reference

    dev = torch.device("cuda")
    w = w or hw
    gen = torch.Generator().manual_seed(seed + b * hw + (w - hw))
    x = torch.randn(b, hw, w, NF, generator=gen).to(dev)
    kernels, biases = [], []
    for k in range(5):
        cin, cout = NF + k * G, (G if k < 4 else NF)
        kernels.append((torch.randn(cout, cin, 3, 3, generator=gen) * math.sqrt(2 / (9 * cin))).to(dev))
        biases.append((torch.randn(cout, generator=gen) * 0.01).to(dev))
    shape = f"x [{b}, {hw}, {w}, {NF}]"
    results = {}
    with torch.no_grad(), tf32_off():
        packed = pack_weights(kernels, biases, NF, G, torch.float32)
        got = rdb(x, kernels, biases, NF, G, packed=packed)
        want = rdb_reference(x, kernels, biases, NF, G)
        torch.cuda.synchronize()
        err32, share32 = (got - want).abs().max().item(), allowance_share(got, want)
        ok = share32 <= 1
        print(f"rdb f32 {shape}: max_abs_err {err32:.3e}, {share32:.3f} of the "
              f"allowance (atol 1e-4, rtol 1e-4) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"rdb f32 kernel disagrees with the plain version at {shape}")
        xb, kb = x.bfloat16(), [k.bfloat16() for k in kernels]
        packed_b = pack_weights(kb, biases, NF, G, torch.bfloat16)
        got_b = rdb(xb, kb, biases, NF, G, packed=packed_b).float()
        want_b = rdb_reference(xb.float(), [k.float() for k in kb], biases, NF, G)
        torch.cuda.synchronize()
        rel16 = bf16_branch_err(got_b, want_b, xb.float())
        err16 = (got_b - want_b).abs().max().item()
        print(f"rdb bf16 {shape}: max_abs_err {err16:.3e}, "
              f"bf16_branch_err {rel16:.3e} (bound 3e-2) {'ok' if rel16 <= 3e-2 else 'FAIL'}")
        if not rel16 <= 3e-2:
            raise AssertionError(f"rdb bf16 kernel disagrees with the plain version at {shape}")
    del got, want, got_b, want_b
    results["f32"] = dict(max_abs_err=err32, allowance_share=share32,
                          **time_rdb(x, kernels, biases, packed))
    results["bf16"] = dict(max_abs_err=err16, bf16_branch_err=rel16,
                           **time_rdb(xb, kb, biases, packed_b))
    return results


def make_tree(root: str, rng: np.random.RandomState, n: int = N_CHIPS) -> None:
    from satlas_sr_tpu_torch.utils.imgio import write_png

    for i in range(n):
        data = (rng.rand(N_FRAMES * 32, 32, 3) * 254 + 1).astype(np.uint8)
        if i % 5 == 0:  # one black frame: the good-first frame policy skips it
            data[32:40] = 0
        write_png(os.path.join(root, f"chip{i:04d}", "tci.png"), data)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


@contextlib.contextmanager
def plain_trunk():
    """Run the trunk through the plain version (a comparison, not the product path)."""
    from satlas_sr_tpu_torch.archs import rrdbnet
    from satlas_sr_tpu_torch.ops.cuda.rdb import rdb_reference

    orig = rrdbnet.rdb
    rrdbnet.rdb = lambda x, k, b, nf, g, packed=None: rdb_reference(x, k, b, nf, g)
    try:
        yield
    finally:
        rrdbnet.rdb = orig


def device_busy(prof):
    """satlas_sr_tpu_torch.profile.device_busy (([(name, us)] of the device
    events, busy us, window us), or None), saying so when the trace holds no
    device time."""
    from satlas_sr_tpu_torch.profile import device_busy as traced

    out = traced(prof)
    if out is None:
        print("profiler: the trace shows no device time on this machine")
    return out


def profile_forwards(model, x: torch.Tensor, fwd_ms: float, n: int = 2, top: int = 8) -> None:
    """One torch.profiler window over n forwards: device kernels by total
    time, and the device's idle share (1 - union of kernel intervals over the
    span of the trace). The profiler slows the host, so the share is also
    given against fwd_ms, the unprofiled forward's time by CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), tf32_off():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                model(x)
            torch.cuda.synchronize()
    traced = device_busy(prof)
    if traced is None:
        return
    kernels, busy, window = traced
    by_name = {}
    for name, us in kernels:
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + us, c + 1)
    total = sum(t for t, _ in by_name.values())
    print(f"profiler, {n} {str(x.dtype)[6:]} forwards of batch {x.shape[0]}: "
          f"window {window / 1e3:.3f} ms, "
          f"device busy {busy / 1e3:.3f} ms, idle share {1 - busy / window:.4f}; against the "
          f"unprofiled forward ({fwd_ms:.3f} ms) {1 - busy / 1e3 / n / fwd_ms:.4f}; "
          f"top device kernels by total time:")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {t / 1e3 / n:9.3f} ms/forward {100 * t / total:5.1f}%  {c // n:4d} launches/forward  "
              f"{name[:90]}")


def phase_main_path(seed: int, work: str, card: str) -> dict:
    from concurrent.futures import ThreadPoolExecutor

    from satlas_sr_tpu_torch.archs import RRDBNet
    from satlas_sr_tpu_torch.infer import run_inference
    from satlas_sr_tpu_torch.inference import InferenceEngine
    from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod
    from satlas_sr_tpu_torch.utils import imgio
    from satlas_sr_tpu_torch.utils.imgio import read_png, write_png
    from satlas_sr_tpu_torch.utils.infer_utils import format_s2naip_batch
    from satlas_sr_tpu_torch.utils.torch_io import load_torch_state_dict, save_torch_state_dict

    net = dict(num_in_ch=IN_CH, num_out_ch=3, num_feat=NF, num_block=NUM_BLOCK, num_grow_ch=G)
    weights = os.path.join(work, "esrgan_8S2_seeded.pth")
    save_torch_state_dict(weights, RRDBNet(scale=4, seed=seed, device="cpu", **net).state_dict(),
                          param_key="params_ema")
    data_dir = os.path.join(work, "sentinel2")
    make_tree(data_dir, np.random.RandomState(seed))
    n_batches = -(-N_CHIPS // BATCH)

    launches, outs = {}, {}
    for dtype in ("float32", "bfloat16"):
        opt = {"data_dir": data_dir, "save_path": os.path.join(work, f"out_{dtype}"),
               "n_lr_images": N_LR, "scale": 4, "batch_size": BATCH, "compute_dtype": dtype,
               "matmul_precision": "highest", "network_g": {"type": "SSR_RRDBNet", **net},
               "path": {"pretrain_network_g": weights, "param_key_g": "params_ema"}}
        rdb_mod.LAUNCHES = 0
        t0 = time.time()
        n = run_inference(opt, device="cuda")
        torch.cuda.synchronize()
        dt = time.time() - t0
        launches[dtype] = rdb_mod.LAUNCHES
        print(f"main path {dtype}: {n} chips in {dt:.3f} s end to end ({n / dt:.2f} img/s, "
              f"first call's packing and PNG IO included); rdb launches {launches[dtype]} "
              f"(expected {RDBS_PER_FORWARD} x {n_batches} batches)")
        if n != N_CHIPS or launches[dtype] != RDBS_PER_FORWARD * n_batches:
            raise AssertionError(f"main path {dtype}: {n} chips, {launches[dtype]} rdb launches")
        outs[dtype] = []
        for i in range(N_CHIPS):
            sr = read_png(os.path.join(opt["save_path"], str(i), "sr.png"))
            if sr.shape != (128, 128, 3) or sr.dtype != np.uint8:
                raise AssertionError(f"{dtype} sr.png {i}: {sr.shape} {sr.dtype}")
            outs[dtype].append(sr)
    p = psnr(np.stack(outs["float32"]), np.stack(outs["bfloat16"]))
    print(f"bf16 vs f32 sr.png PSNR over {N_CHIPS} chips: {p:.2f} dB (floor 30) "
          f"{'ok' if p >= 30 else 'FAIL'}")
    if not p >= 30:
        raise AssertionError("bf16 output too far from f32")

    # the f32 generator through the kernel against the plain trunk, one batch
    state = load_torch_state_dict(weights)
    pngs = sorted(os.path.join(data_dir, d, "tci.png") for d in os.listdir(data_dir))
    inputs, _ = format_s2naip_batch(pngs[:BATCH], N_LR, seed=0)
    model = RRDBNet(scale=4, device="cpu", **net)
    model.load_state_dict(state)
    model = model.cuda().eval()
    x = torch.from_numpy(inputs).cuda().float() / 255.0
    with torch.no_grad(), tf32_off():
        y_kernel = model(x)
        with plain_trunk():
            y_plain = model(x)
        torch.cuda.synchronize()
    err = (y_kernel - y_plain).abs().max().item()
    finite = bool(torch.isfinite(y_kernel).all())
    print(f"generator f32, kernel vs plain trunk, one batch of {BATCH}: max_abs_err {err:.3e} "
          f"(atol 1e-3), finite {finite} {'ok' if err <= 1e-3 and finite else 'FAIL'}")
    if not (err <= 1e-3 and finite):
        raise AssertionError("generator through the kernel disagrees with the plain trunk")

    # steady-state engine throughput (device-bound part of the main path)
    batches = [inputs] * 8
    profiles = []
    for dtype in (torch.float32, torch.bfloat16):
        m = RRDBNet(scale=4, device="cpu", dtype=dtype, **net)
        engine = InferenceEngine(m, state, batch_size=BATCH, device="cuda")
        engine.run(inputs)  # warm-up: packing, cuDNN plans
        t0 = time.time()
        n = sum(len(y) for y in engine.run_many(batches))
        dt = time.time() - t0
        xd = torch.randn(BATCH, HW, HW, NF, device="cuda", dtype=dtype)
        xc = x.to(dtype)
        with torch.no_grad(), tf32_off():
            fwd_ms = time_ms(lambda: engine.model(xc), iters=5, warmup=1)
            trunk_ms = time_ms(lambda: [b(xd) for b in engine.model.body], iters=5, warmup=1)
        print(f"engine {str(dtype)[6:]}: {n / dt:.2f} img/s, {n / dt / 16:.3f} tiles/s "
              f"(512x512 tile = 16 chips) over {len(batches)} batches of {BATCH}; "
              f"forward {fwd_ms:.3f} ms, trunk {trunk_ms:.3f} ms ({100 * trunk_ms / fwd_ms:.1f}%) "
              f"[{card}]")
        profiles.append((engine.model, xc, fwd_ms))
    # after both engines' timings: a profiler session may slow later launches
    for model_d, x_d, fwd_d in profiles:
        profile_forwards(model_d, x_d, fwd_d)

    # host side of the main path, at the thread counts run_inference uses
    t0 = time.time()
    format_s2naip_batch(pngs, N_LR, seed=0)
    dec = len(pngs) / (time.time() - t0)
    workers = max(2, os.cpu_count() or 1)
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(lambda i: write_png(os.path.join(work, "enc", f"{i}.png"), outs["float32"][i]),
                      range(N_CHIPS)))
    enc = N_CHIPS / (time.time() - t0)
    print(f"host: PNG decode + frame formatting {dec:.2f} img/s ({imgio.codec()} codec), "
          f"sr.png encode {enc:.2f} img/s ({workers} threads), {os.cpu_count()} cores")
    return launches



def levels_apart(got: np.ndarray, want: np.ndarray):
    """(largest |got - want| in uint8 levels, share of values more than 1
    level apart, share of values apart at all)."""
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(d.max()), float((d > 1).mean()), float((d > 0).mean())


def gate_levels(what: str, got: np.ndarray, want: np.ndarray) -> None:
    """Fails unless got and want are within 1 level on <= 0.1% of values."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shapes {got.shape} and {want.shape}")
    top, beyond, apart = levels_apart(got, want)
    ok = top <= 1 and apart <= 1e-3
    print(f"{what}: largest difference {top} levels, {apart:.6f} of values apart "
          f"(gate: <= 1 level on <= 0.1%) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: outside 1 level on 0.1% of values")


def load_config(name: str, **overrides) -> dict:
    """A shipped config from options/ with overrides (paths, weights)."""
    from satlas_sr_tpu_torch.utils.options import yaml_load

    opt = yaml_load(os.path.join(REPO, "options", name))
    path = dict(opt.get("path") or {})
    if "weights" in overrides:
        path["pretrain_network_g"] = overrides.pop("weights")
    return {**opt, **overrides, "path": path}


def phase_grid(seed: int, work: str, weights: str) -> dict:
    """infer_grid's three modes on one tile as the shipped configs set them."""
    from satlas_sr_tpu_torch.infer_grid import run_grid
    from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod
    from satlas_sr_tpu_torch.utils.imgio import read_png, write_png

    # data: tile_a alone; data2: tile_a and tile_b (the second tile's time
    # is the difference of the two runs, which cancels the set-up)
    data, data2 = os.path.join(work, "grid", "data"), os.path.join(work, "grid", "data2")
    rng = np.random.RandomState(seed + 2)
    for tile in ("tile_a", "tile_b"):
        for i in range(16):
            for j in range(16):
                chunk = (rng.rand(N_LR * 32, 32, 3) * 254 + 1).astype(np.uint8)
                if (i * 16 + j) % 7 == 0:
                    chunk[32:40] = 0  # a black frame
                for root in ((data, data2) if tile == "tile_a" else (data2,)):
                    write_png(os.path.join(root, tile, f"{i}_{j}.png"), chunk)

    def run(name: str, config: str, forwards: int, **overrides):
        opt = load_config(config, data_dir=data, save_path=os.path.join(work, "grid", name),
                          weights=weights, **overrides)
        secs = []
        # the first run builds the model and plans cuDNN; the launches are its
        for rep, src in enumerate((data, data, data2)):
            rdb_mod.LAUNCHES = 0
            t0 = time.time()
            n = run_grid({**opt, "data_dir": src, "save_path": opt["save_path"] + f"_{rep}"},
                         device="cuda")
            torch.cuda.synchronize()
            secs.append(time.time() - t0)
            if rep == 0:
                launches, n_one = rdb_mod.LAUNCHES, n
        out = opt["save_path"] + "_0"
        sr = read_png(os.path.join(out, "tile_a", "stitched_sr.png"))
        s2 = read_png(os.path.join(out, "tile_a", "stitched_s2.png"))
        ok = (launches == RDBS_PER_FORWARD * forwards and sr.shape == (2048, 2048, 3)
              and s2.shape == (512, 512, 3) and n_one == (256 if name == "chunked" else 1)
              and n == 2 * n_one)
        print(f"grid {name} ({config}, {opt.get('compute_dtype')}, batch {opt.get('batch_size')}): "
              f"one tile {secs[0]:.3f} s first run, {secs[1]:.3f} s second (set-up included), "
              f"two tiles {secs[2]:.3f} s, so {secs[2] - secs[1]:.3f} s per further tile; "
              f"rdb launches {launches} (expected {RDBS_PER_FORWARD} x {forwards} forwards); "
              f"stitched SR {sr.shape}, S2 {s2.shape} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"grid {name}: {n} outputs, {launches} launches, {sr.shape}, {s2.shape}")
        return sr, launches

    launches = {}
    _, launches["chunked"] = run("chunked", "infer_grid_example.yml", 1)
    whole, launches["whole_tile"] = run("whole_tile", "infer_grid_whole_tile.yml", 1)
    halo, launches["halo"] = run("halo", "infer_grid_halo.yml", -(-625 // 256))
    top, beyond, apart = levels_apart(halo, whole)
    print(f"grid halo vs whole-tile (bfloat16, seeded weights; a record, not a gate): "
          f"largest difference {top} levels, {beyond:.6f} of values beyond 1 level, "
          f"{apart:.6f} apart")

    # whole tile in float32 with TF32 off: the kernel against the plain trunk
    f32, launches["whole_tile_f32"] = run("whole_tile_f32", "infer_grid_whole_tile.yml", 1,
                                          compute_dtype="float32", matmul_precision="highest")
    opt = load_config("infer_grid_whole_tile.yml", data_dir=data, weights=weights,
                      save_path=os.path.join(work, "grid", "whole_tile_f32_plain"),
                      compute_dtype="float32", matmul_precision="highest")
    with plain_trunk():
        run_grid(opt, device="cuda")
    plain = read_png(os.path.join(opt["save_path"], "tile_a", "stitched_sr.png"))
    gate_levels("grid whole-tile f32, kernel vs plain trunk", f32, plain)
    return launches


def write_band_chips(root: str, rng: np.random.RandomState, n: int, bands) -> None:
    from satlas_sr_tpu_torch.utils.imgio import write_png

    for c in range(n):
        d = os.path.join(root, f"chip{c:04d}")
        tci = (rng.rand(N_FRAMES * 32, 32, 3) * 254 + 1).astype(np.uint8)
        if c % 3 == 0:
            tci[32:40] = 0
        write_png(os.path.join(d, "tci.png"), tci)
        for band in bands:
            if band != "tci":
                write_png(os.path.join(d, f"{band}.png"),
                          (rng.rand(N_FRAMES * 32, 32, 1) * 254 + 1).astype(np.uint8))


def phase_zoo(seed: int, work: str) -> dict:
    """SRCNN, HighResNet and esrgan_10m through the infer CLI, card vs CPU."""
    import yaml

    from satlas_sr_tpu_torch.infer import main as infer_main
    from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod
    from satlas_sr_tpu_torch.utils.imgio import read_png
    from satlas_sr_tpu_torch.utils.model_utils import build_network
    from satlas_sr_tpu_torch.utils.torch_io import save_torch_state_dict

    n = 8
    launches = {}
    for config in ("zoo/infer_srcnn.yml", "zoo/infer_highresnet.yml", "zoo/infer_esrgan_10m.yml"):
        name = os.path.basename(config)[len("infer_"):-len(".yml")]
        root = os.path.join(work, "zoo", name)
        opt = load_config(config)
        data = os.path.join(root, "data")
        rng = np.random.RandomState(seed + 3)
        if opt.get("s2_bands"):
            write_band_chips(data, rng, n, opt["s2_bands"])
        else:
            make_tree(data, rng, n)
        weights = os.path.join(root, "net_g.pth")
        save_torch_state_dict(weights, build_network(opt, device="cpu").state_dict(), "params_ema")
        outs, secs = {}, []
        for run, device, extra in (("cuda", "cuda", {}), ("cuda_again", "cuda", {}),
                                   ("cpu", "cpu", {"batch_size": n})):
            o = load_config(config, data_dir=data, save_path=os.path.join(root, run), weights=weights,
                            **extra)
            path = os.path.join(root, f"{run}.yml")
            with open(path, "w") as f:
                yaml.safe_dump(o, f)
            rdb_mod.LAUNCHES = 0
            t0 = time.time()
            infer_main(["-opt", path, "--device", device])
            if device == "cuda":
                torch.cuda.synchronize()
                secs.append(time.time() - t0)
                if run == "cuda":
                    launches[name] = rdb_mod.LAUNCHES
            outs[run] = np.stack([read_png(os.path.join(o["save_path"], str(i), "sr.png"))
                                  for i in range(n)])
        rrdb = opt["network_g"]["type"] == "SSR_RRDBNet"
        expected = RDBS_PER_FORWARD if rrdb else 0
        ok = launches[name] == expected and outs["cuda"].shape == (n, 128, 128, 3)
        print(f"zoo {name} ({config}, {opt['compute_dtype']}, batch {opt['batch_size']}): "
              f"{n / secs[1]:.2f} img/s end to end on {n} chips (second run; first {n / secs[0]:.2f}), "
              f"rdb launches {launches[name]} (expected {expected}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"zoo {name}: {launches[name]} launches, {outs['cuda'].shape}")
        gate_levels(f"zoo {name}, card vs the port's CPU run", outs["cuda"], outs["cpu"])
    return launches


def phase_codec(seed: int, work: str, weights: str, card: str) -> str:
    """Which PNG codec ran, its decode rate beside PIL's, and steady-state
    end-to-end run_inference img/s in both dtypes."""
    from concurrent.futures import ThreadPoolExecutor

    from satlas_sr_tpu_torch.infer import run_inference
    from satlas_sr_tpu_torch.utils import imgio, native_png

    codec = imgio.codec()
    if codec != "native":
        if native_png.zlib_present():
            native_png.lib()  # zlib is here, so the codec must build: raises with g++'s output
        print("codec: pil (zlib's header is absent on this machine; the native codec cannot build)")
    else:
        print(f"codec: native ({os.path.relpath(native_png.loaded_path(), REPO)})")
        encode_sizes(os.path.join(work, "grid", "whole_tile_0", "tile_a", "stitched_sr.png"))

    small, big = os.path.join(work, "e2e", "small"), os.path.join(work, "e2e", "big")
    make_tree(small, np.random.RandomState(seed + 4), 256)
    make_tree(big, np.random.RandomState(seed + 5), 1280)
    files = sorted(os.path.join(big, d, "tci.png") for d in os.listdir(big))
    threads = min(8, max(2, (os.cpu_count() or 1) * 2))
    rates = {}
    for name in ("native", "pil"):
        if name == "native" and codec != "native":
            continue
        t0 = time.time()
        if name == "native":
            decoded = native_png.read_png_many(files, n_threads=threads)
        else:
            with ThreadPoolExecutor(max_workers=threads) as pool:
                decoded = list(pool.map(imgio._pil_decode, files))
        rates[name] = len(files) / (time.time() - t0)
        if any(d is None or d.shape != (N_FRAMES * 32, 32, 3) for d in decoded):
            raise AssertionError(f"{name} decode of the corpus failed")
    print("codec decode of the same 1280 files [" + str(N_FRAMES * 32) + "x32x3], "
          f"{threads} threads: " + ", ".join(f"{k} {v:.2f} img/s" for k, v in rates.items()))

    net = dict(num_in_ch=IN_CH, num_out_ch=3, num_feat=NF, num_block=NUM_BLOCK, num_grow_ch=G)
    for dtype in ("float32", "bfloat16"):
        times = {}
        for name, data in (("small", small), ("big", big)):
            opt = {"data_dir": data, "save_path": os.path.join(work, "e2e", f"out_{name}_{dtype}"),
                   "n_lr_images": N_LR, "scale": 4, "batch_size": BATCH, "compute_dtype": dtype,
                   "matmul_precision": "highest", "network_g": {"type": "SSR_RRDBNet", **net},
                   "path": {"pretrain_network_g": weights, "param_key_g": "params_ema"}}
            t0 = time.time()
            done = run_inference(opt, device="cuda")
            torch.cuda.synchronize()
            times[name] = time.time() - t0
            if done != (256 if name == "small" else 1280):
                raise AssertionError(f"run_inference {dtype} {name}: {done} chips")
        steady = 1024 / (times["big"] - times["small"])
        print(f"run_inference {dtype} end to end ({codec} codec): 256 chips {times['small']:.3f} s, "
              f"1280 chips {times['big']:.3f} s; steady state {steady:.2f} img/s "
              f"({steady / 16:.3f} tiles/s; with PIL: {PIL_E2E[dtype]}) [{card}]")
    print(f"codec: {native_png.interlaced_count()} interlaced files handed to PIL in this run")
    return codec


def encode_sizes(path: str) -> None:
    """The native encoder's file size and time on a 2048x2048 stitched_sr.png
    beside PIL's, at zlib level 1 (the port's) and PIL's default 6."""
    import io

    from PIL import Image

    from satlas_sr_tpu_torch.utils import native_png

    img = native_png.read_png(path)
    t0 = time.perf_counter()
    ours = len(native_png.encode_png_bytes(img, level=1))
    t_ours = time.perf_counter() - t0
    sizes = {}
    for level in (1, 6):
        buf = io.BytesIO()
        t0 = time.perf_counter()
        Image.fromarray(img).save(buf, format="PNG", compress_level=level)
        sizes[level] = (len(buf.getvalue()), time.perf_counter() - t0)
    print(f"codec encode of a {img.shape[0]}x{img.shape[1]}x{img.shape[2]} stitched_sr.png: "
          f"native level 1 {ours} B in {t_ours:.3f} s; PIL level 1 {sizes[1][0]} B in "
          f"{sizes[1][1]:.3f} s (ratio {ours / sizes[1][0]:.4f}); PIL level 6 {sizes[6][0]} B in "
          f"{sizes[6][1]:.3f} s (ratio {ours / sizes[6][0]:.4f})")


def make_s2naip_tree(root: str, rng: np.random.RandomState, n: int) -> dict:
    """A synthetic S2-NAIP tree of n chips: naip/{chip}/{chip}.png 128x128x3
    and sentinel2/{chip}/tci.png of N_FRAMES frames (one black), except a
    few chips with a black NAIP pixel and a few with fewer than N_LR frames,
    which the dataset skips, advancing to a later chip."""
    from satlas_sr_tpu_torch.utils.imgio import write_png

    skipped = {"black_naip": 0, "few_frames": 0}
    for i in range(n):
        chip = f"{1000 + i}_{2000 + i}"
        naip = (rng.rand(128, 128, 3) * 254 + 1).astype(np.uint8)
        frames = N_FRAMES
        if i % 29 == 3:
            naip[rng.randint(128), rng.randint(128)] = 0
            skipped["black_naip"] += 1
        elif i % 31 == 7:
            frames = N_LR - 2
            skipped["few_frames"] += 1
        s2 = (rng.rand(frames * 32, 32, 3) * 254 + 1).astype(np.uint8)
        s2[32 * (i % frames):32 * (i % frames) + 5] = 0  # a black frame
        write_png(os.path.join(root, "naip", chip, f"{chip}.png"), naip)
        write_png(os.path.join(root, "sentinel2", chip, "tci.png"), s2)
    return skipped


class TimingRecords:
    """Collects the `timings` that validation logs (data / forward / metrics /
    writes seconds) from the port's root logger, whose own stdout lines it
    quiets to warnings (this script prints its own summary)."""

    def __init__(self):
        import logging

        from satlas_sr_tpu_torch.utils.logger import get_root_logger

        logger = get_root_logger()
        for h in logger.handlers:
            if isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler):
                h.setLevel(logging.WARNING)
        self.records = []
        handler = logging.Handler()
        handler.emit = lambda r: self.records.append(r.timings) if hasattr(r, "timings") else None
        logger.addHandler(handler)


def phase_test_cli(seed: int, work: str, weights: str, card: str) -> dict:
    """python -m satlas_sr_tpu_torch.test on options/esrgan_s2naip_urban.yml at
    full width on a synthetic S2-NAIP tree, its metrics narrowed to
    psnr/ssim/cpsnr (comparable with the runs of earlier versions): as
    shipped (bfloat16, batch 1), in float32 with TF32 off (batch 1), and in
    float32 at batch 64 with fast_metrics; then the float32 config once on
    the CPU; then as shipped with its metrics in full (LPIPS-VGG16 and
    CLIPScore on siglip-ViT-SO400M-14, on the card). Gates: f32 card metrics
    against the CPU's, f32 visualization PNGs within 1 level on <= 0.1% of
    values of the CPU's, bf16 PNGs >= 30 dB against f32, device-batched
    PSNR/SSIM against the numpy metrics of the same run, rdb launches = 69 x
    forwards, no metric failed on any chip, and the tower metrics of the
    full run's first chips on the card against the CPU (tower_metric_check).
    Then the towers' forwards on their own (tower_times)."""
    import yaml

    from satlas_sr_tpu_torch import test as test_cli
    from satlas_sr_tpu_torch.metrics import calculate_psnr, calculate_ssim
    from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod
    from satlas_sr_tpu_torch.utils.imgio import read_png

    root = os.path.join(work, "test_cli")
    skipped = make_s2naip_tree(os.path.join(root, "data"), np.random.RandomState(seed + 6), TEST_CHIPS)
    opt = load_config("esrgan_s2naip_urban.yml", weights=weights)
    shipped_metrics = opt["test"]["metrics"]
    kept = ("psnr", "ssim", "cpsnr")
    opt["test"] = {**opt["test"], "metrics": {k: v for k, v in opt["test"]["metrics"].items()
                                              if k in kept}}
    opt["test_datasets"]["test"].update(sentinel2_path=os.path.join(root, "data", "sentinel2"),
                                        naip_path=os.path.join(root, "data", "naip"))
    runs = {
        "bf16": ({}, {}),
        "f32": ({"compute_dtype": "float32", "matmul_precision": "highest"}, {}),
        "f32_b64_fast": ({"compute_dtype": "float32", "matmul_precision": "highest"},
                         {"batch_size": BATCH}),
        "cpu_f32": ({"compute_dtype": "float32", "matmul_precision": "highest"},
                    {"batch_size": BATCH}),
        "bf16_full": ({}, {}),
    }
    timings = TimingRecords()
    results, secs, launches, vis = {}, {}, {}, {}
    for name, (top, test_ds) in runs.items():
        o = json.loads(json.dumps({**opt, **top, "name": f"smoke_{name}"}))
        o["test_datasets"]["test"].update(test_ds)
        if name == "f32_b64_fast":
            o["test"]["fast_metrics"] = True
        if name == "bf16_full":
            o["test"]["metrics"] = shipped_metrics
            build_metric_towers(card)
        path = os.path.join(root, f"{name}.yml")
        with open(path, "w") as f:
            yaml.safe_dump(o, f)
        device = "cpu" if name.startswith("cpu") else "cuda"
        rdb_mod.LAUNCHES = 0
        t0 = time.time()
        res = test_cli.test_pipeline(root, ["-opt", path], device=device)["test"]
        if device == "cuda":
            torch.cuda.synchronize()
        secs[name] = time.time() - t0
        launches[name] = rdb_mod.LAUNCHES
        results[name] = res
        split = timings.records[-1]
        forwards = -(-TEST_CHIPS // int(o["test_datasets"]["test"].get("batch_size", 1)))
        expected = RDBS_PER_FORWARD * forwards if device == "cuda" else 0
        # {global index: (sr, gt)} from visualization/test/{index}_{name}[_gt].png
        vis_dir = os.path.join(root, "results", o["name"], "visualization", "test")
        vis[name] = {}
        for f in os.listdir(vis_dir):
            idx = int(f.split("_")[0])
            sr_img, gt_img = vis[name].get(idx, (None, None))
            img = read_png(os.path.join(vis_dir, f))
            vis[name][idx] = (sr_img, img) if f.endswith("_gt.png") else (img, gt_img)
        ok = (launches[name] == expected and split["images"] == TEST_CHIPS
              and sorted(vis[name]) == list(range(TEST_CHIPS))
              and all(a is not None and b is not None for a, b in vis[name].values())
              and all(np.isfinite(v) for v in res.values()) and len(res) == len(o["test"]["metrics"])
              and not split["metric_fail"])
        towers = {k: v for k, v in split["metric_seconds"].items() if k in ("lpips", "clipscore")}
        print(f"test CLI {name} ({o['compute_dtype']}, batch "
              f"{o['test_datasets']['test'].get('batch_size', 1)}, {device}): {TEST_CHIPS} images in "
              f"{secs[name]:.3f} s ({TEST_CHIPS / secs[name]:.2f} img/s, set-up included); split "
              + ", ".join(f"{k} {split[k]:.3f} s" for k in ("data", "forward", "metrics", "writes"))
              + "".join(f"; {k} {1e3 * v / TEST_CHIPS:.3f} ms a chip" for k, v in towers.items())
              + f"; metrics {json.dumps(res)}; metric failures {json.dumps(split['metric_fail'])}"
              f"; rdb launches {launches[name]} (expected {expected})"
              f" {'ok' if ok else 'FAIL'}" + (f" [{card}]" if device == "cuda" else ""))
        if not ok:
            raise AssertionError(f"test CLI {name}: {launches[name]} launches, {split['images']} "
                                 f"images, {len(vis[name])} pngs, {res}")
    print(f"test CLI tree: {TEST_CHIPS} chips, skipped and advanced past: {json.dumps(skipped)}")

    tol = {"psnr": 0.01, "ssim": 1e-4, "cpsnr": 0.01}
    deltas = {m: abs(results["f32"][m] - results["cpu_f32"][m]) for m in kept}
    ok = all(deltas[m] <= tol[m] for m in kept)
    print(f"test CLI f32 card vs CPU metrics: |d| {json.dumps(deltas)} (gates {json.dumps(tol)}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("test CLI f32 card metrics disagree with the CPU's")
    sr = lambda run: np.stack([vis[run][i][0] for i in range(TEST_CHIPS)])
    gate_levels("test CLI f32 visualization PNGs, card vs CPU", sr("f32"), sr("cpu_f32"))
    p = psnr(sr("f32"), sr("bf16"))
    print(f"test CLI bf16 vs f32 visualization PSNR: {p:.2f} dB (floor 30) {'ok' if p >= 30 else 'FAIL'}")
    if not p >= 30:
        raise AssertionError("test CLI bf16 output too far from f32")
    fast = results["f32_b64_fast"]
    pairs = list(vis["f32_b64_fast"].values())
    host = {"psnr": np.mean([calculate_psnr(a, b, crop_border=4) for a, b in pairs]),
            "ssim": np.mean([calculate_ssim(a, b, crop_border=4) for a, b in pairs])}
    d_fast = {m: abs(fast[m] - host[m]) for m in host}
    ok = d_fast["psnr"] <= 1e-3 and d_fast["ssim"] <= 1e-4
    print(f"test CLI device-batched metrics vs numpy on the same run: |d| psnr {d_fast['psnr']:.3e} dB"
          f" (gate 1e-3), ssim {d_fast['ssim']:.3e} (gate 1e-4) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("test CLI device-batched metrics disagree with numpy")
    towers = tower_metric_check([vis["bf16_full"][i] for i in range(N_TOWER_CHECK)],
                                shipped_metrics, card)
    times = tower_times(seed, card)
    release_towers()
    profile_test_cli(test_cli, opt, root, seed, timings.records[0], timings)
    return {"launches": launches, "secs": secs, "towers": towers, "tower_times": times}


def build_metric_towers(card: str) -> None:
    """Build the shipped test metrics' towers on the card before the run that
    uses them, timing the SO400M build on its own line: the numpy draw of its
    seeded random params (the JAX package's stream), then the module on the
    card."""
    from satlas_sr_tpu_torch.metrics import clip_encoder, lpips

    t0 = time.perf_counter()
    params, pretrained = clip_encoder.tower_params(SO400M, None)
    t1 = time.perf_counter()
    tower, _ = clip_encoder.get_encoder(SO400M, None, "cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    lpips.tower_pretrained("vgg")
    n = sum(p.numel() for p in tower.parameters())
    print(f"{SO400M} tower ({'imported' if pretrained else 'seeded random'}, {n} parameters): "
          f"numpy draw {t1 - t0:.2f} s, module on the card {t2 - t1:.2f} s (host clock) [{card}]")


def release_towers() -> None:
    """Drop the towers the process keeps (one per model, weights and device)
    and return their card memory, so that a later phase's peak memory counts
    what its own path holds (phase 10 builds its tower anew)."""
    from satlas_sr_tpu_torch.metrics import clip_encoder, clipscore, lpips

    for cached in (clipscore._scorer, lpips._build_lpips, clip_encoder._cached_tower):
        cached.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()


def tower_metric_check(pairs, metric_opts: dict, card: str) -> dict:
    """The shipped LPIPS and CLIPScore of the full run's first chips (its
    SR/GT PNGs) on the card against the port's CPU: float32 with TF32 off,
    gate |d| <= 1e-4 absolute on both; and as shipped (matmul_precision
    default: TF32 allowed), printed."""
    from satlas_sr_tpu_torch.inference import _precision
    from satlas_sr_tpu_torch.metrics import calculate_metric

    out = {}
    for name in ("lpips", "clipscore"):
        m_opt = metric_opts[name]
        each = lambda device: np.array([calculate_metric({"img": a, "img2": b}, m_opt, device=device)
                                        for a, b in pairs])
        cpu = each("cpu")
        with tf32_off():
            f32 = each("cuda")
        with _precision("default"):
            shipped = each("cuda")
        out[name] = {"f32": float(np.abs(f32 - cpu).max()),
                     "shipped": float(np.abs(shipped - cpu).max())}
    ok = all(v["f32"] <= 1e-4 and np.isfinite(v["shipped"]) for v in out.values())
    print(f"test CLI tower metrics, card vs CPU on {len(pairs)} chips of the full run: max|d| "
          + ", ".join(f"{k} {v['f32']:.3e} (f32, TF32 off; gate 1e-4), {v['shipped']:.3e} "
                      f"(as shipped, TF32 allowed)" for k, v in out.items())
          + f" {'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        raise AssertionError("the card's tower metrics disagree with the CPU's")
    return out


def tower_times(seed: int, card: str) -> dict:
    """The towers' forwards on their own, CUDA events, float32 weights: the
    CLIPScore tower (SO400M) at [1, 384, 384, 3] and at the metric's
    [2, 384, 384, 3], the CLIP loss tower (ViT-B-16-SigLIP-256) at [32,
    256, 256, 3] forward and forward + the input's backward, and LPIPS-VGG16
    on one [1, 128, 128, 3] pair; each as shipped (TF32 allowed) and in
    float32 with TF32 off, beside its FLOPs (counted) over the TF32 or the
    float32 peak, and the peak memory of the SigLIP forward + backward."""
    from torch.utils.flop_counter import FlopCounterMode

    from satlas_sr_tpu_torch.inference import _precision
    from satlas_sr_tpu_torch.metrics.clip_encoder import device_key, get_encoder
    from satlas_sr_tpu_torch.metrics.lpips import _build_lpips

    gen = torch.Generator(device="cuda").manual_seed(seed + 30)
    rand = lambda *shape: torch.rand(*shape, device="cuda", generator=gen)
    so400m, _ = get_encoder(SO400M, None, "cuda")
    siglip, _ = get_encoder(SIGLIP, None, "cuda")
    lp = _build_lpips("vgg", None, device_key("cuda"))
    x1, x2, xs = rand(1, 384, 384, 3), rand(2, 384, 384, 3), rand(TRAIN_BATCH, 256, 256, 3)
    xg = xs.clone().requires_grad_(True)
    a, b = rand(1, 128, 128, 3), rand(1, 128, 128, 3)
    cases = {
        "SO400M fwd [1, 384, 384, 3]": lambda: so400m(x1),
        "SO400M fwd [2, 384, 384, 3]": lambda: so400m(x2),
        f"SigLIP-256 fwd [{TRAIN_BATCH}, 256, 256, 3]": lambda: siglip(xs),
        f"SigLIP-256 fwd + x bwd [{TRAIN_BATCH}, 256, 256, 3]":
            lambda: siglip(xg).sum().backward(inputs=[xg]),
        "LPIPS-VGG16 [1, 128, 128, 3] pair": lambda: lp(a, b),
    }
    out = {}
    for name, fn in cases.items():
        grad = "bwd" in name
        with torch.set_grad_enabled(grad), FlopCounterMode(display=False) as counter:
            fn()
        flops = counter.get_total_flops()
        row = {"gflop": flops / 1e9}
        for precision, peak in (("default", PEAK_FLOPS[torch.float32]), ("highest", FP32_FMA_PEAK)):
            with _precision(precision), torch.set_grad_enabled(grad):
                if grad:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                ms = time_ms(fn, iters=5, warmup=2)
                if grad:
                    row["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
            row[precision] = {"ms": ms, "bound_ms": 1e3 * flops / peak}
        out[name] = row
        print(f"tower {name}: {row['gflop']:.1f} GFLOP; as shipped (TF32 allowed) "
              f"{row['default']['ms']:.3f} ms (TF32 bound {row['default']['bound_ms']:.3f} ms), "
              f"float32 (TF32 off) {row['highest']['ms']:.3f} ms (FP32 bound "
              f"{row['highest']['bound_ms']:.3f} ms)"
              + (f"; peak memory above the inputs {row['peak_gb']:.2f} GB" if grad else "")
              + f" [{card}]")
    return out


def profile_test_cli(test_cli, opt: dict, root: str, seed: int, unprofiled: dict,
                     timings: "TimingRecords", n: int = 16) -> None:
    """The device's idle share of the test CLI as shipped (bf16, batch 1),
    from a torch.profiler trace of a run on a tree of n chips: over the
    trace's window, and as the device's busy seconds a chip against the
    unprofiled run's validation seconds a chip (the profiler slows the host).
    Run last: a profiler session slows later launches."""
    import yaml
    from torch.profiler import ProfilerActivity, profile

    data = os.path.join(root, "data_profiled")
    make_s2naip_tree(data, np.random.RandomState(seed + 7), n)
    o = json.loads(json.dumps({**opt, "name": "smoke_profiled"}))
    o["test_datasets"]["test"].update(sentinel2_path=os.path.join(data, "sentinel2"),
                                      naip_path=os.path.join(data, "naip"))
    path = os.path.join(root, "profiled.yml")
    with open(path, "w") as f:
        yaml.safe_dump(o, f)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        test_cli.test_pipeline(root, ["-opt", path], device="cuda")
        torch.cuda.synchronize()
    traced = device_busy(prof)
    if traced is None:
        return
    _, busy, window = traced
    images = timings.records[-1]["images"]
    busy_chip = busy / 1e6 / images
    val_chip = sum(unprofiled[k] for k in ("data", "forward", "metrics", "writes")) / unprofiled["images"]
    print(f"test CLI bf16 batch 1 under the profiler, {images} chips (set-up included): window "
          f"{window / 1e6:.3f} s, device busy {busy / 1e6:.4f} s, idle share {1 - busy / window:.4f}; "
          f"device busy {1e3 * busy_chip:.3f} ms a chip against the unprofiled run's "
          f"{1e3 * val_chip:.3f} ms of validation a chip: idle share {1 - busy_chip / val_chip:.4f}")


def rdb_masked_reference(x, kernels, biases, slopes):
    """`rdb_reference` with each LeakyReLU's slope pattern given: x_k =
    z_k * slopes[k]. Autograd through it is the plain gradient of the RDB
    whose activation pattern is `slopes`."""
    import torch.nn.functional as F

    h = x.permute(0, 3, 1, 2)
    feats = [h]
    for k in range(5):
        y = F.conv2d(torch.cat(feats, dim=1), kernels[k].to(x.dtype), biases[k].to(x.dtype),
                     padding=1)
        if k < 4:
            feats.append(y * slopes[k])
    return (y * 0.2 + h).permute(0, 2, 3, 1)


def rdb_train_check(seed: int, batch: int = TRAIN_BATCH, rows: int = HW,
                    dtypes=(torch.float32, torch.bfloat16)) -> dict:
    """One RDB under autograd at x [batch, rows, 32, 64] (the train step's
    shape, [32, 32, 32, 64]; an accumulation micro-batch's in phase 13; a
    row band's with its halo rows in phase 16), in each of `dtypes`:
    the kernel's forward keeping its concat buffer and `rdb_backward` from it,
    against autograd of the plain version on cuDNN, on the same float32
    master weights. The LeakyReLU's derivative jumps at 0, so where the
    kernel and cuDNN round a pre-activation near 0 to opposite signs the two
    gradients differ by 0.8 g at that pixel (about 5e-3 of a weight
    gradient's max at this shape): the gate compares against autograd of the
    plain version run with the kernel's activation pattern
    (`rdb_masked_reference`), and the count of such sign flips and the
    unmasked comparison are printed beside it. Gates: every gradient (dx,
    dW_k, db_k) within 1e-4 of its reference's max in float32 with TF32 off,
    TRAIN_BF16_BOUND in bfloat16. Device times in CUDA graphs
    (time_graph_ms): the kernel's forward and `rdb_backward`, the plain
    version's forward and forward + backward, with the Function's times in a
    Python loop beside; bound: the forward's (rdb_bound_ms), backward 2x,
    step 3x."""
    import torch.nn.functional as F

    from satlas_sr_tpu_torch.ops.cuda.rdb import (_launch, pack_weights, rdb, rdb_backward,
                                                  rdb_reference)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed + 8 + (batch != TRAIN_BATCH) * batch + (rows != HW) * rows)
    x0 = torch.randn(batch, rows, HW, NF, generator=gen)
    gy0 = torch.randn(batch, rows, HW, NF, generator=gen)
    masters = []
    for k in range(5):
        cin, cout = NF + k * G, (G if k < 4 else NF)
        masters += [torch.randn(cout, cin, 3, 3, generator=gen) * math.sqrt(2 / (9 * cin)),
                    torch.randn(cout, generator=gen) * 0.01]
    names = ["dx"] + [f"{'dW' if i % 2 == 0 else 'db'}{i // 2 + 1}" for i in range(10)]
    results = {}
    for dtype in dtypes:
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        params = [p.to(dev).requires_grad_() for p in masters]
        kernels, biases = params[0::2], params[1::2]
        x = x0.to(dev, dtype).requires_grad_()
        gy = gy0.to(dev, dtype)
        packed = pack_weights(kernels, biases, NF, G, dtype)
        kernel_fwd = lambda: rdb(x, kernels, biases, NF, G, packed=packed)
        plain_fwd = lambda: rdb_reference(x, kernels, biases, NF, G)
        grads = lambda fwd: torch.autograd.grad(fwd(), [x, *params], gy)
        rel_err = lambda a, b: ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
        with tf32_off():
            with torch.no_grad():
                _, buf = _launch(x.detach(), packed, NF, G, keep_concat=True)
                cat = buf.permute(0, 3, 1, 2)
                slopes = [torch.where(cat[:, NF + k * G:NF + (k + 1) * G] > 0, 1.0, 0.2).to(dtype)
                          for k in range(4)]
                h, feats, flips = x.detach().permute(0, 3, 1, 2), [], 0
                feats = [h]
                for k in range(4):
                    z = F.conv2d(torch.cat(feats, 1), kernels[k].to(dtype), biases[k].to(dtype),
                                 padding=1)
                    flips += int(((z > 0) != (slopes[k] == 1)).sum())
                    feats.append(F.leaky_relu(z, 0.2))
            y_k, y_p = kernel_fwd(), plain_fwd()
            got = grads(kernel_fwd)
            want = grads(lambda: rdb_masked_reference(x, kernels, biases, slopes))
            plain = grads(plain_fwd)
            torch.cuda.synchronize()
            fwd_err = (y_k.float() - y_p.float()).abs().max().item()
            rel = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
            unmasked = max(rel_err(a, b) for a, b in zip(got, plain))
            grad_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            bound = 1e-4 if dtype == torch.float32 else TRAIN_BF16_BOUND
            ok = max(rel.values()) <= bound
            print(f"rdb train {name} x [{batch}, {rows}, {HW}, {NF}]: forward max_abs_err "
                  f"{fwd_err:.3e}; gradients against the plain version with the kernel's "
                  f"activation pattern, max|d|/max|ref| "
                  + ", ".join(f"{n} {v:.2e}" for n, v in rel.items())
                  + f" (bound {bound:g}) {'ok' if ok else 'FAIL'}; {flips} of "
                  f"{4 * batch * rows * HW * G} pre-activations change sign between the "
                  f"kernel and cuDNN, and the unmasked gradients differ by up to {unmasked:.2e}")
            if not ok:
                raise AssertionError(f"rdb {name} backward disagrees with autograd of the plain version")
            # Device time, in CUDA graphs: the kernel's forward keeping its
            # concat and `rdb_backward` from it (what RDBFunction runs, less
            # autograd's bookkeeping); the plain version's forward and its
            # forward + autograd.grad. The Python loop's time of the Function
            # beside. Fresh leaves, and no graph of the checks above alive:
            # an AccumulateGrad node made on the default stream makes a
            # capture wait on that stream, which the capture refuses.
            del y_k, y_p, got, want, plain
            x = x.detach().requires_grad_()
            params = [p.detach().requires_grad_() for p in params]
            kernels, biases = params[0::2], params[1::2]
            xd, kd = x.detach(), [k.detach() for k in kernels]
            with torch.no_grad():
                fwd_ms = time_graph_ms(lambda: _launch(xd, packed, NF, G, keep_concat=True))
                _, buf = _launch(xd, packed, NF, G, keep_concat=True)
                bwd_ms = time_graph_ms(lambda: rdb_backward(buf, gy, kd, NF, G))
                plain_fwd_ms = time_graph_ms(plain_fwd)
            try:
                plain_step_ms, plain_how = time_graph_ms(lambda: grads(plain_fwd)), "graph"
            except RuntimeError as e:  # a measurement's route, not the kernel's
                print(f"rdb train {name}: autograd in a CUDA graph refused ({str(e)[:80]}); "
                      "the plain step is timed in a Python loop")
                plain_step_ms, plain_how = time_ms(lambda: grads(plain_fwd)), "eager"
            eager_fwd_ms, eager_step_ms = time_ms(kernel_fwd), time_ms(lambda: grads(kernel_fwd))
            step_ms = fwd_ms + bwd_ms
            feats = [torch.randn(batch, NF + k * G, rows, HW, device=dev, dtype=dtype)
                     .contiguous(memory_format=torch.channels_last) for k in range(5)]
            kcl = [k.detach().to(dtype).contiguous(memory_format=torch.channels_last)
                   for k in kernels]
            bb = [b.detach().to(dtype) for b in biases]
            gouts = [torch.randn(batch, kcl[k].shape[0], rows, HW, device=dev, dtype=dtype)
                     .contiguous(memory_format=torch.channels_last) for k in range(5)]
            with torch.no_grad():
                library_ms = time_graph_ms(
                    lambda: [F.conv2d(feats[k], kcl[k], bb[k], padding=1) for k in range(5)])
                # cuDNN's own gradient calls (input, weight, bias) for the same five convs
                library_bwd_ms = time_graph_ms(lambda: [torch.ops.aten.convolution_backward(
                    gouts[k], feats[k], kcl[k], [kcl[k].shape[0]], [1, 1], [1, 1], [1, 1], False,
                    [0, 0], 1, [True, True, True]) for k in range(5)])
        bound_ms, bound_by, flops = rdb_bound_ms(dtype, batch, rows)
        print(f"rdb train {name} x [{batch}, {rows}, {HW}, {NF}] (CUDA graphs): kernel forward keeping the concat {fwd_ms:.4f} "
              f"ms, rdb_backward {bwd_ms:.4f} ms, step {step_ms:.4f} ms; cuDNN autograd of "
              f"rdb_reference forward {plain_fwd_ms:.4f} ms, step {plain_step_ms:.4f} ms "
              f"({plain_how}), so backward {plain_step_ms - plain_fwd_ms:.4f} ms; five cuDNN "
              f"convs {library_ms:.4f} ms, their five cuDNN gradient calls {library_bwd_ms:.4f} "
              f"ms; the Function in a Python loop (host issue "
              f"included): forward {eager_fwd_ms:.4f} ms, step {eager_step_ms:.4f} ms; bound "
              f"(3x the forward's {flops / 1e9:.2f} GFLOP, {bound_by}) {3 * bound_ms:.4f} ms: "
              f"{100 * 3 * bound_ms / step_ms:.1f}% of the step")
        results[name] = {
            "fwd": dict(max_abs_err=fwd_err, ms=fwd_ms, plain_ms=plain_fwd_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=library_ms, eager_ms=eager_fwd_ms),
            "bwd": dict(max_abs_err=grad_err, max_rel_err=max(rel.values()), sign_flips=flips,
                        unmasked_rel_err=unmasked, ms=bwd_ms,
                        eager_ms=eager_step_ms - eager_fwd_ms,
                        plain_ms=plain_step_ms - plain_fwd_ms, bound_ms=2 * bound_ms,
                        bound_by=bound_by, library_ms=library_bwd_ms)}
    return results


def train_opt(name: str, work: str, data_dir: str, val_dir: str,
              config: str = "esrgan_s2naip_urban.yml", **over) -> dict:
    """A shipped train config (options/esrgan_s2naip_urban.yml by default) on
    the synthetic trees, as shipped (full width, batch 32, its dtype) unless
    `over` says otherwise; an OSM config gets the tree's box JSON."""
    opt = load_config(config)
    opt = json.loads(json.dumps({**opt, "name": name, **over}))
    tr = opt["datasets"]["train"]
    tr.update(sentinel2_path=os.path.join(data_dir, "sentinel2"),
              naip_path=os.path.join(data_dir, "naip"),
              tile_weights=os.path.join(data_dir, "tile_weights.json"))
    if tr.get("osm_objs_path"):
        tr["osm_objs_path"] = os.path.join(data_dir, "osm_chips_to_masks.json")
    opt["datasets"]["val"].update(sentinel2_path=os.path.join(val_dir, "sentinel2"),
                                  naip_path=os.path.join(val_dir, "naip"))
    opt["path"]["experiments_root"] = os.path.join(work, "experiments")
    opt["logger"].update(print_freq=1)
    return opt


def write_yml(opt: dict, path: str) -> str:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return path


def run_train(root: str, opt: dict, *flags: str):
    """The train CLI on `opt` (written under `root`) on the card: (seconds,
    rdb launches, rdb backwards), the counts zeroed just before."""
    from satlas_sr_tpu_torch import train as train_cli
    from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod

    rdb_mod.LAUNCHES = rdb_mod.BACKWARDS = 0
    t0 = time.time()
    train_cli.train_pipeline(root, ["-opt", write_yml(opt, os.path.join(root, "opt.yml")), *flags],
                             device="cuda")
    torch.cuda.synchronize()
    return time.time() - t0, rdb_mod.LAUNCHES, rdb_mod.BACKWARDS


def train_rows(exp: str):
    """(train rows, validation rows) of a run's metrics.jsonl."""
    rows = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    return ([r for r in rows if "val_dataset" not in r], [r for r in rows if "val_dataset" in r])


def step_check(seed: int) -> dict:
    """One full-width train step (esrgan_s2naip_urban: 23 blocks, nf 64, g 32,
    D nf 64, VGG19 to conv5_4), batch 2, float32 with TF32 off, on the card and
    on the CPU from the same seeded weights and batch; then, after the step,
    the first RDB through the kernel against rdb_reference on the updated
    weights (its pack was refreshed). The CPU step also counts the step's
    FLOPs (torch.utils.flop_counter).

    Gates: every loss within 1e-4 relative; each network's first gradients
    within 1e-3 relative L2 and every gradient tensor within 1e-2 of its
    max. Not 1e-4 per tensor: the derivatives of the LeakyReLUs and ReLUs
    jump at 0, and the card and the CPU round ~1 in 10^6 pre-activations to
    opposite signs (counted here for the 69 x 4 RDB LeakyReLUs); each such
    pixel moves the gradient of every tensor upstream of it by up to ~1e-3
    of its max at batch 2. At the RDB alone, rdb_train_check holds 1e-4 per
    tensor with the activation pattern shared."""
    from torch.utils.flop_counter import FlopCounterMode

    from satlas_sr_tpu_torch.archs import rrdbnet
    from satlas_sr_tpu_torch.models import build_model
    from satlas_sr_tpu_torch.ops.cuda.rdb import _launch, rdb_reference, rdb_reference_with_concat

    opt = load_config("esrgan_s2naip_urban.yml", compute_dtype="float32",
                      matmul_precision="highest", manual_seed=seed, is_train=True, val=None)
    opt["name"] = "smoke_step"
    rng = np.random.RandomState(seed + 9)
    batch = {"lr": (rng.rand(2, HW, HW, IN_CH) * 255).astype(np.uint8),
             "hr": (rng.rand(2, 4 * HW, 4 * HW, 3) * 255).astype(np.uint8)}
    plain_rdb, signs = rrdbnet.rdb, {"cuda": [], "cpu": []}

    def recording_rdb(x, kernels, biases, nf, g, packed=None):
        """The rdb op, also recording the signs of the call's x1..x4 from a
        concat buffer (the kernel's on the card, the plain version's on the
        CPU; both deterministic)."""
        with torch.no_grad():
            _, buf = (_launch(x.detach(), packed, nf, g, keep_concat=True) if x.is_cuda else
                      rdb_reference_with_concat(x.detach(), kernels, biases, nf, g))
        signs[x.device.type].append((buf[..., nf:] > 0).cpu())
        return plain_rdb(x, kernels, biases, nf, g, packed=packed)

    logs, models = {}, {}
    for dev in ("cuda", "cpu"):
        models[dev] = m = build_model(json.loads(json.dumps(opt)), device=dev)
        if dev == "cuda":
            before = [p.detach().clone() for c in m.net_g.body[0].rdb1.convs()
                      for p in (c.weight, c.bias)]
        rrdbnet.rdb = recording_rdb  # the signs, from a forward of G before the step
        try:
            with torch.no_grad(), tf32_off():
                m.net_g(torch.from_numpy(batch["lr"]).to(m.device).float() / 255.0)
        finally:
            rrdbnet.rdb = plain_rdb
        with tf32_off(), FlopCounterMode(display=False) as counter:
            logs[dev] = {k: float(v) for k, v in m.train_iter(batch, 1).items()}
        flops = counter.get_total_flops() / 2  # the CPU's, counted last
    torch.cuda.synchronize()
    rel = {k: abs(logs["cuda"][k] - logs["cpu"][k]) / max(abs(logs["cpu"][k]), 1e-12)
           for k in logs["cpu"]}
    ok = all(v <= 1e-4 for v in rel.values())
    print(f"train step card vs CPU (f32, TF32 off, batch 2, full width): losses "
          + ", ".join(f"{k} {logs['cuda'][k]:.6f} ({v:.1e})" for k, v in rel.items())
          + f" (gate 1e-4 relative) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("train step losses disagree between the card and the CPU")
    worst, l2 = {}, {}
    for net in ("net_g", "net_d"):
        cpu = dict(getattr(models["cpu"], net).named_parameters())
        num = den = 0.0
        for n, p in getattr(models["cuda"], net).named_parameters():
            want, d = cpu[n].grad, p.grad.cpu() - cpu[n].grad
            worst[f"{net}.{n}"] = (d.abs().max() / want.abs().max().clamp(min=1e-30)).item()
            num, den = num + float(d.square().sum()), den + float(want.square().sum())
        l2[net] = math.sqrt(num / den)
    flips = sum(int((a != b).sum()) for a, b in zip(signs["cuda"], signs["cpu"]))
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    ok = all(v <= 1e-3 for v in l2.values()) and all(v <= 1e-2 for v in worst.values())
    print(f"train step first gradients, card vs CPU, {len(worst)} tensors: relative L2 "
          + ", ".join(f"{k} {v:.2e}" for k, v in l2.items()) + " (gate 1e-3); max|d|/max|ref| "
          "worst " + ", ".join(f"{n} {v:.2e}" for n, v in top) + " (gate 1e-2); "
          f"{sum(v > 1e-4 for v in worst.values())} tensors over 1e-4; {flips} of "
          f"{sum(a.numel() for a in signs['cpu'])} RDB pre-activations change sign between the "
          f"card and the CPU {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("train step gradients disagree between the card and the CPU")
    block = models["cuda"].net_g.body[0].rdb1
    convs = block.convs()
    x = torch.randn(2, HW, HW, NF, generator=torch.Generator().manual_seed(seed)).cuda()
    with torch.no_grad(), tf32_off():
        got = block(x)
        new = rdb_reference(x, [c.weight for c in convs], [c.bias for c in convs], NF, G)
        old = rdb_reference(x, before[0::2], before[1::2], NF, G)
        torch.cuda.synchronize()
    err, moved = (got - new).abs().max().item(), (new - old).abs().max().item()
    ok = torch.allclose(got, new, atol=1e-4, rtol=1e-4) and err < 0.1 * moved
    print(f"after the step, the kernel's RDB against rdb_reference on the updated weights: "
          f"max|d| {err:.3e} (the step moved it {moved:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the rdb kernel ran stale packed weights after an optimizer step")
    return {"flops_per_sample": flops, "l2": l2, "worst": max(worst.values()), "flips": flips}


def train_rate(opt: dict, steps: int, profile: int = 0, warmup: int = 3) -> dict:
    """Steady state of the train step on the card, batches from the real
    loader (accum_steps x batch_size_per_gpu rows a step): samples/s, the
    host's wait on the loader, the step split by the model's CUDA-event
    marks (a mark a micro-batch takes sums), peak memory; with `profile`,
    then a torch.profiler window of that many more steps of the same model
    ("prof", for profile_train)."""
    from torch.profiler import ProfilerActivity, profile as tprofile, schedule

    from satlas_sr_tpu_torch.data import build_dataset, build_train_loader
    from satlas_sr_tpu_torch.models import build_model

    o = json.loads(json.dumps({**opt, "is_train": True, "val": None}))
    ds = o["datasets"]["train"]
    rows = int(ds["batch_size_per_gpu"]) * int(o["train"].get("accum_steps", 1) or 1)
    model = build_model(o, device="cuda")
    loader = build_train_loader(build_dataset(ds), {**ds, "batch_size_per_gpu": rows}, seed=0)
    batches = iter(loader)
    try:
        for i in range(warmup):
            model.train_iter(next(batches), i + 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model.split_events = []
        wait = 0.0
        t0 = time.perf_counter()
        for i in range(steps):
            tw = time.perf_counter()
            batch = next(batches)
            wait += time.perf_counter() - tw
            model.train_iter(batch, i + warmup + 1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        marks, peak = model.split_events, torch.cuda.max_memory_allocated()
        out = {}
        if profile:
            model.split_events = None  # no CUDA-event marks in the traced steps
            # one traced warm-up step before the window, as profile.run_profile
            # has it: a session's first kernels can reach the trace partly
            with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                          schedule=schedule(wait=0, warmup=1, active=profile, repeat=1)) as prof:
                for i in range(profile + 1):
                    model.train_iter(next(batches), i + warmup + steps + 1)
                    if i in (0, profile):  # the window holds its own steps' device work
                        torch.cuda.synchronize()
                    prof.step()
            out = {"prof": prof}
    finally:
        loader.stop()
    per = len(marks) // steps
    split = {}
    for s in range(steps):
        step_marks = marks[s * per:(s + 1) * per]
        for (_, a), (b_name, b) in zip(step_marks, step_marks[1:]):
            split[b_name] = split.get(b_name, 0.0) + a.elapsed_time(b) / steps
    return {"samples_s": steps * rows / secs, "step_ms": 1e3 * secs / steps,
            "data_wait_ms": 1e3 * wait / steps, "split_ms": split,
            "max_memory_gb": peak / 1e9, **out}


def phase_train(seed: int, work: str, card: str) -> dict:
    """The ESRGAN GAN train CLI on options/esrgan_s2naip_urban.yml at full
    width (see the module docstring, phase 8)."""
    rdb_rows = rdb_train_check(seed)
    step = step_check(seed)
    root = os.path.join(work, "train")
    data, val = os.path.join(root, "data"), os.path.join(root, "val")
    make_s2naip_tree(data, np.random.RandomState(seed + 10), N_TRAIN_CHIPS)
    make_s2naip_tree(val, np.random.RandomState(seed + 11), N_VAL_CHIPS)
    chips = sorted(os.listdir(os.path.join(data, "naip")))
    weights = np.random.RandomState(seed + 12).rand(len(chips)) * 10 + 0.1
    with open(os.path.join(data, "tile_weights.json"), "w") as f:
        json.dump(dict(zip(chips, weights.tolist())), f)

    TimingRecords()  # quiet the port logger's stdout lines
    opt = train_opt("smoke_train", root, data, val,
                    train={**load_config("esrgan_s2naip_urban.yml")["train"],
                           "total_iter": TRAIN_ITERS},
                    val={**load_config("esrgan_s2naip_urban.yml")["val"], "val_freq": TRAIN_ITERS})
    opt["logger"]["save_checkpoint_freq"] = TRAIN_ITERS
    exp = os.path.join(root, "experiments", "smoke_train")
    runs = {}
    secs, launches, backwards = run_train(root, opt)
    rows, val_rows = train_rows(exp)
    expected = RDBS_PER_FORWARD * (TRAIN_ITERS + 2 * N_VAL_CHIPS)
    files = [os.path.join(exp, "models", f"net_{n}_{TRAIN_ITERS}.pth") for n in ("g", "d")] + [
        os.path.join(exp, "training_states", f"{TRAIN_ITERS}.state")]
    finite = all(np.isfinite(v) for r in rows for k, v in r.items() if k.startswith(("l_", "out_")))
    ok = (launches == expected and backwards == RDBS_PER_FORWARD * TRAIN_ITERS and finite
          and [r["iter"] for r in rows] == list(range(1, TRAIN_ITERS + 1))
          and len(val_rows) == 2 and all(os.path.exists(f) for f in files))
    print(f"train CLI bf16 batch {TRAIN_BATCH}, {TRAIN_ITERS} iterations + 2 validations of "
          f"{N_VAL_CHIPS} chips + checkpoint: {secs:.1f} s; last losses "
          + json.dumps({k: round(v, 5) for k, v in rows[-1].items() if k.startswith("l_")})
          + f"; val {json.dumps({k: round(v, 3) for k, v in val_rows[-1].items() if k in ('psnr', 'ssim')})}"
          f"; rdb launches {launches} (expected {expected}), backwards {backwards} (expected "
          f"{RDBS_PER_FORWARD * TRAIN_ITERS}); files {'written' if all(map(os.path.exists, files)) else 'MISSING'}"
          f" {'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        raise AssertionError("train CLI bf16 run failed its gates")
    runs["bf16"] = {"launches": launches, "backwards": backwards}

    opt["train"]["total_iter"] = TRAIN_ITERS + RESUME_ITERS
    secs, launches, backwards = run_train(root, opt, "--auto_resume")
    rows2, val_rows2 = train_rows(exp)
    resumed = [r["iter"] for r in rows2[len(rows):]]
    expected = RDBS_PER_FORWARD * (RESUME_ITERS + N_VAL_CHIPS)
    finite = all(np.isfinite(v) for r in rows2 for k, v in r.items() if k.startswith(("l_", "out_")))
    ok = (resumed == list(range(TRAIN_ITERS + 1, TRAIN_ITERS + RESUME_ITERS + 1))
          and launches == expected and finite and len(val_rows2) == 3
          and os.path.exists(os.path.join(exp, "training_states", "latest.state")))
    print(f"train CLI --auto_resume to {TRAIN_ITERS + RESUME_ITERS}: resumed at iterations "
          f"{resumed} in {secs:.1f} s; rdb launches {launches} (expected {expected}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("train CLI auto-resume failed its gates")

    opt32 = train_opt("smoke_train_f32", root, data, val, compute_dtype="float32",
                      train={**load_config("esrgan_s2naip_urban.yml")["train"],
                             "total_iter": F32_ITERS}, val=None)
    secs, launches, backwards = run_train(root, opt32)
    rows32, _ = train_rows(os.path.join(root, "experiments", "smoke_train_f32"))
    finite = all(np.isfinite(v) for r in rows32 for k, v in r.items() if k.startswith(("l_", "out_")))
    ok = launches == RDBS_PER_FORWARD * F32_ITERS and backwards == launches and finite
    print(f"train CLI f32 batch {TRAIN_BATCH}, {F32_ITERS} iterations: {secs:.1f} s; last losses "
          + json.dumps({k: round(v, 5) for k, v in rows32[-1].items() if k.startswith("l_")})
          + f"; rdb launches {launches} (expected {RDBS_PER_FORWARD * F32_ITERS}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("train CLI f32 run failed its gates")
    runs["f32"] = {"launches": launches, "backwards": backwards}

    rates = {}
    for name, o in (("bf16", opt), ("f32", opt32)):
        rates[name] = r = train_rate(o, RATE_STEPS, profile=PROFILE_STEPS if name == "bf16" else 0)
        flops_step = step["flops_per_sample"] * TRAIN_BATCH
        share = flops_step / (r["step_ms"] / 1e3) / PEAK_FLOPS[torch.bfloat16]
        print(f"train step {name} batch {TRAIN_BATCH}, steady state over {RATE_STEPS} steps: "
              f"{r['samples_s']:.2f} samples/s ({r['step_ms']:.2f} ms a step); data wait "
              f"{r['data_wait_ms']:.2f} ms; split by CUDA events (ms): "
              + ", ".join(f"{k} {v:.2f}" for k, v in r["split_ms"].items())
              + f"; max_memory_allocated {r['max_memory_gb']:.2f} GB; model FLOPs "
              f"{flops_step / 1e12:.3f} TFLOP a step, {100 * share:.2f}% of the bf16 dense peak "
              f"[{card}]")
    profile_train(rates["bf16"], "bf16")
    return {"rdb": rdb_rows, "runs": runs, "rates": rates,
            "flops_step": step["flops_per_sample"] * TRAIN_BATCH}


def profile_train(rate: dict, label: str) -> None:
    """train_rate's profiler window of PROFILE_STEPS train steps: device
    idle share (in the window, and against the unprofiled steps), and the
    top device kernels by total time."""
    traced = device_busy(rate.pop("prof"))
    if traced is None:
        return
    kernels, busy, window = traced
    step_ms = rate["step_ms"]
    by_name = {}
    for name, us in kernels:
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + us, c + 1)
    total = sum(t for t, _ in by_name.values())
    print(f"profiler, {PROFILE_STEPS} {label} train steps of batch {TRAIN_BATCH}: window "
          f"{window / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms, idle share "
          f"{1 - busy / window:.4f}; against the unprofiled steps ({step_ms:.2f} ms) "
          f"{1 - busy / 1e3 / PROFILE_STEPS / step_ms:.4f}; top device kernels by total time:")
    for kname, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {t / 1e3 / PROFILE_STEPS:9.3f} ms/step {100 * t / total:5.1f}%  "
              f"{c // PROFILE_STEPS:5d} launches/step  {kname[:90]}")


FAMILIES = (("osm", "osm_obj_esrgan.yml", 4), ("ssim", "ssimloss_esrgan_s2naip_urban.yml", 4),
            ("srcnn", "srcnn_s2naip_urban.yml", 4), ("highresnet", "highresnet_s2naip_urban.yml", 4))
SSIM_LOSS_KEYS = ("mse", "mae", "ssim", "tot_loss", "psnr_loss")


def write_osm_boxes(data_dir: str, rng: np.random.RandomState) -> str:
    """osm_chips_to_masks.json for a synthetic tree: 1 to 4 boxes a chip in
    two classes, the first box of every fourth chip degenerate (x1 == x2)."""
    boxes = {}
    for i, chip in enumerate(sorted(os.listdir(os.path.join(data_dir, "naip")))):
        objs = []
        for _ in range(1 + i % 4):
            x1, y1 = (int(v) for v in rng.randint(0, 120, size=2))
            objs.append([x1, y1, x1 + int(rng.randint(1, 129 - x1)), y1 + int(rng.randint(1, 129 - y1))])
        if i % 4 == 0:
            objs[0][2] = objs[0][0]
        boxes[chip] = {"building": objs[::2], "road": objs[1::2]}
    path = os.path.join(data_dir, "osm_chips_to_masks.json")
    with open(path, "w") as f:
        json.dump(boxes, f)
    return path


def ssim_check(seed: int) -> dict:
    """ops/ssim.ssim_loss on the card under `matmul_precision: default` (TF32
    allowed, as all four new configs ship) against the CPU, on near-constant
    images: magnitude ~0.97, variance 1e-4, below C2 = 9e-4, where a filter
    that errs in E[x^2] by C2 breaks the map. Gate: finite, within 1e-6
    absolute. Printed beside (a record): how far a TF32-allowed cuDNN
    depthwise filter of x^2 errs on the same input, against C2."""
    import torch.nn.functional as F

    from satlas_sr_tpu_torch.inference import _precision
    from satlas_sr_tpu_torch.ops.ssim import _gaussian_1d, filter_separable_reflect, ssim_loss

    gen = torch.Generator().manual_seed(seed + 20)
    x, y = (0.97 + 0.01 * torch.randn(TRAIN_BATCH, 4 * HW, 4 * HW, 3, generator=gen)
            for _ in range(2))
    want = ssim_loss(x, y)
    k = torch.tensor(_gaussian_1d(5, 1.5)).cuda()
    with _precision("default"):
        got = ssim_loss(x.cuda(), y.cuda()).cpu()
        xx = F.pad((x * x).cuda().permute(0, 3, 1, 2).reshape(-1, 1, 4 * HW, 4 * HW),
                   (2, 2, 2, 2), mode="reflect")
        conv = F.conv2d(F.conv2d(xx, k.view(1, 1, 5, 1)), k.view(1, 1, 1, 5))
        conv = conv.reshape(TRAIN_BATCH, 3, 4 * HW, 4 * HW).permute(0, 2, 3, 1).cpu()
    exact = filter_separable_reflect((x * x).double(), _gaussian_1d(5, 1.5))
    conv_err = (conv.double() - exact).abs().max().item()
    err = (got - want).abs().max().item()
    finite = bool(torch.isfinite(got).all())
    ok = finite and err <= 1e-6
    print(f"ssim_loss, card (matmul_precision default) vs CPU, near-constant [{TRAIN_BATCH}, "
          f"{4 * HW}, {4 * HW}, 3]: max|d| {err:.3e} (gate 1e-6), finite {finite}, mean loss "
          f"{got.mean().item():.6f}; a cuDNN depthwise filter of x^2 with TF32 allowed errs by "
          f"{conv_err:.3e} in E[x^2] (C2 = 9e-4) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("ssim_loss on the card disagrees with the CPU or is not finite")
    return {"max_abs_err": err, "tf32_conv_err": conv_err}


def family_step_check(seed: int, config: str, osm_path: Optional[str] = None) -> dict:
    """One full-width float32 train step (TF32 off), batch 2, of a shipped
    config on the CPU and on the card from the same seeded weights and
    batch: the OSM trainer with the boxes it draws for the iteration (equal
    on both), the L2 trainer with the CPU step's dropout masks replayed on
    the card (DropoutMasks.record / replay). Gates: losses within 1e-4
    relative; each network's first gradients within 1e-3 relative L2, and
    for the GAN trainers every tensor within 1e-2 of its max (the ReLU
    kinks: see step_check)."""
    from satlas_sr_tpu_torch.models import build_model

    opt = load_config(config, compute_dtype="float32", matmul_precision="highest",
                      manual_seed=seed, is_train=True, val=None)
    l2 = opt["model_type"] == "L2Model"
    if osm_path:
        opt["datasets"]["train"]["osm_objs_path"] = osm_path
    rng = np.random.RandomState(seed + 21)
    lr_shape = (2, N_LR, HW, HW, 3) if l2 else (2, HW, HW, IN_CH)
    batch = {"lr": (rng.rand(*lr_shape) * 255).astype(np.uint8),
             "hr": (rng.rand(2, 4 * HW, 4 * HW, 3) * 255).astype(np.uint8)}
    if osm_path:
        with open(osm_path) as f:
            batch["Chip"] = sorted(json.load(f))[:2]
    masks, logs, models = [], {}, {}
    for dev in ("cpu", "cuda"):
        models[dev] = m = build_model(json.loads(json.dumps(opt)), device=dev)
        if l2 and dev == "cpu":
            m.dropout_masks.record = masks
        elif l2:
            m.dropout_masks.replay(masks)
        with tf32_off():
            logs[dev] = {k: float(v) for k, v in m.train_iter(batch, 1).items()}
    torch.cuda.synchronize()
    rel = {k: abs(logs["cuda"][k] - logs["cpu"][k]) / max(abs(logs["cpu"][k]), 1e-12)
           for k in logs["cpu"]}
    worst, l2_err = {}, {}
    for net in ("net_g",) if l2 else ("net_g", "net_d"):
        cpu = dict(getattr(models["cpu"], net).named_parameters())
        num = den = 0.0
        for n, p in getattr(models["cuda"], net).named_parameters():
            want, d = cpu[n].grad, p.grad.cpu() - cpu[n].grad
            worst[f"{net}.{n}"] = (d.abs().max() / want.abs().max().clamp(min=1e-30)).item()
            num, den = num + float(d.square().sum()), den + float(want.square().sum())
        l2_err[net] = math.sqrt(num / den)
    same_boxes = not osm_path or np.array_equal(models["cpu"].boxes, models["cuda"].boxes)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:2]
    ok = (all(v <= 1e-4 for v in rel.values()) and all(v <= 1e-3 for v in l2_err.values())
          and (l2 or all(v <= 1e-2 for v in worst.values())) and same_boxes
          and (not l2 or (len(masks) > 0 and not models["cuda"].dropout_masks.queue)))
    print(f"{config} step card vs CPU (f32, TF32 off, batch 2, full width"
          + (f", {len(masks)} dropout masks shared" if l2 else "")
          + (", the same boxes" if osm_path else "") + "): losses "
          + ", ".join(f"{k} {logs['cuda'][k]:.6f} ({v:.1e})" for k, v in rel.items())
          + " (gate 1e-4); gradients relative L2 "
          + ", ".join(f"{k} {v:.2e}" for k, v in l2_err.items()) + " (gate 1e-3); max|d|/max|ref| "
          "worst " + ", ".join(f"{n} {v:.2e}" for n, v in top)
          + ("" if l2 else " (gate 1e-2)") + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{config}: the train step disagrees between the card and the CPU")
    return {"losses_rel": max(rel.values()), "l2": l2_err, "worst": max(worst.values())}


def phase_train_families(seed: int, work: str, card: str) -> dict:
    """The other trainer families through the train CLI at full width, as
    shipped (see the module docstring, phase 9)."""
    ssim = ssim_check(seed)
    root = os.path.join(work, "families")
    data, val = os.path.join(root, "data"), os.path.join(root, "val")
    make_s2naip_tree(data, np.random.RandomState(seed + 22), N_TRAIN_CHIPS)
    make_s2naip_tree(val, np.random.RandomState(seed + 23), N_VAL_CHIPS)
    chips = sorted(os.listdir(os.path.join(data, "naip")))
    weights = np.random.RandomState(seed + 24).rand(len(chips)) * 10 + 0.1
    with open(os.path.join(data, "tile_weights.json"), "w") as f:
        json.dump(dict(zip(chips, weights.tolist())), f)
    osm_path = write_osm_boxes(data, np.random.RandomState(seed + 25))
    steps = {key: family_step_check(seed, config, osm_path if key == "osm" else None)
             for key, config, _ in FAMILIES}

    TimingRecords()  # quiet the port logger's stdout lines
    runs, rates = {}, {}
    for key, config, iters in FAMILIES:
        shipped = load_config(config)
        l2 = shipped["model_type"] == "L2Model"
        validate = key != "ssim"
        opt = train_opt(f"smoke_{key}", root, data, val, config=config,
                        train={**shipped["train"], "total_iter": iters},
                        val={**shipped["val"], "val_freq": iters} if validate else None)
        opt["logger"]["save_checkpoint_freq"] = iters
        exp = os.path.join(root, "experiments", opt["name"])
        secs, launches, backwards = run_train(root, opt)
        rows, val_rows = train_rows(exp)
        loss_keys = SSIM_LOSS_KEYS if l2 else [k for k in rows[0] if k.startswith(("l_", "out_"))]
        finite = all(np.isfinite(r[k]) for r in rows for k in loss_keys)
        forwards = iters + (2 * N_VAL_CHIPS if validate else 0)
        files = [os.path.join(exp, "models", f"net_{n}_{iters}.pth")
                 for n in (("g",) if l2 else ("g", "d"))]
        files.append(os.path.join(exp, "training_states", f"{iters}.state"))
        want_launches = 0 if l2 else RDBS_PER_FORWARD * forwards
        want_backwards = 0 if l2 else RDBS_PER_FORWARD * iters
        extra = {"ssim": ["l_g_ssim"], "osm": ["l_g_gan_objs", "l_d_real_objs", "l_d_fake_objs"]}
        ok = (launches == want_launches and backwards == want_backwards and finite
              and [r["iter"] for r in rows] == list(range(1, iters + 1))
              and all(k in r for r in rows for k in extra.get(key, []))
              and len(val_rows) == (2 if validate else 0) and all(map(os.path.exists, files)))
        print(f"train CLI {config} ({opt['compute_dtype']}, batch {TRAIN_BATCH}), {iters} iterations"
              + (f" + 2 validations of {N_VAL_CHIPS} chips" if validate else "")
              + f" + checkpoint: {secs:.1f} s; last losses "
              + json.dumps({k: round(rows[-1][k], 5) for k in loss_keys})
              + (f"; val {json.dumps({k: round(v, 3) for k, v in val_rows[-1].items() if k in ('psnr', 'ssim')})}"
                 if validate else "")
              + f"; rdb launches {launches} (expected {want_launches}), backwards {backwards} "
              f"(expected {want_backwards}) {'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            raise AssertionError(f"train CLI {config} failed its gates")
        runs[key] = {"launches": launches, "backwards": backwards, "seconds": secs}
        if key == "osm":
            opt["train"]["total_iter"] = iters + RESUME_ITERS
            secs, launches, backwards = run_train(root, opt, "--auto_resume")
            rows2, val_rows2 = train_rows(exp)
            resumed = [r["iter"] for r in rows2[len(rows):]]
            want_launches = RDBS_PER_FORWARD * (RESUME_ITERS + N_VAL_CHIPS)
            ok = (resumed == list(range(iters + 1, iters + RESUME_ITERS + 1))
                  and launches == want_launches and backwards == RDBS_PER_FORWARD * RESUME_ITERS
                  and len(val_rows2) == 3
                  and all(np.isfinite(r[k]) for r in rows2 for k in loss_keys))
            print(f"train CLI {config} --auto_resume to {iters + RESUME_ITERS}: resumed at "
                  f"iterations {resumed} in {secs:.1f} s; rdb launches {launches} (expected "
                  f"{want_launches}), backwards {backwards} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"train CLI {config} auto-resume failed its gates")
            runs[key]["launches"] += launches
            runs[key]["backwards"] += backwards
        rates[key] = r = train_rate(opt, RATE_STEPS, profile=PROFILE_STEPS)
        print(f"train step {key} ({config}, {opt['compute_dtype']}) batch {TRAIN_BATCH}, steady "
              f"state over {RATE_STEPS} steps: {r['samples_s']:.2f} samples/s ({r['step_ms']:.2f} ms "
              f"a step); data wait {r['data_wait_ms']:.2f} ms"
              + ("; split by CUDA events (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in
                                                             r["split_ms"].items())
                 if r["split_ms"] else "")
              + f"; max_memory_allocated {r['max_memory_gb']:.2f} GB [{card}]")
        profile_train(r, f"{key} {opt['compute_dtype']}")
    return {"ssim": ssim, "steps": steps, "runs": runs, "rates": rates}


CLIP_CONFIG, CLIP_ITERS = "cliploss_esrgan_s2naip_urban.yml", 4


def clip_term(seed: int, card: str) -> dict:
    """The CLIP loss term of the step on its own, as the trainer calls it
    (losses/clip.py, matmul_precision default: TF32 allowed): a bfloat16 G
    output [32, 128, 128, 3] and its float32 GT, each resized to 256 and
    through the SigLIP tower, then the output's backward; CUDA events, the
    FLOPs counted, the peak memory it adds. Then l_clip_sim of two of those
    images on the card against the port's CPU: TF32 off, gate 1e-4
    relative; as shipped (TF32 allowed), printed."""
    from torch.utils.flop_counter import FlopCounterMode

    from satlas_sr_tpu_torch.inference import _precision
    from satlas_sr_tpu_torch.losses import build_loss

    fn = build_loss(load_config(CLIP_CONFIG)["train"]["clip_opt"])
    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    out = torch.rand(TRAIN_BATCH, 4 * HW, 4 * HW, 3, device="cuda", generator=gen)
    out = out.bfloat16().requires_grad_(True)
    gt = torch.rand(TRAIN_BATCH, 4 * HW, 4 * HW, 3, device="cuda", generator=gen)
    step = lambda: torch.autograd.grad(fn(out, gt), out)
    with _precision("default"):
        with FlopCounterMode(display=False) as counter:
            step()
        with torch.no_grad():
            fwd = time_ms(lambda: fn(out, gt), iters=5, warmup=2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        both = time_ms(step, iters=5, warmup=2)
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    flops = counter.get_total_flops()
    x2, gt2 = out[:2].detach(), gt[:2]
    with torch.no_grad():
        want = fn(x2.cpu(), gt2.cpu()).item()
        with tf32_off():
            f32 = fn(x2, gt2).item()
        with _precision("default"):
            shipped = fn(x2, gt2).item()
    rel = {"f32": abs(f32 - want) / abs(want), "shipped": abs(shipped - want) / abs(want)}
    ok = rel["f32"] <= 1e-4 and math.isfinite(shipped)
    print(f"CLIP term ({SIGLIP}, batch {TRAIN_BATCH}, as shipped): resize + two tower forwards "
          f"{fwd:.3f} ms; with the output's backward {both:.3f} ms; {flops / 1e12:.3f} TFLOP "
          f"counted (TF32 bound {1e3 * flops / PEAK_FLOPS[torch.float32]:.3f} ms); peak memory "
          f"above the inputs {peak:.2f} GB; l_clip_sim of 2 images card vs CPU ({want:.6f}): "
          f"relative {rel['f32']:.2e} with TF32 off (gate 1e-4), {rel['shipped']:.2e} as shipped "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        raise AssertionError("l_clip_sim on the card disagrees with the CPU's")
    return {"fwd_ms": fwd, "ms": both, "tflop": flops / 1e12, "peak_gb": peak, "rel": rel}


def phase_clip_train(seed: int, work: str, card: str, esrgan_flops_step: float) -> dict:
    """The ESRGAN trainer with the CLIP loss (options/cliploss_esrgan_s2naip_
    urban.yml as shipped: bf16, batch 32, G 23 blocks, the ViT-B-16-SigLIP-256
    tower) through the train CLI on phase 9's tree (see the module
    docstring, phase 10)."""
    step = family_step_check(seed, CLIP_CONFIG)
    root = os.path.join(work, "families")
    data, val = os.path.join(root, "data"), os.path.join(root, "val")
    shipped = load_config(CLIP_CONFIG)
    opt = train_opt("smoke_clip", root, data, val, config=CLIP_CONFIG,
                    train={**shipped["train"], "total_iter": CLIP_ITERS},
                    val={**shipped["val"], "val_freq": CLIP_ITERS})
    opt["logger"]["save_checkpoint_freq"] = CLIP_ITERS
    exp = os.path.join(root, "experiments", opt["name"])
    runs = {}
    for total, flags in ((CLIP_ITERS, ()), (CLIP_ITERS + RESUME_ITERS, ("--auto_resume",))):
        opt["train"]["total_iter"] = total
        secs, launches, backwards = run_train(root, opt, *flags)
        rows, val_rows = train_rows(exp)
        first = total - (CLIP_ITERS if not flags else RESUME_ITERS) + 1
        iters = total - first + 1
        new = [r for r in rows if r["iter"] >= first]
        want_launches = RDBS_PER_FORWARD * (iters + (2 if not flags else 1) * N_VAL_CHIPS)
        files = [os.path.join(exp, "models", f"net_{n}_{CLIP_ITERS}.pth") for n in ("g", "d")]
        files.append(os.path.join(exp, "training_states", f"{CLIP_ITERS}.state"))
        ok = ([r["iter"] for r in new] == list(range(first, total + 1))
              and all(np.isfinite(r["l_clip_sim"]) and r["l_clip_sim"] > 0 for r in new)
              and all(np.isfinite(v) for r in new for k, v in r.items() if k.startswith(("l_", "out_")))
              and launches == want_launches and backwards == RDBS_PER_FORWARD * iters
              and len(val_rows) == (2 if not flags else 3) and all(map(os.path.exists, files)))
        print(f"train CLI {CLIP_CONFIG} (bf16, batch {TRAIN_BATCH}) "
              + (f"{iters} iterations + 2 validations of {N_VAL_CHIPS} chips + checkpoint" if not flags
                 else f"--auto_resume to {total}: resumed at iterations {[r['iter'] for r in new]}")
              + f" in {secs:.1f} s; last losses "
              + json.dumps({k: round(v, 5) for k, v in new[-1].items() if k.startswith("l_")})
              + f"; rdb launches {launches} (expected {want_launches}), backwards {backwards} "
              f"(expected {RDBS_PER_FORWARD * iters}) {'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            raise AssertionError(f"train CLI {CLIP_CONFIG} failed its gates")
        runs["launches"] = runs.get("launches", 0) + launches
        runs["backwards"] = runs.get("backwards", 0) + backwards
    term = clip_term(seed, card)
    # the step with and without the CLIP term in turns, on the same tree: the
    # host-bound step's rate moves between runs more than the term costs
    base = train_opt("smoke_clip_base", root, data, val, val=None)
    rates = {"esrgan": [], "cliploss": []}
    for turn, key in enumerate(("esrgan", "cliploss", "cliploss", "esrgan")):
        rates[key].append(train_rate(opt if key == "cliploss" else base, RATE_STEPS,
                                     profile=PROFILE_STEPS if turn == 1 else 0))
    r = rates["cliploss"][0]
    mean = {k: sum(x["samples_s"] for x in v) / len(v) for k, v in rates.items()}
    print(f"train step cliploss (bf16) batch {TRAIN_BATCH}, steady state over {RATE_STEPS} steps: "
          f"{r['samples_s']:.2f} samples/s ({r['step_ms']:.2f} ms a step); data wait "
          f"{r['data_wait_ms']:.2f} ms; split by CUDA events (ms): "
          + ", ".join(f"{k} {v:.2f}" for k, v in r["split_ms"].items())
          + f"; max_memory_allocated {r['max_memory_gb']:.2f} GB; FLOPs a step: CLIP term "
          f"{term['tflop']:.3f} TFLOP beside the ESRGAN step's {esrgan_flops_step / 1e12:.3f} "
          f"[{card}]")
    print("train step in turns (esrgan, cliploss, cliploss, esrgan), samples/s (ms a step): "
          + ", ".join(f"{k} " + " / ".join(f"{x['samples_s']:.2f} ({x['step_ms']:.2f})" for x in v)
                      + f" (mean "
                      f"{mean[k]:.2f}, peak memory {max(x['max_memory_gb'] for x in v):.2f} GB)"
                      for k, v in rates.items()) + f" [{card}]")
    profile_train(r, "cliploss bf16")
    return {"step": step, "runs": runs, "rates": rates, "term": term}


SERVE_CLIENTS, SERVE_REQUESTS, SERIAL_REQUESTS, PROFILE_REQUESTS = 64, 256, 50, 64
SERVE_UNIQUE = 64  # distinct request bodies, sent round-robin


def serve_traffic(port: int, bodies, clients: int, stop, raw: bool = False,
                  results: Optional[list] = None) -> list:
    """POST /v1/sr from a closed loop of `clients` keep-alive connections,
    each sending its next request when its last answer came, until
    stop(request number) is true. Appends (body index, status, answer
    bytes, t_sent, t_done) to `results` as the answers come, and returns
    it. `raw` asks for raw uint8 answers."""
    import http.client
    import threading

    results = [] if results is None else results
    lock, nxt = threading.Lock(), [0]
    headers = {"Accept": "application/octet-stream"} if raw else {}

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            while True:
                with lock:
                    i = nxt[0]
                    nxt[0] += 1
                if stop(i):
                    return
                t0 = time.perf_counter()
                conn.request("POST", "/v1/sr", body=bodies[i % len(bodies)], headers=headers)
                resp = conn.getresponse()
                r = (i % len(bodies), resp.status, resp.read(), t0, time.perf_counter())
                with lock:
                    results.append(r)
                if resp.will_close:
                    conn.close()
                    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        finally:
            conn.close()

    threads = [threading.Thread(target=client) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def requests_n(port: int, bodies, n: int, clients: int, raw: bool = False) -> list:
    """Exactly n requests through serve_traffic."""
    results = serve_traffic(port, bodies, clients, lambda i: i >= n, raw)
    if len(results) != n:
        raise AssertionError(f"{n - len(results)} requests got no answer")
    return results


def within_level(got: np.ndarray, want: np.ndarray) -> bool:
    """gate_levels' test: within 1 level on <= 0.1% of values."""
    if got.shape != want.shape:
        return False
    top, _, apart = levels_apart(got, want)
    return top <= 1 and apart <= 1e-3


def answers(results, raw: bool = False):
    """(body index, decoded [128, 128, 3] answer) of each 200 result; fails
    on any other status."""
    from satlas_sr_tpu_torch.utils.imgio import read_png_bytes

    bad = [r for r in results if r[1] != 200]
    if bad:
        raise AssertionError(f"{len(bad)} answers not 200; first: {bad[0][1]} {bad[0][2][:200]!r}")
    return [(j, np.frombuffer(d, np.uint8).reshape(128, 128, 3) if raw else read_png_bytes(d))
            for j, _, d, _, _ in results]


def gate_answers(what: str, got, expected: dict) -> dict:
    """Each answer within 1 level on <= 0.1% of values of the engine's
    output for its input (expected: {batch: [U, 128, 128, 3]}, the engine at
    batch 64 and at bucket 8); returns how many were bit-equal to each."""
    equal = {b: 0 for b in expected}
    for j, y in got:
        if not any(within_level(y, want[j]) for want in expected.values()):
            raise AssertionError(f"{what}: an answer is outside 1 level on 0.1% of the "
                                 "engine's output for its input")
        for b, want in expected.items():
            equal[b] += int(np.array_equal(y, want[j]))
    return equal


def latency_ms(results) -> tuple:
    lat = [1e3 * (r[4] - r[3]) for r in results]
    return float(np.percentile(lat, 50)), float(np.percentile(lat, 95))


def engine_outputs(engine, inputs: np.ndarray) -> dict:
    """The engine's output for each input at batch 64 and at bucket 8."""
    out8 = [engine.fetch(engine.dispatch(inputs[i:i + 8], bucket=8))
            for i in range(0, len(inputs), 8)]
    return {BATCH: engine.run(inputs), 8: np.concatenate(out8)}


def start_server(server):
    import threading

    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread


def stop_server(server, thread) -> None:
    server.shutdown()
    server.server_close()
    server.ctx["batcher"].close()
    thread.join(timeout=30)


def warmup_batches(batcher) -> dict:
    """The batches _build_engine's warm-up ran: one per bucket."""
    return {b: 1 for b in batcher.buckets}


def gate_launches(what: str, launches: int, batches: dict) -> None:
    """launches = 69 x dispatched batches (warm-up included)."""
    n = sum(batches.values())
    ok = launches == RDBS_PER_FORWARD * n
    print(f"{what}: rdb launches {launches} (expected {RDBS_PER_FORWARD} x {n} batches, by "
          f"bucket {batches}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: {launches} rdb launches for {n} batches")


def add_batches(total: dict, *parts: dict) -> dict:
    for part in parts:
        for b, k in part.items():
            total[b] = total.get(b, 0) + k
    return total


def drive_server(what: str, server, inputs: np.ndarray, bodies, card: str) -> dict:
    """Saturation (SERVE_REQUESTS from SERVE_CLIENTS clients, PNG answers),
    then a serial client (SERIAL_REQUESTS, fill 1, raw answers) through a
    server built with the rdb counts at 0. Gates: launches = 69 x batches,
    every answer 200 and within 1 level on <= 0.1% of the engine's output
    for its input; then a profiler window at saturation. Returns the
    server's thread, its batches by bucket and the engine's outputs."""
    import urllib.request

    from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod

    batcher = server.ctx["batcher"]
    port = server.server_address[1]
    thread = start_server(server)
    t0 = time.perf_counter()
    sat = requests_n(port, bodies, SERVE_REQUESTS, SERVE_CLIENTS)
    rate = SERVE_REQUESTS / (time.perf_counter() - t0)
    fill = batcher.images_total / batcher.batches_total
    sat_buckets = dict(batcher.bucket_batches)
    serial = requests_n(port, bodies, SERIAL_REQUESTS, 1, raw=True)
    torch.cuda.synchronize()
    launches = rdb_mod.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    batches = add_batches(warmup_batches(batcher), batcher.bucket_batches)
    gate_launches(what, launches, batches)
    expected = engine_outputs(batcher.engine, inputs)
    eq_sat = gate_answers(f"{what} saturation", answers(sat), expected)
    eq_serial = gate_answers(f"{what} serial", answers(serial, raw=True), expected)
    (p50, p95), (s50, s95) = latency_ms(sat), latency_ms(serial)
    stats = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30).read())
    print(f"{what}: saturation {rate:.2f} requests/s ({SERVE_CLIENTS} clients, {SERVE_REQUESTS} "
          f"requests), p50 {p50:.3f} ms, p95 {p95:.3f} ms, mean fill {fill:.2f}, batches by "
          f"bucket {sat_buckets}; serial (fill 1) p50 {s50:.3f} ms, p95 {s95:.3f} ms over "
          f"{SERIAL_REQUESTS} requests; server /stats p50 {stats['latency_ms']['p50']} ms, "
          f"p95 {stats['latency_ms']['p95']} ms, errors {stats['errors_total']}; peak memory "
          f"{peak:.2f} GB; every answer 200 and within 1 level on <= 0.1%; bit-equal to the "
          f"engine at batch 64 / bucket 8: saturation {eq_sat[BATCH]} / {eq_sat[8]} of "
          f"{SERVE_REQUESTS}, serial {eq_serial[BATCH]} / {eq_serial[8]} of {SERIAL_REQUESTS} "
          f"[{card}]")
    serving_window(port, bodies, card)
    return {"thread": thread, "batches": batches, "expected": expected}


def serving_window(port: int, bodies, card: str) -> None:
    """A torch.profiler window over PROFILE_REQUESTS at saturation: the
    device's busy time against the window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        requests_n(port, bodies, PROFILE_REQUESTS, SERVE_CLIENTS)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    traced = device_busy(prof)
    if traced is not None:
        kernels, busy, _ = traced
        print(f"  profiler, {PROFILE_REQUESTS} requests at saturation: {len(kernels)} device "
              f"kernels, busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms of wall time, idle "
              f"share {1 - busy / wall_us:.4f} (the profiler slows the host) [{card}]")


def hot_reload(server, art_b: str, inputs: np.ndarray, bodies, expected_a: dict, card: str) -> dict:
    """POST /admin/reload to art_b under a closed loop of SERVE_CLIENTS
    clients, from its SERVE_REQUESTS // 4-th answer to SERVE_REQUESTS
    answers after the swap. Gates: every answer 200; the answers to requests
    sent after the reload returned match the new weights, those done before
    it began the old; launches = 69 x batches of both engines (the new one's
    warm-up included); reload_generation 1. Returns the batches by bucket."""
    import threading
    import urllib.request

    from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod

    port = server.server_address[1]
    old = server.ctx["batcher"]
    old_before = dict(old.bucket_batches)
    rdb_mod.LAUNCHES = 0
    halt, results = threading.Event(), []
    traffic = threading.Thread(target=serve_traffic, args=(
        port, bodies, SERVE_CLIENTS, lambda i: halt.is_set()), kwargs={"results": results})
    traffic.start()

    def wait_for(n: int) -> None:
        deadline = time.time() + 600
        while len(results) < n and time.time() < deadline:
            time.sleep(0.01)

    wait_for(SERVE_REQUESTS // 4)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/admin/reload", method="POST",
                                 data=json.dumps({"artifact": art_b}).encode(),
                                 headers={"X-Admin-Token": "chip-smoke"})
    t_begin = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        info = json.loads(resp.read())
    t_end = time.perf_counter()
    wait_for(len(results) + SERVE_REQUESTS)
    halt.set()
    traffic.join()
    torch.cuda.synchronize()
    launches = rdb_mod.LAUNCHES
    new = server.ctx["batcher"]
    batches = add_batches({b: k - old_before[b] for b, k in old.bucket_batches.items()},
                          warmup_batches(new), new.bucket_batches)
    gate_launches("hot reload", launches, batches)
    health = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                               timeout=30).read())
    if info.get("generation") != 1 or health["reload_generation"] != 1 or new is old:
        raise AssertionError(f"reload: {info}, healthz {health}")
    expected_b = engine_outputs(new.engine, inputs)
    got = answers(results)
    after = [g for g, r in zip(got, results) if r[3] > t_end]
    before = [g for g, r in zip(got, results) if r[4] < t_begin]
    if not after or not before:
        raise AssertionError(f"reload: {len(before)} answers before it, {len(after)} after it")
    gate_answers("reload: requests sent after the swap, against the new weights", after, expected_b)
    gate_answers("reload: requests done before it, against the old weights", before, expected_a)
    for j, y in got:  # the rest: one or the other
        if not any(within_level(y, e[j]) for e in (*expected_a.values(), *expected_b.values())):
            raise AssertionError("reload: an answer matches neither weights")
    print(f"hot reload under load: {len(results)} answers, all 200 (no 5xx); {len(after)} sent "
          f"after the swap returned, all on the new weights; {len(before)} done before it "
          f"began, on the old; {len(results) - len(after) - len(before)} in between, on either; "
          f"the reload took {1e3 * (t_end - t_begin):.1f} ms (artifact load + warm-up of "
          f"{new.buckets}); generation {health['reload_generation']} [{card}]")
    return batches


@contextlib.contextmanager
def direct_trunk():
    """The trunk's no-grad RDB calls straight to `_launch`, the route before
    the satlas_sr_torch::rdb op (a comparison, not the product path)."""
    from satlas_sr_tpu_torch.archs import rrdbnet
    from satlas_sr_tpu_torch.ops.cuda.rdb import _launch

    orig = rrdbnet.rdb
    rrdbnet.rdb = lambda x, k, b, nf, g, packed=None: _launch(x, packed, nf, g)
    try:
        yield
    finally:
        rrdbnet.rdb = orig


def op_overhead(seed: int, weights: str, card: str) -> None:
    """What the op costs the host, in turns (op, direct, direct, op) x 2: one
    bf16 RDB call at [1, 32, 32, 64] in a Python loop through `rdb` (the op)
    and through `_launch`, and the bf16 engine's forward at batch 64 with
    its trunk routed either way (CUDA events over eager calls, so host time
    shows where it exceeds the device's)."""
    from satlas_sr_tpu_torch.archs import RRDBNet
    from satlas_sr_tpu_torch.inference import InferenceEngine
    from satlas_sr_tpu_torch.ops.cuda.rdb import _launch, pack_weights, rdb
    from satlas_sr_tpu_torch.utils.torch_io import load_torch_state_dict

    gen = torch.Generator().manual_seed(seed + 12)
    x = torch.randn(1, HW, HW, NF, generator=gen).cuda().bfloat16()
    kernels = [(torch.randn(G if k < 4 else NF, NF + k * G, 3, 3, generator=gen) * 0.05)
               .cuda().bfloat16() for k in range(5)]
    biases = [torch.zeros(G if k < 4 else NF, device="cuda") for k in range(5)]
    packed = pack_weights(kernels, biases, NF, G, torch.bfloat16)
    net = dict(num_in_ch=IN_CH, num_out_ch=3, num_feat=NF, num_block=NUM_BLOCK, num_grow_ch=G)
    engine = InferenceEngine(RRDBNet(scale=4, device="cpu", dtype=torch.bfloat16, **net),
                             load_torch_state_dict(weights), batch_size=BATCH, device="cuda")
    xe = torch.rand(BATCH, HW, HW, IN_CH, device="cuda").bfloat16()
    calls = {"op": lambda: rdb(x, kernels, biases, NF, G, packed=packed),
             "direct": lambda: _launch(x, packed, NF, G)}
    turns = []
    with torch.no_grad(), tf32_off():
        for route in ("op", "direct", "direct", "op") * 2:
            call = time_ms(calls[route], iters=500, warmup=20)
            with direct_trunk() if route == "direct" else contextlib.nullcontext():
                fwd = time_ms(lambda: engine.model(xe), iters=10, warmup=1)
            turns.append((route, call, fwd))
    median = lambda route, k: np.median([t[k] for t in turns if t[0] == route])
    print("rdb op overhead, in turns (op, direct, direct, op) x 2: bf16 call at [1, 32, 32, 64] "
          f"in a Python loop {' / '.join(f'{t[1]:.4f}' for t in turns)} ms (medians: op - direct "
          f"{1e3 * (median('op', 1) - median('direct', 1)):.1f} us a call); bf16 engine forward "
          f"at batch {BATCH} {' / '.join(f'{t[2]:.3f}' for t in turns)} ms (medians: op - direct "
          f"{median('op', 2) - median('direct', 2):.3f} ms a forward of {RDBS_PER_FORWARD} "
          f"calls) [{card}]")


def phase_serve(seed: int, work: str, weights: str, card: str) -> dict:
    """Phase 11 (see the module docstring): export and the serving daemon at
    full width in both dtypes. Returns the timed [8, 32, 32, 64] kernel rows
    and the rdb launches of the servers by dtype and bucket."""
    from satlas_sr_tpu_torch.archs import RRDBNet
    from satlas_sr_tpu_torch.export import export_artifact
    from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod
    from satlas_sr_tpu_torch.serve import build_server
    from satlas_sr_tpu_torch.utils.imgio import encode_png_bytes
    from satlas_sr_tpu_torch.utils.infer_utils import format_s2naip_data
    from satlas_sr_tpu_torch.utils.torch_io import save_torch_state_dict

    rows = phase_kernels_at(seed, 8, HW)
    op_overhead(seed, weights, card)
    root = os.path.join(work, "serve")
    os.makedirs(root)
    net = dict(num_in_ch=IN_CH, num_out_ch=3, num_feat=NF, num_block=NUM_BLOCK, num_grow_ch=G)
    weights_b = os.path.join(root, "esrgan_8S2_seeded_b.pth")
    save_torch_state_dict(weights_b, RRDBNet(scale=4, seed=seed + 1, device="cpu", **net)
                          .state_dict(), param_key="params_ema")
    rng = np.random.RandomState(seed + 11)
    series = [(rng.rand(N_FRAMES * 32, 32, 3) * 254 + 1).astype(np.uint8)
              for _ in range(SERVE_UNIQUE)]
    bodies = [encode_png_bytes(s) for s in series]
    launches = {}
    for dtype in ("float32", "bfloat16"):
        opt = load_config("infer_example.yml", weights=weights, compute_dtype=dtype)
        opt_b = load_config("infer_example.yml", weights=weights_b, compute_dtype=dtype)
        rng_seed = int(opt.get("manual_seed") or 0)  # the server's frame selection
        inputs = np.stack([format_s2naip_data(s, N_LR, rng=np.random.RandomState(rng_seed))[0]
                           for s in series])
        art, art_b = (os.path.join(root, f"esrgan_8S2_{k}{dtype}.ssrx") for k in ("", "b_"))
        t0 = time.time()
        meta = export_artifact(opt, art, buckets=[8], check=True)
        print(f"export {dtype}: {time.time() - t0:.3f} s, {os.path.getsize(art) / 1e6:.1f} MB, "
              f"platforms {meta['platforms']}, buckets {meta['bucket_batches']}, checked "
              f"{meta['checked']} (bit-exact at batch 64 and bucket 8) [{card}]")
        if not meta["checked"]:
            raise AssertionError("export --check did not run on the card")
        t0 = time.time()
        export_artifact(opt_b, art_b, buckets=[8], check=True, platforms=("cuda",))
        print(f"export {dtype}, second weights, cuda only: {time.time() - t0:.3f} s, "
              f"{os.path.getsize(art_b) / 1e6:.1f} MB")

        total = {}
        for label, artifact in (("live", None), ("artifact", art)):
            torch.cuda.reset_peak_memory_stats()
            rdb_mod.LAUNCHES = 0
            server, _ = build_server(opt, port=0, buckets=[8], artifact=artifact,
                                     admin_token="chip-smoke")
            run = drive_server(f"{label} server {dtype}", server, inputs, bodies, card)
            add_batches(total, run["batches"])
            if artifact is None:
                stop_server(server, run["thread"])
        add_batches(total, hot_reload(server, art_b, inputs, bodies, run["expected"], card))
        stop_server(server, run["thread"])
        launches[dtype] = {b: RDBS_PER_FORWARD * k for b, k in total.items()}
        gc.collect()
        torch.cuda.empty_cache()
    print(f"serving: rdb launches by bucket {json.dumps(launches)}")
    return {"rows": rows, "launches": launches}


ACCEPT_CHIPS, ACCEPT_BATCH = 16, 4  # phase 12's val tree and acceptance's default batch
WARP_SHAPE = (4, NF, 64, 64)  # x [N, C, H, W] of the warp ops' check


def warp_check(seed: int, card: str) -> dict:
    """DCNv2Pack (nf 64, random offsets and mask) and flow_warp on x
    [4, 64, 64, 64] in float32 with TF32 off: forward and input gradient on
    the card against the port's CPU run, within 1e-4 of each one's max;
    CUDA-event times of the forward and forward + backward."""
    from satlas_sr_tpu_torch.archs.blocks import DCNv2Pack, init_weights
    from satlas_sr_tpu_torch.ops.warp import flow_warp

    gen = torch.Generator().manual_seed(seed + 20)
    x = torch.rand(*WARP_SHAPE, generator=gen)
    feat = torch.rand(*WARP_SHAPE, generator=gen)
    flow = (torch.rand(WARP_SHAPE[0], *WARP_SHAPE[2:], 2, generator=gen) - 0.5) * 6
    cot = torch.randn(*WARP_SHAPE, generator=gen)
    dcn = DCNv2Pack(NF, NF)
    dcn.to_empty(device="cpu")
    init_weights(dcn, gen)
    with torch.no_grad():  # offsets of a few pixels, a mask away from 0.5
        dcn.conv_offset.weight.copy_(torch.randn(dcn.conv_offset.weight.shape, generator=gen) * 0.05)
    ops = {"dcnv2": lambda m, a, b: m(a, b), "flow_warp": lambda m, a, b: flow_warp(a, b)}
    out = {}
    with tf32_off():
        for name, op in ops.items():
            other = feat if name == "dcnv2" else flow
            res = {}
            for dev in ("cpu", "cuda"):
                m = dcn.to(dev)
                a = x.detach().to(dev).requires_grad_()
                y = op(m, a, other.to(dev))
                (y * cot.to(dev)).sum().backward()
                res[dev] = (y.detach().cpu(), a.grad.cpu())
            errs = [((g - w).abs().max() / w.abs().max()).item()
                    for g, w in zip(res["cuda"], res["cpu"])]
            m, a, b = dcn.cuda(), x.cuda(), other.cuda()
            fwd = time_ms(lambda: op(m, a, b), iters=10)
            a.requires_grad_()
            bwd = time_ms(lambda: (op(m, a, b) * 1.0).sum().backward(), iters=10)
            ok = max(errs) <= 1e-4
            print(f"{name} x {list(WARP_SHAPE)} f32, card vs CPU (TF32 off): forward "
                  f"{errs[0]:.3e}, input gradient {errs[1]:.3e} of their max (bound 1e-4) "
                  f"{'ok' if ok else 'FAIL'}; forward {fwd:.3f} ms, forward + backward "
                  f"{bwd:.3f} ms [{card}]")
            if not ok:
                raise AssertionError(f"{name} on the card disagrees with the CPU")
            out[name] = dict(forward_err=errs[0], grad_err=errs[1], ms=fwd, fwd_bwd_ms=bwd)
    return out


@contextlib.contextmanager
def launches_by(counts: dict):
    """Count the rdb kernel's launches by (dtype, batch) while in the block
    (the product's LAUNCHES counts them all together)."""
    from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod

    orig = rdb_mod._launch

    def counted(x, *args, **kwargs):
        key = ("bf16" if x.dtype == torch.bfloat16 else "f32", x.shape[0])
        counts[key] = counts.get(key, 0) + 1
        return orig(x, *args, **kwargs)

    rdb_mod._launch = counted
    try:
        yield counts
    finally:
        rdb_mod._launch = orig


GENERATOR_ATOL = 1e-3  # phase 3's bound on the f32 generator through the kernel vs the plain trunk


def acceptance_run(root: str, tree: str, weights: str, tag: str, *flags: str):
    """One `acceptance --no-download` on the card, rdb launches counted by
    (dtype, batch): (exit code, verdict, total launches, counts, seconds)."""
    from satlas_sr_tpu_torch import acceptance
    from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod

    out = os.path.join(root, f"PARITY_RESULTS_{tag}.json")
    rdb_mod.LAUNCHES = 0
    t0 = time.time()
    with launches_by({}) as counts:
        rc = acceptance.main(["--weights", weights, "--data", tree, "--workdir",
                              os.path.join(root, "ws"), "--no-download", "--out", out, *flags])
    dt = time.time() - t0
    v = json.load(open(out))
    print(f"acceptance ({tag}): exit {rc}, pass {v['pass']}, {dt:.1f} s, stages "
          f"{json.dumps({k: [s['ok'], s.get('seconds')] for k, s in v['stages'].items()})}; "
          f"forward max|d| {v['stages']['forward'].get('max_abs_diff')!r}, uint8 agreement "
          f"{v['stages']['forward'].get('uint8_agreement_psnr_db')!r} dB")
    return rc, v, rdb_mod.LAUNCHES, counts, dt


def forward_breakdown(weights: str, card: str) -> None:
    """Where the forward stage's max|d| comes from, on its input (batch 2,
    RandomState(0)): the port's generator through the kernel and through the
    plain trunk (cuDNN) on the card, the oracle on the card and on the CPU,
    all float32 with TF32 off."""
    from satlas_sr_tpu_torch.archs import RRDBNet
    from satlas_sr_tpu_torch.utils import torch_oracles
    from satlas_sr_tpu_torch.utils.torch_io import load_torch_state_dict

    state = load_torch_state_dict(weights)
    x = torch.from_numpy(np.random.RandomState(0).rand(2, HW, HW, IN_CH).astype(np.float32))
    model = RRDBNet(num_in_ch=IN_CH, num_out_ch=3, scale=4, device="cpu")
    model.load_state_dict(state)
    model = model.cuda().eval()
    with torch.no_grad(), tf32_off():
        ys = {"kernel": model(x.cuda()).cpu()}
        with plain_trunk():
            ys["plain trunk"] = model(x.cuda()).cpu()
        for dev in ("cuda", "cpu"):
            sd = {k: v.float().to(dev) for k, v in state.items()}
            ys[f"oracle {dev}"] = torch_oracles.rrdbnet_forward(
                sd, x.to(dev).permute(0, 3, 1, 2), NUM_BLOCK, 4).permute(0, 2, 3, 1).cpu()
    peak = ys["oracle cpu"].abs().max().item()
    pairs = [("kernel", "oracle cuda"), ("plain trunk", "oracle cuda"), ("oracle cuda", "oracle cpu"),
             ("kernel", "oracle cpu"), ("plain trunk", "oracle cpu")]
    print(f"forward stage breakdown, f32 TF32 off, output max|y| {peak:.4f} (float32 ulp there "
          f"{float(np.spacing(np.float32(peak))):.3e}): " + "; ".join(
              f"{a} vs {b} {(ys[a] - ys[b]).abs().max().item():.4e}" for a, b in pairs) + f" [{card}]")


def tools_acceptance(root: str, tree: str, weights: str, card: str) -> dict:
    """acceptance --no-download on the seeded esrgan_8S2 .pth and the tree, on
    the card (batch 4). At the CLI's defaults first: exit 0 and pass, or
    else (the f32 kernel's three TF32 products against cuDNN in f32, on
    seeded weights whose output reaches ~74) exit 2 with the forward stage
    the only failure and its max|d| within phase 3's generator bound, 1e-3,
    printed with its breakdown as the finding. Then with --fwd-tol at that
    bound, so the evaluate and engine legs run: exit 0 and pass; the CLIP
    leg skipped; rdb launches = 69 x the forwards of the port's generator
    and engines. Returns the second run's launches at batch 4 by dtype."""
    rc, v, launches, counts, _ = acceptance_run(root, tree, weights, "defaults")
    fwd = v["stages"]["forward"]
    failed = [k for k, st in v["stages"].items() if not st["ok"]]
    if rc != 0 or not v["pass"]:
        forward_breakdown(weights, card)
        if not (rc == 2 and failed == ["forward"] and fwd["max_abs_diff"] <= GENERATOR_ATOL
                and launches == RDBS_PER_FORWARD and counts == {("f32", 2): RDBS_PER_FORWARD}):
            raise AssertionError(f"acceptance at its defaults: exit {rc}, verdict "
                                 f"{json.dumps(v['stages'])}, {launches} rdb launches")
        print(f"acceptance at its defaults misses the forward bar on the card: max|d| "
              f"{fwd['max_abs_diff']!r} > fwd-tol 1e-4 (a finding, not a pass); the other "
              f"stages run below at fwd-tol {GENERATOR_ATOL:g}, phase 3's generator bound")
        rc, v, launches, counts, _ = acceptance_run(root, tree, weights, "fwd_tol_1e-3",
                                                     "--fwd-tol", str(GENERATOR_ATOL))
    st = v["stages"]
    if rc != 0 or not v["pass"]:
        raise AssertionError(f"acceptance on the card: exit {rc}, verdict {json.dumps(st)}")
    ev, prod = st["evaluate"], st["bf16_engine"]
    n = ev["images_evaluated"]
    k = -(-n // ACCEPT_BATCH)
    print(f"acceptance evaluate ({n} images): PSNR ours {ev['metrics']['jax']['psnr']!r} / "
          f"oracle {ev['metrics']['torch_oracle']['psnr']!r} dB, dPSNR "
          f"{ev['delta_psnr_db']!r}, dcPSNR {ev['delta_cpsnr_db']!r}, dSSIM "
          f"{abs(ev['metrics']['jax']['ssim'] - ev['metrics']['torch_oracle']['ssim'])!r}; "
          f"clipscore {json.dumps(ev.get('clipscore'))} [{card}]")
    print(f"acceptance engines: bf16 vs the f32 eval dPSNR {prod['delta_bf16_vs_eval_db']}, "
          f"f32 engine {prod['delta_f32_engine_vs_eval_db']}, bf16 vs f32 engine "
          f"{prod['delta_bf16_vs_f32_engine_db']}; at_parity_engine {v['at_parity_engine']}")
    if "skipped" not in ev.get("clipscore", {}):
        raise AssertionError("the CLIP leg ran on a random tower")
    want = {("f32", 2): RDBS_PER_FORWARD, ("f32", ACCEPT_BATCH): 2 * k * RDBS_PER_FORWARD,
            ("bf16", ACCEPT_BATCH): k * RDBS_PER_FORWARD}
    print(f"acceptance rdb launches {launches} (expected {RDBS_PER_FORWARD} x {1 + 3 * k} "
          f"forwards: the forward stage at batch 2, {k} batches of the eval and of each "
          f"engine); by (dtype, batch) {sorted(counts.items())}")
    if launches != RDBS_PER_FORWARD * (1 + 3 * k) or counts != want:
        raise AssertionError(f"acceptance: {launches} rdb launches, {counts}")
    return {"bf16": counts[("bf16", ACCEPT_BATCH)], "f32": counts[("f32", ACCEPT_BATCH)]}


def tools_profile(root: str, weights: str, card: str) -> None:
    """profile on infer_example.yml (float32 as shipped, bfloat16 by
    compute_dtype) and on esrgan_s2naip_urban.yml (the bf16 train step), 5
    steps each: the summary names the route's RDB kernel at 5 x 69 launches
    a step (one generator forward a step)."""
    from satlas_sr_tpu_torch import profile

    infer = write_yml(load_config("infer_example.yml", weights=weights),
                      os.path.join(root, "infer_example.yml"))
    runs = (("infer f32", infer, None, "dense_conv3x3_tf32x3"),
            ("infer bf16", infer, ["compute_dtype=bfloat16"], "dense_conv3x3_wgmma"),
            ("train bf16", os.path.join(REPO, "options", "esrgan_s2naip_urban.yml"), None,
             "dense_conv3x3_wgmma"))
    for label, yml, force, kernel in runs:
        s = profile.run_profile(yml, steps=PROFILE_STEPS, out=os.path.join(root, "trace"),
                                device="cuda", force_yml=force)
        if s is None:
            raise AssertionError(f"profile {label}: no device time in the trace")
        per_step = sum(c for name, (_, c) in s["kernels"].items() if kernel in name)
        ms = sum(t for name, (t, _) in s["kernels"].items() if kernel in name)
        print(f"profile {label}: {s['ms_per_step']:.3f} ms/step, device busy "
              f"{s['busy_ms_per_step']:.3f} ms/step, idle share {s['idle_share']:.4f}; "
              f"{kernel} {per_step:g} launches/step (expected {5 * RDBS_PER_FORWARD}), "
              f"{ms:.3f} ms/step [{card}]")
        if per_step != 5 * RDBS_PER_FORWARD:
            raise AssertionError(f"profile {label}: {kernel} {per_step} launches a step")
        if any(name.startswith(("ProfilerStep", "Optimizer.")) for name in s["kernels"]):
            raise AssertionError(f"profile {label}: user annotations counted as device work")
        gc.collect()
        torch.cuda.empty_cache()


def tools_warmup(root: str, weights: str) -> None:
    """warmup on esrgan_s2naip_urban.yml and infer_example.yml, twice in one
    process: the second finds the kernel built."""
    import io

    from satlas_sr_tpu_torch import warmup

    infer = write_yml(load_config("infer_example.yml", weights=weights),
                      os.path.join(root, "infer_example.yml"))
    for turn in (1, 2):
        for yml in (os.path.join(REPO, "options", "esrgan_s2naip_urban.yml"), infer):
            buf = io.StringIO()
            t0 = time.time()
            with contextlib.redirect_stdout(buf):
                warmup.main(["-opt", yml])
            text = buf.getvalue()
            print(f"warmup {os.path.basename(yml)} (turn {turn}): {time.time() - t0:.1f} s; "
                  + "; ".join(line for line in text.splitlines() if line.startswith("[warmup]")))
            if turn == 2 and "rdb.cu found built" not in text:
                raise AssertionError("warmup's second turn rebuilt the kernel")
            gc.collect()
            torch.cuda.empty_cache()


def tools_doctor(root: str, tree: str, weights: str, kind: str) -> None:
    """doctor --device cuda on infer_example.yml pointed at the tree and the
    seeded weights: exit 0, the card named, the native codec, the kernel
    build ok."""
    from satlas_sr_tpu_torch import doctor

    opt = load_config("infer_example.yml", weights=weights,
                      data_dir=os.path.join(tree, "sentinel2"))
    rc = doctor.main(["-opt", write_yml(opt, os.path.join(root, "doctor.yml"))])
    rows = doctor.diagnose(opt).rows
    by_area = {}
    for level, area, msg in rows:
        by_area.setdefault(area, []).append((level, msg))
    print(f"doctor: exit {rc}; devices {by_area.get('devices')}; native png "
          f"{by_area.get('native png')}; kernel build {by_area.get('kernel build')}")
    if (rc != 0 or not any(kind in m for _, m in by_area.get("devices", []))
            or not by_area["native png"][0][1].startswith("native")
            or any(lv != "ok" for lv, _ in by_area.get("kernel build", [("missing", "")]))):
        raise AssertionError("doctor on the card: see the rows above")


def tools_ckpt(root: str, weights: str, state: str) -> None:
    """ckpt on the seeded .pth and a train run's .state: exit 0; a copy of the
    .state with one byte flipped: exit 1."""
    from satlas_sr_tpu_torch import ckpt

    bad = os.path.join(root, "flipped.state")
    blob = bytearray(open(state, "rb").read())
    blob[len(blob) // 3] ^= 0x5A
    open(bad, "wb").write(bytes(blob))
    rcs = {}
    for path in (weights, state, bad):
        info = ckpt.inspect(path)
        rcs[path] = ckpt.main([path, "--json"]) if path == bad else ckpt.main([path])
        print(f"ckpt {os.path.basename(path)}: exit {rcs[path]}, {info['status']}, step "
              f"{info.get('step')}, collections {json.dumps(info.get('collections'))}, "
              f"{info.get('error', '')}")
    if [rcs[weights], rcs[state], rcs[bad]] != [0, 0, 1]:
        raise AssertionError(f"ckpt exit codes {list(rcs.values())}")


def tools_scan(root: str, tree: str, made_bad: dict) -> None:
    """scan_data on the tree after a few more chips are made bad: the report
    counts exactly those chips, and --strict exits 1."""
    from satlas_sr_tpu_torch import scan_data

    chips = sorted(os.listdir(os.path.join(tree, "naip")))
    tci = os.path.join(tree, "sentinel2", chips[10], "tci.png")
    open(tci, "wb").write(open(tci, "rb").read()[:60])  # a torn band png
    open(os.path.join(tree, "naip", chips[12], f"{chips[12]}.png"), "wb").write(b"not a png")
    want = {"naip_black_pixels": made_bad["black_naip"], "too_few_frames": made_bad["few_frames"],
            "bands_invalid": 1, "naip_unreadable": 1, "all_frames_black": 0}
    opt = {"datasets": {"train": {"type": "S2NAIPDataset", "n_s2_images": N_LR,
                                  "sentinel2_path": os.path.join(tree, "sentinel2"),
                                  "naip_path": os.path.join(tree, "naip")}}}
    report_path = os.path.join(root, "scan.json")
    rc = scan_data.main(["-opt", write_yml(opt, os.path.join(root, "scan.yml")), "--json",
                         report_path, "--strict"])
    report = json.load(open(report_path))
    got = {k: v["count"] for k, v in report["issues"].items()}
    print(f"scan_data: exit {rc} (--strict), {report['chips_scanned']} scanned, "
          f"{report['chips_unusable']} unusable, issues {got} (made bad: {want})")
    if rc != 1 or got != want or report["chips_unusable"] != sum(want.values()):
        raise AssertionError("scan_data's report differs from the chips made bad")


def phase_tools(seed: int, work: str, weights: str, state: Optional[str], card: str) -> dict:
    """Phase 12 (see the module docstring): the arch ops and the run tooling.
    `state` is a train run's .state (phase 8's), or None to write one from a
    seeded generator. Returns the [4, 32, 32, 64] kernel rows and
    acceptance's launches at batch 4 by dtype."""
    from satlas_sr_tpu_torch.archs import RRDBNet
    from satlas_sr_tpu_torch.utils.checkpoint import save_state

    root = os.path.join(work, "tools")
    os.makedirs(root)
    warp = warp_check(seed, card)
    rows = phase_kernels_at(seed, ACCEPT_BATCH, HW)
    tree = os.path.join(root, "tree")
    made_bad = make_s2naip_tree(tree, np.random.RandomState(seed + 21), ACCEPT_CHIPS)
    launches = tools_acceptance(root, tree, weights, card)
    tools_profile(root, weights, card)
    tools_warmup(root, weights)
    tools_doctor(root, tree, weights, torch.cuda.get_device_name(0))
    if state is None:
        state = os.path.join(root, "seeded.state")
        net = RRDBNet(num_in_ch=IN_CH, num_out_ch=3, seed=seed, device="cpu")
        save_state(state, {"epoch": 0, "iter": 0, "state": {"step": 0, "g": net.state_dict()}})
    tools_ckpt(root, weights, state)
    tools_scan(root, tree, made_bad)
    return {"rows": rows, "launches": launches, "warp": warp}


# phase 13: accumulation, remat, tune, .msgpack, prepare, the tower dry-run
ACCUM_K, ACCUM_B, ACCUM_SAVE, ACCUM_ITERS = 8, 4, 4, 6  # optimizer batch 32 = 8 x 4
RECIPE_B, RECIPE_K, RECIPE_CHIPS = 32, 8, 272  # MIGRATION.md's global batch 256 on one card
EQUIV_K = 2  # accum 2 x 16 against one native batch-32 step
REMAT_MODES = (False, "block", "rdb")
NATIVE_STEP_GB = 3.56  # the native bf16 batch-32 step's peak memory (PERF.md section 5, PR 8)


def accum_opt(name: str, root: str, data: str, val: str, k: int, b: int, **over) -> dict:
    """esrgan_s2naip_urban.yml as shipped with train.accum_steps k and
    batch_size_per_gpu b (an optimizer batch of k x b), no validation."""
    cfg = load_config("esrgan_s2naip_urban.yml")
    opt = train_opt(name, root, data, val, train={**cfg["train"], "accum_steps": k}, val=None,
                    **over)
    opt["datasets"]["train"]["batch_size_per_gpu"] = b
    return opt


def write_tile_weights(data: str, seed: int) -> None:
    chips = sorted(os.listdir(os.path.join(data, "naip")))
    weights = np.random.RandomState(seed).rand(len(chips)) * 10 + 0.1
    with open(os.path.join(data, "tile_weights.json"), "w") as f:
        json.dump(dict(zip(chips, weights.tolist())), f)


def first_batch(opt: dict) -> dict:
    """One batch of accum_steps x batch_size_per_gpu rows from the real loader."""
    from satlas_sr_tpu_torch.data import build_dataset, build_train_loader

    ds = opt["datasets"]["train"]
    rows = int(ds["batch_size_per_gpu"]) * int(opt["train"].get("accum_steps", 1))
    loader = build_train_loader(build_dataset(ds), {**ds, "batch_size_per_gpu": rows}, seed=0)
    try:
        return next(iter(loader))
    finally:
        loader.stop()


def accum_equivalence(root: str, data: str, val: str, card: str) -> None:
    """One step of accum_steps 2 x batch 16 against one native batch-32 step
    on the same 32 rows from the same seed, float32 with TF32 off, the GAN
    weight at 0 (every G loss term a per-sample mean, so the two updates
    agree; D's power iterations legitimately differ). Held: each G gradient
    within 1e-4 of its max; the G params and the EMA within rtol 1e-4, atol
    2e-5 (tests/test_training.py:579's bar) on every element whose gradient
    is above its tensor's noise floor (1e-4 of the max). Below that floor
    the two reduction orders round a gradient of ~1e-8 to opposite signs,
    and Adam's first step (lr x g / (|g| + eps)) turns each into +-lr: those
    elements are counted and printed, and held to Adam's one-step bound
    2 lr."""
    from satlas_sr_tpu_torch.models import build_model
    from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod

    models, launches, batch = {}, {}, None
    for k in (1, EQUIV_K):
        o = accum_opt(f"equiv_{k}", root, data, val, k, TRAIN_BATCH // k,
                      compute_dtype="float32", matmul_precision="highest", is_train=True)
        o["train"]["gan_opt"]["loss_weight"] = 0.0
        if batch is None:  # the native step's 32 rows, for both
            batch = first_batch(o)
        with tf32_off():
            models[k] = build_model(o, device="cuda")
            rdb_mod.LAUNCHES = rdb_mod.BACKWARDS = 0
            models[k].train_iter(batch, 1)
            torch.cuda.synchronize()
        launches[k] = (rdb_mod.LAUNCHES, rdb_mod.BACKWARDS)
    lr = float(o["train"]["optim_g"]["lr"])
    grad_rel = outside = quiet_outside = elements = 0
    worst = {"net_g": 0.0, "net_g_ema": 0.0}
    ok = True
    for a, b in zip(models[1].net_g.parameters(), models[EQUIV_K].net_g.parameters()):
        g_scale = a.grad.abs().max()
        grad_rel = max(grad_rel, ((a.grad - b.grad).abs().max() / g_scale).item())
        d = (a - b).abs()
        off = d > 2e-5 + 1e-4 * a.abs()
        quiet = a.grad.abs() <= 1e-4 * g_scale
        outside += int(off.sum())
        quiet_outside += int((off & quiet).sum())
        ok &= bool(d[off].le(2 * lr * (1 + 1e-3)).all()) if off.any() else True
        worst["net_g"] = max(worst["net_g"], d.max().item())
        elements += a.numel()
    for a, b in zip(models[1].net_g_ema.parameters(), models[EQUIV_K].net_g_ema.parameters()):
        worst["net_g_ema"] = max(worst["net_g_ema"], (a - b).abs().max().item())
        ok &= torch.allclose(b, a, rtol=1e-4, atol=2e-5)
    ok &= grad_rel <= 1e-4 and outside == quiet_outside
    ok &= launches == {1: (RDBS_PER_FORWARD, RDBS_PER_FORWARD),
                       EQUIV_K: (EQUIV_K * RDBS_PER_FORWARD, EQUIV_K * RDBS_PER_FORWARD)}
    print(f"accumulation equivalence, f32 TF32 off, GAN weight 0: {EQUIV_K} x "
          f"{TRAIN_BATCH // EQUIV_K} against one batch-{TRAIN_BATCH} step on the same rows: "
          f"G gradients within {grad_rel:.3e} of each tensor's max (bound 1e-4); G params "
          f"max|d| {worst['net_g']:.3e}, {outside} of {elements} elements outside rtol 1e-4 / "
          f"atol 2e-5, all with a gradient below 1e-4 of its tensor's max (Adam's first step "
          f"gives them +-lr: bound 2 lr = {2 * lr:g}); EMA max|d| {worst['net_g_ema']:.3e} "
          f"(every element within the bar); rdb launches/backwards native {launches[1]}, "
          f"accumulated {launches[EQUIV_K]} {'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        raise AssertionError("an accumulated step disagrees with the native batch step")


def accum_train(root: str, data: str, val: str, card: str) -> dict:
    """The train CLI as users run accumulation: bf16 as shipped, accum_steps
    8 x batch 4, ACCUM_SAVE iterations and a checkpoint (.pth, .msgpack,
    .state), --auto_resume to ACCUM_ITERS; rdb launches = 69 x 8 forwards and
    backwards an iteration; then the steady-state rate beside the native
    batch-32 step's peak memory."""
    exp = os.path.join(root, "experiments", "accum_train")
    opt = accum_opt("accum_train", root, data, val, ACCUM_K, ACCUM_B)
    opt["train"]["total_iter"] = ACCUM_SAVE
    opt["logger"]["save_checkpoint_freq"] = ACCUM_SAVE
    secs, launches, backwards = run_train(root, opt)
    rows, _ = train_rows(exp)
    per_iter = RDBS_PER_FORWARD * ACCUM_K
    files = [os.path.join(exp, "models", f"net_{n}_{ACCUM_SAVE}.{ext}")
             for n in ("g", "d") for ext in ("pth", "msgpack")]
    files.append(os.path.join(exp, "training_states", f"{ACCUM_SAVE}.state"))
    finite = all(np.isfinite(v) for r in rows for k, v in r.items() if k.startswith(("l_", "out_")))
    ok = (launches == backwards == per_iter * ACCUM_SAVE and finite
          and [r["iter"] for r in rows] == list(range(1, ACCUM_SAVE + 1))
          and all(map(os.path.exists, files)))
    opt["train"]["total_iter"] = ACCUM_ITERS
    secs2, launches2, backwards2 = run_train(root, opt, "--auto_resume")
    rows2, _ = train_rows(exp)
    resumed = [r["iter"] for r in rows2[len(rows):]]
    ok &= (resumed == list(range(ACCUM_SAVE + 1, ACCUM_ITERS + 1))
           and launches2 == backwards2 == per_iter * (ACCUM_ITERS - ACCUM_SAVE))
    print(f"train CLI bf16 accum_steps {ACCUM_K} x batch {ACCUM_B}: {ACCUM_SAVE} iterations + "
          f"checkpoint {secs:.1f} s, --auto_resume to {ACCUM_ITERS} (resumed at {resumed}) "
          f"{secs2:.1f} s; rdb launches {launches} / {launches2}, backwards {backwards} / "
          f"{backwards2} (expected 69 x {ACCUM_K} an iteration); last losses "
          + json.dumps({k: round(v, 5) for k, v in rows2[-1].items() if k.startswith("l_")})
          + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("train CLI with accum_steps failed its gates")
    r = train_rate(opt, 2, warmup=2)
    print(f"train step bf16 accum_steps {ACCUM_K} x batch {ACCUM_B} (optimizer batch "
          f"{ACCUM_K * ACCUM_B}), steady state over 2 steps: {r['samples_s']:.2f} samples/s "
          f"({r['step_ms']:.2f} ms a step); data wait {r['data_wait_ms']:.2f} ms; split by CUDA "
          f"events, summed over micro-batches (ms): "
          + ", ".join(f"{k} {v:.2f}" for k, v in r["split_ms"].items())
          + f"; max_memory_allocated {r['max_memory_gb']:.2f} GB (native batch-32 step "
          f"{NATIVE_STEP_GB} GB) [{card}]")
    return {"launches": launches + launches2, "backwards": backwards + backwards2, "rate": r}


def accum_recipe(seed: int, root: str, val: str, card: str) -> dict:
    """MIGRATION.md's recipe on one card: batch_size_per_gpu 32 x
    accum_steps 8 (global batch 256) on a tree of RECIPE_CHIPS chips, two
    iterations (one warm-up, one timed): samples/s and peak memory."""
    data = os.path.join(root, "recipe_data")
    make_s2naip_tree(data, np.random.RandomState(seed + 31), RECIPE_CHIPS)
    write_tile_weights(data, seed + 32)
    from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod

    opt = accum_opt("accum_recipe", root, data, val, RECIPE_K, RECIPE_B)
    rdb_mod.LAUNCHES = rdb_mod.BACKWARDS = 0
    r = train_rate(opt, 1, warmup=1)
    r["launches"], r["backwards"] = rdb_mod.LAUNCHES, rdb_mod.BACKWARDS
    if not r["launches"] == r["backwards"] == 2 * RECIPE_K * RDBS_PER_FORWARD:
        raise AssertionError(f"recipe: {r['launches']} rdb launches, {r['backwards']} backwards")
    print(f"train step bf16, MIGRATION.md recipe batch {RECIPE_B} x accum_steps {RECIPE_K} "
          f"(global batch {RECIPE_B * RECIPE_K}) on {RECIPE_CHIPS} chips: "
          f"{r['samples_s']:.2f} samples/s ({r['step_ms']:.2f} ms a step); data wait "
          f"{r['data_wait_ms']:.2f} ms; max_memory_allocated {r['max_memory_gb']:.2f} GB "
          f"(native batch-32 step {NATIVE_STEP_GB} GB) [{card}]")
    return r


def remat_check(root: str, data: str, val: str, card: str) -> dict:
    """One bf16 batch-32 train step with network_g.remat False, 'block' and
    'rdb' (and False again, the control) from the same seed and batch, cuDNN
    deterministic: losses and G gradients bit-equal to False's; peak memory
    and rdb launches a step (the recomputes add forwards) printed."""
    from satlas_sr_tpu_torch.models import build_model
    from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod

    cfg = load_config("esrgan_s2naip_urban.yml")
    base = train_opt("remat", root, data, val, train=dict(cfg["train"]), val=None, is_train=True)
    batch = first_batch(base)
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    ref, out = None, {}
    try:
        for mode in REMAT_MODES + (False,):
            o = json.loads(json.dumps(base))
            o["network_g"]["remat"] = mode
            model = build_model(o, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rdb_mod.LAUNCHES = rdb_mod.BACKWARDS = 0
            logs = {k: v.item() for k, v in model.train_iter(batch, 1).items()}
            torch.cuda.synchronize()
            grads = [p.grad.detach().clone() for p in model.net_g.parameters()]
            row = {"launches": rdb_mod.LAUNCHES, "backwards": rdb_mod.BACKWARDS,
                   "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
            if ref is None:
                ref = (logs, grads)
                row["equal"] = True
            else:
                row["equal"] = logs == ref[0] and all(torch.equal(a, b)
                                                      for a, b in zip(grads, ref[1]))
            out["control" if mode is False and out else str(mode)] = row
            del model, grads
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    want = {"False": 1, "block": 2, "rdb": 2, "control": 1}
    ok = all(r["equal"] and r["launches"] == want[m] * RDBS_PER_FORWARD
             and r["backwards"] == RDBS_PER_FORWARD for m, r in out.items())
    print("remat, bf16 batch 32, one step each (cuDNN deterministic): "
          + "; ".join(f"{m}: rdb launches {r['launches']}, backwards {r['backwards']}, "
                      f"max_memory_allocated {r['max_memory_gb']:.2f} GB, losses and G "
                      f"gradients {'bit-equal to False' if r['equal'] else 'DIFFER'}"
                      for m, r in out.items())
          + f" {'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        raise AssertionError("remat changed the numbers or the launch counts")
    return out


def tune_sweep(root: str, card: str) -> dict:
    """`tune` on esrgan_s2naip_urban.yml as shipped (bf16) at --effective_batch
    32 over batches 8, 16, 32 and remat false, rdb: every candidate ok; the
    table, the recommendation and the JSON; rdb launches by (dtype, batch)."""
    from satlas_sr_tpu_torch import tune

    from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod

    out = os.path.join(root, "tune.json")
    counts, backwards = {}, {}
    orig = rdb_mod.rdb_backward

    def counted(buf, *args, **kwargs):
        key = ("bf16" if buf.dtype == torch.bfloat16 else "f32", buf.shape[0])
        backwards[key] = backwards.get(key, 0) + 1
        return orig(buf, *args, **kwargs)

    rdb_mod.rdb_backward = counted
    try:
        with launches_by(counts):
            rc = tune.main(["-opt", os.path.join(REPO, "options", "esrgan_s2naip_urban.yml"),
                            "--effective_batch", str(TRAIN_BATCH), "--batches", "8,16,32",
                            "--remat", "false,rdb", "--iters", "2", "--trials", "1", "--out",
                           out])
    finally:
        rdb_mod.rdb_backward = orig
    with open(out) as f:
        rep = json.load(f)
    ok = rc == 0 and len(rep["candidates"]) == 6 and all(c["ok"] for c in rep["candidates"])
    print(f"tune: {len(rep['candidates'])} candidates, best {json.dumps(rep['best'])}, "
          f"recommended --force_yml {' '.join(rep['recommended_force_yml'] or [])}; rdb launches "
          f"by (dtype, batch) {sorted(counts.items())}, backwards {sorted(backwards.items())} "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        raise AssertionError(f"tune: exit {rc}, candidates {json.dumps(rep['candidates'])}")
    return {"launches": counts, "backwards": backwards}


def msgpack_infer(seed: int, root: str, weights: str, card: str) -> dict:
    """Phase 3's seeded esrgan_8S2 weights written through rrdbnet_to_jax as
    net_g_1.msgpack: infer (infer_example.yml, f32 batch 64, the kernel) on
    64 chips from it and from the .pth, every sr.png byte-equal; then one
    byte flipped: ckpt exits 1 with "crc mismatch" and loading raises."""
    from satlas_sr_tpu_torch import ckpt
    from satlas_sr_tpu_torch.infer import run_inference
    from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod
    from satlas_sr_tpu_torch.utils.checkpoint import (CheckpointCorruptError,
                                                      load_network_variables, save_pytree)
    from satlas_sr_tpu_torch.utils.torch_io import load_torch_state_dict, rrdbnet_to_jax

    params = rrdbnet_to_jax(load_torch_state_dict(weights))["params"]
    mp = os.path.join(root, "net_g_1.msgpack")
    save_pytree(mp, {"params": params, "params_ema": params})
    data = os.path.join(root, "infer_s2")
    make_tree(data, np.random.RandomState(seed + 33), BATCH)
    launches, pngs = {}, {}
    for name, w in (("pth", weights), ("msgpack", mp)):
        opt = load_config("infer_example.yml", weights=w, data_dir=data,
                          save_path=os.path.join(root, f"infer_{name}"))
        rdb_mod.LAUNCHES = 0
        n = run_inference(opt, device="cuda")
        torch.cuda.synchronize()
        launches[name] = rdb_mod.LAUNCHES
        pngs[name] = [open(os.path.join(opt["save_path"], str(i), "sr.png"), "rb").read()
                      for i in range(n)]
    equal = len(pngs["pth"]) == BATCH and pngs["pth"] == pngs["msgpack"]
    bad = os.path.join(root, "net_g_flipped.msgpack")
    blob = bytearray(open(mp, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(bad, "wb").write(bytes(blob))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ckpt.main([bad])
    try:
        load_network_variables("SSR_RRDBNet", bad)
        refused = False
    except CheckpointCorruptError:
        refused = True
    ok = (equal and launches["pth"] == launches["msgpack"] == RDBS_PER_FORWARD and rc == 1
          and "crc mismatch" in buf.getvalue() and refused)
    print(f".msgpack weights: infer_example on {BATCH} chips from net_g_1.msgpack and the .pth: "
          f"sr.png {'byte-equal' if equal else 'DIFFER'}, rdb launches {launches}; a flipped "
          f"byte: ckpt exit {rc} ({'crc mismatch' if 'crc mismatch' in buf.getvalue() else '?'}),"
          f" load {'refused' if refused else 'ACCEPTED'} {'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        raise AssertionError(".msgpack weights failed their gates")
    return launches


def host_tools(seed: int, root: str, card: str) -> None:
    """prepare chip on a seeded synthetic S2 (two revisits, 3 x 2 tiles) and
    NAIP raster (.npy with --origin), one batch of the result through the
    port's S2-NAIP loader; the seeded VGG19 and LPIPS-VGG16 towers saved as
    .pth and tower_dryrun over them on the card."""
    from satlas_sr_tpu_torch import prepare, tower_dryrun
    from satlas_sr_tpu_torch.data import build_dataset, build_train_loader
    from satlas_sr_tpu_torch.losses.vgg import _TORCHVISION_CONV_IDX, init_vgg19_params
    from satlas_sr_tpu_torch.metrics.lpips import _PLANS, _init_backbone

    rng = np.random.RandomState(seed + 34)
    tree = os.path.join(root, "prepared")
    ox, oy = prepare.tile_origin(1000, 2000)
    rasters = [("s2", "tci", prepare.S2_CHIP), ("s2", "tci", prepare.S2_CHIP),
               ("naip", "rgb", prepare.NAIP_CHIP)]
    for i, (role, band, chip) in enumerate(rasters):
        path = os.path.join(root, f"raster_{i}.npy")
        np.save(path, (rng.rand(2 * chip, 3 * chip, 3) * 254 + 1).astype(np.uint8))
        with contextlib.redirect_stdout(io.StringIO()):
            rc = prepare.main(["chip", "--input", path, "--out", tree, "--role", role, "--band",
                               band, f"--origin={ox},{oy}"])
        if rc != 0:
            raise AssertionError(f"prepare chip {role}: exit {rc}")
    ds_opt = {"name": "prepared", "type": "S2NAIPDataset", "phase": "train", "n_s2_images": 2,
              "scale": 4, "sentinel2_path": os.path.join(tree, "sentinel2"),
              "naip_path": os.path.join(tree, "naip"), "batch_size_per_gpu": 4}
    ds = build_dataset(ds_opt)
    loader = build_train_loader(ds, ds_opt, seed=0)
    try:
        batch = next(iter(loader))
    finally:
        loader.stop()
    ok = (len(ds) == 6 and batch["lr"].shape == (4, 32, 32, 6)
          and batch["hr"].shape == (4, 128, 128, 3))
    print(f"prepare: 2 S2 revisits + 1 NAIP raster of 3 x 2 tiles -> {len(ds)} chips; one loader "
          f"batch lr {tuple(batch['lr'].shape)}, hr {tuple(batch['hr'].shape)} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("prepare's tree does not load")

    towers = os.path.join(root, "towers")
    os.makedirs(towers)
    vgg = init_vgg19_params(seed)
    state = {}
    for (name, p), idx in zip(vgg.items(), _TORCHVISION_CONV_IDX):
        state[f"features.{idx}.weight"] = torch.from_numpy(p["kernel"].transpose(3, 2, 0, 1).copy())
        state[f"features.{idx}.bias"] = torch.from_numpy(p["bias"].copy())
    torch.save(state, os.path.join(towers, "vgg19.pth"))
    convs = _init_backbone(_PLANS["vgg"], seed)
    lp = {f"net.{i}.weight": torch.from_numpy(c["kernel"].transpose(3, 2, 0, 1).copy())
          for i, c in enumerate(convs)}
    lp.update({f"net.{i}.bias": torch.from_numpy(c["bias"]) for i, c in enumerate(convs)})
    for i, ch in enumerate((64, 128, 256, 512, 512)):
        lp[f"lin{i}.model.1.weight"] = torch.from_numpy(
            np.abs(rng.randn(1, ch, 1, 1)).astype(np.float32))
    torch.save(lp, os.path.join(towers, "lpips_vgg.pth"))
    report = os.path.join(root, "towers.json")
    t0 = time.time()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tower_dryrun.main([towers, "--clip-models", "RN50", "--out", report])
    with open(report) as f:
        rep = json.load(f)
    found = {r["file"]: sorted(m["tower"] for m in r["matches"] if "error" not in m)
             for r in rep["files"]}
    ok = rc == 0 and found == {"lpips_vgg.pth": ["lpips-vgg"], "vgg19.pth": ["vgg19"]}
    print(f"tower_dryrun on the card ({time.time() - t0:.1f} s): exit {rc}, {json.dumps(found)}; "
          + "; ".join(f"{m['tower']} {m['fingerprint']}" for r in rep["files"]
                      for m in r["matches"]) + f" {'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        raise AssertionError(f"tower_dryrun: exit {rc}\n{buf.getvalue()[-2000:]}")


def phase_accum_tools(seed: int, work: str, card: str) -> dict:
    """Phase 13 (see the module docstring): accumulation, remat, tune, the
    JAX .msgpack weights, prepare and the tower dry-run. Reuses phase 8's
    train tree and phase 3's seeded weights. Returns the kernel rows at the
    micro-batch shapes and the launches of each path."""
    root = os.path.join(work, "accum")
    os.makedirs(root)
    train_root = os.path.join(work, "train")
    data, val = os.path.join(train_root, "data"), os.path.join(train_root, "val")
    rows = {b: rdb_train_check(seed, b) for b in (ACCUM_B, 8, 16)}
    TimingRecords()
    accum_equivalence(root, data, val, card)
    users = accum_train(root, data, val, card)
    recipe = accum_recipe(seed, root, val, card)
    remat = remat_check(root, data, val, card)
    tuned = tune_sweep(root, card)
    infer = msgpack_infer(seed, root, os.path.join(work, "esrgan_8S2_seeded.pth"), card)
    host_tools(seed, root, card)
    return {"rows": rows, "users": users, "recipe": recipe, "remat": remat, "tune": tuned,
            "infer": infer}


# -- phase 14: data parallelism across processes, DCP checkpoints ------------------

MULTI_WORLD, MULTI_ITERS, MULTI_TIMEOUT = 2, 2, 420
MULTI_TEST_CHIPS = 16
NOT_SCALING = "two processes sharing one card; not a scaling figure"


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def deterministic_algorithms():
    """torch.use_deterministic_algorithms(True) and cuDNN deterministic, for
    gates 1 and 5. Before the U-Net D's bilinear x2 became shifted sums its
    F.interpolate backward accumulated with atomics (20 distinct gradients
    in 20 tries of one step on the card), and only this made a run repeat;
    gate 0 now holds two runs without it. cuBLAS needs
    CUBLAS_WORKSPACE_CONFIG, which main() sets before the first call."""
    prev = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev[1:]


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic flag (benchmark off) alone, without torch's
    deterministic algorithms."""
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev


@contextlib.contextmanager
def torchrun_env(rank: int, world: int):
    """The variables torchrun sets for one rank of `world` on this host."""
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    prev = {k: os.environ.get(k) for k in keys}
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dir_mb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs) / 1e6


def same_files(a: str, b: str) -> bool:
    """Every file under a and b, byte for byte."""
    rel = lambda root: sorted(os.path.relpath(os.path.join(d, f), root)
                              for d, _, fs in os.walk(root) for f in fs)
    if rel(a) != rel(b):
        return False
    for f in rel(a):
        with open(os.path.join(a, f), "rb") as x, open(os.path.join(b, f), "rb") as y:
            if x.read() != y.read():
                return False
    return True


def multi_train_runs(root: str, data: str, val: str, card: str) -> dict:
    """Gates 0, 1 and 5 of phase 14: the train CLI as shipped (bf16, batch
    32) for MULTI_ITERS iterations twice with cuDNN's deterministic flag but
    not torch's deterministic algorithms (R1, R2: bit-equal), once with
    cuDNN's defaults (R3, against R1: a record); then under the
    deterministic algorithms without a launcher (A), as torchrun's rank 0
    of 1 over NCCL (B), and with checkpoint_backend orbax for half the
    iterations then --auto_resume (C). B and C end bit-equal to A (losses
    of every iteration, net_g/net_d_latest.pth).
    Then the save costs on C's final model: the native .state against DCP's
    async_save (blocking and wait ms, MB on disk)."""
    from satlas_sr_tpu_torch import ckpt
    from satlas_sr_tpu_torch import train as train_cli
    from satlas_sr_tpu_torch.models.base import _to_cpu
    from satlas_sr_tpu_torch.utils.checkpoint import save_state
    from satlas_sr_tpu_torch.utils.options import close_distributed
    from satlas_sr_tpu_torch.utils.orbax_io import OrbaxCheckpointIO

    cfg = load_config("esrgan_s2naip_urban.yml")

    def opt_for(name, total, **train):
        o = train_opt(name, root, data, val, train={**cfg["train"], "total_iter": total, **train},
                      val=None)
        # the DCP runs save at the resume point; the others only at the end
        # (their gates read net_*_latest.pth)
        orbax = train.get("checkpoint_backend") == "orbax"
        o["logger"]["save_checkpoint_freq"] = MULTI_ITERS // 2 if orbax else 10 ** 9
        return o

    def models(name):
        exp = os.path.join(root, "experiments", name, "models")
        return {n: torch.load(os.path.join(exp, f"net_{n}_latest.pth"), weights_only=True)
                for n in ("g", "d")}

    def equal(a, b):
        return all(torch.equal(a[n][k][p], b[n][k][p]) for n in a for k in a[n] for p in a[n][k])

    built = []
    real_build = train_cli.build_model
    train_cli.build_model = lambda opt, device: built.append(real_build(opt, device=device)) or built[-1]
    counts = {}
    try:
        with cudnn_deterministic():
            r1 = run_train(root, opt_for("repeat_1", MULTI_ITERS))
            r2 = run_train(root, opt_for("repeat_2", MULTI_ITERS))
        r3 = run_train(root, opt_for("repeat_3", MULTI_ITERS))
        with deterministic_algorithms():
            a = run_train(root, opt_for("dp_plain", MULTI_ITERS))
            with torchrun_env(0, 1):
                try:
                    b = run_train(root, opt_for("dp_nccl_w1", MULTI_ITERS), "--launcher", "pytorch")
                    backend = torch.distributed.get_backend()
                finally:
                    close_distributed()
            c1 = run_train(root, opt_for("dp_dcp", MULTI_ITERS // 2, checkpoint_backend="orbax"))
            c2 = run_train(root, opt_for("dp_dcp", MULTI_ITERS, checkpoint_backend="orbax"),
                           "--auto_resume")
    finally:
        train_cli.build_model = real_build
    rows = {n: train_rows(os.path.join(root, "experiments", n))[0]
            for n in ("repeat_1", "repeat_2", "repeat_3", "dp_plain", "dp_nccl_w1", "dp_dcp")}
    want = [RDBS_PER_FORWARD * MULTI_ITERS] * 2
    same = rows["repeat_2"] == rows["repeat_1"] and equal(models("repeat_2"), models("repeat_1"))
    ok0 = same and list(r1[1:]) == want and list(r2[1:]) == want
    free = (rows["repeat_3"] == rows["repeat_1"], equal(models("repeat_3"), models("repeat_1")))
    print(f"train CLI as shipped, bf16 batch {TRAIN_BATCH}, {MULTI_ITERS} iterations, twice "
          f"without torch's deterministic algorithms (cuDNN's deterministic flag on): losses of "
          f"every iteration and net_g/net_d_latest.pth bit-equal {same}; rdb launches/backwards "
          f"{r1[1:]} and {r2[1:]} (expected {want}); {r1[0]:.1f} and {r2[0]:.1f} s "
          f"{'ok' if ok0 else 'FAIL'}; a third with cuDNN's defaults against the first (a "
          f"record): losses {free[0]}, .pth {free[1]}, {r3[0]:.1f} s [{card}]")
    if not ok0:
        raise AssertionError("two train runs without deterministic algorithms differ")
    ok1 = (backend == "nccl" and rows["dp_nccl_w1"] == rows["dp_plain"]
           and equal(models("dp_nccl_w1"), models("dp_plain"))
           and list(a[1:]) == want and list(b[1:]) == want)
    print(f"world size 1 over NCCL (--launcher pytorch, torchrun's env), bf16 batch "
          f"{TRAIN_BATCH}, {MULTI_ITERS} iterations, deterministic algorithms: backend {backend}; "
          f"losses of every iteration and net_g/net_d_latest.pth bit-equal to the run without a "
          f"launcher: {rows['dp_nccl_w1'] == rows['dp_plain']} / "
          f"{equal(models('dp_nccl_w1'), models('dp_plain'))}; rdb launches/backwards {b[1:]} "
          f"(expected {want}); {b[0]:.1f} s against {a[0]:.1f} s {'ok' if ok1 else 'FAIL'} [{card}]")
    if not ok1:
        raise AssertionError("the world-1 NCCL run differs from the run without a launcher")

    dcp_root = os.path.join(root, "experiments", "dp_dcp", "training_states", "orbax")
    info = ckpt.inspect(dcp_root)
    half = [RDBS_PER_FORWARD * MULTI_ITERS // 2] * 2
    ok5 = (rows["dp_dcp"] == rows["dp_plain"] and equal(models("dp_dcp"), models("dp_plain"))
           and info["status"] == "ok" and info["committed_steps"] == [MULTI_ITERS // 2, MULTI_ITERS]
           and list(c1[1:]) == half and list(c2[1:]) == half
           and not [f for f in os.listdir(os.path.dirname(dcp_root)) if f.endswith(".state")])
    print(f"checkpoint_backend orbax (DCP): {MULTI_ITERS // 2} iterations + save, --auto_resume "
          f"to {MULTI_ITERS}: losses and net_g/net_d_latest.pth bit-equal to the uninterrupted "
          f"run: {rows['dp_dcp'] == rows['dp_plain']} / {equal(models('dp_dcp'), models('dp_plain'))}"
          f"; ckpt on the root: {info['status']}, steps {info['committed_steps']}, "
          f"{info['size_bytes'] / 1e6:.1f} MB; rdb launches/backwards {c1[1:]} + {c2[1:]} "
          f"{'ok' if ok5 else 'FAIL'} [{card}]")
    if not ok5:
        raise AssertionError("the DCP resume differs from the uninterrupted run")

    model = built[-1]  # the resumed run's, at MULTI_ITERS
    save_dir = os.path.join(root, "save_costs")
    state_path = os.path.join(save_dir, "native.state")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_state(state_path, {"epoch": 0, "iter": model.step, "state": _to_cpu(model.train_state())})
    native_ms = 1e3 * (time.perf_counter() - t0)
    io = OrbaxCheckpointIO(os.path.join(save_dir, "orbax"))
    payload = {"epoch": 0, "iter": model.step, "state": model.train_state(),
               "nets": model.network_checkpoints()}
    t0 = time.perf_counter()
    io.save(model.step, payload)
    block_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    io.wait()
    wait_ms = 1e3 * (time.perf_counter() - t0)
    io.close()
    costs = {"native_ms": native_ms, "native_mb": os.path.getsize(state_path) / 1e6,
             "dcp_block_ms": block_ms, "dcp_wait_ms": wait_ms,
             "dcp_mb": dir_mb(os.path.join(save_dir, "orbax"))}
    print(f"save costs at full width: native .state {native_ms:.1f} ms blocking, "
          f"{costs['native_mb']:.1f} MB; DCP async_save {block_ms:.1f} ms blocking + wait() "
          f"{wait_ms:.1f} ms, {costs['dcp_mb']:.1f} MB (state + nets: G, EMA and D again) [{card}]")
    del built[:], model, payload
    counts.update(w1=b[1:], dcp=(c1[1] + c2[1], c1[2] + c2[2]), costs=costs,
                  repeat=(r1[1] + r2[1] + r3[1], r1[2] + r2[2] + r3[2]))
    return counts


def multi_rank(rank: int, work: str) -> None:
    """One of phase 14's two gloo ranks on the one card: the f32 train step
    on its 16 of the 32 rows (then two timed steps), the test CLI and the
    infer CLI with --launcher pytorch; results under `work`."""
    import torch.distributed as dist

    from satlas_sr_tpu_torch import infer as infer_cli
    from satlas_sr_tpu_torch import test as test_cli
    from satlas_sr_tpu_torch.models import build_model
    from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod
    from satlas_sr_tpu_torch.ops.cuda.build import load
    from satlas_sr_tpu_torch.parallel import mesh

    load("rdb")  # built by the parent: found, not rebuilt
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(MULTI_WORLD), LOCAL_RANK="0")
    dist.init_process_group("gloo", init_method=f"file://{work}/init", rank=rank,
                            world_size=MULTI_WORLD)
    TimingRecords()
    with open(os.path.join(work, "plan.json")) as f:
        plan = json.load(f)
    out = {}
    b = TRAIN_BATCH // MULTI_WORLD
    rows = {k: v[rank * b:(rank + 1) * b] for k, v in np.load(os.path.join(work, "batch.npz")).items()}
    with tf32_off():
        model = build_model({**plan["train"], "world_size": MULTI_WORLD}, device="cuda")
        rdb_mod.LAUNCHES = rdb_mod.BACKWARDS = 0
        model.train_iter(rows, 1)
        torch.cuda.synchronize()
        out["step_launches"] = [rdb_mod.LAUNCHES, rdb_mod.BACKWARDS]
        torch.save(step_record(model), os.path.join(work, f"step_r{rank}.pt"))
        mesh.REDUCE_EVENTS = []
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for it in (2, 3):
            model.train_iter(rows, it)
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / 2
        reduce_ms = {}
        for tag, start, end in mesh.REDUCE_EVENTS:
            reduce_ms[tag] = reduce_ms.get(tag, 0.0) + start.elapsed_time(end) / 2
        mesh.REDUCE_EVENTS = None
        out.update(step_s=secs, reduce_ms=reduce_ms)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    rdb_mod.LAUNCHES = 0
    res = test_cli.test_pipeline(plan["test_root"], ["-opt", plan["test_yml"], "--launcher",
                                                     "pytorch"], device="cuda")
    torch.cuda.synchronize()
    out.update(test=res["test"], test_launches=rdb_mod.LAUNCHES)

    written, manifests = [], []
    real_write, real_replace = infer_cli.write_png, os.replace

    def write(path, img):
        written.append(os.path.relpath(path, plan["infer_save"]))
        return real_write(path, img)

    def replace(src, dst):
        if dst.endswith(".ssr_corpus_manifest.json"):
            manifests.append(dst)
        return real_replace(src, dst)

    infer_cli.write_png, os.replace = write, replace
    rdb_mod.LAUNCHES = 0
    try:
        infer_cli.main(["-opt", plan["infer_yml"], "--launcher", "pytorch"])  # destroys the group
    finally:
        infer_cli.write_png, os.replace = real_write, real_replace
    torch.cuda.synchronize()
    out.update(infer_written=written, infer_manifests=len(manifests),
               infer_launches=rdb_mod.LAUNCHES)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def step_record(model) -> dict:
    """G and D weights (u/v included; no D in the L2 trainer), their
    gradients and the EMA, on the CPU."""
    ema = getattr(model, "net_g_ema", None)
    rec = {"ema": ema.state_dict() if ema is not None else dict(getattr(model, "ema", None) or {})}
    for net in ("g", "d"):
        m = getattr(model, f"net_{net}", None)
        if m is not None:
            rec[net] = m.state_dict()
            rec[f"{net}_grad"] = {n: p.grad for n, p in m.named_parameters()}
    return {k: {n: t.detach().cpu().clone() for n, t in v.items()} for k, v in rec.items()}


def run_ranks(work: str) -> list:
    """Start MULTI_WORLD ranks (`multi_rank`, fresh interpreters: this process
    holds a CUDA context, so no fork); any rank failing, or the deadline,
    kills them all and fails the phase."""
    logs = [open(os.path.join(work, f"rank{r}.log"), "w") for r in range(MULTI_WORLD)]
    procs = [subprocess.Popen([sys.executable, "-c",
                               f"import chip_smoke as cs; cs.multi_rank({r}, {work!r})"],
                              cwd=REPO, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(MULTI_WORLD)]
    deadline = time.time() + MULTI_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.time() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in bad:
            with open(os.path.join(work, f"rank{r}.log")) as f:
                print(f"--- rank {r} (exit {procs[r].returncode}) ---\n{f.read()[-6000:]}")
        raise AssertionError(f"phase 14: rank(s) {bad} failed or hung past {MULTI_TIMEOUT} s")
    out = []
    for r in range(MULTI_WORLD):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def check_step(ref: dict, ranks: list, lrs: dict, card: str) -> None:
    """Gate 2: replicas bit-equal; against the one-process batch-32 step,
    the bar of accum_equivalence (phase 13): gradients within 1e-4 of
    each tensor's max; params above the gradient noise floor within rtol
    1e-4 / atol 2e-5, the rest within Adam's one-step 2 lr; the EMA and D's
    u/v within rtol 1e-4 / atol 2e-5."""
    r0, r1 = ranks
    replica = all(torch.equal(r0[k][n], r1[k][n]) for k in r0 for n in r0[k])
    grad_rel, outside, quiet_outside, elements, ok = 0.0, 0, 0, 0, True
    for net in ("g", "d"):
        for n, g in ref[f"{net}_grad"].items():
            scale = g.abs().max().clamp_min(1e-30)
            grad_rel = max(grad_rel, ((g - r0[f"{net}_grad"][n]).abs().max() / scale).item())
            d = (ref[net][n] - r0[net][n]).abs()
            off = d > 2e-5 + 1e-4 * ref[net][n].abs()
            quiet = g.abs() <= 1e-4 * scale
            outside += int(off.sum())
            quiet_outside += int((off & quiet).sum())
            ok &= bool(d[off].le(2 * lrs[net] * (1 + 1e-3)).all()) if off.any() else True
            elements += d.numel()
    buffers = [n for n in ref["d"] if n not in ref["d_grad"]]  # D's spectral u/v
    ema_ok = all(torch.allclose(r0["ema"][n], t, rtol=1e-4, atol=2e-5) for n, t in ref["ema"].items())
    uv_ok = all(torch.allclose(r0["d"][n], ref["d"][n], rtol=1e-4, atol=2e-5) for n in buffers)
    ok &= replica and grad_rel <= 1e-4 and outside == quiet_outside and ema_ok and uv_ok
    print(f"2 gloo ranks x {TRAIN_BATCH // MULTI_WORLD} on one card against one process at batch "
          f"{TRAIN_BATCH}, one f32 step, TF32 off, GAN term on: replicas bit-equal (G, D, "
          f"{len(buffers)} u/v, EMA, grads) {replica}; G and D gradients within {grad_rel:.3e} of "
          f"each tensor's max (bound 1e-4); {outside} of {elements} params outside rtol 1e-4 / "
          f"atol 2e-5, {quiet_outside} of them below the gradient noise floor (bound 2 lr); EMA "
          f"{ema_ok}, u/v {uv_ok} {'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        raise AssertionError("the two-rank step disagrees with the one-process step")


def phase_multi(seed: int, work: str, card: str) -> dict:
    """Phase 14 (see the module docstring): data parallelism across processes
    and the DCP checkpoint backend, on phase 8's tree and phase 3's seeded
    weights."""
    import yaml

    from satlas_sr_tpu_torch import test as test_cli
    from satlas_sr_tpu_torch.data import SequentialEvalLoader, build_dataset
    from satlas_sr_tpu_torch.infer import run_inference, shard_contiguous
    from satlas_sr_tpu_torch.models import build_model
    from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod

    root = os.path.join(work, "multi")
    os.makedirs(root)
    train_root = os.path.join(work, "train")
    data, val = os.path.join(train_root, "data"), os.path.join(train_root, "val")
    weights = os.path.join(work, "esrgan_8S2_seeded.pth")
    TimingRecords()
    counts = multi_train_runs(root, data, val, card)

    # the one-process references of gates 2-4, then the two ranks
    step_opt = train_opt("dp_step", root, data, val, compute_dtype="float32",
                         matmul_precision="highest", is_train=True, val=None)
    batch = first_batch(step_opt)
    np.savez(os.path.join(root, "batch.npz"), lr=batch["lr"], hr=batch["hr"])
    with tf32_off():
        model = build_model(step_opt, device="cuda")
        model.train_iter({"lr": batch["lr"], "hr": batch["hr"]}, 1)
        torch.cuda.synchronize()
        ref = step_record(model)
    del model
    lrs = {n: float(step_opt["train"][f"optim_{n}"]["lr"]) for n in ("g", "d")}

    test_root = os.path.join(root, "test")
    make_s2naip_tree(os.path.join(test_root, "data"), np.random.RandomState(seed + 14),
                     MULTI_TEST_CHIPS)
    topt = load_config("esrgan_s2naip_urban.yml", weights=weights)
    topt["test"] = {**topt["test"], "metrics": {k: v for k, v in topt["test"]["metrics"].items()
                                                if k in ("psnr", "ssim", "cpsnr")}}
    topt["test_datasets"]["test"].update(
        sentinel2_path=os.path.join(test_root, "data", "sentinel2"),
        naip_path=os.path.join(test_root, "data", "naip"))
    test_ymls = {}
    for name in ("one", "ranks"):
        test_ymls[name] = write_yml({**topt, "name": f"dp_test_{name}"},
                                    os.path.join(test_root, f"{name}.yml"))
    rdb_mod.LAUNCHES = 0
    test_one = test_cli.test_pipeline(test_root, ["-opt", test_ymls["one"]], device="cuda")["test"]
    test_one_launches = rdb_mod.LAUNCHES
    ds = build_dataset({**topt["test_datasets"]["test"], "phase": "test", "scale": 4})
    per_rank = [len(SequentialEvalLoader(ds, 1, rank=r, world=MULTI_WORLD))
                for r in range(MULTI_WORLD)]

    infer_opt = {"data_dir": os.path.join(work, "sentinel2"), "n_lr_images": N_LR, "scale": 4,
                 "batch_size": BATCH, "compute_dtype": "bfloat16", "matmul_precision": "highest",
                 "skip_existing": True,
                 "network_g": {"type": "SSR_RRDBNet", "num_in_ch": IN_CH, "num_out_ch": 3,
                               "num_feat": NF, "num_block": NUM_BLOCK, "num_grow_ch": G},
                 "path": {"pretrain_network_g": weights, "param_key_g": "params_ema"}}
    one_save, mp_save = os.path.join(root, "infer_one"), os.path.join(root, "infer_ranks")
    n_one = run_inference({**infer_opt, "save_path": one_save}, device="cuda")
    infer_yml = write_yml({**infer_opt, "save_path": mp_save}, os.path.join(root, "infer.yml"))
    with open(os.path.join(root, "plan.json"), "w") as f:
        json.dump({"train": step_opt, "test_root": test_root, "test_yml": test_ymls["ranks"],
                   "infer_yml": infer_yml, "infer_save": mp_save}, f)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    ranks = run_ranks(root)
    ranks_s = time.time() - t0
    step_recs = [torch.load(os.path.join(root, f"step_r{r}.pt")) for r in range(MULTI_WORLD)]
    check_step(ref, step_recs, lrs, card)
    one_step = [RDBS_PER_FORWARD, RDBS_PER_FORWARD]
    step_s = max(r["step_s"] for r in ranks)
    print(f"2 gloo ranks x {TRAIN_BATCH // MULTI_WORLD}, f32 TF32 off: step {1e3 * step_s:.1f} ms, "
          f"{TRAIN_BATCH / step_s:.2f} samples/s; gradient all_reduce a step (gloo, staged through "
          f"the host) G {ranks[0]['reduce_ms'].get('g', 0):.1f} / "
          f"{ranks[1]['reduce_ms'].get('g', 0):.1f} ms, D {ranks[0]['reduce_ms'].get('d', 0):.1f} / "
          f"{ranks[1]['reduce_ms'].get('d', 0):.1f} ms (rank 0 / 1); rdb launches/backwards of the "
          f"first step {[r['step_launches'] for r in ranks]} (expected {one_step} each); the ranks' "
          f"processes {ranks_s:.1f} s in all ({NOT_SCALING}) [{card}]")
    if any(r["step_launches"] != one_step for r in ranks):
        raise AssertionError("a rank's train step missed the kernel")

    mine = [set(r["infer_written"]) for r in ranks]
    expected = [RDBS_PER_FORWARD * -(-len(shard_contiguous(n_one, r, MULTI_WORLD)) // BATCH)
                for r in range(MULTI_WORLD)]
    ok3 = (same_files(one_save, mp_save) and not (mine[0] & mine[1])
           and len(mine[0] | mine[1]) == 2 * n_one
           and [r["infer_manifests"] for r in ranks] == [1, 0]
           and [r["infer_launches"] for r in ranks] == expected)
    print(f"infer --launcher pytorch on 2 gloo ranks, bf16 batch {BATCH}: {n_one} chips; every "
          f"file byte-equal to the one-process run {same_files(one_save, mp_save)}; files written "
          f"by rank {[len(m) for m in mine]} (disjoint, sr.png + lr.png each); manifest writes "
          f"{[r['infer_manifests'] for r in ranks]}; rdb launches {[r['infer_launches'] for r in ranks]}"
          f" (expected {expected}) {'ok' if ok3 else 'FAIL'} [{card}]")
    if not ok3:
        raise AssertionError("sharded infer differs from the one-process run")

    bars = {"psnr": 1e-6, "cpsnr": 1e-6, "ssim": 1e-8}
    diffs = {m: max(abs(r["test"][m] - test_one[m]) for r in ranks) for m in bars}
    expected = [RDBS_PER_FORWARD * n for n in per_rank]
    ok4 = (all(diffs[m] <= bars[m] for m in bars) and ranks[0]["test"] == ranks[1]["test"]
           and [r["test_launches"] for r in ranks] == expected
           and test_one_launches == RDBS_PER_FORWARD * len(ds))
    print(f"test --launcher pytorch on 2 gloo ranks, bf16 batch 1, {len(ds)} chips: metrics "
          f"{json.dumps({m: round(v, 6) for m, v in ranks[0]['test'].items()})} against one "
          f"process's, |d| {json.dumps({m: float(f'{d:.3e}') for m, d in diffs.items()})} (bounds "
          f"1e-6 dB, 1e-8 SSIM); rdb launches by rank {[r['test_launches'] for r in ranks]} "
          f"(expected {expected}: each rank's own chips and its pad), one process "
          f"{test_one_launches} {'ok' if ok4 else 'FAIL'} [{card}]")
    if not ok4:
        raise AssertionError("sharded test metrics differ from the one-process run")
    counts.update(step=[sum(r["step_launches"][0] for r in ranks),
                        sum(r["step_launches"][1] for r in ranks)],
                  infer=sum(r["infer_launches"] for r in ranks),
                  test=sum(r["test_launches"] for r in ranks),
                  step_ms=1e3 * step_s, reduce_ms=ranks[0]["reduce_ms"])
    return counts


# -- phase 15: the 'space' row sharding of whole-tile inference ---------------------

SPACE_WORLD = 4
SPACE_BAND = TILE // SPACE_WORLD  # a rank's rows of a whole tile
SPACE_HALO = {"rdb": 5, "conv": 1}  # rows from each neighbour: a fused RDB, a 3x3 head
NOT_SCALING_SP = "ranks sharing one card through gloo: not a scaling figure"


def space_bytes(dtype: torch.dtype) -> dict:
    """Bytes one rank sends a forward at each boundary it has, from the
    shapes: the trunk's 69 RDB exchanges of 5 rows x 512 x 64, and the heads'
    one-row exchanges (conv_first on 24 channels at 512 wide, conv_body at
    512, conv_up1 at 1024, conv_up2, conv_hr and conv_last at 2048, 64
    channels)."""
    elt = torch.tensor([], dtype=dtype).element_size()
    trunk = RDBS_PER_FORWARD * SPACE_HALO["rdb"] * TILE * NF * elt
    heads = (TILE * IN_CH + TILE * NF + 2 * TILE * NF + 3 * 4 * TILE * NF) * elt
    return {"trunk": trunk, "heads": heads, "all": trunk + heads}


def space_rank(rank: int, work: str) -> None:
    """One of phase 15's four gloo ranks on the one card: infer_grid
    --launcher pytorch on the shipped whole-tile yml at spatial_shards 4, in
    bf16 (two tiles) then f32 (one tile). Records the files it wrote, its
    rdb launches, each forward's ms, the halo exchanges' host and CUDA-event
    ms and bytes, and its peak memory; results under `work`."""
    import torch.distributed as dist

    from satlas_sr_tpu_torch import infer_grid
    from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod
    from satlas_sr_tpu_torch.ops.cuda.build import load
    from satlas_sr_tpu_torch.parallel import halo

    load("rdb")  # built by the parent: found, not rebuilt
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(SPACE_WORLD), LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE=str(SPACE_WORLD))
    out = {}
    real_write, real_run_band = infer_grid.write_png, infer_grid.InferenceEngine.run_band
    for run in ("bf16", "f32"):
        written, forwards = [], []

        def write(path, img):
            written.append(os.path.relpath(path, work))
            return real_write(path, img)

        def run_band(engine, band):
            dist.barrier()  # the ranks start each forward together: no skew in its time
            torch.cuda.synchronize()
            halo.EXCHANGE_EVENTS = []
            t0 = time.perf_counter()
            try:
                y = real_run_band(engine, band)  # ends with the copy to the host
            finally:
                events, halo.EXCHANGE_EVENTS = halo.EXCHANGE_EVENTS, None
            forwards.append({"ms": 1e3 * (time.perf_counter() - t0), "exchanges": len(events),
                             "host_ms": 1e3 * sum(e[0] for e in events),
                             "event_ms": sum(e[2].elapsed_time(e[3]) for e in events if e[2]),
                             "bytes": sum(e[1] for e in events)})
            return y

        # each rank makes its own gloo group (NCCL refuses two ranks on one
        # card); the CLI's --launcher pytorch takes it as it is, and destroys it
        dist.init_process_group("gloo", init_method=f"file://{work}/init_{run}", rank=rank,
                                world_size=SPACE_WORLD)
        infer_grid.write_png, infer_grid.InferenceEngine.run_band = write, run_band
        torch.cuda.reset_peak_memory_stats()
        rdb_mod.LAUNCHES = 0
        try:
            infer_grid.main(["-opt", os.path.join(work, f"{run}.yml"), "--launcher", "pytorch"])
        finally:
            infer_grid.write_png, infer_grid.InferenceEngine.run_band = real_write, real_run_band
        torch.cuda.synchronize()
        out[run] = {"written": written, "launches": rdb_mod.LAUNCHES, "forwards": forwards,
                    "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def run_space_ranks(work: str, fn: str = "space_rank", timeout: float = 300,
                    phase: int = 15) -> list:
    """Start SPACE_WORLD ranks (`fn`: `space_rank` or `space_train_rank`,
    fresh interpreters); any rank failing, or the deadline, kills them all
    and fails the phase."""
    logs = [open(os.path.join(work, f"rank{r}.log"), "w") for r in range(SPACE_WORLD)]
    procs = [subprocess.Popen([sys.executable, "-c",
                               f"import chip_smoke as cs; cs.{fn}({r}, {work!r})"],
                              cwd=REPO, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(SPACE_WORLD)]
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.time() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in bad:
            with open(os.path.join(work, f"rank{r}.log")) as f:
                print(f"--- rank {r} (exit {procs[r].returncode}) ---\n{f.read()[-6000:]}")
        raise AssertionError(f"phase {phase}: rank(s) {bad} failed or hung past {timeout} s")
    out = []
    for r in range(SPACE_WORLD):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def phase_space(seed: int, work: str, weights: str, card: str) -> dict:
    """Phase 15 (see the module docstring): whole-tile infer_grid with a
    tile's rows split over 4 gloo ranks on the one card, against phase 4's
    one-process runs on the same tiles; then the kernel at the band shapes."""
    from satlas_sr_tpu_torch.utils.imgio import read_png

    root = os.path.join(work, "space")
    os.makedirs(root)
    grid = os.path.join(work, "grid")
    # phase 4's one-process whole-tile runs: bf16 over data2 (two tiles) in
    # whole_tile_2, f32 over data (tile_a) in whole_tile_f32_0
    runs = {"bf16": dict(data="data2", ref="whole_tile_2", tiles=("tile_a", "tile_b"), over={}),
            "f32": dict(data="data", ref="whole_tile_f32_0", tiles=("tile_a",),
                        over=dict(compute_dtype="float32", matmul_precision="highest"))}
    for name, run in runs.items():
        opt = load_config("infer_grid_whole_tile.yml", data_dir=os.path.join(grid, run["data"]),
                          save_path=os.path.join(root, f"sp4_{name}"), weights=weights,
                          spatial_shards=SPACE_WORLD, **run["over"])
        write_yml(opt, os.path.join(root, f"{name}.yml"))
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    ranks = run_space_ranks(root)
    ranks_s = time.time() - t0
    counts = {}
    for name, run in runs.items():
        dtype = torch.bfloat16 if name == "bf16" else torch.float32
        for tile in run["tiles"]:
            paths = {k: os.path.join(root, f"sp4_{name}", tile, f"stitched_{k}.png")
                     for k in ("sr", "s2")}
            refs = {k: os.path.join(grid, run["ref"], tile, f"stitched_{k}.png")
                    for k in ("sr", "s2")}
            got, want = read_png(paths["sr"]), read_png(refs["sr"])
            n_apart = int((got != want).sum()) if got.shape == want.shape else -1
            print(f"space {name} {tile}: {n_apart} of {want.size} stitched_sr values differ from "
                  f"the one-process run (bit-equal: {n_apart == 0})")
            gate_levels(f"space {name} {tile}: 4 ranks against one process", got, want)
            with open(paths["s2"], "rb") as a, open(refs["s2"], "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"space {name} {tile}: stitched_s2.png differs")
        writers = {}
        for r, rank in enumerate(ranks):
            for path in rank[name]["written"]:
                writers.setdefault(path, []).append(r)
        want_files = {os.path.join(f"sp4_{name}", t, f"stitched_{k}.png")
                      for t in run["tiles"] for k in ("sr", "s2")}
        launches = [rank[name]["launches"] for rank in ranks]
        expected = RDBS_PER_FORWARD * len(run["tiles"])
        ok = (set(writers) == want_files and all(w == [0] for w in writers.values())
              and launches == [expected] * SPACE_WORLD)
        print(f"space {name}: stitched_s2.png byte-equal; files written by rank "
              f"{sorted({r for w in writers.values() for r in w})} ({len(writers)} files, each "
              f"once); rdb launches by rank {launches} (expected {expected} each) "
              f"{'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            raise AssertionError(f"space {name}: writers {writers}, launches {launches}")
        want_bytes = space_bytes(dtype)
        for r, rank in enumerate(ranks):
            fwd = rank[name]["forwards"]
            sides = 1 if r in (0, SPACE_WORLD - 1) else 2
            print(f"space {name} rank {r}: forward ms {[round(f['ms'], 3) for f in fwd]} (the "
                  f"first includes cuDNN's first calls); halo exchanges "
                  f"{[f['exchanges'] for f in fwd]} a forward, host "
                  f"{[round(f['host_ms'], 3) for f in fwd]} ms, CUDA events "
                  f"{[round(f['event_ms'], 3) for f in fwd]} ms; bytes sent "
                  f"{[f['bytes'] for f in fwd]} (computed {sides} x {want_bytes['all']}: trunk "
                  f"{want_bytes['trunk']}, heads {want_bytes['heads']}); peak memory "
                  f"{rank[name]['peak_mb']:.1f} MiB ({NOT_SCALING_SP}) [{card}]")
            if any(f["bytes"] != sides * want_bytes["all"] for f in fwd):
                raise AssertionError(f"space {name} rank {r}: the bytes exchanged differ from "
                                     "the shapes'")
        counts[name] = sum(launches)
    print(f"space: the four ranks' processes {ranks_s:.1f} s in all ({NOT_SCALING_SP}) [{card}]")
    rows = {f"{h}": phase_kernels_at(seed, 1, h, TILE)
            for h in (SPACE_BAND + SPACE_HALO["rdb"], SPACE_BAND + 2 * SPACE_HALO["rdb"])}
    return {"launches": counts, "rows": rows}


# -- phase 16: the train step on a dp x sp layout ------------------------------------

SP_PARITY_GROUP = 8  # rows a data group in the parity steps (dp 2 x sp 2): 16 in all
SP_SHIPPED_PER_RANK = 8  # batch_size_per_gpu as shipped at dp 1 x sp 4: 32 rows a data group
SP_ITERS, SP_VAL_CHIPS, SP_TRAIN_CHIPS = 2, 8, 40
SP_LEGS = (("esrgan", "esrgan_s2naip_urban.yml"), ("srcnn", "srcnn_s2naip_urban.yml"),
           ("osm", "osm_obj_esrgan.yml"))


def space_train_bytes(opt: dict, b: int, elt: int) -> dict:
    """Bytes one rank sends at each boundary it has in one step of the ESRGAN
    trainer `opt` on a row-band layout (b images), from the shapes, and the
    exchanges' count. Rows a side times width times channels, for each
    exchange: G's forward (its head convs one row, each RDB five; LR 32
    wide), the U-Net D's (conv0 on 3 + the LR's channels, the stride-2 convs
    and the upsamples one row at their level's width) and VGG19's to the
    deepest perceptual tap. The step runs G once, D three times (the G
    step's fake, then real and fake) and VGG19 twice (output and GT).
    Backward: every exchange whose input carries a gradient, so not G's
    first (the LR input), not D's conv0 on the real and the detached fake
    image, not VGG19 on the GT."""
    from satlas_sr_tpu_torch.losses.vgg import VGG19_PLAN

    nf, rdbs = opt["network_g"]["num_feat"], 3 * opt["network_g"]["num_block"]
    cin = 3 * opt["datasets"]["train"]["n_s2_images"]
    dn, w = opt["network_d"]["num_feat"], 4 * HW
    g_first = HW * cin
    g = g_first + rdbs * 5 * HW * nf + HW * nf + 2 * HW * nf + 3 * w * nf
    d0 = w * (3 + cin)
    d = d0 + (w * dn + w // 2 * 2 * dn + w // 4 * 4 * dn + w // 8 * 8 * dn + w // 4 * 8 * dn
              + w // 4 * 4 * dn + w // 2 * 4 * dn + w // 2 * 2 * dn + w * 2 * dn + 3 * w * dn)
    taps = opt["train"]["perceptual_opt"]["layer_weights"]
    deepest = max(i for i, item in enumerate(VGG19_PLAN) if item != "M" and item[0] in taps)
    v, v_n, width, ch = 0, 0, w, 3
    for item in VGG19_PLAN[:deepest + 1]:
        if item == "M":
            width //= 2
        else:
            v, v_n, ch = v + width * ch, v_n + 1, item[1]
    g_n, d_n = rdbs + 6, 13
    return {"fwd": (g + 3 * d + 2 * v) * b * elt,
            "bwd": ((g - g_first) + d + 2 * (d - d0) + v) * b * elt,
            "exchanges": (g_n + 3 * d_n + 2 * v_n, g_n - 1 + d_n + 2 * (d_n - 1) + v_n)}


def exchange_summary(events) -> dict:
    return {"n": len(events), "host_ms": 1e3 * sum(e[0] for e in events),
            "event_ms": sum(e[2].elapsed_time(e[3]) for e in events if e[2] is not None),
            "bytes": sum(e[1] for e in events)}


def space_train_rank(rank: int, work: str) -> None:
    """One of phase 16's four gloo ranks on the one card: the parity steps
    at dp 2 x sp 2 (f32, TF32 off) of the three families on its data group's
    rows, then the train CLI --launcher pytorch as shipped at dp 1 x sp 4,
    each iteration timed with its halo exchanges; results under `work`."""
    import torch.distributed as dist

    from satlas_sr_tpu_torch import train as train_cli
    from satlas_sr_tpu_torch.models import build_model
    from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod
    from satlas_sr_tpu_torch.ops.cuda.build import load
    from satlas_sr_tpu_torch.parallel import halo

    load("rdb")  # built by the parent: found, not rebuilt
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(SPACE_WORLD), LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE=str(SPACE_WORLD))
    dist.init_process_group("gloo", init_method=f"file://{work}/init", rank=rank,
                            world_size=SPACE_WORLD)
    TimingRecords()
    with open(os.path.join(work, "plan.json")) as f:
        plan = json.load(f)
    out = {"parity": {}}
    try:
        with tf32_off():
            for leg, opt in plan["legs"].items():
                model = build_model({**opt, "world_size": SPACE_WORLD, "spatial_shards": 2},
                                    device="cuda")
                d = model.space.data_index
                rows = {k: (v[d * SP_PARITY_GROUP:(d + 1) * SP_PARITY_GROUP].tolist()
                            if k == "Chip" else v[d * SP_PARITY_GROUP:(d + 1) * SP_PARITY_GROUP])
                        for k, v in np.load(os.path.join(work, f"{leg}.npz")).items()}
                rdb_mod.LAUNCHES = rdb_mod.BACKWARDS = 0
                logs = model.train_iter(rows, 1)
                torch.cuda.synchronize()
                out["parity"][leg] = {"launches": [rdb_mod.LAUNCHES, rdb_mod.BACKWARDS],
                                      "logs": {k: float(v) for k, v in logs.items()}}
                torch.save(step_record(model), os.path.join(work, f"{leg}_r{rank}.pt"))
                del model
                gc.collect()
                torch.cuda.empty_cache()

        iters = []
        real_build = train_cli.build_model

        def build(opt, device):
            model = real_build(opt, device=device)
            step = model.train_iter

            def train_iter(batch, it):
                dist.barrier()  # the ranks start each step together: no skew in its time
                torch.cuda.synchronize()
                halo.EXCHANGE_EVENTS, halo.EXCHANGE_BACKWARD_EVENTS = [], []
                counts = rdb_mod.LAUNCHES, rdb_mod.BACKWARDS
                t0 = time.perf_counter()
                try:
                    logs = step(batch, it)
                    torch.cuda.synchronize()
                finally:
                    fwd, bwd = halo.EXCHANGE_EVENTS, halo.EXCHANGE_BACKWARD_EVENTS
                    halo.EXCHANGE_EVENTS = halo.EXCHANGE_BACKWARD_EVENTS = None
                iters.append({"ms": 1e3 * (time.perf_counter() - t0),
                              "logs": {k: float(v) for k, v in logs.items()},
                              "launches": rdb_mod.LAUNCHES - counts[0],
                              "backwards": rdb_mod.BACKWARDS - counts[1],
                              "fwd": exchange_summary(fwd), "bwd": exchange_summary(bwd)})
                return logs

            model.train_iter = train_iter
            return model

        train_cli.build_model = build
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rdb_mod.LAUNCHES = rdb_mod.BACKWARDS = 0
        t0 = time.time()
        try:
            train_cli.train_pipeline(plan["root"], ["-opt", plan["yml"], "--launcher", "pytorch"],
                                     device="cuda")
        finally:
            train_cli.build_model = real_build
        torch.cuda.synchronize()
        out["shipped"] = {"iters": iters, "launches": rdb_mod.LAUNCHES,
                          "backwards": rdb_mod.BACKWARDS, "seconds": time.time() - t0,
                          "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def space_parity_check(leg: str, ref: dict, ranks: list, logs: list, lr: float,
                       exact_bias: Optional[float], card: str) -> None:
    """Phase 16 (a)/(c): four ranks at dp 2 x sp 2 against one process on the
    same 16 rows: replicas bit-equal; losses within 1e-4 relative; each
    network's gradients within 1e-4 relative L2, every tensor within 1e-3
    of its max, and the tensors beyond phase 14's 1e-4 counted and named.
    A band's head and D convs run cuDNN at other shapes than the whole
    image's, so a pre-activation within rounding of 0 can take the other
    LeakyReLU slope (0.8 g at that pixel): over the trunk's 16 x 32 x 32
    pixels one such kink moves a weight gradient by ~6e-5 of its max (1.27e-4
    read on the card), which phase 14's row split by batch never met.
    D's last bias, one cancelling sum over 16 x 128 x 128 logits, is held
    instead on both sides within 1e-3 of its max of the float64 sum of
    those terms from the one-process step. Params above the gradient noise
    floor within rtol 1e-4 / atol 2e-5, the rest within Adam's one-step
    2 lr; the EMA and D's u/v within rtol 1e-4 / atol 2e-5."""
    r0 = ranks[0]
    replica = all(torch.equal(r[k][n], r0[k][n]) for r in ranks[1:] for k in r0 for n in r0[k])
    replica &= all(l == logs[0] for l in logs[1:])
    loss_rel = max(abs(logs[0][k] - v) / max(abs(v), 1e-12) for k, v in ref["logs"].items())
    grad_rel, outside, quiet_outside, elements, ok, bias = 0.0, 0, 0, 0, True, []
    nets = [n for n in ("g", "d") if n in ref]
    worst, l2 = {}, {}
    for net in nets:
        num = den = 0.0
        for n, g in ref[f"{net}_grad"].items():
            scale = g.abs().max().clamp_min(1e-30)
            diff = g - r0[f"{net}_grad"][n]
            num, den = num + float(diff.square().sum()), den + float(g.square().sum())
            rel = (diff.abs().max() / scale).item()
            worst[f"{net}.{n}"] = (rel, scale.item())
            if rel > 1e-4 and net == "d" and n.endswith("conv9.bias") and exact_bias is not None:
                sides = [abs(float(t) - exact_bias) / scale.item()
                         for t in (g, r0[f"{net}_grad"][n])]
                bias.append((n, rel, max(sides)))
                ok &= max(sides) <= 1e-3
            else:
                grad_rel = max(grad_rel, rel)
            d = (ref[net][n] - r0[net][n]).abs()
            off = d > 2e-5 + 1e-4 * ref[net][n].abs()
            quiet = g.abs() <= 1e-4 * scale
            outside += int(off.sum())
            quiet_outside += int((off & quiet).sum())
            ok &= bool(d[off].le(2 * lr * (1 + 1e-3)).all()) if off.any() else True
            elements += d.numel()
        l2[net] = math.sqrt(num / max(den, 1e-30))
    top = sorted(worst.items(), key=lambda kv: -kv[1][0])[:4]
    buffers = [n for n in ref.get("d", {}) if n not in ref["d_grad"]]  # D's spectral u/v
    ema_ok = all(torch.allclose(r0["ema"][n], t, rtol=1e-4, atol=2e-5) for n, t in ref["ema"].items())
    uv_ok = all(torch.allclose(r0["d"][n], ref["d"][n], rtol=1e-4, atol=2e-5) for n in buffers)
    beyond = [k for k, (r, _) in worst.items() if r > 1e-4 and not k.endswith("conv9.bias")]
    ok &= (replica and loss_rel <= 1e-4 and grad_rel <= 1e-3 and max(l2.values()) <= 1e-4
           and outside == quiet_outside and ema_ok and uv_ok)
    print(f"space {leg}: 4 gloo ranks at dp 2 x sp 2 x {SP_PARITY_GROUP} rows a group on one card "
          f"against one process at batch {2 * SP_PARITY_GROUP}, one f32 step, TF32 off: replicas "
          f"bit-equal (weights, {len(buffers)} u/v, EMA, grads, logs) {replica}; losses within "
          f"{loss_rel:.2e} (bound 1e-4); {'/'.join(nets).upper()} gradients within {grad_rel:.3e} of "
          f"each tensor's max (bound 1e-3; {len(beyond)} of {len(worst)} tensors beyond 1e-4), "
          f"relative L2 " + ", ".join(f"{k} {v:.2e}" for k, v in l2.items())
          + " (bound 1e-4); worst "
          + ", ".join(f"{k} {r:.2e} (max|g| {m:.2e})" for k, (r, m) in top)
          + "".join(f"; {n} {r:.2e} of its max off the one-process step, both within {e:.2e} of "
                    f"the float64 sum (bound 1e-3)" for n, r, e in bias)
          + f"; {outside} of {elements} params outside rtol 1e-4 / atol 2e-5, {quiet_outside} of "
          f"them below the gradient noise floor (bound 2 lr); EMA {ema_ok}, u/v {uv_ok} "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        raise AssertionError(f"space {leg}: the dp x sp step disagrees with the one-process step")


def space_parity_reference(leg: str, opt: dict, batch: dict) -> dict:
    """The one-process step on the card on the 16 rows (f32, TF32 off); each
    data group's chips draw their own boxes, as the ranks do; D's per-pixel
    logit terms kept for the float64 sum of its last bias's gradient."""
    from satlas_sr_tpu_torch.models import build_model

    with tf32_off():
        model = build_model(json.loads(json.dumps(opt)), device="cuda")
        terms = []
        if hasattr(model, "cri_gan"):
            gan = model.cri_gan

            def cri_gan(logits, target_is_real, is_disc=False):
                if is_disc and logits.shape[1] > 2:
                    terms.append((logits.detach().double(), float(target_is_real)))
                return gan(logits, target_is_real, is_disc)

            model.cri_gan = cri_gan
        if "Chip" in batch:
            draw = model._sample_boxes
            seed = (int(opt["manual_seed"]) * 7919 + 1) % (2 ** 31 - 1)
            groups = [batch["Chip"][i:i + SP_PARITY_GROUP]
                      for i in range(0, len(batch["Chip"]), SP_PARITY_GROUP)]
            boxes = np.concatenate([draw(list(g), np.random.RandomState(seed)) for g in groups])
            model._sample_boxes = lambda chips, rng: boxes
            batch = {**batch, "Chip": list(batch["Chip"])}
        logs = {k: float(v) for k, v in model.train_iter(batch, 1).items()}
        torch.cuda.synchronize()
        rec = step_record(model)
    rec["logs"] = logs
    rec["exact_bias"] = (float(sum((torch.sigmoid(z) - y).mean() for z, y in terms))
                         if terms else None)
    if "Chip" in batch:
        rec["crossing"] = int(((boxes[..., 1] < 64) & (boxes[..., 3] > 64)).sum())
        rec["boxes"] = int(boxes[..., 0].size)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_space_train(seed: int, work: str, card: str) -> dict:
    """Phase 16 (see the module docstring): the train step on a dp x sp
    layout, four gloo ranks on the one card."""
    root = os.path.join(work, "space_train")
    data, val = os.path.join(root, "data"), os.path.join(root, "val")
    make_s2naip_tree(data, np.random.RandomState(seed + 16), SP_TRAIN_CHIPS)
    make_s2naip_tree(val, np.random.RandomState(seed + 17), SP_VAL_CHIPS)
    write_tile_weights(data, seed + 18)
    osm_path = write_osm_boxes(data, np.random.RandomState(seed + 19))
    TimingRecords()

    rng = np.random.RandomState(seed + 20)
    n = 2 * SP_PARITY_GROUP
    legs, refs = {}, {}
    with open(osm_path) as f:
        chips = sorted(json.load(f))[:n]
    for leg, config in SP_LEGS:
        opt = load_config(config, compute_dtype="float32", matmul_precision="highest",
                          manual_seed=seed, is_train=True, val=None)
        if leg == "osm":
            opt["datasets"]["train"]["osm_objs_path"] = osm_path
        lr_shape = (n, N_LR, HW, HW, 3) if leg == "srcnn" else (n, HW, HW, IN_CH)
        batch = {"lr": (rng.rand(*lr_shape) * 255).astype(np.uint8),
                 "hr": (rng.rand(n, 4 * HW, 4 * HW, 3) * 255).astype(np.uint8)}
        if leg == "osm":
            batch["Chip"] = np.asarray(chips)
        np.savez(os.path.join(root, f"{leg}.npz"), **batch)
        legs[leg] = opt
        refs[leg] = space_parity_reference(leg, opt, batch)

    shipped = train_opt("sp4_shipped", root, data, val, spatial_shards=SPACE_WORLD)
    shipped["datasets"]["train"]["batch_size_per_gpu"] = SP_SHIPPED_PER_RANK
    shipped["train"]["total_iter"] = SP_ITERS
    shipped["val"].update(val_freq=1000, save_img=False, metrics={
        k: v for k, v in shipped["val"]["metrics"].items() if k in ("psnr", "ssim")})
    shipped["logger"].update(save_checkpoint_freq=1000)
    with open(os.path.join(root, "plan.json"), "w") as f:
        json.dump({"legs": legs, "root": root,
                   "yml": write_yml(shipped, os.path.join(root, "shipped.yml"))}, f)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    ranks = run_space_ranks(root, "space_train_rank", timeout=600, phase=16)
    ranks_s = time.time() - t0

    parity = {}
    for leg, _ in SP_LEGS:
        recs = [torch.load(os.path.join(root, f"{leg}_r{r}.pt")) for r in range(SPACE_WORLD)]
        lr = float(legs[leg]["train"]["optim_g"]["lr"])
        space_parity_check(leg, refs[leg], recs, [r["parity"][leg]["logs"] for r in ranks], lr,
                           refs[leg]["exact_bias"], card)
        launches = [r["parity"][leg]["launches"] for r in ranks]
        want = [0, 0] if leg == "srcnn" else [RDBS_PER_FORWARD, RDBS_PER_FORWARD]
        if leg == "osm":
            print(f"space osm: {refs[leg]['crossing']} of the {refs[leg]['boxes']} boxes drawn "
                  f"cross the band edge at row 64 (their crops read both bands)")
        print(f"space {leg}: rdb launches/backwards by rank {launches} (expected {want} each) "
              f"{'ok' if all(l == want for l in launches) else 'FAIL'}")
        if any(l != want for l in launches):
            raise AssertionError(f"space {leg}: a rank's step missed the kernel")
        parity[leg] = [sum(l[0] for l in launches), sum(l[1] for l in launches)]

    # (b) as shipped at dp 1 x sp 4
    elt = torch.tensor([], dtype=torch.bfloat16).element_size()
    b = SP_SHIPPED_PER_RANK * SPACE_WORLD
    want = space_train_bytes(shipped, b, elt)
    iters = [r["shipped"]["iters"] for r in ranks]
    logs_equal = all([it["logs"] for it in its] == [it["logs"] for it in iters[0]] for its in iters)
    finite = all(math.isfinite(v) for it in iters[0] for v in it["logs"].values())
    val_fwd = SP_VAL_CHIPS  # every rank runs the group's validation images, batch 1
    ok = logs_equal and finite and len(iters[0]) == SP_ITERS
    for r, rank in enumerate(ranks):
        its, sh = rank["shipped"]["iters"], rank["shipped"]
        sides = 1 if r in (0, SPACE_WORLD - 1) else 2
        steady = its[1:]
        fwd_ok = all(it["fwd"]["bytes"] == sides * want["fwd"] and it["bwd"]["bytes"]
                     == sides * want["bwd"] and (it["fwd"]["n"], it["bwd"]["n"])
                     == want["exchanges"] for it in its)
        counts_ok = (all(it["launches"] == it["backwards"] == RDBS_PER_FORWARD for it in its)
                     and sh["launches"] == RDBS_PER_FORWARD * (SP_ITERS + val_fwd)
                     and sh["backwards"] == RDBS_PER_FORWARD * SP_ITERS)
        ok &= fwd_ok and counts_ok
        print(f"space shipped rank {r} (bf16, {b} rows at dp 1 x sp 4, {SP_ITERS} iterations): "
              f"step ms {[round(it['ms'], 1) for it in its]} (steady "
              f"{sum(it['ms'] for it in steady) / len(steady):.1f}); halo exchanges a step "
              f"forward {its[-1]['fwd']['n']} / backward {its[-1]['bwd']['n']} (computed "
              f"{want['exchanges']}), host ms forward "
              f"{[round(it['fwd']['host_ms'], 1) for it in its]} backward "
              f"{[round(it['bwd']['host_ms'], 1) for it in its]}, CUDA events forward "
              f"{[round(it['fwd']['event_ms'], 1) for it in its]} backward "
              f"{[round(it['bwd']['event_ms'], 1) for it in its]}; bytes sent forward "
              f"{its[-1]['fwd']['bytes']} backward {its[-1]['bwd']['bytes']} (computed {sides} x "
              f"{want['fwd']} / {want['bwd']}) {fwd_ok}; rdb launches {sh['launches']} "
              f"({RDBS_PER_FORWARD} x ({SP_ITERS} steps + {val_fwd} validation forwards)), "
              f"backwards "
              f"{sh['backwards']} ({RDBS_PER_FORWARD} x {SP_ITERS}) {counts_ok}; peak memory "
              f"{sh['peak_mb'] / 1024:.2f} GiB (one process at batch 32, phase 8: "
              f"{NATIVE_STEP_GB} GB); the CLI {sh['seconds']:.1f} s ({NOT_SCALING_SP}) [{card}]")
    exp = os.path.join(root, "experiments", "sp4_shipped")
    _, val_rows = train_rows(exp)
    ok &= bool(val_rows) and all(math.isfinite(v) for r in val_rows for k, v in r.items()
                                 if k in ("psnr", "ssim"))
    ok &= os.path.exists(os.path.join(exp, "models", "net_g_latest.pth"))
    print(f"space shipped: logs of every iteration bit-equal on the 4 ranks {logs_equal}, finite "
          f"{finite}; {iters[0][-1]['logs']}; validation on bands {val_rows[-1] if val_rows else None}; "
          f"net_g_latest.pth written; the ranks' processes {ranks_s:.1f} s in all "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        raise AssertionError("space shipped: the dp 1 x sp 4 train CLI failed its gates")

    rows = {"sp4_edge": rdb_train_check(seed, b, HW // SPACE_WORLD + 5, (torch.bfloat16,)),
            "sp4_interior": rdb_train_check(seed, b, HW // SPACE_WORLD + 10, (torch.bfloat16,)),
            "sp2": rdb_train_check(seed, SP_PARITY_GROUP, HW // 2 + 5, (torch.float32,)),
            "val_edge": phase_kernels_at(seed, 1, HW // SPACE_WORLD + 5, HW),
            "val_interior": phase_kernels_at(seed, 1, HW // SPACE_WORLD + 10, HW)}
    edge, interior = (0, SPACE_WORLD - 1), (1, 2)
    shipped_counts = {}
    for part, ids in (("edge", edge), ("interior", interior)):
        its = [it for r in ids for it in ranks[r]["shipped"]["iters"]]
        shipped_counts[part] = {
            "fwd": sum(it["launches"] for it in its), "bwd": sum(it["backwards"] for it in its),
            "val": sum(ranks[r]["shipped"]["launches"] for r in ids) - sum(it["launches"]
                                                                           for it in its)}
    return {"rows": rows, "parity": parity, "shipped": shipped_counts,
            "step_ms": [sum(it["ms"] for it in r["shipped"]["iters"][1:]) / (SP_ITERS - 1)
                        for r in ranks]}

# -- phase 17: the training-evidence, bf16-trajectory, band-order and conversion tools --

EVIDENCE_ITERS, EVIDENCE_PREEMPT, EVIDENCE_VAL_CHIPS = 300, 0.4, 8
JAX_EVIDENCE = os.path.join(REPO, "TRAIN_EVIDENCE_r05.json")  # a TPU run: printed, never gated
BAND_POOL, BAND_TRUE = ("tci", "b08", "b05", "b06"), ["tci", "b08"]
BAND_CHIPS, BAND_TOL_DB = 16, 0.01  # band_order_search's default --limit; dB, card vs CPU


def counting_command(path: str) -> list:
    """A stand-in for `python -m satlas_sr_tpu_torch.train` taking its
    arguments: it runs the train CLI's main and, at exit, appends the
    process's rdb LAUNCHES and BACKWARDS and its wall seconds to `path` as
    one JSON line (and prints them)."""
    code = ("import atexit, json, sys, time\n"
            "t0 = time.time()\n"
            "from satlas_sr_tpu_torch import train\n"
            "from satlas_sr_tpu_torch.ops.cuda import rdb\n"
            "def report():\n"
            "    rec = {'launches': rdb.LAUNCHES, 'backwards': rdb.BACKWARDS,\n"
            "           'seconds': time.time() - t0}\n"
            f"    with open({path!r}, 'a') as f:\n"
            "        f.write(json.dumps(rec) + '\\n')\n"
            "    print('train child rdb counts', json.dumps(rec), flush=True)\n"
            "atexit.register(report)\n"
            "train.main(sys.argv[1:])\n")
    return [sys.executable, "-c", code]


def trained_iterations(exp: str) -> list:
    """(first, last) iteration of each train process of a run, in order, from
    its train_*.log: the start (0, or "Resuming training from ... iter: N")
    and the end (the stop signal's iteration, else total_iter)."""
    import re

    legs = []
    for name in sorted(f for f in os.listdir(exp) if f.startswith("train_") and f.endswith(".log")):
        text = open(os.path.join(exp, name)).read()
        start = re.search(r"Resuming training from epoch: \d+, iter: (\d+)", text)
        stop = re.search(r"Stop signal .* at iter (\d+)", text)
        legs.append((int(start.group(1)) if start else 0,
                     int(stop.group(1)) if stop else EVIDENCE_ITERS))
    return legs


def checkpoint_val_psnrs(exp: str, corpus: str, iters) -> dict:
    """{iter: {"g": PSNR, "ema": PSNR}}: the run's net_g_{iter}.pth, its
    trained generator (`params`) and its EMA (`params_ema`), on the
    protocol's 8 val chips as the trainer's validation runs them (one chip a
    forward, bfloat16 under matmul_precision default, rint to uint8, PSNR
    with crop_border 4, averaged)."""
    from satlas_sr_tpu_torch import train_evidence as tev
    from satlas_sr_tpu_torch.archs import RRDBNet
    from satlas_sr_tpu_torch.data import build_dataset
    from satlas_sr_tpu_torch.inference import _precision
    from satlas_sr_tpu_torch.metrics.psnr_ssim import calculate_psnr
    from satlas_sr_tpu_torch.models.base import to_uint8
    from satlas_sr_tpu_torch.utils.torch_io import load_torch_state_dict

    opt = tev.FAMILIES["esrgan"](corpus, EVIDENCE_ITERS, 1, 1, 1)
    ds = build_dataset({**opt["datasets"]["val"], "phase": "val", "scale": 4})
    items = [ds[i] for i in range(len(ds))]
    widths = {k: v for k, v in opt["network_g"].items() if k != "type"}
    net = RRDBNet(**widths, scale=4, dtype=torch.bfloat16, device="cuda")
    out = {}
    for it in iters:
        out[it] = {}
        for name, key in (("g", "params"), ("ema", "params_ema")):
            path = os.path.join(exp, "models", f"net_g_{it}.pth")
            net.load_state_dict(load_torch_state_dict(path, key))
            net.invalidate_packs()
            psnrs = []
            with torch.inference_mode(), _precision("default"):
                for item in items:
                    x = torch.from_numpy(np.asarray(item["lr"])[None]).cuda().float() / 255.0
                    sr = to_uint8(net(x.to(torch.bfloat16))).cpu().numpy()[0]
                    psnrs.append(calculate_psnr(sr, np.asarray(item["hr"]), crop_border=4))
            out[it][name] = float(np.mean(psnrs))
    return out


def evidence_esrgan(work: str, corpus: str, card: str) -> dict:
    """(a): train_evidence's ESRGAN leg on the card, the children through
    counting_command; its gates (see the module docstring, phase 17)."""
    import argparse

    from satlas_sr_tpu_torch import dtype_train_equiv as dte
    from satlas_sr_tpu_torch import train_evidence as tev

    counts = os.path.join(work, "evidence_counts.jsonl")
    args = argparse.Namespace(iters=EVIDENCE_ITERS, workdir=corpus, preempt_frac=EVIDENCE_PREEMPT,
                              psnr_margin=tev.PSNR_MARGIN_DB, device="cuda")
    section, _ = tev.run_family("esrgan", args, command=counting_command(counts))
    exp = os.path.join(tev.EXPERIMENTS, "evidence_esrgan")
    if "error" in section:
        raise AssertionError(f"train_evidence esrgan: {section['error']}")
    procs = [json.loads(line) for line in open(counts)]
    legs = trained_iterations(exp)
    trained = sum(b - a for a, b in legs)
    all_val_rows = [r for r in map(json.loads, open(os.path.join(exp, "metrics.jsonl")))
                    if "val_dataset" in r]
    val_forwards = EVIDENCE_VAL_CHIPS * len(all_val_rows)
    launches = sum(p["launches"] for p in procs)
    backwards = sum(p["backwards"] for p in procs)
    bounds = section.get("d_loss_bounds") or {}
    ema = [(v["iter"], v["psnr"]) for v in section["val_psnr"]]
    ckpt = checkpoint_val_psnrs(exp, corpus, [it for it, _ in ema])
    g_rise, g_fit, g_learns = tev._psnr_gate([(it, ckpt[it]["g"]) for it, _ in ema],
                                             tev.PSNR_MARGIN_DB)
    gates = {
        "resumed_ok": section["resumed_ok"] is True,
        "pixel_loss_fell_20pct": section["loss_last"] < 0.8 * section["loss_first"],
        "d_loss_bounded_finite": bool(bounds) and all(np.isfinite(v) and abs(v) < 50
                                                      for pair in bounds.values() for v in pair),
        "generator_val_psnr_rose": g_learns is True,
        "ema_replayed_within_0.01db": all(abs(ckpt[it]["ema"] - p) <= 1e-2 for it, p in ema),
        "rdb_counts": (len(procs) == 2 and len(legs) == 2 and legs[0][1] == legs[1][0]
                       and trained == EVIDENCE_ITERS
                       and backwards == RDBS_PER_FORWARD * trained
                       and launches == RDBS_PER_FORWARD * (trained + val_forwards)),
    }
    jax_rise = json.load(open(JAX_EVIDENCE))["families"]["esrgan"]["val_psnr_rise_db"]
    steady = dte.steady_iter_seconds(exp)
    print(f"(a) train_evidence esrgan, {EVIDENCE_ITERS} iterations (bf16, batch 32, nf 64, 23 "
          f"blocks, VGG19, U-Net SN D), SIGTERM at {EVIDENCE_PREEMPT}: the protocol's val PSNR "
          f"(EMA generator, decay 0.999) " + ", ".join(f"{it}: {p:.3f}" for it, p in ema)
          + f" dB, rise {section['val_psnr_rise_db']} pointwise, {section['val_psnr_fit_rise_db']} "
          f"by fit: val_psnr_rose {section['val_psnr_rose']}, section pass {section['pass']} "
          f"(printed, not gated: see the module docstring; JAX's record, a TPU run, for comparison "
          f"only: {jax_rise}); the trained generator's val PSNR "
          + ", ".join(f"{it}: {ckpt[it]['g']:.3f}" for it, _ in ema)
          + f" dB, rise {g_rise:+.4f} pointwise, {g_fit:+.4f} by fit; EMA replayed from the "
          f"checkpoints " + ", ".join(f"{ckpt[it]['ema']:.3f}" for it, _ in ema) + "; "
          f"{section['loss_key']} {section['loss_first']} -> {section['loss_last']} "
          f"({section['pix_drop_pct']}% drop); D-loss bounds {json.dumps(bounds)}; legs "
          f"(iterations) {legs}, wall seconds a leg {[round(p['seconds'], 1) for p in procs]} "
          f"({section['wall_seconds']} s in all); steady {steady} s a step (log timestamps); rdb "
          f"launches {launches} (expected {RDBS_PER_FORWARD} x ({trained} + {val_forwards}) = "
          f"{RDBS_PER_FORWARD * (trained + val_forwards)}), backwards {backwards} (expected "
          f"{RDBS_PER_FORWARD * trained}); gates {gates} [{card}]", flush=True)
    if not all(gates.values()):
        raise AssertionError(f"train_evidence esrgan failed its gates: {section}")
    return {"train": (RDBS_PER_FORWARD * trained, backwards),
            "val": launches - RDBS_PER_FORWARD * trained}


def evidence_l2_dtypes(work: str, corpus: str, card: str) -> dict:
    """(b): dtype_train_equiv --family l2 on the card; gates: both runs
    complete with finite losses and the f32 run's val PSNR passes
    _psnr_gate at 0.05 dB. The verdict (its delta against the 0.05 dB bar,
    the speedup) and the module's own exit code are printed."""
    from satlas_sr_tpu_torch import dtype_train_equiv as dte
    from satlas_sr_tpu_torch import train_evidence as tev

    out = os.path.join(work, "dtype_equiv_l2.json")
    rc = dte.main(["--family", "l2", "--iters", str(EVIDENCE_ITERS), "--workdir", corpus,
                   "--out", out, "--device", "cuda"])
    verdict = json.load(open(out))
    runs = verdict["runs"]
    f32 = runs["float32"]
    rise, fit, learns = tev._psnr_gate([(v["iter"], v["psnr"]) for v in f32.get("val_psnr", [])],
                                       tev.PSNR_MARGIN_DB)
    gates = {"complete": all("error" not in s for s in runs.values()),
             "loss_finite": all(s.get("loss_finite") is True for s in runs.values()),
             "f32_learns": learns is True}
    print(f"(b) dtype_train_equiv l2, {EVIDENCE_ITERS} iterations (HighResNet hidden 128, batch "
          f"32, lr 2e-3): " + "; ".join(
              f"{d} val PSNR "
              + ", ".join(f"{v['iter']}: {v['psnr']:.3f}" for v in s.get("val_psnr", []))
              + f", tot_loss {s.get('loss_first')} -> {s.get('loss_last')}, finite "
              f"{s.get('loss_finite')}, steady {s.get('steady_iter_seconds')} s a step, wall "
              f"{s.get('wall_seconds')} s" for d, s in runs.items())
          + f"; f32 rise {rise} pointwise, {fit} by fit; final val-PSNR delta bf16 vs f32 "
          f"{verdict['final_val_psnr_delta_db']} dB (bar {verdict['bar_db']}: "
          f"{'within' if verdict['within_bar'] else 'OUT OF BAR'}), bf16 speedup "
          f"{verdict['bf16_speedup_vs_f32']} (the module's exit code {rc}); gates {gates} "
          f"[{card}]", flush=True)
    if not all(gates.values()):
        raise AssertionError(f"dtype_train_equiv l2 failed its gates: {verdict}")
    return verdict


def evidence_band_search(seed: int, work: str, card: str) -> dict:
    """(c): band_order_search at options/zoo/infer_esrgan_10m.yml's widths on
    seeded weights, its NAIP GT the plain version's SR of the true stacking
    (on the CPU) moved by a seeded -2..2 levels, so every candidate's PSNR
    is finite on both sides: the card's search against the same search on
    the CPU."""
    from satlas_sr_tpu_torch import band_order_search as bos
    from satlas_sr_tpu_torch.archs import RRDBNet
    from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod
    from satlas_sr_tpu_torch.utils.imgio import write_png
    from satlas_sr_tpu_torch.utils.torch_io import save_torch_state_dict

    cpf = sum(3 if b == "tci" else 1 for b in BAND_TRUE)
    model = RRDBNet(num_in_ch=N_LR * cpf, num_out_ch=3, scale=4, seed=seed + 40, device="cpu")
    pth = os.path.join(work, "esrgan_10m_seeded.pth")
    save_torch_state_dict(pth, model.state_dict(), param_key="params_ema")
    root, rng = os.path.join(work, "band_tree"), np.random.RandomState(seed + 41)
    stacks, chips = [], []
    for c in range(BAND_CHIPS):
        chip = f"{3000 + c}_{4000 + c}"
        frames = {}
        for band in BAND_POOL:
            img = (rng.rand(N_LR * 32, 32, 3 if band == "tci" else 1) * 254 + 1).astype(np.uint8)
            write_png(os.path.join(root, "sentinel2", chip, f"{band}.png"), img)
            frames[band] = img.reshape(N_LR, 32, 32, -1)
        stack = np.concatenate([frames[b] for b in BAND_TRUE], axis=-1)
        stacks.append(np.concatenate(list(stack), axis=-1))
        chips.append(chip)
    t0 = time.time()
    hr = bos.super_resolve(model, np.stack(stacks), "cpu")
    for chip, img in zip(chips, hr):
        img = np.clip(img.astype(np.int64) + rng.randint(-2, 3, img.shape), 0, 255)
        write_png(os.path.join(root, "naip", chip, f"{chip}.png"), img.astype(np.uint8))
    gt_s = time.time() - t0
    del model
    reports, rcs, secs = {}, {}, {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(work, f"band_search_{dev}.json")
        rdb_mod.LAUNCHES = 0
        t0 = time.time()
        rcs[dev] = bos.main([pth, root, "--out", out, "--device", dev])
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = rdb_mod.LAUNCHES
        secs[dev] = time.time() - t0
        reports[dev] = json.load(open(out))
    card_r, cpu_r = reports["cuda"], reports["cpu"]
    psnr_card = {tuple(r["bands"]): r["psnr"] for r in card_r["ranking"]}
    psnr_cpu = {tuple(r["bands"]): r["psnr"] for r in cpu_r["ranking"]}
    deltas = {",".join(k): abs(psnr_card[k] - v) for k, v in psnr_cpu.items() if k in psnr_card}
    gates = {"exit_0": rcs == {"cuda": 0, "cpu": 0}, "winner": card_r["winner"] == BAND_TRUE,
             "margin_3db": card_r["margin_db"] >= 3.0,
             "card_vs_cpu": psnr_card.keys() == psnr_cpu.keys()
             and all(d <= BAND_TOL_DB for d in deltas.values()),
             "launches": launches == RDBS_PER_FORWARD * len(psnr_card)}
    print(f"(c) band_order_search on {BAND_CHIPS} chips of {list(BAND_POOL)} (num_in_ch "
          f"{N_LR * cpf}, nf {NF}, {NUM_BLOCK} blocks, g {G}; GT made on the CPU in {gt_s:.1f} s): "
          f"card ranking " + ", ".join(f"{','.join(r['bands'])} {r['psnr']:.4f}"
                                       for r in card_r["ranking"])
          + f" dB, winner {card_r['winner']} by {card_r['margin_db']:.3f} dB; |card - CPU| a "
          f"candidate {json.dumps({k: float(f'{v:.3e}') for k, v in deltas.items()})} dB (bound "
          f"{BAND_TOL_DB}); rdb launches {launches} (expected {RDBS_PER_FORWARD} x "
          f"{len(psnr_card)}); seconds card {secs['cuda']:.1f}, CPU {secs['cpu']:.1f}; gates "
          f"{gates} [{card}]", flush=True)
    if not all(gates.values()):
        raise AssertionError("band_order_search failed its gates")
    return {"launches": launches, "rows": phase_kernels_at(seed, BAND_CHIPS, HW)}


def evidence_convert(seed: int, work: str, weights: str, net_d: str, card: str) -> dict:
    """(d): convert_checkpoint .pth -> .msgpack -> .pth on the card for
    phase 3's esrgan_8S2 .pth and phase 8's U-Net D, every tensor bit-equal
    to the original; infer_example.yml from the original .pth and from the
    .msgpack, every sr.png byte-equal."""
    from satlas_sr_tpu_torch import convert_checkpoint as cc
    from satlas_sr_tpu_torch.infer import run_inference
    from satlas_sr_tpu_torch.ops.cuda import rdb as rdb_mod
    from satlas_sr_tpu_torch.utils.torch_io import load_torch_state_dict

    equal, msgpacks = {}, {}
    for name, pth, arch, key in (("esrgan_8S2", weights, "SSR_RRDBNet", "params_ema"),
                                 ("unet_d", net_d, "SSR_UNetDiscriminatorSN", "params")):
        mp, back = (os.path.join(work, f"{name}_converted{ext}") for ext in (".msgpack", ".pth"))
        rcs = (cc.main(["from_pth", pth, mp, arch, key, "--device", "cuda"]),
               cc.main(["to_pth", mp, back, arch, "--device", "cuda"]))
        src, got = load_torch_state_dict(pth, key), load_torch_state_dict(back, "params")
        equal[name] = (rcs == (0, 0) and sorted(got) == sorted(src)
                       and all(got[k].dtype == v.dtype and torch.equal(got[k], v)
                               for k, v in src.items()))
        msgpacks[name] = mp
    data = os.path.join(work, "convert_s2")
    make_tree(data, np.random.RandomState(seed + 42), BATCH)
    launches, pngs = {}, {}
    for name, w in (("pth", weights), ("msgpack", msgpacks["esrgan_8S2"])):
        opt = load_config("infer_example.yml", weights=w, data_dir=data,
                          save_path=os.path.join(work, f"convert_infer_{name}"))
        rdb_mod.LAUNCHES = 0
        n = run_inference(opt, device="cuda")
        torch.cuda.synchronize()
        launches[name] = rdb_mod.LAUNCHES
        pngs[name] = [open(os.path.join(opt["save_path"], str(i), "sr.png"), "rb").read()
                      for i in range(n)]
    gates = {"round_trip": all(equal.values()),
             "sr_png": len(pngs["pth"]) == BATCH and pngs["pth"] == pngs["msgpack"],
             "launches": launches == {"pth": RDBS_PER_FORWARD, "msgpack": RDBS_PER_FORWARD}}
    print(f"(d) convert_checkpoint from_pth -> to_pth: bit-equal {equal}; infer_example on {BATCH} "
          f"chips from the .pth and the converted .msgpack: sr.png "
          f"{'byte-equal' if gates['sr_png'] else 'DIFFER'}, rdb launches {launches}; gates "
          f"{gates} [{card}]", flush=True)
    if not all(gates.values()):
        raise AssertionError("convert_checkpoint failed its gates")
    return launches


def phase_evidence(seed: int, work: str, card: str) -> dict:
    """Phase 17 (see the module docstring): (a) train_evidence's ESRGAN leg,
    (b) dtype_train_equiv's L2 leg, (c) band_order_search, (d)
    convert_checkpoint, each through the port's module on the card. Needs
    phase 3's seeded .pth and phase 8's net_d .pth under `work`."""
    from satlas_sr_tpu_torch import train_evidence as tev

    corpus = os.path.join(work, "evidence")
    tev.make_corpus(corpus)
    esrgan = evidence_esrgan(work, corpus, card)
    l2 = evidence_l2_dtypes(work, corpus, card)
    band = evidence_band_search(seed, work, card)
    net_d = os.path.join(work, "train", "experiments", "smoke_train", "models",
                         f"net_d_{TRAIN_ITERS}.pth")
    convert = evidence_convert(seed, work, os.path.join(work, "esrgan_8S2_seeded.pth"), net_d, card)
    return {"esrgan": esrgan, "l2": l2, "band": band, "convert": convert}


def timed(phase, *args):
    """phase(*args), its seconds printed."""
    t0 = time.time()
    out = phase(*args)
    print(f"[{phase.__name__}: {time.time() - t0:.1f} s]", flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--kernels-only", action="store_true",
                        help="build and check the kernels (phases 1-2) and stop")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1
    # read when cuBLAS starts: phase 14's deterministic runs need it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from satlas_sr_tpu_torch.ops.cuda.build import load, ptxas_report

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {kind}", flush=True)
    t0 = time.time()
    load("rdb")
    print(f"built rdb.cu in {time.time() - t0:.1f} s")
    print(f"--- ptxas report for rdb.cu ---\n{ptxas_report('rdb').strip()}")
    kernels = phase_kernels(args.seed)
    if args.kernels_only:
        return 0

    kernels_tile = phase_kernels_at(args.seed, 1, TILE)
    kernels_b1 = phase_kernels_at(args.seed, 1, HW)
    kernels_chunk = phase_kernels_at(args.seed, 256, HW)

    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    launches = timed(phase_main_path, args.seed, work, card)
    weights = os.path.join(work, "esrgan_8S2_seeded.pth")
    grid_launches = timed(phase_grid, args.seed, work, weights)
    zoo_launches = timed(phase_zoo, args.seed, work)
    codec = timed(phase_codec, args.seed, work, weights, card)
    test_cli = timed(phase_test_cli, args.seed, work, weights, card)
    train = timed(phase_train, args.seed, work, card)
    families = timed(phase_train_families, args.seed, work, card)
    clip = timed(phase_clip_train, args.seed, work, card, train["flops_step"])
    serving = timed(phase_serve, args.seed, work, weights, card)
    tools = timed(phase_tools, args.seed, work, weights,
                  os.path.join(work, "train", "experiments", "smoke_train", "training_states",
                               f"{TRAIN_ITERS}.state"), card)
    accum = timed(phase_accum_tools, args.seed, work, card)
    multi = timed(phase_multi, args.seed, work, card)
    space = timed(phase_space, args.seed, work, weights, card)
    space_train = timed(phase_space_train, args.seed, work, card)
    evidence = timed(phase_evidence, args.seed, work, card)
    shutil.rmtree(work)
    train_runs = {**train["runs"], **families["runs"], "clip": clip["runs"]}
    print(f"paths: rdb launches {json.dumps({**launches, **grid_launches, **zoo_launches})}, "
          f"test CLI {json.dumps(test_cli['launches'])}, train CLI "
          f"{json.dumps({k: v['launches'] for k, v in train_runs.items()})}; codec {codec}")

    record = []
    for name, dtype in (("bf16", "bfloat16"), ("f32", "float32")):
        design = "wgmma" if name == "bf16" else "wgmma-3xtf32"
        record.append({"name": f"rdb[{name}]", "route": "cuda", "design": design,
                       "source": "satlas_sr_tpu_torch/csrc/rdb.cu",
                       "replaces": "satlas_sr_tpu/ops/pallas/rdb.py:129",
                       "shape": [BATCH, HW, HW, NF], "launches": launches[dtype], **kernels[name]})
    for name, path in (("bf16", "whole_tile"), ("f32", "whole_tile_f32")):
        record.append({"name": f"rdb[{name},whole_tile]", "route": "cuda",
                       "design": "wgmma" if name == "bf16" else "wgmma-3xtf32",
                       "source": "satlas_sr_tpu_torch/csrc/rdb.cu",
                       "replaces": "satlas_sr_tpu/ops/pallas/rdb.py:129",
                       "shape": [1, TILE, TILE, NF], "launches": grid_launches[path],
                       **kernels_tile[name]})
    record.append({"name": "rdb[bf16,grid_chunked]", "route": "cuda", "design": "wgmma",
                   "source": "satlas_sr_tpu_torch/csrc/rdb.cu",
                   "replaces": "satlas_sr_tpu/ops/pallas/rdb.py:129",
                   "shape": [256, HW, HW, NF],
                   "launches": grid_launches["chunked"] + grid_launches["halo"],
                   **kernels_chunk["bf16"]})
    for name, run in (("bf16", "bf16"), ("f32", "f32")):
        record.append({"name": f"rdb[{name},test_b1]", "route": "cuda",
                       "design": "wgmma" if name == "bf16" else "wgmma-3xtf32",
                       "source": "satlas_sr_tpu_torch/csrc/rdb.cu",
                       "replaces": "satlas_sr_tpu/ops/pallas/rdb.py:129",
                       "shape": [1, HW, HW, NF],
                       "launches": test_cli["launches"][run]
                       + (test_cli["launches"]["bf16_full"] if name == "bf16" else 0),
                       **kernels_b1[name]})
    for name in ("bf16", "f32"):
        design = "wgmma" if name == "bf16" else "wgmma-3xtf32"
        rows = train["rdb"][name]
        record.append({"name": f"rdb[{name},train_fwd]", "route": "cuda",
                       "design": design + ", concat buffer kept for the backward",
                       "source": "satlas_sr_tpu_torch/csrc/rdb.cu",
                       "replaces": "satlas_sr_tpu/ops/pallas/rdb.py:129",
                       "shape": [TRAIN_BATCH, HW, HW, NF],
                       "launches": train["runs"][name]["launches"], **rows["fwd"]})
        record.append({"name": f"rdb[{name},train_bwd]", "route": "cuda",
                       "design": "rdb_backward: cuDNN conv gradients from the saved concat "
                                 "(stock ops; the TPU kernel has no backward)",
                       "source": "satlas_sr_tpu_torch/ops/cuda/rdb.py",
                       "replaces": "satlas_sr_tpu/ops/pallas/rdb.py:129",
                       "shape": [TRAIN_BATCH, HW, HW, NF],
                       "launches": train["runs"][name]["backwards"], **rows["bwd"]})
    rows = train["rdb"]["bf16"]  # the same kernel at the same shape, timed in phase 8
    for key in ("osm", "ssim", "clip"):
        run = train_runs[key]
        record.append({"name": f"rdb[bf16,{key}_train_fwd]", "route": "cuda",
                       "design": "wgmma, concat buffer kept for the backward",
                       "source": "satlas_sr_tpu_torch/csrc/rdb.cu",
                       "replaces": "satlas_sr_tpu/ops/pallas/rdb.py:129",
                       "shape": [TRAIN_BATCH, HW, HW, NF], "launches": run["launches"],
                       **rows["fwd"]})
        record.append({"name": f"rdb[bf16,{key}_train_bwd]", "route": "cuda",
                       "design": "rdb_backward: cuDNN conv gradients from the saved concat "
                                 "(stock ops; the TPU kernel has no backward)",
                       "source": "satlas_sr_tpu_torch/ops/cuda/rdb.py",
                       "replaces": "satlas_sr_tpu/ops/pallas/rdb.py:129",
                       "shape": [TRAIN_BATCH, HW, HW, NF], "launches": run["backwards"],
                       **rows["bwd"]})
    for name in ("bf16", "f32"):
        dtype = "bfloat16" if name == "bf16" else "float32"
        for b, rows in ((8, serving["rows"][name]), (BATCH, kernels[name])):
            record.append({"name": f"rdb[{name},serve_b{b}]", "route": "cuda",
                           "design": ("wgmma" if name == "bf16" else "wgmma-3xtf32")
                           + ", through the satlas_sr_torch::rdb op (live and exported engines)",
                           "source": "satlas_sr_tpu_torch/csrc/rdb.cu",
                           "replaces": "satlas_sr_tpu/ops/pallas/rdb.py:129",
                           "shape": [b, HW, HW, NF],
                           "launches": serving["launches"][dtype].get(b, 0), **rows})
    for name in ("bf16", "f32"):
        record.append({"name": f"rdb[{name},acceptance_b4]", "route": "cuda",
                       "design": ("wgmma" if name == "bf16" else "wgmma-3xtf32")
                       + ", acceptance's generator and engines at its default batch 4",
                       "source": "satlas_sr_tpu_torch/csrc/rdb.cu",
                       "replaces": "satlas_sr_tpu/ops/pallas/rdb.py:129",
                       "shape": [ACCEPT_BATCH, HW, HW, NF], "launches": tools["launches"][name],
                       **tools["rows"][name]})
    train_rows_bf16 = train["rdb"]["bf16"]  # the kernel at [32, 32, 32, 64], phase 8
    train_design = ("wgmma, concat buffer kept for the backward",
                    "rdb_backward: cuDNN conv gradients from the saved concat (stock ops; the "
                    "TPU kernel has no backward)")

    def train_pair(tag, b, rows, fwd, bwd, note, dtype="bf16"):
        for part, design, n, src in (("fwd", train_design[0], fwd, "satlas_sr_tpu_torch/csrc/rdb.cu"),
                                     ("bwd", train_design[1], bwd,
                                      "satlas_sr_tpu_torch/ops/cuda/rdb.py")):
            if dtype == "f32":
                design = design.replace("wgmma", "wgmma-3xtf32")
            record.append({"name": f"rdb[{dtype},{tag}_{part}]", "route": "cuda",
                           "design": f"{design}; {note}", "source": src,
                           "replaces": "satlas_sr_tpu/ops/pallas/rdb.py:129",
                           "shape": [b, HW, HW, NF], "launches": n, **rows[dtype][part]})

    rows13, tuned = accum["rows"], accum["tune"]
    train_pair("accum", ACCUM_B, rows13[ACCUM_B], accum["users"]["launches"],
               accum["users"]["backwards"],
               f"accumulation micro-batch (accum_steps {ACCUM_K} x batch {ACCUM_B})")
    train_pair("accum_equiv", TRAIN_BATCH // EQUIV_K, rows13[TRAIN_BATCH // EQUIV_K],
               EQUIV_K * RDBS_PER_FORWARD, EQUIV_K * RDBS_PER_FORWARD,
               f"the equivalence check's micro-batch ({EQUIV_K} x {TRAIN_BATCH // EQUIV_K})", "f32")
    for b in (8, 16):
        train_pair(f"tune_b{b}", b, rows13[b], tuned["launches"].get(("bf16", b), 0),
                   tuned["backwards"].get(("bf16", b), 0), f"tune's batch-{b} candidates")
    train_pair("tune_b32", TRAIN_BATCH, train["rdb"], tuned["launches"].get(("bf16", TRAIN_BATCH), 0),
               tuned["backwards"].get(("bf16", TRAIN_BATCH), 0),
               "tune's batch-32 candidates (timed in phase 8)")
    train_pair("recipe", RECIPE_B, train["rdb"], accum["recipe"]["launches"],
               accum["recipe"]["backwards"],
               f"MIGRATION.md's recipe, {RECIPE_B} x accum_steps {RECIPE_K} (timed in phase 8)")
    remat = accum["remat"]
    recompute = sum(r["launches"] - RDBS_PER_FORWARD for m, r in remat.items()
                    if m in ("block", "rdb"))
    record.append({"name": "rdb[bf16,remat_recompute]", "route": "cuda",
                   "design": f"{train_design[0]}; rerun in the backward under "
                             "torch.utils.checkpoint (remat block and rdb, one step each): "
                             f"{recompute} of these launches are recomputes",
                   "source": "satlas_sr_tpu_torch/csrc/rdb.cu",
                   "replaces": "satlas_sr_tpu/ops/pallas/rdb.py:129",
                   "shape": [TRAIN_BATCH, HW, HW, NF],
                   "launches": sum(r["launches"] for r in remat.values()),
                   **train_rows_bf16["fwd"]})
    train_pair("repeat", TRAIN_BATCH, train["rdb"], *multi["repeat"],
               "the train CLI three times without torch's deterministic algorithms, its "
               "repeatability gate (phase 14; timed in phase 8)")
    train_pair("dp_nccl_w1", TRAIN_BATCH, train["rdb"], *multi["w1"],
               "world size 1 over NCCL through --launcher pytorch (phase 14; timed in phase 8)")
    train_pair("dp_dcp_resume", TRAIN_BATCH, train["rdb"], *multi["dcp"],
               "checkpoint_backend orbax (DCP): save, then --auto_resume (phase 14; timed in "
               "phase 8)")
    train_pair("dp_gloo_2x16", TRAIN_BATCH // MULTI_WORLD, rows13[TRAIN_BATCH // MULTI_WORLD],
               *multi["step"], f"two gloo ranks x {TRAIN_BATCH // MULTI_WORLD} on one card, both "
               "ranks' first step (phase 14; timed in phase 13)", "f32")
    record.append({"name": "rdb[bf16,dp_infer]", "route": "cuda", "design": "wgmma, infer "
                   "--launcher pytorch on two gloo ranks, both ranks' launches (phase 14)",
                   "source": "satlas_sr_tpu_torch/csrc/rdb.cu",
                   "replaces": "satlas_sr_tpu/ops/pallas/rdb.py:129",
                   "shape": [BATCH, HW, HW, NF], "launches": multi["infer"], **kernels["bf16"]})
    record.append({"name": "rdb[bf16,dp_test_b1]", "route": "cuda", "design": "wgmma, test "
                   "--launcher pytorch on two gloo ranks, both ranks' launches (phase 14)",
                   "source": "satlas_sr_tpu_torch/csrc/rdb.cu",
                   "replaces": "satlas_sr_tpu/ops/pallas/rdb.py:129",
                   "shape": [1, HW, HW, NF], "launches": multi["test"], **kernels_b1["bf16"]})
    record.append({"name": "rdb[f32,msgpack_infer]", "route": "cuda", "design": "wgmma-3xtf32, "
                   "infer_example.yml from the JAX-layout .msgpack and the .pth",
                   "source": "satlas_sr_tpu_torch/csrc/rdb.cu",
                   "replaces": "satlas_sr_tpu/ops/pallas/rdb.py:129",
                   "shape": [BATCH, HW, HW, NF], "launches": sum(accum["infer"].values()),
                   **kernels["f32"]})
    for name in ("bf16", "f32"):
        interior = space["rows"][str(SPACE_BAND + 2 * SPACE_HALO["rdb"])][name]
        edge = space["rows"][str(SPACE_BAND + SPACE_HALO["rdb"])][name]
        record.append({"name": f"rdb[{name},whole_tile_sp4]", "route": "cuda",
                       "design": ("wgmma" if name == "bf16" else "wgmma-3xtf32")
                       + ", a whole tile's row band with its 5-row halos, 4 gloo ranks on one "
                         "card (phase 15); times at the interior band, `edge` at the edge band",
                       "source": "satlas_sr_tpu_torch/csrc/rdb.cu",
                       "replaces": "satlas_sr_tpu/ops/pallas/rdb.py:129",
                       "shape": [1, SPACE_BAND + 2 * SPACE_HALO["rdb"], TILE, NF],
                       "launches": space["launches"][name], **interior,
                       "edge": {"shape": [1, SPACE_BAND + SPACE_HALO["rdb"], TILE, NF], **edge}})
    sp_rows, sp_shipped, sp_parity = (space_train[k] for k in ("rows", "shipped", "parity"))
    for part, h in (("edge", HW // SPACE_WORLD + 5), ("interior", HW // SPACE_WORLD + 10)):
        b = SP_SHIPPED_PER_RANK * SPACE_WORLD
        train_pair(f"sp4_train_{part}", b, {"bf16": sp_rows[f"sp4_{part}"]["bf16"]},
                   sp_shipped[part]["fwd"], sp_shipped[part]["bwd"],
                   f"a row band with its 5-row halos at dp 1 x sp 4, the train CLI as shipped "
                   f"({part} ranks; phase 16)")
        record[-2]["shape"] = record[-1]["shape"] = [b, h, HW, NF]
        record.append({"name": f"rdb[bf16,sp4_val_{part}]", "route": "cuda",
                       "design": "wgmma, validation's band forward at dp 1 x sp 4 (phase 16)",
                       "source": "satlas_sr_tpu_torch/csrc/rdb.cu",
                       "replaces": "satlas_sr_tpu/ops/pallas/rdb.py:129",
                       "shape": [1, h, HW, NF], "launches": sp_shipped[part]["val"],
                       **sp_rows[f"val_{part}"]["bf16"]})
    train_pair("sp2_parity", SP_PARITY_GROUP, {"f32": sp_rows["sp2"]["f32"]},
               sp_parity["esrgan"][0] + sp_parity["osm"][0],
               sp_parity["esrgan"][1] + sp_parity["osm"][1],
               "a row band with its 5-row halo at dp 2 x sp 2, the ESRGAN and OSM parity steps "
               "(phase 16)", "f32")
    record[-2]["shape"] = record[-1]["shape"] = [SP_PARITY_GROUP, HW // 2 + 5, HW, NF]
    train_pair("evidence_train", TRAIN_BATCH, train["rdb"], *evidence["esrgan"]["train"],
               f"train_evidence's ESRGAN leg, {EVIDENCE_ITERS} iterations preempted and resumed "
               "(phase 17; timed in phase 8)")
    record.append({"name": "rdb[bf16,evidence_val]", "route": "cuda",
                   "design": "wgmma, train_evidence's validation forwards (phase 17)",
                   "source": "satlas_sr_tpu_torch/csrc/rdb.cu",
                   "replaces": "satlas_sr_tpu/ops/pallas/rdb.py:129", "shape": [1, HW, HW, NF],
                   "launches": evidence["esrgan"]["val"], **kernels_b1["bf16"]})
    record.append({"name": "rdb[f32,band_search]", "route": "cuda",
                   "design": f"wgmma-3xtf32, band_order_search's {BAND_CHIPS} chips a candidate "
                             "(phase 17)",
                   "source": "satlas_sr_tpu_torch/csrc/rdb.cu",
                   "replaces": "satlas_sr_tpu/ops/pallas/rdb.py:129",
                   "shape": [BAND_CHIPS, HW, HW, NF], "launches": evidence["band"]["launches"],
                   **evidence["band"]["rows"]["f32"]})
    print(json.dumps({"kernels": record}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
