#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (uspace_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
1. the card: `nvidia-smi` name and power limit, TF32 off for comparisons;
2. build every CUDA kernel from the sources in this checkout (nvcc, sm_90a,
   one process per source, in parallel);
3. each kernel against its plain PyTorch twin at its path's shapes
   (B=50 for the sampling kernels, B=128 for the backward kernel; L=257,
   C=1024, H=16, bf16; the int8 and w8 MLPs on the 12850 rows of B=50 with
   hidden 4096; the [B, H, L, D] kernel at B=50, H=8, L=1024, D=32, and at
   H=4, D=64 and at L=600; its backward at B=128 at the same three head
   shapes, dq, dk and dv each; the blocked online-softmax kernel (row 9) at
   B=50, H=8, L=4096, D=32, at B=4, H=16, L=1025, D=64 and at a ragged
   L=1300; the bf16 and int8 attention sub-blocks at
   B=50 and the bf16 MLP and MLP sub-block on 12850 rows, each sub-block on
   its update out - x; the stage-delta base and delta halves at B=50 and on
   12850 rows, in the three hidden modes (rows 18 to 25), the base ones on
   every output, caches included, the delta ones on what they add to their
   cache; rows 1-6, 10 and 11 also at head dim 32, B=50, L=257, C=1024 in
   32 heads): max-abs and rel-L2 within the tolerances below; the delta
   MLP rows 25, 23 and 24 each against its twin (max-abs printed) and
   repeated bit-equal, at the base's own point rows 25 and 23 equal to rows
   20 and 22's outputs bit for bit and row 24 within DELTA_G_ZERO_REL of
   row 21's; rows 15 and 19 by their pieces: row 15's code pass, fc1 and
   fc2 and row 19's code pass and two GEMMs each bit-equal to its twin on
   the same inputs, row 15's sub-block to its pieces and to a repeat; rows
   21 and 22 by their pieces the same way (the f32 code pass, the mode's
   fc1, fc2 with m) at 12850 and 129 rows; row 18 by its pieces (the padded
   LN1 code pass, the GEMM's pass A partials, pass B's codes, scales and
   bf16 buffer) each bit-equal to its twin, its cache over all Lp rows
   equal to the twin's and its output to row 1's kernel on the twin's bf16
   buffer;
   for each int8 and w8 kernel, controls (twins with one rounding site
   changed) that the same limits must refuse; kernel, twin and library-call
   times with CUDA events; the bound of the same work on an H100 SXM (the
   larger of its bytes, its tensor-core operations and, for the [B, H, L, D]
   attention kernels, its exponentials over the special-function units);
3b. `ops.quant.int8_conv` on the card against the CPU at UNet-large's 3x3
   conv and Downsample shapes: equal codes, bit-equal f32 outputs;
4. the main path: U-ViT-large (embed 1024, depth 20, 16 heads, patch 2) in
   bf16 with seeded random weights, Euler-50 at batch 50 through
   `core.flow.decode` with attn_impl="auto": 21 x 50 = 1050 launches of the
   QKV-projection kernel, latents against the plain path (attn_impl="xla")
   from the same z, img/s of both, peak memory;
4b. the int8 W8A8 view's main path: the same weights in f32, quant=True,
   attn_impl="auto", Euler-50 at batch 50 from the same z: 1050 launches of
   the int8 LN + QKV-projection kernel and 1050 of the int8 MLP sub-block
   kernel and no other kernel, no weight quantization inside the timed
   solve, img/s and peak memory, the JAX bench's quality gate (latent
   cosine and rel-L2 against the bf16 kernel view of phase 4) and one
   full-width field evaluation: each block (kernels) against the same
   block composed from the kernels' plain twins on the same input, with
   control blocks the limit must refuse, and the whole field against the
   twins' composition;
4c. adaptive sampling, the reference's eval decode: dopri5 at rtol = atol =
   1e-5 (I controller, safety 0.9) through `core.flow.decode` at batch 50
   from the same weights and z, a warm solve and a timed one per view: the
   bf16 view on the LN-fused route (attn_impl="pallas_lnmlp": 21 x NFE
   launches of the LN + QKV-projection kernel, latents against rk4-50 of
   the same view) and the weight-only int8 view (quant="w8", "auto": 21 x
   NFE launches each of that kernel and of the w8 MLP sub-block kernel, no
   weight quantization in the timed solve, NFE at most 1.5 x the bf16
   view's, latents against the bf16 view's): NFE, steps, rejections, t = 1,
   img/s, peak memory; the W8A8 view under the same solve, capped at 60
   step attempts, as a control (its NFE, and whether it hit the cap);
5. the "pallas_packed" and "pallas_lnmlp" views, the int8 "pallas_qkvproj"
   (int8 QKV-projection + int8 MLP kernels) and "xla" (int8 MLP kernel)
   views, and the w8 "pallas_qkvproj" (QKV-projection + w8 MLP kernels) and
   "xla" (w8 MLP kernel) views, for a few Euler steps each: launch counts
   and agreement with the plain path; then the w8 view's Euler-50 against
   phase 4's bf16 latents, which must sit closer than the W8A8 view's;
6. the entry point `cli.sample_lfm.run`: one batch of the w8 view with the
   config's adaptive solve (dopri5, PI controller), and two latent batches
   each of the bf16 and int8 (quant=True) views with Euler-50;
7. the training path: U-ViT-large with f32 master weights and bf16 compute,
   attn_impl="pallas_packed", per-block remat with REMAT_EXEMPT blocks
   exempt, batch 128 of `SyntheticFeatures` moments, the JAX bench's Adam
   (betas 0.99, L2 0.03), warmup schedule and EMA 0.995, through
   `train.step.make_train_step`: train img/s, peak memory, every loss
   finite, no non-finite skip, and exact launch counts per step (packed
   attention 21 + rematted blocks, its backward 21);
8. gradient agreement at batch 32 on one batch: the kernel path
   (pallas_packed) against the plain path (xla attention), and the `auto`
   view (QKV-projection kernel + backward) against pallas_packed;
9. the entry point `cli.train_lfm.run` for 2 steps; its checkpoint's params
   load into a fresh model with strict=True;
10. the SD-UNet path: UNet-large (`unet_large`: 256 channels x (1, 2, 4),
   head channels 32) in bf16 with seeded weights (its zero-initialised
   output convs drawn live), Euler-50 at batch 50 with attn_impl="auto":
   5 x 50 = 250 launches of the [B, H, L, D] kernel and of no other kernel,
   latents against the plain path (attn_impl="xla") from the same z, a
   control with the kernel's output zeroed that must fail the same limits,
   img/s of both, peak memory; one evaluation at the JAX bench's shape (head
   channels 64, a seeded [50, 77, 768] context): 5 launches, kernel view
   against the plain view and both against the f32 field;
11. the f32 SD VAE (TF32 off) decodes those latents to [50, 256, 256, 3]:
   time, peak memory, finite; one image on the card against the CPU, and
   with TF32 on as a control;
12. the entry point `cli.sample_lfm.run(config="unet_large", decode=True)`:
   two batches of latents and uint8 pixels;
13. the UNet's int8 view (quant=True: its convs in W8A8), f32 weights of
   phase 10's seed, Euler-50 at batch 50 from phase 10's z: 250 launches of
   kernel 7 and no other, no weight quantization in the timed solve, img/s
   against the bf16 view, latents against phase 10's; one evaluation at the
   bench shape against the bf16 view;
14. the VAE's int8 decode view decodes those latents: time, peak memory,
   finite pixels, rel-L2 against the f32 decode;
15. `cli.sample_lfm.run(config="unet_large", quant=True, decode=True)`: two
   batches of latents and uint8 pixels through both int8 views;
16. UNet-large training: batch 128, f32 masters, bf16 compute, `auto`, the
   reference init, phase 7's optimizer: img/s, peak memory, finite losses,
   per step 5 launches of the backward kernel, 5 of kernel 7 (10 with
   remat) and no other;
17. the UNet gradient at batch 32 on one batch (output convs drawn live):
   the kernel path against the plain path and both against the f32
   field's, globally and on the L = 1024 attention projections; a control
   with the backward kernel's outputs zeroed must fail the limits;
18. `cli.train_lfm.run(config="unet_large")` for 2 steps; its checkpoint's
   params load into a fresh model with strict=True;
19. the whole-sub-block route, attn_impl="pallas_block", in bf16: phase 4's
   weights and z, Euler-50 at batch 50: 1050 launches of the attention
   sub-block kernel and of no other kernel (the MLP is plain after LN2, as
   the JAX package routes it), latents against phase 4's plain latents,
   img/s, peak memory;
20. its W8A8 view (quant=True): 1050 launches each of the int8 attention
   sub-block and int8 MLP sub-block kernels and of no other, no weight
   quantization in the timed solve, the quality gate against phase 4's bf16
   kernel latents, and one full-width evaluation block by block against the
   twins (with control blocks) and whole against their composition;
21. the w8 and w8a8_mlp views on pallas_block (4 Euler steps, launches,
   the quantized limits against the plain path); the bf16 MLP kernels
   inside the bf16 field (each block's MLP half as the MLP sub-block kernel,
   then as the MLP kernel after LN2; no model route runs them, as in the JAX
   package) against the model's own evaluation; the pallas_block gradient
   at batch 32 against xla, with row 10 launched in every remat recompute;
   `cli.sample_lfm.run(attn_impl="pallas_block")` in bf16 and W8A8 and
   `cli.train_lfm.run` of a config whose nnet.attn_impl is "pallas_block";
22. the base-anchored stage-delta int8 field (`core/delta_field.py`,
   hidden_mode "grad") of phase 4's weights, its codes fitted once outside
   the solve: a delta evaluation at the base's own point equal to the base
   bit for bit, a delta at a nearby point tracking a base there, then dopri5
   at rtol = atol = 1e-5 (I controller, safety 0.9) at batch 50 through
   `core.flow.decode` with `solver_kwargs["stage_delta"]`, a warm solve and
   a timed one: NFE, steps, t = 1, img/s, ms per evaluation, peak memory,
   exactly 21 x (steps + 2) launches of rows 18 and 22 and 21 x 5 x steps
   of rows 19 and 23 and of no other kernel, no weight quantization in the
   solve, NFE at most 1.3 x phase 4c's bf16 NFE and latents close to its
   latents; `cli.sample_lfm.run(field="stage_delta_int8")` for one batch and
   `cli.profile_field`'s base and delta evaluation profiles;
23. the same field in its "exact" and "gelu" hidden modes (rows 20 and 25,
   rows 21 and 24), each as phase 22: the zero-delta evaluation (bit for bit
   in "exact", within 1.5e-2 in "gelu", which adds back the base's hidden
   rounding), tracking, one full-width fused base evaluation against the
   unfused one (rel-L2 below 0.03), the warm and the timed dopri5 solve with
   exact launches of row 18 and the mode's base MLP kernel, of row 19 and
   its delta MLP kernel, and of no other, 0 quantizations, the NFE bound and
   the latents against phase 4c's; `sample_lfm.run(hidden_mode=...)` and
   `profile_field --hidden_mode`;
24. SD-UNet-large at SD 1.x's 512 x 512 (`unet_large_512`: 64 x 64
   latents, L = 4096 at the top level) in bf16 with seeded weights (output
   convs drawn live), Euler-50 at batch 50 on `auto`: exactly 5 x 50
   launches of row 9 and of row 7 and of no other kernel, img/s, peak
   memory; at batch 8 from the same z `auto` against `xla` within the path
   limits, and a control with row 9's output zeroed that must fail them;
   `sample_lfm.run(config="unet_large_512", decode=True)` to finite
   512-pixel images;
25. u-space editing on U-ViT-large (256 px) and on `unet_large_512`:
   `cli.dissect_lfm.run`'s read of 8 `SyntheticAttrFeatures` samples (the
   mid tap over the Euler-50 inversion), build_attr and build_pca (npz
   only), then through the `DissectSession` the write sweep of attribute 0
   at scales (-s, 0, s) on 4 samples and the encode -> decode roundtrip:
   exact launches per evaluated batch (row 9 five times a step on the
   UNet), the scale-0 row equal bit for bit to a plain decode, the read
   features of `auto` against `xla` on 2 samples within the path limits,
   the edit moving the latents one way beyond the routes' bf16 noise; the
   roundtrip errors as readings;
26. a U-ViT at the JAX package's U-ViT toys' shape (embed 128, depth 6, 4
   heads of 32, 8 x 8 x 4 latents, seeded weights): 2 train steps at batch
   256 on `pallas_packed` with exact launches of rows 1 and 4 at head dim
   32 and finite losses; Euler-50 at batch 64 on `auto` (row 2 at head dim
   32) against `xla` within the path limits, exact launches; the W8A8 view
   at head dim 32 (embed 256 in 8 heads of 32: the int8 MLP kernels take
   strips of 256 hidden units or more, embed 128 gives 128) Euler-50 at
   batch 64 on `pallas_qkvproj` (row 6) and `pallas_block` (row 11) with
   exact launches, each against `xla`'s W8A8 view at the quality gate.

Prints the `kernels` JSON line and then, last,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
With `--out PATH` the whole report is also written to PATH as JSON.
"""

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# kernel vs plain twin on the same inputs: the two share every rounding
# site, so they differ only where an f32 sum taken in another order flips
# a bf16 rounding (one bf16 ulp of an O(1) value is 4e-3 to 8e-3);
# measured on an H100 at the main path's shapes: max-abs <= 2e-3,
# rel-L2 <= 5e-4
KERNEL_MAX_ABS = 1e-2
KERNEL_REL_L2 = 2e-3
# the backward kernel vs its twin at B=128 (same reasoning: shared rounding
# sites, bf16 flips where an f32 sum runs in another order); measured on an
# H100: max-abs 9.8e-4 (one bf16 ulp), rel-L2 8.2e-5
BWD_MAX_ABS = 5e-3
BWD_REL_L2 = 5e-4
# a whole solve, fused kernels vs plain attention: the kernels normalise
# after P.V (the plain softmax before), so bf16 roundings differ in every
# attention call; measured on an H100: cos >= 0.9999982, rel-L2 <= 1.9e-3
PATH_MIN_COS = 0.9999
PATH_MAX_REL_L2 = 1e-2
# int8 kernels vs their twins: kernel and twin share every rounding site,
# so an output moves only where an f32 sum in another order (LN
# statistics) flips an int8 code or a bf16 rounding: max-abs one bf16 step
# of the largest output value; rel-L2 of the kernel's own part (out - x for
# the MLP sub-block, whose residual would dilute an error). Measured on an
# H100 at the main path's shapes: attention 1.33e-4 (LN) and 7.1e-5, MLP
# kernels equal bit for bit. Each int8 case also runs controls, twins with
# one rounding site changed, which must fail the same comparison; the
# nearest read 1.9e-3 (MLP, x coded by division), 2.3e-3 (LN-free
# attention, the same) and 5.0e-3 (LN attention, LN1 output in bf16).
INT8_ATTN_REL_L2 = 5e-4
INT8_MLP_REL_L2 = 1e-4
# the int8 view against the bf16 view over a whole Euler-50 solve (the JAX
# bench's quality gate, bench.py:123-142) and the other int8 views over a
# few steps against the plain path; first H100 run: cos 0.9999902 / rel-L2
# 4.43e-3 (Euler-50), 0.9999834 / 5.76e-3 (4 steps): margins of 6x or more
# on 1 - cos and 5x on rel-L2
QUANT_MIN_COS = 0.9999
QUANT_MAX_REL_L2 = 3e-2
# one full-width field evaluation of the int8 view, block by block: each
# block of the model (kernels) against the same block composed from the
# twins, on the same input; rel-L2 of the block's update (out - in). Flips
# of the attention kernel pass through proj's row codes into the MLP.
# Controls: twin blocks whose MLP keeps its hidden in f32 or codes it with
# one grid per row must read above the limit. Measured on an H100: kernels
# 2.08e-3 at most over the 21 blocks, controls 8.24e-3 and 9.61e-3 at
# least: the limit sits about 2x from each.
BLOCK_REL_L2 = 4e-3
# the whole field, kernels vs the twins' composition: a flipped code in one
# block moves the quantizers of every later block, so this reading only
# shows that the view routes through its kernels (measured on an H100:
# 1.63e-2, and 1.74e-2 for twins whose MLPs keep their hidden in f32)
FIELD_MIN_COS = 0.999
FIELD_MAX_REL_L2 = 5e-2

# weight-only int8 (w8) MLP kernels vs their twins: shared rounding sites,
# so an output moves only where an f32 sum in another order (the products,
# the LN statistics) flips a bf16 rounding of the hidden or the output:
# max-abs one bf16 step of the largest output value, rel-L2 on out - x for
# the sub-block. Controls: twins with the hidden kept in f32, with the
# weights dequantized to bf16 before the product, or with LN2 normalised in
# f32, must fail the same comparison. First H100 run: kernels 1.70e-4 (LN)
# and 1.86e-4, controls 2.55e-3 at least: the limit sits 3x and 4x from
# them.
W8_MLP_REL_L2 = 6e-4
# the adaptive phase: dopri5 at the reference's eval tolerances
ADAPTIVE_SK = {"solver": "adaptive", "solver_adaptive": "dopri5",
               "rtol": 1e-5, "atol": 1e-5, "controller": "i", "safety": 0.9}
MAX_STEPS = 4096
W8A8_CONTROL_MAX_STEPS = 60
# the w8 view's dopri5 NFE at most this multiple of the bf16 view's
W8_NFE_RATIO = 1.5
# dopri5 latents vs rk4-50 of the same view (bf16), and the w8 view's
# dopri5 latents vs the bf16 view's; first H100 run: cos 0.9999997 / rel-L2
# 8.29e-4 and 0.9999965 / 2.63e-3: margins of 5x on 1 - cos and on rel-L2
ADAPT_RK4_LIMITS = (0.9999985, 4e-3)
ADAPT_W8_LIMITS = (0.99998, 1.3e-2)

# the stage-delta base kernels' caches against their twins: int8 codes one
# step apart at most (an f32 sum in another order flips a rounding), at
# most this share of them; scales within STAGE_SCALE_ABS. The twins take
# the LN sums in the kernels' order, so on an H100 both read exact (with
# torch's order a flipped input code moved 3e-4 of the rows' scales)
STAGE_FLIP_RATE = 1e-3
STAGE_SCALE_ABS = 1e-6
# phase 3's stage-delta inputs: the streams' std and the stage gap (x = x_b
# + STAGE_GAP * STREAM_STD * n). The gap is a large RK stage's: row 19's a
# is rebuilt from a qkv that moved by the gap, and the attention core rounds
# a to bf16 where its twin may round one step apart (row 1: 4e-4 of the
# values on an H100); da = a - a_b carries that step at full size, so the
# smaller the gap, the more it weighs (H100, twins with torch's LN sums:
# update rel-L2 1.1e-2 at a gap of 1e-2, 1.9e-3 at 1e-1)
STREAM_STD = 1.0
STAGE_GAP = 1e-1
# row 19 against its plain twin: its attention core's bf16 steps pass
# through da (above), so the update xm - xm_b is held to 5x the first
# reading with the twins' LN sums in the kernels' order (4.87e-4 on an
# H100); against the twin whose attention core is row 1's kernel (the same
# bf16 a) it read 0 and takes the int8 attention limit, where its control
# (da coded as int8_dense codes it, 7.4e-4) is refused; against the plain
# twin no limit separates that control from the kernel
DELTA_ATTN_REL_L2 = 2.5e-3

# phase 22, the stage-delta field: a delta at (0.32, z + 0.02 n) against a
# base evaluation there (tests/test_delta_field.py:78-92's rule); the
# dopri5 NFE at most this multiple of phase 4c's bf16 NFE (the JAX tests'
# rule, tests/test_delta_field.py:250); its latents against the bf16 dopri5
# latents (cos, rel-L2)
STAGE_TRACK_REL = 0.04
STAGE_NFE_RATIO = 1.3
STAGE_LIMITS = (0.999, 5e-2)
# phase 23, the "exact" and "gelu" hidden modes. The "gelu" delta at the
# base's own point adds back W2 q8(r), r = gelu(e_b) - deq(g_q) the base's
# affine hidden rounding, which grows with the hidden width: the JAX tests
# hold it to 5e-3 at embed 64 (tests/test_delta_field.py:111), but JAX's
# own field reads 6.8e-3 at U-ViT-large's width (embed 1024, hidden 4096,
# depth 2; tests/test_torch_delta_modes.py::
# test_gelu_zero_delta_at_uvit_large_width) and the card 7.4e-3 at full
# size, so the limit is twice those readings; one full-width fused
# evaluation against the unfused one (tests/test_delta_field.py:57-66,
# :148-155)
STAGE_GELU_ZERO_REL = 1.5e-2
STAGE_FUSED_REL = 0.03
# row 24 alone at the base's own point, on o - x of one MLP half: the limit
# of the GPU tests (tests/test_torch_gpu.py, about 1e-2 of o - x read)
DELTA_G_ZERO_REL = 5e-2
# each hidden mode's MLP kernels (base, delta) by their LAUNCHES keys
STAGE_MLP = {"grad": ("base_mlp_grad", "delta_mlp_lin"),
             "exact": ("base_mlp_e", "delta_mlp_exact"),
             "gelu": ("base_mlp_eg", "delta_mlp_g")}

# H100 SXM published peaks (dense bf16 and int8, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12
# its special-function units: 16 exponentials per SM per clock, 132 SMs, at
# the 1980 MHz maximum SM clock that nvidia-smi reads on the card. The
# [B, H, L, D] attention kernels take one exponential per score (rows 7 to
# 9): at head dim 32 these, not the tensor cores, bound rows 7 and 9
PEAK_EXP_PER_S = 16 * 132 * 1.98e9

# the SD-UNet: self-attentions at 32 x 32 latents (L = 1024) per evaluation
UNET_KERNEL_CALLS = 5
# the UNet's Euler-50 latents are held to PATH_MIN_COS / PATH_MAX_REL_L2:
# first H100 run cos 0.9999956, rel-L2 2.97e-3; the zero-attention control
# read cos 0.966, rel-L2 0.258.
# One UNet evaluation at the bench shape, kernel view vs plain view: a bf16
# rounding that differs in one attention call re-rounds every later layer
# of the random-weight UNet, so one evaluation differs by about as much as
# either bf16 view differs from the f32 field (first H100 run: 1.74e-2 vs
# each other, 1.584e-2 and 1.594e-2 from f32). The kernel view must stay
# within UNET_F32_RATIO of the plain view's distance to the f32 field.
UNET_FIELD_MIN_COS = 0.999
UNET_FIELD_MAX_REL_L2 = 5e-2
UNET_F32_RATIO = 1.25
# one VAE image decoded on the card against the CPU, both exact f32: first
# H100 run cos 1 - 5e-12, rel-L2 4.9e-6; with TF32 on (the control) cos
# 0.99999962, rel-L2 8.7e-4: only the rel-L2 limit refuses TF32
VAE_MIN_COS = 0.99999
VAE_MAX_REL_L2 = 1e-4

# global gradient at batch 32, kernel path vs plain path and auto vs
# pallas_packed: bf16 roundings differ in every attention call, forward and
# backward; measured on an H100: pallas_packed vs xla cos 0.9999986, rel-L2
# 1.7e-3 (auto vs pallas_packed: identical)
GRAD_MIN_COS = 0.99999
GRAD_MAX_REL_L2 = 1e-2

B, L, C, H = 50, 257, 1024, 16
# phase 3's head-dim-32 cases: the main path's width in heads of 32, the
# head dim of the U-ViT toys (uspace_tpu/configs/synthetic_attr_e2e.py:30)
H32 = 32
# kernel 7's phase-3 shapes (B, H, L, D); the first is the UNet main path's
FWD_SHAPES = {"attention_fwd": (50, 8, 1024, 32),
              "attention_fwd D=64": (50, 4, 1024, 64),
              "attention_fwd L=600": (50, 8, 600, 32)}
# row 9's phase-3 shapes (B, H, L, D); the first is the 512-px UNet's top
# level (64 x 64 latents), the last has a partial last key block
FLASH_SHAPES = {"flash": (50, 8, 4096, 32),
                "flash D=64": (4, 16, 1025, 64),
                "flash L=1300": (8, 8, 1300, 32)}
# phase 24: auto against xla at this batch (xla's f32 [B, 8, 4096, 4096]
# scores are 27 GB at batch 50), and sample_lfm's batch
UNET512_CMP_B = 8
UNET512_CLI_N = 10
# phase 25, editing: samples read, components kept, samples written. The
# read features are the bf16 mid tap at every step of the inversion, so two
# bf16 routes differ there by about a bf16 step of each activation, as one
# UNet evaluation does (first H100 run: auto vs xla rel-L2 1.09e-2 on the
# U-ViT, 1.85e-2 on the 512-px UNet): they take phase 10b's rule against
# the f32 field (H100: auto 9.52e-3 and 1.475e-2 from f32, xla 9.52e-3 and
# 1.479e-2). The write scale takes the direction to EDIT_REL of the tap's
# rms. The random-weight U-ViT's velocity is small beside z, so its edits
# move the latents little: at 0.1, 0.3, 1 and 3 of the tap's rms they moved
# 0.8e-3, 1.9e-3, 5.8e-3 and 1.6e-2 of |x0| against the routes' own
# difference of 5.8e-4 on the same z, with cos(x+ - x0, x0 - x-) 0.28,
# 0.84, 0.93 and 0.87 (noise below, the quadratic response above); the
# 512-px UNet at 0.1 moved 3.7e-2 against 3.3e-3, cos 0.975. The edit must
# move the latents by EDIT_MIN_NOISE times the routes' difference (readings
# 10.0 and 11.3) at a cosine of EDIT_MIN_COS (readings 0.93 and 0.975)
EDIT_READ_N = 8
EDIT_PCA_N = 4
EDIT_WRITE_N = 4
EDIT_REL = {"uvit_large": 1.0, "unet_large_512": 0.1}
EDIT_MIN_NOISE = 5.0
EDIT_MIN_COS = 0.8
STEPS = 50
SHORT_STEPS = 4
TRAIN_B = 128          # the reference's per-GPU batch
# blocks left un-rematted at TRAIN_B: all 21 fit (47.5 GiB peak) and run
# fastest (profile_field --train on an H100: 121.0 img/s, against 103.1 at
# 12 and 90.8 at 0); phase 8 runs the rematted path (remat_exempt 0)
REMAT_EXEMPT = 21
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
# phase 26, the U-ViT toys' shape: the JAX config's training batch
# (synthetic_attr_e2e.py: train.batch_size 256) and its sampling batch
# (sample.mini_batch_size 64)
TOY_TRAIN_B, TOY_TRAIN_STEPS, TOY_SAMPLE_B = 256, 2, 64
# phase 26's W8A8 view at head dim 32: the narrowest width whose MLP strips
# (hidden / 4) the int8 MLP kernels take
TOY_Q_EMBED = 256
GRAD_B = 32
# kernel 8's phase-3 shapes (B, H, L, D) at the training batch; the first is
# the UNet-large training path's (its five self-attentions at 32 x 32)
BWD_SHAPES = {"fused_attention_bwd": (TRAIN_B, 8, 1024, 32),
              "fused_attention_bwd D=64": (TRAIN_B, 4, 1024, 64),
              "fused_attention_bwd L=600": (TRAIN_B, 8, 600, 32)}
# kernel 8's twin holds several [B, H, L, L] f32 tensors: run it in chunks
TWIN_CHUNK = 16
# int8_conv on the card against the CPU on the same inputs: UNet-large's
# 3x3 conv at 32 x 32 and 256 channels, and its Downsample (k3 s2)
INT8_CONV_SHAPES = {"k3": ((B, 32, 32, 256), 256, 1),
                    "k3 s2": ((B, 32, 32, 256), 256, 2)}
# UNet-large training at TRAIN_B runs without remat, as its config does:
# it fits (58.6 GiB peak on the first H100 run)
UNET_TRAIN_REMAT = False
# the UNet's global gradient at GRAD_B, kernel path (auto: kernels 7 and 8)
# against the plain path (xla), and its part on the five L = 1024
# self-attentions' q, k and v projections (kernel 8's direct product); each
# path also against the f32 field's gradient, the kernel path within
# UNET_F32_RATIO of the plain path's distance. First H100 run: cos
# 0.9999950 / rel-L2 3.17e-3 globally, 0.9999961 / 2.80e-3 on the
# projections (the U-ViT's closeness, not one evaluation's), 1.01x the
# plain path's distance to f32; the control with kernel 8 zeroed read
# rel-L2 0.317 and 1.0: limits at about 5x the readings
UNET_GRAD_MIN_COS = 0.99997
UNET_GRAD_MAX_REL_L2 = 1.5e-2
# the int8 (convs-only) UNet view against the bf16 kernel view, Euler-50
# latents (first H100 run: cos 0.9995759, rel-L2 2.92e-2) and one
# evaluation at the JAX bench's shape (cos 0.9977634, rel-L2 6.69e-2): 5x
# the readings, but never looser than the JAX package's one-evaluation gate
# (cos > 0.995, rel-L2 < 0.1, tests/test_quant.py:493-501)
UNET_QUANT_LIMITS = (0.998, 0.1)
UNET_QUANT_EVAL_LIMITS = (0.995, 0.1)


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(torch, out, ref):
    a, b = out.double(), ref.double()
    if not torch.isfinite(a).all():
        return float("inf"), float("inf"), float("-inf")
    max_abs = float((a - b).abs().max())
    rel = float((a - b).norm() / b.norm())
    cos = float((a * b).sum() / (a.norm() * b.norm()))
    return max_abs, rel, cos


def bf16_step(v):
    """One bf16 step (8 significant bits) at magnitude ``v``."""
    return 2.0 ** (math.floor(math.log2(v)) - 7) if v > 0 else 0.0


def judge(torch, case, out, ref):
    """max-abs and rel-L2 of ``out`` against ``ref`` (rel-L2 on the
    case's ``part``) and the case's limits; a max-abs limit of None is one
    bf16 step of the largest |ref|."""
    if isinstance(out, tuple):  # each output held to the limits
        parts = [judge(torch, case, o, r) for o, r in zip(out, ref)]
        return (max(p[0] for p in parts), max(p[1] for p in parts),
                min(p[2] for p in parts), parts[0][3])
    part = case.get("part", lambda t: t)
    _, rel, _ = compare(torch, part(out), part(ref))
    max_abs, _, _ = compare(torch, out, ref)
    tol_abs, tol_rel = case.get("tol", (KERNEL_MAX_ABS, KERNEL_REL_L2))
    if tol_abs is None:
        tol_abs = bf16_step(float(ref.float().abs().max()))
    return max_abs, rel, tol_abs, tol_rel


def bound(bytes_moved, flops, int8_ops=0.0, exps=0.0):
    """Least ms for the work: bytes over the memory rate against bf16
    operations and int8 operations, each over its peak rate, and the
    exponentials over the special-function units' rate (which run beside
    the tensor cores). Returns (ms, "bytes" or "operations", the term that
    sets it: "bytes", "tensor" or "exp")."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_tensor = (flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS) * 1e3
    t_exp = exps / PEAK_EXP_PER_S * 1e3
    t, term = max((t_bytes, "bytes"), (t_tensor, "tensor"), (t_exp, "exp"))
    return t, ("bytes" if term == "bytes" else "operations"), term


def all_launches(attn, mlpk):
    """Every kernel wrapper's count: attention, MLP and stage-delta."""
    from uspace_tpu_torch.ops import delta as dops
    return {**attn.LAUNCHES, **mlpk.LAUNCHES, **dops.LAUNCHES}


def reset_launches(attn, mlpk):
    from uspace_tpu_torch.ops import delta as dops
    attn.reset_launches()
    mlpk.reset_launches()
    dops.reset_launches()


def expected(attn, mlpk, **counts):
    """Every kernel's launch count: 0 unless given."""
    want = dict.fromkeys(all_launches(attn, mlpk), 0)
    want.update(counts)
    return want


def check_kernels(torch, F, attn, mlpk, quant):
    """Phase 3: each kernel vs its twin at its path's shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    bf = torch.bfloat16
    d = C // H
    scale = d ** -0.5

    def randn(*shape, std=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    x = randn(B, L, C)
    # [C, 3C] view of a torch-layout [3C, C] weight, as the model passes
    # qkv.weight.t(): the kernel reads it without a copy
    w = randn(3 * C, C, std=0.02).t()
    qkv = randn(B, L, 3 * C, std=0.64)  # the spread of x @ w
    lns = 1.0 + randn(C, std=0.1, dtype=torch.float32)
    lnb = randn(C, std=0.1, dtype=torch.float32)

    def sdpa_packed(qkv_):
        q, k, v = qkv_.view(B, L, 3, H, d).permute(2, 0, 3, 1, 4)
        return F.scaled_dot_product_attention(q, k, v)

    proj_flops = 2.0 * B * L * C * 3 * C
    attn_flops = 4.0 * B * H * L * L * d
    io = lambda *ts: float(sum(t.numel() * t.element_size() for t in ts))
    cases = [
        dict(name="packed_attention",
             replaces="uspace_tpu/ops/attention.py:258 (_packed_fwd_kernel)",
             kernel=lambda: attn.fused_qkv_attention(qkv, H),
             plain=lambda: attn.packed_attention_plain(qkv, H, scale),
             library=lambda: sdpa_packed(qkv),
             bytes=io(qkv) + io(x), flops=attn_flops),
        dict(name="qkvproj_attention",
             replaces="uspace_tpu/ops/attention.py:468 (_qkv_attn_kernel)",
             kernel=lambda: attn.fused_qkvproj_attention(x, w, H),
             plain=lambda: attn.qkvproj_attention_plain(x, w, H, scale),
             library=lambda: sdpa_packed(torch.matmul(x, w)),
             bytes=io(x, w) + io(x), flops=proj_flops + attn_flops),
        dict(name="ln_qkvproj_attention",
             replaces="uspace_tpu/ops/attention.py:654 (_qkv_attn_kernel_ln)",
             kernel=lambda: attn.fused_ln_qkvproj_attention(x, lns, lnb, w, H),
             plain=lambda: attn.ln_qkvproj_attention_plain(
                 x, lns, lnb, w, H, scale, 1e-5),
             library=lambda: sdpa_packed(torch.matmul(
                 F.layer_norm(x, (C,), lns.to(bf), lnb.to(bf), 1e-5), w)),
             bytes=io(x, w, lns, lnb) + io(x), flops=proj_flops + attn_flops),
    ]
    # the backward at the training path's batch
    qkv_t = randn(TRAIN_B, L, 3 * C, std=0.64)
    do_t = randn(TRAIN_B, L, C)
    qkv_l = qkv_t.detach().requires_grad_()
    o_l = F.scaled_dot_product_attention(
        *qkv_l.view(TRAIN_B, L, 3, H, d).permute(2, 0, 3, 1, 4))
    go_l = do_t.view(TRAIN_B, L, H, d).transpose(1, 2)
    cases.append(dict(
        name="packed_attention_bwd",
        source="uspace_tpu_torch/ops/csrc/fused_attention_bwd.cu",
        replaces="uspace_tpu/ops/attention.py:285 (_packed_bwd_kernel)",
        kernel=lambda: attn.packed_attention_bwd(qkv_t, do_t, H),
        plain=lambda: attn.packed_attention_bwd_plain(qkv_t, do_t, H, scale),
        # SDPA's backward on a retained graph: a yardstick only
        library=lambda: torch.autograd.grad(o_l, qkv_l, go_l,
                                            retain_graph=True),
        bytes=io(qkv_t, do_t) + io(qkv_t),
        flops=10.0 * TRAIN_B * H * L * L * d,
        tol=(BWD_MAX_ABS, BWD_REL_L2), shape=f"B={TRAIN_B} L={L} C={C} "
        f"H={H} bf16"))
    cases += int8_cases(torch, F, attn, mlpk, quant, randn, sdpa_packed, io)
    cases += w8_cases(torch, F, attn, mlpk, quant, randn, io)
    cases += fwd_cases(torch, F, attn, randn, io)
    cases += flash_cases(torch, F, attn, randn, io)
    cases += bwd_cases(torch, F, attn, randn, io)
    cases += block_cases(torch, F, attn, mlpk, quant, randn, sdpa_packed, io)
    cases += hd32_cases(torch, F, attn, mlpk, randn, io, quant)
    cases += delta_cases(torch, F, attn, mlpk, quant, randn, sdpa_packed, io)
    results, shapes, controls, problems = [], [], {}, []
    for case in cases:
        counter = case.get("counter", case["name"])
        before = all_launches(attn, mlpk)[counter]
        with torch.no_grad():
            out = case["kernel"]()
        torch.cuda.synchronize()
        if all_launches(attn, mlpk)[counter] != before + 1:
            fail(f"{case['name']}: the wrapper did not launch its kernel")
        ref = case["plain"]()
        # a case with several kinds of output (a cache of codes beside a
        # bf16 output) judges them itself: (max_abs, rel, tol_abs, tol_rel,
        # ok, what it read)
        own = case.get("judge")
        if own:
            max_abs, rel, tol_abs, tol_rel, ok, more = own(out, ref)
        else:
            max_abs, rel, tol_abs, tol_rel = judge(torch, case, out, ref)
            ok, more = max_abs <= tol_abs and rel <= tol_rel, ""
        if not ok:
            problems.append(f"{case['name']} disagrees with its plain twin")
        log(f"kernel {case['name']}: max_abs {max_abs:.3e} (tol "
            f"{tol_abs:.3e}) rel_l2 {rel:.3e} (tol {tol_rel:.1e}){more}")
        for cname, cfn in case.get("controls", ()):
            if own:
                c_abs, c_rel, _, _, c_ok, c_more = own(cfn(), ref)
                caught = not c_ok
            else:
                c_abs, c_rel, _, _ = judge(torch, case, cfn(), ref)
                caught, c_more = c_abs > tol_abs or c_rel > tol_rel, ""
            log(f"  control, {cname}: max_abs {c_abs:.3e} rel_l2 "
                f"{c_rel:.3e}{c_more}: {'fails' if caught else 'PASSES'} the "
                f"comparison")
            if not caught:
                problems.append(f"{case['name']}: the limits let a twin with "
                                f"{cname} pass")
            controls.setdefault(case["name"], {})[cname] = dict(
                max_abs=c_abs, rel_l2=c_rel)
        del out, ref
        with torch.no_grad():
            ms = time_ms(torch, case["kernel"])
            plain_ms = time_ms(torch, case["plain"], iters=5)
            library_ms = time_ms(torch, case["library"])
        bound_ms, bound_by, term = bound(case["bytes"], case["flops"],
                                         case.get("int8_ops", 0.0),
                                         case.get("exps", 0.0))
        r = dict(name=case["name"], route="cuda",
                 source=case.get("source",
                                 "uspace_tpu_torch/ops/csrc/attention.cu"),
                 replaces=case["replaces"], launches=0, max_abs_err=max_abs,
                 rel_l2=rel, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, bound_term=term, library_ms=library_ms,
                 shape=case.get("shape", f"B={B} L={L} C={C} H={H} bf16"))
        log(f"  {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{library_ms:.4f} ms, bound {bound_ms * 1e3:.1f} us ({bound_by}"
            f", {term})")
        (results if case.get("listed", True) else shapes).append(r)
    problems += piece_checks(torch, attn, quant, randn)
    problems += row15_19_piece_checks(torch, mlpk, quant, randn)
    problems += row18_piece_checks(torch, attn, quant, randn)
    problems += row21_22_piece_checks(torch, quant, randn)
    problems += delta_mlp_checks(torch, quant, randn)
    if problems:
        fail("; ".join(problems))
    return results, shapes, controls


def piece_checks(torch, attn, quant, randn):
    """Rows 4 and 5 by their pieces and edges: row 5's code pass bit-equal
    to ``row_codes(ln_lanes(x))`` (codes and row scales) and its int8
    GEMM's qkv bit-equal to the dequantised int32 product, at B * L rows
    and at ragged row counts; row 4 at the edges of its 64-row tiles and
    128-row blocks with 16 heads of 64 and 32 heads of 32, within the
    backward limits, a repeat bit-equal. Returns what disagreed."""
    from uspace_tpu_torch.ops import delta as dops
    problems = []
    f32 = torch.float32
    lns = 1.0 + randn(C, std=0.1, dtype=f32)
    lnb = randn(C, std=0.1, dtype=f32)
    qw = quant.quantized_weight(randn(3 * C, C, std=0.02, dtype=f32).t())
    for rows in (B * L, 1, 63, 129):
        x = randn(rows, C)
        codes, sr = attn._ln_codes_kernel(x, lns, lnb, 1e-5)
        ref_q, ref_s = quant.row_codes(dops.ln_lanes(x, lns, lnb, 1e-5))
        qkv = attn._qkv_gemm_int8_kernel(codes, sr, qw)
        ref = ((quant.int_matmul(codes, qw.kn).float() * sr[:, None])
               * qw.scale).to(torch.bfloat16)
        ok = (torch.equal(codes, ref_q) and torch.equal(sr, ref_s.reshape(-1))
              and torch.equal(qkv, ref))
        log(f"piece ln_qkvproj_attention_int8, {rows} rows: code pass and "
            f"int8 GEMM {'bit-equal' if ok else 'DIFFER'}")
        if not ok:
            problems.append(f"row 5's pieces differ at {rows} rows")
    for h in (H, H32):  # head dims 64 and 32
        worst, repeats = (0.0, 0.0), True
        for l in (1, 16, 17, 63, 64, 65, 128, 129, 257, 334, 512):
            qkv = randn(2, l, 3 * C, std=0.64)
            do = randn(2, l, C)
            out = attn.packed_attention_bwd(qkv, do, h)
            again = attn.packed_attention_bwd(qkv, do, h)
            max_abs, rel, _ = compare(torch, out, attn.packed_attention_bwd_plain(
                qkv, do, h, (C // h) ** -0.5))
            same = torch.equal(out, again)
            worst = (max(worst[0], max_abs), max(worst[1], rel))
            repeats = repeats and same
            if not same or max_abs > BWD_MAX_ABS or rel > BWD_REL_L2:
                problems.append(f"packed_attention_bwd at L={l}, H={h}: "
                                f"max_abs {max_abs:.3e} rel_l2 {rel:.3e}, "
                                f"repeat {'equal' if same else 'differs'}")
        log(f"piece packed_attention_bwd at 11 tile edges, B=2 H={h} "
            f"D={C // h}: worst max_abs {worst[0]:.3e} rel_l2 {worst[1]:.3e}, "
            f"repeats {'bit-equal' if repeats else 'DIFFER'}")
    return problems


def row15_19_piece_checks(torch, mlpk, quant, randn):
    """Rows 15 and 19 by their pieces at the main path's shapes (12850
    rows, C 1024, hidden 4096; B = 50, L = 257, Lp = 288): row 15's code
    pass bit-equal to ``row_codes`` of the bf16-chain LN2 in lane order, its
    fc1 (codes, scales, zero points) and fc2 bit-equal to their twins on the
    same inputs, the sub-block bit-equal to its pieces and to a repeat; row
    19's code pass bit-equal to ``ln_delta_codes_plain``, its qkv and xm
    GEMMs bit-equal to the twins' dequantised products on the same codes.
    Returns what disagreed."""
    from uspace_tpu_torch.ops import delta as dops
    f32, bf = torch.float32, torch.bfloat16
    rows, hid, strips = B * L, 4 * C, 4
    problems = []
    x = randn(rows, C)
    lns, lnb = 1.0 + randn(C, std=0.1, dtype=f32), randn(C, std=0.1,
                                                         dtype=f32)
    w1, w2 = randn(hid, C, std=0.02, dtype=f32).t(), randn(
        C, hid, std=0.02, dtype=f32).t()
    b1, b2 = randn(hid, std=0.02, dtype=f32), randn(C, std=0.02, dtype=f32)
    q1, q2 = quant.quantized_weight(w1), quant.quantized_weight(w2)
    with torch.no_grad():
        codes, sr = mlpk._int8_codes_kernel(x, lns, lnb, 1e-5)
        xf = x.float()
        mu = quant.true_div(dops._lane_sum(xf), C)
        var = quant.true_div(dops._lane_sum(xf * xf), C) - mu * mu
        xln = ((x - mu.to(bf)) * torch.rsqrt(var + 1e-5).to(bf) * lns.to(bf)
               + lnb.to(bf))
        ref_q, ref_s = quant.row_codes(xln.float())
        hq, hsc, hzp = mlpk._int8_fc1_kernel(codes, sr, q1, b1, strips)
        twin = mlpk.mlp_int8_fc1_plain(codes, sr[:, None], q1, b1, strips)
        out = mlpk._int8_fc2_kernel(hq, hsc, hzp, q2, b2, q2.colsums(strips),
                                    x)
        ref = mlpk.mlp_int8_fc2_plain(hq, hsc, hzp, q2, b2, x)
        block = mlpk.fused_mlp_block_q(x, lns, lnb, w1, b1, w2, b2)
        again = mlpk.fused_mlp_block_q(x, lns, lnb, w1, b1, w2, b2)
    torch.cuda.synchronize()
    checks = dict(
        code_pass=torch.equal(codes, ref_q) and torch.equal(
            sr, ref_s.reshape(-1)),
        fc1=all(torch.equal(a, t) for a, t in zip((hq, hsc, hzp), twin)),
        fc2=torch.equal(out, ref),
        pieces_and_repeat=torch.equal(block, out) and torch.equal(block,
                                                                  again))
    log(f"piece ln_mlp_int8, {rows} rows: " + ", ".join(
        f"{k} {'bit-equal' if v else 'DIFFERS'}" for k, v in checks.items()))
    problems += [f"row 15's {k} differs" for k, v in checks.items() if not v]
    del hq, twin, block, again
    lp = dops.round_up(L, dops.SEQ_ALIGN)
    xb = randn(rows, C, std=STREAM_STD)
    xs = (xb.float() + randn(rows, C, std=STAGE_GAP * STREAM_STD,
                             dtype=f32)).to(bf)
    qw = quant.quantized_weight(randn(3 * C, C, std=0.02, dtype=f32).t())
    qp = quant.quantized_weight(randn(C, C, std=0.02, dtype=f32).t())
    qkv_q = (randn(B, lp, 3 * C, std=50.0, dtype=f32).round()
             .clamp(-127, 127).to(torch.int8))
    qkv_s = randn(B, lp, 1, std=0.01, dtype=f32).abs()
    with torch.no_grad():
        codes, sr = dops._ln_delta_codes_kernel(xs, xb, lns, lnb, 1e-5)
        ref_q, ref_s = dops.ln_delta_codes_plain(xs, xb, lns, lnb, 1e-5)
        qkv = dops._qkv_delta_kernel(codes, sr, qw.q, qw.scale, qkv_q, qkv_s,
                                     L)
        xm = dops._xm_delta_kernel(codes, sr, qp.q, qp.scale, xs, xb, x)
    torch.cuda.synchronize()
    checks = dict(
        code_pass=torch.equal(codes, ref_q) and torch.equal(
            sr, ref_s.reshape(-1)),
        qkv_gemm=torch.equal(qkv, dops.qkv_delta_plain(
            codes, sr[:, None], qw.kn, qw.scale, qkv_q, qkv_s, L)),
        xm_gemm=torch.equal(xm, dops.xm_delta_plain(
            codes, sr[:, None], qp.kn, qp.scale, xs, xb, x)))
    log(f"piece delta_attn, B={B} L={L} (Lp={lp}): " + ", ".join(
        f"{k} {'bit-equal' if v else 'DIFFERS'}" for k, v in checks.items()))
    problems += [f"row 19's {k} differs" for k, v in checks.items() if not v]
    return problems


def row18_piece_checks(torch, attn, quant, randn):
    """Row 18 by its pieces at the main path's shape (B = 50, L = 257 padded
    to Lp = 288, C = 1024, H = 16), each bit-equal to its twin on the same
    inputs: the padded LN1 code pass to ``row_codes(ln_lanes(x padded))``,
    pass A's row amax partials to ``qkv_amax_plain``, pass B's cache codes,
    row scales and bf16 buffer to ``qkv_code_plain`` on them; the wrapper's
    cache over all Lp rows (the padded rows included) to the whole twin's
    and its ``a`` to row 1's kernel on the twin's bf16 buffer, and a repeat
    to the first call. Code flips and the largest scale difference against
    the twin are printed. Returns what disagreed."""
    import torch.nn.functional as F

    from uspace_tpu_torch.ops import delta as dops
    f32 = torch.float32
    lp = dops.round_up(L, dops.SEQ_ALIGN)
    problems = []
    x = randn(B, L, C, std=STREAM_STD)
    lns, lnb = 1.0 + randn(C, std=0.1, dtype=f32), randn(C, std=0.1,
                                                         dtype=f32)
    qw = quant.quantized_weight(randn(3 * C, C, std=0.02, dtype=f32).t())
    with torch.no_grad():
        codes, sr = dops._padded_codes_kernel(x, lns, lnb, 1e-5)
        ref_q, ref_s = quant.row_codes(dops.ln_lanes(
            F.pad(x, (0, 0, 0, lp - L)), lns, lnb, 1e-5).reshape(B * lp, C))
        part = dops._qkv_amax_kernel(codes, sr, qw.q, qw.scale)
        ref_part = dops.qkv_amax_plain(codes, sr[:, None], qw.kn, qw.scale)
        cq, cs, qkv = dops._qkv_code_kernel(codes, sr, qw.q, qw.scale, part,
                                            L, lp)
        ref_cq, ref_cs, ref_qkv = dops.qkv_code_plain(
            codes, sr[:, None], qw.kn, qw.scale, ref_part, L, lp)
        a, kq, ks = dops.base_attn_block(x, lns, lnb, qw.kn, qw.scale, H,
                                         1e-5)
        again = dops.base_attn_block(x, lns, lnb, qw.kn, qw.scale, H, 1e-5)
        _, tq, ts = dops.base_attn_plain(x, lns, lnb, qw.kn, qw.scale, H,
                                         1e-5)
        a1 = attn.fused_qkv_attention(
            (tq[:, :L].float() * ts[:, :L]).to(torch.bfloat16), H)
    torch.cuda.synchronize()
    step, rate = codes_read(torch, kq, tq)
    scale_err = float((ks.double() - ts.double()).abs().max())
    checks = dict(
        code_pass=torch.equal(codes, ref_q) and torch.equal(
            sr, ref_s.reshape(-1)),
        pass_a=torch.equal(part, ref_part),
        pass_b=torch.equal(cq, ref_cq) and torch.equal(
            cs, ref_cs.reshape(-1)) and torch.equal(qkv, ref_qkv),
        cache_over_lp_rows=torch.equal(kq, tq) and torch.equal(ks, ts),
        a_on_row1s_kernel=torch.equal(a, a1),
        repeat=all(torch.equal(u, v) for u, v in zip((a, kq, ks), again)))
    log(f"piece base_attn_cache, B={B} L={L} (Lp={lp}): " + ", ".join(
        f"{k} {'bit-equal' if v else 'DIFFERS'}" for k, v in checks.items())
        + f"; cache against the twin over {B * lp} rows: largest code step "
        f"{step}, flips {rate:.2e}, scales max_abs {scale_err:.1e}")
    problems += [f"row 18's {k} differs" for k, v in checks.items() if not v]
    return problems


def row21_22_piece_checks(torch, quant, randn):
    """Rows 21 and 22 by their pieces at the main path's shape (12850 rows,
    C 1024, hidden 4096 in 4 strips) and at 129 rows: the f32 code pass
    bit-equal to ``base_codes_plain``, the mode's fc1 (its cache and the
    affine codes, scales and zero points of its hidden) bit-equal to its
    twin on the same codes, fc2 (x + m and m) bit-equal to
    ``base_fc2_plain`` on fc1's hidden, the wrapper bit-equal to its pieces
    in sequence and to a repeat. Returns what disagreed."""
    from uspace_tpu_torch.ops import delta as dops
    f32 = torch.float32
    hid, strips = 4 * C, 4
    problems = []
    lns, lnb = 1.0 + randn(C, std=0.1, dtype=f32), randn(C, std=0.1,
                                                         dtype=f32)
    q1 = quant.quantized_weight(randn(hid, C, std=0.02, dtype=f32).t())
    q2 = quant.quantized_weight(randn(C, hid, std=0.02, dtype=f32).t())
    b1, b2 = randn(hid, std=0.02, dtype=f32), randn(C, std=0.02, dtype=f32)
    w = (lns, lnb, q1.kn, q1.scale, b1, q2.kn, q2.scale, b2, 1e-5)
    for rows in (B * L, 129):
        x = randn(rows, C, std=STREAM_STD)
        for mode, row in (("grad", 22), ("e+g", 21)):
            with torch.no_grad():
                codes, sr = dops._base_codes_kernel(x, lns, lnb, 1e-5)
                ref_q, ref_s = dops.base_codes_plain(x, lns, lnb, 1e-5)
                fc1 = dops._base_fc1_kernel(codes, sr, q1.q, q1.scale, b1,
                                            strips, mode)
                twin1 = (dops.base_fc1_grad_plain if mode == "grad" else
                         dops.base_fc1_eg_plain)(codes, sr[:, None], q1.kn,
                                                 q1.scale, b1, strips)
                fc2 = dops._base_fc2_kernel(*fc1[2:], q2.q, q2.scale, b2,
                                            q2.colsums(strips), x)
                twin2 = dops.base_fc2_plain(*fc1[2:], q2.kn, q2.scale, b2, x)
                block = dops.base_mlp_block(x, *w, mode=mode)
                again = dops.base_mlp_block(x, *w, mode=mode)
            torch.cuda.synchronize()
            pieces = ((fc2[0], *fc1[:2], fc2[1])
                      + (fc1[2:] if mode == "e+g" else ()))
            checks = dict(
                code_pass=torch.equal(codes, ref_q) and torch.equal(
                    sr, ref_s.reshape(-1)),
                fc1=all(torch.equal(a, t) for a, t in zip(fc1, twin1)),
                fc2=all(torch.equal(a, t) for a, t in zip(fc2, twin2)),
                pieces_and_repeat=len(block) == len(pieces) and all(
                    torch.equal(b_, p_) and torch.equal(b_, a_)
                    for b_, p_, a_ in zip(block, pieces, again)))
            log(f"piece base_mlp ({mode}, row {row}), {rows} rows: "
                + ", ".join(f"{k} {'bit-equal' if v else 'DIFFERS'}"
                            for k, v in checks.items()))
            problems += [f"row {row}'s {k} differs at {rows} rows"
                         for k, v in checks.items() if not v]
            del fc1, twin1, fc2, twin2, block, again, pieces
    return problems


def delta_mlp_checks(torch, quant, randn):
    """Rows 25, 23 and 24 (the delta MLP pieces of the "exact", "grad" and
    "gelu" modes) on the 12850 rows of B=50 at hidden 4096: a stage's delta
    on the twin's cache against the twin (max-abs printed) and repeated
    bit-equal; at the base's own point (x = x_b on the base kernel's cache
    and m) rows 25 and 23 give their base row's output (20, 22) bit for bit
    (dg is 0, every code 0), and row 24, which re-rounds the base's hidden
    residual, lies within DELTA_G_ZERO_REL of row 21's output (on o - x).
    Returns what disagreed."""
    from uspace_tpu_torch.ops import delta as dops
    f32, bf = torch.float32, torch.bfloat16
    rows, hid = B * L, 4 * C
    strips = 4
    xb = randn(rows, C, std=STREAM_STD)
    x = (xb.float() + randn(rows, C, std=STAGE_GAP * STREAM_STD,
                            dtype=f32)).to(bf)
    lns, lnb = 1.0 + randn(C, std=0.1, dtype=f32), randn(C, std=0.1,
                                                         dtype=f32)
    q1 = quant.quantized_weight(randn(hid, C, std=0.02, dtype=f32).t())
    q2 = quant.quantized_weight(randn(C, hid, std=0.02, dtype=f32).t())
    b1, b2 = randn(hid, std=0.02, dtype=f32), randn(C, std=0.02, dtype=f32)
    w = (lns, lnb, q1.kn, q1.scale, b1, q2.kn, q2.scale, b2, 1e-5)
    dw = (lns, lnb, q1.kn, q1.scale, q2.kn, q2.scale, 1e-5)
    problems = []
    for name, base_row, mode in (("delta_mlp_exact", 20, "e"),
                                 ("delta_mlp_lin", 22, "grad"),
                                 ("delta_mlp_g", 21, "e+g")):
        with torch.no_grad():
            base = dops.base_mlp_block(xb, *w, mode=mode)
            kw = (dict(grad=True) if mode == "grad" else
                  dict(gelu_cache=tuple(base[4:])) if mode == "e+g" else {})
            same = dops.delta_mlp_block(xb, xb, *base[1:4], *dw, **kw)
            out = dops.delta_mlp_block(x, xb, *base[1:4], *dw, **kw)
            again = dops.delta_mlp_block(x, xb, *base[1:4], *dw, **kw)
            plain = (dops.delta_mlp_lin_plain if mode == "grad" else
                     dops.delta_mlp_g_plain if mode == "e+g" else
                     dops.delta_mlp_exact_plain)
            ref = plain(x, xb, *base[1:3], *base[4:], base[3], *dw, strips)
        torch.cuda.synchronize()
        max_abs = float((out.double() - ref.double()).abs().max())
        repeat = torch.equal(out, again)
        if mode == "e+g":
            part = base[0].double() - xb.double()
            rel0 = float((same.double() - base[0].double()).norm()
                         / part.norm())
            at_base = rel0 < DELTA_G_ZERO_REL
            said = (f"rel-L2 {rel0:.2e} from row {base_row}'s output on o - "
                    f"x (max {DELTA_G_ZERO_REL})")
        else:
            at_base = torch.equal(same, base[0])
            said = (f"{'bit-equal to' if at_base else 'DIFFERS from'} row "
                    f"{base_row}'s output")
        log(f"piece {name}, {rows} rows: max_abs {max_abs:.3e} against its "
            f"twin on the kernel's cache; repeat "
            f"{'bit-equal' if repeat else 'DIFFERS'}; at the base's point "
            f"{said}")
        if not at_base:
            problems.append(f"{name} at the base's point is not row "
                            f"{base_row}'s output")
        if not repeat:
            problems.append(f"{name}'s repeat differs")
        del base, same, out, again, ref
    return problems


def attn_control(attn, quant, x, qw, w, heads, scale, change, ln=None):
    """A twin of the int8 attention kernels with one rounding site changed
    (a wrong kernel's stand-in); ``ln = (scale, bias, eps)`` for LN1."""
    if change == "a bf16 projection":
        if ln is None:
            return attn.qkvproj_attention_plain(x, w, heads, scale)
        return attn.ln_qkvproj_attention_plain(x, ln[0], ln[1], w, heads,
                                               scale, ln[2])
    xf = x.float() if ln is None else attn._ln_f32(x, *ln)
    if change == "the LN1 output rounded to bf16":
        xf = xf.to(x.dtype).float()
    xq, xs = (quant.quantize_rowwise(xf) if change == "x coded by division"
              else quant.row_codes(xf))
    qkv = (quant.int_matmul(xq, qw.kn).float() * xs * qw.scale).to(x.dtype)
    return attn.packed_attention_plain(qkv, heads, scale)


def mlp_control(torch, attn, mlpk, quant, x, q1, b1, q2, b2, strips, change,
                ln=None):
    """A twin of the int8 MLP kernels with one rounding site changed (a
    wrong kernel's stand-in); ``ln = (scale, bias, eps)`` for the LN2 +
    residual variant."""
    if ln is None:
        xf = x.float()
    elif change == "LN2 normalised in f32":
        xf = attn._ln_f32(x, *ln)
    else:
        xf = mlpk._ln_bf16_normalise(x, *ln)
    codes = (quant.quantize_rowwise(xf) if change == "x coded by division"
             else quant.row_codes(xf))
    if change == "the hidden kept in f32":
        xq, xs = codes
        h = mlpk._gelu_f32(quant.int_matmul(xq, q1.kn).float() * xs
                           * q1.scale + b1.float())
        m = (torch.matmul(h, q2.kn.float() * q2.scale) + b2.float()).to(
            x.dtype)
    else:
        m = mlpk.mlp_int8_fc2_plain(*mlpk.mlp_int8_fc1_plain(
            *codes, q1, b1, 1 if change == "one hidden grid per row"
            else strips), q2, b2, x, residual=False)
    return m if ln is None else x + m


def int8_cases(torch, F, attn, mlpk, quant, randn, sdpa_packed, io):
    """Phase 3's int8 cases (rows 5, 6, 15, 14 of the PERF.md table). The
    weights are f32 views of torch-layout tensors, as the model passes
    them; their codes come from the cache (made before any timing), so a
    call reads int8 codes and f32 scales. Yardsticks: the same function
    from PyTorch calls (F.layer_norm, row quantization, torch._int_mm,
    dequantization, SDPA or F.gelu). Controls: twins with one rounding
    site changed, which the limits must refuse."""
    f32, bf = torch.float32, torch.bfloat16
    x = randn(B, L, C)
    w = randn(3 * C, C, std=0.02, dtype=f32).t()
    lns = 1.0 + randn(C, std=0.1, dtype=f32)
    lnb = randn(C, std=0.1, dtype=f32)
    qw = quant.quantized_weight(w)
    d = C // H
    scale = d ** -0.5
    hid = 4 * C
    rows = B * L
    xr = x.reshape(rows, C)
    w1 = randn(hid, C, std=0.02, dtype=f32).t()
    b1 = randn(hid, std=0.02, dtype=f32)
    w2 = randn(C, hid, std=0.02, dtype=f32).t()
    b2 = randn(C, std=0.02, dtype=f32)
    q1, q2 = quant.quantized_weight(w1), quant.quantized_weight(w2)
    strips = mlpk.col_slices(hid)
    ln1 = (lns, lnb, 1e-5)

    def lib_proj(xf, qw_):  # row codes, torch._int_mm, dequant
        xq, xs = quant.quantize_rowwise(xf)
        return quant.int8_matmul(xq, xs, qw_.kn, qw_.scale)

    def lib_attn(xf):
        return sdpa_packed(lib_proj(xf, qw).to(bf))

    def lib_mlp(xf):
        h = F.gelu(lib_proj(xf, q1) + b1)
        return (lib_proj(h, q2) + b2).to(bf)

    def ln(t):
        return F.layer_norm(t.float(), (C,), lns, lnb, 1e-5)

    def a_ctl(*changes, ln_=None):
        return [(c, lambda c=c: attn_control(attn, quant, x, qw, w, H, scale,
                                             c, ln_))
                for c in changes]

    def m_ctl(*changes, ln_=None):
        return [(c, lambda c=c: mlp_control(torch, attn, mlpk, quant, xr, q1,
                                            b1, q2, b2, strips, c, ln_))
                for c in changes]

    proj_ops = 2.0 * B * L * C * 3 * C
    attn_flops = 4.0 * B * H * L * L * d
    mlp_ops = 2.0 * 2.0 * rows * C * hid
    wbytes = io(qw.q, qw.scale)
    mbytes = io(q1.q, q1.scale, b1, q2.q, q2.scale, b2)
    mshape = f"rows={rows} C={C} hidden={hid} strips={strips} bf16/int8"
    ashape = f"B={B} L={L} C={C} H={H} bf16/int8"
    # row 15 runs delta_mlp.cu's wgmma GEMMs after its code pass; row 14
    # keeps mlp_int8.cu's block kernel
    mlp_src = "uspace_tpu_torch/ops/csrc/mlp_int8.cu"
    lnmlp_src = "uspace_tpu_torch/ops/csrc/delta_mlp.cu"
    a_tol, m_tol = (None, INT8_ATTN_REL_L2), (None, INT8_MLP_REL_L2)
    return [
        dict(name="ln_qkvproj_attention_int8",
             replaces="uspace_tpu/ops/attention.py:592 (_qkv_attn_kernel_qln)",
             kernel=lambda: attn.fused_ln_qkvproj_attention(
                 x, lns, lnb, w, H, quant=True),
             plain=lambda: attn.ln_qkvproj_attention_int8_plain(
                 x, lns, lnb, qw, H, scale, 1e-5),
             library=lambda: lib_attn(ln(x)),
             bytes=io(x, lns, lnb) + wbytes + io(x), flops=attn_flops,
             int8_ops=proj_ops, tol=a_tol, shape=ashape,
             # not "x coded by division": on f32 LN rows (bf16 x makes
             # ties) it reads 1.97e-4 on an H100, as close to the twin as
             # a reordered f32 sum
             controls=a_ctl("the LN1 output rounded to bf16",
                            "a bf16 projection", ln_=ln1)),
        dict(name="qkvproj_attention_int8",
             replaces="uspace_tpu/ops/attention.py:541 (_qkv_attn_kernel_q)",
             kernel=lambda: attn.fused_qkvproj_attention(x, w, H, quant=True),
             plain=lambda: attn.qkvproj_attention_int8_plain(x, qw, H, scale),
             library=lambda: lib_attn(x.float()),
             bytes=io(x) + wbytes + io(x), flops=attn_flops,
             int8_ops=proj_ops, tol=a_tol, shape=ashape,
             controls=a_ctl("x coded by division", "a bf16 projection")),
        dict(name="ln_mlp_int8", source=lnmlp_src,
             replaces="uspace_tpu/ops/mlp.py:225 (_mlp_kernel_int8_lnres)",
             kernel=lambda: mlpk.fused_mlp_block_q(xr, lns, lnb, w1, b1, w2,
                                                   b2),
             plain=lambda: mlpk.ln_mlp_int8_plain(xr, lns, lnb, q1, b1, q2,
                                                  b2, strips, 1e-5),
             library=lambda: xr + lib_mlp(ln(xr)),
             bytes=io(xr, lns, lnb) + mbytes + io(xr), flops=0.0,
             int8_ops=mlp_ops, tol=m_tol, shape=mshape,
             part=lambda t: t.double() - xr.double(),
             controls=m_ctl("the hidden kept in f32",
                            "one hidden grid per row", "x coded by division",
                            "LN2 normalised in f32", ln_=ln1)),
        dict(name="mlp_int8", source=mlp_src,
             replaces="uspace_tpu/ops/mlp.py:161 (_mlp_kernel_int8)",
             kernel=lambda: mlpk.fused_mlp(xr, w1, b1, w2, b2, quant=True),
             plain=lambda: mlpk.mlp_int8_plain(xr, q1, b1, q2, b2, strips),
             library=lambda: lib_mlp(xr.float()),
             bytes=io(xr) + mbytes + io(xr), flops=0.0, int8_ops=mlp_ops,
             tol=m_tol, shape=mshape,
             controls=m_ctl("the hidden kept in f32",
                            "one hidden grid per row",
                            "x coded by division")),
    ]


def w8_twin(torch, attn, mlpk, x, q1, b1, q2, b2, strips, change=None,
            ln=None):
    """The w8 MLP kernels' twin, or with ``change`` one rounding site
    changed (a wrong kernel's stand-in); ``ln = (scale, bias, eps)`` for
    the LN2 + residual variant."""
    if change is None:
        if ln is None:
            return mlpk.mlp_w8_plain(x, q1, b1, q2, b2, strips)
        return mlpk.ln_mlp_w8_plain(x, *ln[:2], q1, b1, q2, b2, strips, ln[2])
    if ln is None:
        xf = x.float()
    elif change == "LN2 normalised in f32":
        xf = attn._ln_f32(x, *ln)
    else:
        xf = mlpk._ln_bf16_normalise(x, *ln)
    if change == "the weights dequantized to bf16":
        w1 = (q1.q.float() * q1.scale[:, None]).to(x.dtype).float()
        w2 = (q2.q.float() * q2.scale[:, None]).to(x.dtype).float()
        h = mlpk._gelu_f32(torch.matmul(xf, w1.t()) + b1.float()).to(x.dtype)
        m = (torch.matmul(h.float(), w2.t()) + b2.float()).to(x.dtype)
    elif change == "the hidden kept in f32":
        h = mlpk._gelu_f32(torch.matmul(xf, q1.q.float().t()) * q1.scale
                           + b1.float())
        m = (torch.matmul(h, q2.q.float().t()) * q2.scale
             + b2.float()).to(x.dtype)
    else:
        m = mlpk._mlp_w8_core(xf, q1, b1, q2, b2, strips, x.dtype)
    return m if ln is None else x + m


def w8_cases(torch, F, attn, mlpk, quant, randn, io):
    """Phase 3's weight-only int8 cases (rows 16 and 17 of the PERF.md
    table) on the 12850 rows of B=50, C=1024, hidden 4096: f32 weights
    whose codes come from the cache (made before any timing). Yardstick:
    the same function from PyTorch calls (the LN chain, F.linear on bf16
    copies of the codes with the scales and biases in f32, F.gelu)."""
    f32, bf = torch.float32, torch.bfloat16
    rows, hid = B * L, 4 * C
    xr = randn(rows, C)
    w1 = randn(hid, C, std=0.02, dtype=f32).t()
    b1 = randn(hid, std=0.02, dtype=f32)
    w2 = randn(C, hid, std=0.02, dtype=f32).t()
    b2 = randn(C, std=0.02, dtype=f32)
    lns = 1.0 + randn(C, std=0.1, dtype=f32)
    lnb = randn(C, std=0.1, dtype=f32)
    q1, q2 = quant.quantized_weight(w1), quant.quantized_weight(w2)
    strips = mlpk.col_slices(hid)
    ln2 = (lns, lnb, 1e-5)
    c1, c2 = q1.q.to(bf), q2.q.to(bf)  # the library's bf16 weights

    def lib_mlp(xa):
        h = F.gelu(F.linear(xa, c1).float() * q1.scale + b1).to(bf)
        return (F.linear(h, c2).float() * q2.scale + b2).to(bf)

    def lib_ln(t):
        return F.layer_norm(t, (C,), lns.to(bf), lnb.to(bf), 1e-5)

    def ctl(*changes, ln_=None):
        return [(c, lambda c=c: w8_twin(torch, attn, mlpk, xr, q1, b1, q2, b2,
                                        strips, c, ln_))
                for c in changes]

    flops = 2.0 * 2.0 * rows * C * hid
    mbytes = io(q1.q, q1.scale, b1, q2.q, q2.scale, b2)
    shape = f"rows={rows} C={C} hidden={hid} bf16, int8 weights"
    src = "uspace_tpu_torch/ops/csrc/mlp_w8.cu"
    tol = (None, W8_MLP_REL_L2)
    return [
        dict(name="ln_mlp_w8", source=src,
             replaces="uspace_tpu/ops/mlp.py:287 (_mlp_kernel_w8_lnres)",
             kernel=lambda: mlpk.fused_mlp_block_q(xr, lns, lnb, w1, b1, w2,
                                                   b2, quant="w8"),
             plain=lambda: w8_twin(torch, attn, mlpk, xr, q1, b1, q2, b2,
                                   strips, ln=ln2),
             library=lambda: xr + lib_mlp(lib_ln(xr)),
             bytes=io(xr, lns, lnb) + mbytes + io(xr), flops=flops, tol=tol,
             shape=shape, part=lambda t: t.double() - xr.double(),
             controls=ctl("the hidden kept in f32",
                          "the weights dequantized to bf16",
                          "LN2 normalised in f32", ln_=ln2)),
        dict(name="mlp_w8", source=src,
             replaces="uspace_tpu/ops/mlp.py:437 (_mlp_kernel_w8)",
             kernel=lambda: mlpk.fused_mlp(xr, w1, b1, w2, b2, quant="w8"),
             plain=lambda: w8_twin(torch, attn, mlpk, xr, q1, b1, q2, b2,
                                   strips),
             library=lambda: lib_mlp(xr),
             bytes=io(xr) + mbytes + io(xr), flops=flops, tol=tol,
             shape=shape,
             controls=ctl("the hidden kept in f32",
                          "the weights dequantized to bf16")),
    ]


def fwd_cases(torch, F, attn, randn, io):
    """Phase 3's cases of the [B, H, L, D] kernel (row 7 of the PERF.md
    table): the UNet-large self-attention at 32 x 32 latents (B=50, H=8,
    L=1024, D=32; the `kernels` line), the JAX bench's head channels 64
    (H=4, D=64) and a ragged L=600. Yardstick: SDPA on the same tensors."""
    out = []
    for name, (b, h, l, d) in FWD_SHAPES.items():
        q, k, v = (randn(b, h, l, d) for _ in range(3))
        out.append(dict(
            name=name, counter="attention_fwd", listed=name == "attention_fwd",
            source="uspace_tpu_torch/ops/csrc/attention_fwd.cu",
            replaces="uspace_tpu/ops/attention.py:109 (_fwd_kernel)",
            kernel=lambda q=q, k=k, v=v: attn.fused_attention(q, k, v),
            plain=lambda q=q, k=k, v=v, d=d: attn.attention_plain(
                q, k, v, d ** -0.5),
            library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v),
            bytes=io(q, k, v) + io(q), flops=4.0 * b * h * l * l * d,
            exps=float(b * h * l * l), shape=f"B={b} H={h} L={l} D={d} bf16"))
    return out


def flash_cases(torch, F, attn, randn, io):
    """Phase 3's cases of the blocked online-softmax kernel (row 9 of the
    PERF.md table): the 512-px UNet-large's top level (B=50, H=8, L=4096,
    D=32; the `kernels` line), an unfused U-ViT-width call just past 1024
    (H=16, D=64) and a ragged L=1300 whose last key block is partial.
    Yardstick: SDPA on the same tensors."""
    out = []
    for name, (b, h, l, d) in FLASH_SHAPES.items():
        q, k, v = (randn(b, h, l, d) for _ in range(3))
        out.append(dict(
            name=name, counter="flash", listed=name == "flash",
            source="uspace_tpu_torch/ops/csrc/flash_attention.cu",
            replaces="uspace_tpu/ops/attention.py:1213 (_flash_kernel)",
            kernel=lambda q=q, k=k, v=v: attn.flash_attention_blocked(
                q, k, v),
            plain=lambda q=q, k=k, v=v, d=d: attn.flash_attention_plain(
                q, k, v, d ** -0.5),
            library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v),
            bytes=io(q, k, v) + io(q), flops=4.0 * b * h * l * l * d,
            exps=float(b * h * l * l), shape=f"B={b} H={h} L={l} D={d} bf16"))
    return out


def bwd_cases(torch, F, attn, randn, io):
    """Phase 3's cases of the [B, H, L, D] backward kernel (row 8 of the
    PERF.md table) at the training batch: the UNet-large self-attention at
    32 x 32 latents (H=8, L=1024, D=32; the `kernels` line), head channels
    64 (H=4, D=64) and a ragged L=600; dq, dk and dv each within the
    backward limits. Yardstick: SDPA's backward through autograd on a
    retained graph of the same inputs."""
    out = []
    for name, (b, h, l, d) in BWD_SHAPES.items():
        q, k, v, do = (randn(b, h, l, d) for _ in range(4))
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        o = F.scaled_dot_product_attention(ql, kl, vl)

        def twin(q=q, k=k, v=v, do=do, d=d):
            parts = [attn.attention_bwd_plain(*ts, d ** -0.5) for ts in zip(
                *(t.split(TWIN_CHUNK) for t in (q, k, v, do)))]
            return tuple(torch.cat(p) for p in zip(*parts))

        out.append(dict(
            name=name, counter="fused_attention_bwd",
            listed=name == "fused_attention_bwd",
            source="uspace_tpu_torch/ops/csrc/fused_attention_bwd.cu",
            replaces="uspace_tpu/ops/attention.py:132 (_bwd_kernel)",
            kernel=lambda q=q, k=k, v=v, do=do: attn.fused_attention_bwd(
                q, k, v, do),
            plain=twin,
            library=lambda o=o, ts=(ql, kl, vl), do=do: torch.autograd.grad(
                o, ts, do, retain_graph=True),
            bytes=io(q, k, v, do) + io(q, k, v),
            flops=10.0 * b * h * l * l * d, exps=float(b * h * l * l),
            tol=(BWD_MAX_ABS, BWD_REL_L2),
            shape=f"B={b} H={h} L={l} D={d} bf16"))
    return out


def block_q_control(torch, attn, mlpk, quant, x, lns, lnb, qw, qwp, bp,
                    change, heads=H):
    """A twin of the int8 attention sub-block kernel with one rounding site
    changed (a wrong kernel's stand-in)."""
    d = C // heads
    if change == "LN1 normalised in f32":  # row 5's LN
        xln = attn._ln_f32(x, lns, lnb, 1e-5)
    else:
        xln = mlpk._ln_bf16_normalise(x, lns, lnb, 1e-5)
    a = attn._int8_qkv_attention(xln, qw, heads, d ** -0.5, x.dtype)
    if change == "proj coded as int8_dense codes":  # x / (amax / 127)
        p = quant.int8_matmul(*quant.quantize_rowwise(a.float()), qwp.kn,
                              qwp.scale) + bp
        return x + p.to(x.dtype)
    aq, sa = quant.row_codes(a.float())
    p = quant.int_matmul(aq, qwp.kn).float() * sa * qwp.scale + bp
    return x + p.to(x.dtype)


def block_cases(torch, F, attn, mlpk, quant, randn, sdpa_packed, io):
    """Phase 3's cases of the whole-sub-block route (rows 10-13 of the
    PERF.md table) at the main path's shapes: the bf16 and int8 attention
    sub-blocks at B=50, L=257, and the bf16 MLP and MLP sub-block on the
    12850 rows of B=50 with hidden 4096; each sub-block compared on its
    update out - x. Yardsticks: the same function from PyTorch calls
    (layer_norm, matmul, SDPA, F.linear, F.gelu; row quantization and
    torch._int_mm for the int8 one). Controls of the int8 sub-block: twins
    with one rounding site changed, which the limits must refuse."""
    f32, bf = torch.float32, torch.bfloat16
    d = C // H
    scale = d ** -0.5
    # x at the scale of the attention update (std about 0.03 here): with x of
    # std 1 the bf16 residual add keeps two bits of the update, and a one-ulp
    # difference in it flips the output's rounding (first H100 run: update
    # rel-L2 4.4e-3 for kernel and twin alike rounded); LN1 takes any scale
    x = randn(B, L, C, std=0.05)
    lns = 1.0 + randn(C, std=0.1, dtype=f32)
    lnb = randn(C, std=0.1, dtype=f32)
    # the bf16 view's weights are bf16 parameters, passed as weight.t()
    w = randn(3 * C, C, std=0.02).t()
    wp = randn(C, C, std=0.02).t()
    wf = randn(3 * C, C, std=0.02, dtype=f32).t()
    wpf = randn(C, C, std=0.02, dtype=f32).t()
    bp = randn(C, std=0.02, dtype=f32)
    qw, qwp = quant.quantized_weight(wf), quant.quantized_weight(wpf)
    rows, hid = B * L, 4 * C
    xr = randn(rows, C)
    w1 = randn(hid, C, std=0.02).t()
    b1 = randn(hid, std=0.02, dtype=f32)
    w2 = randn(C, hid, std=0.02).t()
    b2 = randn(C, std=0.02, dtype=f32)
    strips = mlpk.col_slices(hid)

    def ln(t):
        return F.layer_norm(t, (C,), lns.to(bf), lnb.to(bf), 1e-5)

    def heads(o):  # SDPA's [B, H, L, d] -> [B, L, C]
        return o.transpose(1, 2).reshape(B, L, C)

    def lib_proj(xf, qw_):  # row codes, torch._int_mm, dequant
        return quant.int8_matmul(*quant.quantize_rowwise(xf), qw_.kn,
                                 qw_.scale)

    def lib_block_q():
        a = heads(sdpa_packed(lib_proj(ln(x).float(), qw).to(bf)))
        return x + (lib_proj(a.float(), qwp) + bp).to(bf)

    def lib_mlp(t):
        return F.linear(F.gelu(F.linear(t, w1.t(), b1.to(bf))), w2.t(),
                        b2.to(bf))

    def ctl(*changes):
        return [(c, lambda c=c: block_q_control(
            torch, attn, mlpk, quant, x, lns, lnb, qw, qwp, bp, c))
            for c in changes]

    qkv_ops = 2.0 * B * L * C * 3 * C
    proj_ops = 2.0 * B * L * C * C
    attn_flops = 4.0 * B * H * L * L * d
    mlp_flops = 2.0 * 2.0 * rows * C * hid
    src = "uspace_tpu_torch/ops/csrc/attention_block.cu"
    msrc = "uspace_tpu_torch/ops/csrc/mlp_bf16.cu"
    upd = dict(part=lambda t: t.double() - x.double())
    # the MLP's outputs pass 2 in magnitude, where a bf16 step exceeds 1e-2
    # (x of std 1 makes the MLP sub-block's do too): one bf16 step of the
    # largest output and the bf16 rel-L2 (of the update for the sub-block),
    # as the int8 and w8 MLP kernels are held; the attention sub-blocks'
    # outputs stay below 0.5 with x at the update's scale
    res_tol = (None, KERNEL_REL_L2)
    mshape = f"rows={rows} C={C} hidden={hid} bf16"
    return [
        dict(name="attention_block", source=src,
             replaces="uspace_tpu/ops/attention.py:1044 (_attn_block_kernel)",
             kernel=lambda: attn.fused_attention_block(x, lns, lnb, w, wp, bp,
                                                       H),
             plain=lambda: attn.attention_block_plain(x, lns, lnb, w, wp, bp,
                                                      H, scale, 1e-5),
             library=lambda: x + F.linear(
                 heads(sdpa_packed(torch.matmul(ln(x), w))), wp.t(),
                 bp.to(bf)),
             bytes=io(x, lns, lnb, w, wp, bp) + io(x),
             flops=qkv_ops + attn_flops + proj_ops, **upd),
        dict(name="attention_block_int8", source=src,
             replaces="uspace_tpu/ops/attention.py:831 "
             "(_attn_block_kernel_q)",
             kernel=lambda: attn.fused_attention_block_q(x, lns, lnb, wf, wpf,
                                                         bp, H),
             plain=lambda: attn.attention_block_int8_plain(
                 x, lns, lnb, qw, qwp, bp, H, scale, 1e-5),
             library=lib_block_q,
             bytes=io(x, lns, lnb, qw.q, qw.scale, qwp.q, qwp.scale, bp)
             + io(x), flops=attn_flops, int8_ops=qkv_ops + proj_ops,
             tol=(None, INT8_ATTN_REL_L2), shape=f"B={B} L={L} C={C} H={H} "
             "bf16/int8", **upd,
             controls=ctl("LN1 normalised in f32",
                          "proj coded as int8_dense codes")),
        dict(name="mlp_bf16", source=msrc,
             replaces="uspace_tpu/ops/mlp.py:91 (_mlp_kernel_bf16)",
             kernel=lambda: mlpk.fused_mlp(xr, w1, b1, w2, b2),
             plain=lambda: mlpk.mlp_bf16_plain(xr, w1, b1, w2, b2, strips),
             library=lambda: lib_mlp(xr),
             bytes=io(xr, w1, b1, w2, b2) + io(xr), flops=mlp_flops,
             tol=res_tol, shape=mshape),
        dict(name="ln_mlp_bf16", source=msrc,
             replaces="uspace_tpu/ops/mlp.py:119 (_mlp_kernel_bf16_lnres)",
             kernel=lambda: mlpk.fused_mlp_block_q(xr, lns, lnb, w1, b1, w2,
                                                   b2, quant=False),
             plain=lambda: mlpk.ln_mlp_bf16_plain(xr, lns, lnb, w1, b1, w2,
                                                  b2, strips, 1e-5),
             library=lambda: xr + lib_mlp(ln(xr)),
             bytes=io(xr, lns, lnb, w1, b1, w2, b2) + io(xr),
             flops=mlp_flops, shape=mshape, tol=res_tol,
             part=lambda t: t.double() - xr.double()),
    ]


def hd32_cases(torch, F, attn, mlpk, randn, io, quant):
    """Phase 3's cases at head dim 32 (the U-ViT toys' head dim) of rows 1-6,
    10 and 11, at the main path's B=50, L=257, C=1024 (the backward at
    TRAIN_B) in H32 = 32 heads: each against its twin within its D = 64
    limits, with its time and bound, the int8 rows with their D = 64
    controls. Listed under ``kernel_shapes``, each counted on its row's
    launch count."""
    f32, bf = torch.float32, torch.bfloat16
    h, d = H32, C // H32
    scale = d ** -0.5

    def sdpa32(qkv_, b=B):
        q, k, v = qkv_.view(b, L, 3, h, d).permute(2, 0, 3, 1, 4)
        return F.scaled_dot_product_attention(q, k, v).transpose(
            1, 2).reshape(b, L, C)

    x = randn(B, L, C)
    xb = randn(B, L, C, std=0.05)  # the sub-block's x at its update's scale
    w = randn(3 * C, C, std=0.02).t()
    wp = randn(C, C, std=0.02).t()
    bp = randn(C, std=0.02, dtype=f32)
    wf = randn(3 * C, C, std=0.02, dtype=f32).t()
    qw = quant.quantized_weight(wf)
    wpf = randn(C, C, std=0.02, dtype=f32).t()
    qwp = quant.quantized_weight(wpf)
    qkv = randn(B, L, 3 * C, std=0.64)
    lns = 1.0 + randn(C, std=0.1, dtype=f32)
    lnb = randn(C, std=0.1, dtype=f32)
    qkv_t = randn(TRAIN_B, L, 3 * C, std=0.64)
    do_t = randn(TRAIN_B, L, C)
    qkv_l = qkv_t.detach().requires_grad_()
    o_l = sdpa32(qkv_l, TRAIN_B)

    def ln(t):
        return F.layer_norm(t, (C,), lns.to(bf), lnb.to(bf), 1e-5)

    def lib_proj(xf, qw_):  # row codes, torch._int_mm, dequant
        return quant.int8_matmul(*quant.quantize_rowwise(xf), qw_.kn,
                                 qw_.scale)

    def lib_block_q():
        a = sdpa32(lib_proj(ln(xb).float(), qw).to(bf))
        return xb + (lib_proj(a.float(), qwp) + bp).to(bf)

    proj_flops = 2.0 * B * L * C * 3 * C
    attn_flops = 4.0 * B * h * L * L * d
    shape = f"B={B} L={L} C={C} H={h} D={d} bf16"
    qshape = f"B={B} L={L} C={C} H={h} D={d} bf16/int8"
    src = "uspace_tpu_torch/ops/csrc/attention.cu"
    cases = [
        dict(name="packed_attention", counter="packed_attention",
             replaces="uspace_tpu/ops/attention.py:258 (_packed_fwd_kernel)",
             kernel=lambda: attn.fused_qkv_attention(qkv, h),
             plain=lambda: attn.packed_attention_plain(qkv, h, scale),
             library=lambda: sdpa32(qkv),
             bytes=io(qkv) + io(x), flops=attn_flops),
        dict(name="qkvproj_attention", counter="qkvproj_attention",
             replaces="uspace_tpu/ops/attention.py:468 (_qkv_attn_kernel)",
             kernel=lambda: attn.fused_qkvproj_attention(x, w, h),
             plain=lambda: attn.qkvproj_attention_plain(x, w, h, scale),
             library=lambda: sdpa32(torch.matmul(x, w)),
             bytes=io(x, w) + io(x), flops=proj_flops + attn_flops),
        dict(name="ln_qkvproj_attention", counter="ln_qkvproj_attention",
             replaces="uspace_tpu/ops/attention.py:654 (_qkv_attn_kernel_ln)",
             kernel=lambda: attn.fused_ln_qkvproj_attention(x, lns, lnb, w, h),
             plain=lambda: attn.ln_qkvproj_attention_plain(
                 x, lns, lnb, w, h, scale, 1e-5),
             library=lambda: sdpa32(torch.matmul(ln(x), w)),
             bytes=io(x, w, lns, lnb) + io(x), flops=proj_flops + attn_flops),
        dict(name="packed_attention_bwd", counter="packed_attention_bwd",
             source="uspace_tpu_torch/ops/csrc/fused_attention_bwd.cu",
             replaces="uspace_tpu/ops/attention.py:285 (_packed_bwd_kernel)",
             kernel=lambda: attn.packed_attention_bwd(qkv_t, do_t, h),
             plain=lambda: attn.packed_attention_bwd_plain(qkv_t, do_t, h,
                                                           scale),
             library=lambda: torch.autograd.grad(o_l, qkv_l, do_t,
                                                 retain_graph=True),
             bytes=io(qkv_t, do_t) + io(qkv_t),
             flops=10.0 * TRAIN_B * h * L * L * d,
             tol=(BWD_MAX_ABS, BWD_REL_L2),
             shape=f"B={TRAIN_B} L={L} C={C} H={h} D={d} bf16"),
        dict(name="ln_qkvproj_attention_int8",
             counter="ln_qkvproj_attention_int8",
             replaces="uspace_tpu/ops/attention.py:592 (_qkv_attn_kernel_qln)",
             kernel=lambda: attn.fused_ln_qkvproj_attention(
                 x, lns, lnb, wf, h, quant=True),
             plain=lambda: attn.ln_qkvproj_attention_int8_plain(
                 x, lns, lnb, qw, h, scale, 1e-5),
             library=lambda: sdpa32(quant.int8_matmul(
                 *quant.quantize_rowwise(F.layer_norm(
                     x.float(), (C,), lns, lnb, 1e-5)), qw.kn,
                 qw.scale).to(bf)),
             bytes=io(x, lns, lnb, qw.q, qw.scale) + io(x), flops=attn_flops,
             int8_ops=proj_flops, tol=(None, INT8_ATTN_REL_L2),
             shape=qshape),
        dict(name="qkvproj_attention_int8", counter="qkvproj_attention_int8",
             replaces="uspace_tpu/ops/attention.py:541 (_qkv_attn_kernel_q)",
             kernel=lambda: attn.fused_qkvproj_attention(x, wf, h,
                                                         quant=True),
             plain=lambda: attn.qkvproj_attention_int8_plain(x, qw, h, scale),
             library=lambda: sdpa32(lib_proj(x.float(), qw).to(bf)),
             bytes=io(x, qw.q, qw.scale) + io(x), flops=attn_flops,
             int8_ops=proj_flops, tol=(None, INT8_ATTN_REL_L2), shape=qshape,
             controls=[(c, lambda c=c: attn_control(
                 attn, quant, x, qw, wf, h, scale, c))
                 for c in ("x coded by division", "a bf16 projection")]),
        dict(name="attention_block_int8", counter="attention_block_int8",
             source="uspace_tpu_torch/ops/csrc/attention_block.cu",
             replaces="uspace_tpu/ops/attention.py:831 "
             "(_attn_block_kernel_q)",
             kernel=lambda: attn.fused_attention_block_q(xb, lns, lnb, wf,
                                                         wpf, bp, h),
             plain=lambda: attn.attention_block_int8_plain(
                 xb, lns, lnb, qw, qwp, bp, h, scale, 1e-5),
             library=lib_block_q,
             bytes=io(xb, lns, lnb, qw.q, qw.scale, qwp.q, qwp.scale, bp)
             + io(xb), flops=attn_flops, int8_ops=proj_flops * 4 / 3,
             tol=(None, INT8_ATTN_REL_L2), shape=qshape,
             part=lambda t: t.double() - xb.double(),
             controls=[(c, lambda c=c: block_q_control(
                 torch, attn, mlpk, quant, xb, lns, lnb, qw, qwp, bp, c, h))
                 for c in ("LN1 normalised in f32",
                           "proj coded as int8_dense codes")]),
        dict(name="attention_block", counter="attention_block",
             source="uspace_tpu_torch/ops/csrc/attention_block.cu",
             replaces="uspace_tpu/ops/attention.py:1044 (_attn_block_kernel)",
             kernel=lambda: attn.fused_attention_block(xb, lns, lnb, w, wp, bp,
                                                       h),
             plain=lambda: attn.attention_block_plain(xb, lns, lnb, w, wp, bp,
                                                      h, scale, 1e-5),
             library=lambda: xb + F.linear(sdpa32(torch.matmul(ln(xb), w)),
                                           wp.t(), bp.to(bf)),
             bytes=io(xb, lns, lnb, w, wp, bp) + io(xb),
             flops=proj_flops * 4 / 3 + attn_flops,
             part=lambda t: t.double() - xb.double()),
    ]
    for case in cases:
        case.setdefault("source", src)
        case.setdefault("shape", shape)
        case.update(name=f"{case['name']} D={d}", listed=False)
    return cases


def codes_read(torch, out, ref):
    """Two int8 code tensors: the largest step between them and the share
    of codes that differ."""
    d = (out.int() - ref.int()).abs()
    return int(d.max()), float((d > 0).float().mean())


@contextlib.contextmanager
def attention_core(dops, core):
    """The stage-delta twins with ``core(qkv, heads, scale)`` as their
    attention core (row 1's kernel in place of its twin)."""
    plain = dops.packed_attention_plain
    dops.packed_attention_plain = core
    try:
        yield
    finally:
        dops.packed_attention_plain = plain


@contextlib.contextmanager
def bf16_chain_ln(dops, mlpk):
    """The stage-delta twins with row 15's bf16-chain LN2 in place of their
    f32 LN (``ops.delta.ln_lanes``)."""
    ln = dops.ln_lanes
    dops.ln_lanes = mlpk._ln_bf16_normalise
    try:
        yield
    finally:
        dops.ln_lanes = ln


def delta_attn_control(torch, attn, dops, quant, x, xb, cq, cs, a_b, xm_b,
                       lns, lnb, qw, qp, core):
    """Row 19's twin with ``da`` coded as ``int8_dense`` codes it (a
    division by the rounded scale, clipped): a wrong kernel's stand-in;
    ``core(qkv, heads, scale)`` its attention core."""
    l = x.shape[1]
    dq, ds = quant.row_codes(dops.ln_lanes(x, lns, lnb, 1e-5)
                             - dops.ln_lanes(xb, lns, lnb, 1e-5))
    dqkv = quant.int_matmul(dq, qw.kn).float() * ds * qw.scale
    qkv = (cq[:, :l].float() * cs[:, :l] + dqkv).to(x.dtype)
    a = core(qkv, H, (C // H) ** -0.5)
    daq, das = quant.quantize_rowwise(a.float() - a_b.float())
    dp = quant.int_matmul(daq, qp.kn).float() * das * qp.scale
    return (x.float() - xb.float() + xm_b.float() + dp).to(x.dtype)


def delta_mlp_control(torch, attn, mlpk, dops, quant, x, xb, gq, gs, m_b,
                      lns, lnb, q1, q2, strips, change):
    """Row 23's twin with one site changed: LN2 as row 15's bf16 chain, or
    dg coded with one scale per whole row."""
    if change == "row 15's bf16-chain LN2":
        ln = lambda t: mlpk._ln_bf16_normalise(t, lns, lnb, 1e-5)  # noqa
    else:
        ln = lambda t: dops.ln_lanes(t, lns, lnb, 1e-5)  # noqa
    dq, ds = quant.row_codes(ln(x) - ln(xb))
    hs = q1.q.shape[0] // strips
    gp = gq.float() * gs.repeat_interleave(hs, dim=1)
    dg = quant.int_matmul(dq, q1.kn).float() * ds * q1.scale * gp
    n = 1 if change == "dg coded per whole row" else strips
    acc, w = 0.0, q1.q.shape[0] // n
    for j in range(n):
        hq, hsc = quant.row_codes(dg[:, j * w:(j + 1) * w])
        acc = acc + quant.int_matmul(hq, q2.kn[j * w:(j + 1) * w]).float() \
            * hsc
    return x + (m_b.float() + acc * q2.scale).to(x.dtype)


def base_mlp_control(torch, attn, mlpk, dops, quant, x, lns, lnb, q1, b1, q2,
                     b2, strips, change):
    """Row 22's twin with one site changed: LN2 as row 15's bf16 chain, or
    gelu'(e) coded with one scale per whole row (the unfused base's
    layout, its scale repeated over the strips)."""
    if change == "row 15's bf16-chain LN2":
        with bf16_chain_ln(dops, mlpk):
            return dops.base_mlp_grad_plain(x, lns, lnb, q1.kn, q1.scale, b1,
                                            q2.kn, q2.scale, b2, 1e-5, strips)
    o, _, _, m = dops.base_mlp_grad_plain(x, lns, lnb, q1.kn, q1.scale, b1,
                                          q2.kn, q2.scale, b2, 1e-5, strips)
    xq, xs = quant.row_codes(dops.ln_lanes(x, lns, lnb, 1e-5))
    e = quant.int_matmul(xq, q1.kn).float() * xs * q1.scale + b1
    gq, gs = quant.row_codes(mlpk.gelu_grad(e))
    return o, gq, gs.expand(-1, strips).contiguous(), m


def base_e_control(torch, mlpk, dops, quant, x, lns, lnb, q1, b1, q2, b2,
                   strips, change, emit_gelu):
    """Row 20's twin (21's with ``emit_gelu``) with one site changed: LN2 as
    row 15's bf16 chain, e coded with one scale per whole row (the unfused
    base's layout, its scale repeated over the strips), or GELU run on the
    uncoded e (the cache as the kernel's)."""
    w = (lns, lnb, q1.kn, q1.scale, b1, q2.kn, q2.scale, b2, 1e-5, strips)
    if change == "row 15's bf16-chain LN2":
        with bf16_chain_ln(dops, mlpk):
            return dops.base_mlp_e_plain(x, *w, emit_gelu=emit_gelu)
    if change == "GELU on the uncoded e":
        def hidden_of(e):
            return mlpk._gelu_f32(e), quant.row_codes(e)
    else:  # "e coded per whole row"
        xq, xs = quant.row_codes(dops.ln_lanes(x, lns, lnb, 1e-5))
        e = quant.int_matmul(xq, q1.kn).float() * xs * q1.scale + b1
        amax = e.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8)

        def hidden_of(e):
            eq = torch.round(e * quant.true_div(127.0, amax)).to(torch.int8)
            es = amax * (1.0 / 127.0)
            return mlpk._gelu_f32(eq.float() * es), (eq, es)
    o, m, e_q, e_s, g_q, g_s, g_z = dops._base_mlp_twin(x, *w, hidden_of)
    return (o, e_q, e_s, m) + ((g_q, g_s, g_z) if emit_gelu else ())


def delta_e_control(torch, mlpk, dops, quant, x, xb, e_q, e_s, gcache, m_b,
                    lns, lnb, q1, q2, strips, change):
    """Row 25's twin (24's with ``gcache``) with one site changed: LN2 as
    row 15's bf16 chain, dg coded with one scale per whole row, or row 24
    anchored at gelu(deq(e_q)) (row 25's anchor) instead of the affine
    codes fc2 read in the base."""
    w = (lns, lnb, q1.kn, q1.scale, q2.kn, q2.scale, 1e-5, strips)
    if change == "row 24 anchored at gelu(deq(e_q))":
        return dops.delta_mlp_exact_plain(x, xb, e_q, e_s, m_b, *w)
    if change == "row 15's bf16-chain LN2":
        with bf16_chain_ln(dops, mlpk):
            if gcache is None:
                return dops.delta_mlp_exact_plain(x, xb, e_q, e_s, m_b, *w)
            return dops.delta_mlp_g_plain(x, xb, e_q, e_s, *gcache, m_b, *w)
    # "dg coded per whole row"
    hs = q1.q.shape[0] // strips
    dq, ds = quant.row_codes(dops.ln_lanes(x, lns, lnb, 1e-5)
                             - dops.ln_lanes(xb, lns, lnb, 1e-5))
    de = quant.int_matmul(dq, q1.kn).float() * ds * q1.scale
    e_b = e_q.float() * e_s.repeat_interleave(hs, dim=1)
    dg = mlpk._gelu_f32(e_b + de) - mlpk._gelu_f32(e_b)
    hq, hsc = quant.row_codes(dg)
    acc = quant.int_matmul(hq, q2.kn).float() * hsc
    return x + (m_b.float() + acc * q2.scale).to(x.dtype)


def delta_cases(torch, F, attn, mlpk, quant, randn, sdpa_packed, io):
    """Phase 3's cases of the stage-delta field (rows 18 to 25 of the
    PERF.md table) at the main path's shapes (B = 50, L = 257 padded to Lp
    = 288 for the base's cache; 12850 rows, hidden 4096). The delta kernels'
    inputs are a stage's: x = x_b + 1e-2 of x_b's scale, the caches from the
    base twins on x_b, xm_b the field's post-attention stream; they are
    compared on what they add to their cache (xm - xm_b, o - x - m_b). The
    base kernels are held on every output, caches included: codes one step
    apart at most at a rate below STAGE_FLIP_RATE, scales within 1e-6.
    Yardsticks: the same chains from PyTorch calls (layer_norm, row
    quantization, torch._int_mm, dequantization, SDPA, F.gelu and its slope
    from autograd's formula). Controls: twins with one site changed."""
    from uspace_tpu_torch.core import delta_field
    from uspace_tpu_torch.ops import delta as dops

    f32, bf = torch.float32, torch.bfloat16
    d = C // H
    scale = d ** -0.5
    lp = dops.round_up(L, dops.SEQ_ALIGN)
    rows, hid = B * L, 4 * C
    strips = mlpk.col_slices(hid)
    xb = randn(B, L, C, std=STREAM_STD)
    x = (xb.float() + randn(B, L, C, std=STAGE_GAP * STREAM_STD,
                            dtype=f32)).to(bf)
    lns, lnb = 1.0 + randn(C, std=0.1, dtype=f32), randn(C, std=0.1,
                                                         dtype=f32)
    qw = quant.quantized_weight(randn(3 * C, C, std=0.02, dtype=f32).t())
    qp = quant.quantized_weight(randn(C, C, std=0.02, dtype=f32).t())
    bp = randn(C, std=0.02, dtype=f32)
    q1 = quant.quantized_weight(randn(hid, C, std=0.02, dtype=f32).t())
    q2 = quant.quantized_weight(randn(C, hid, std=0.02, dtype=f32).t())
    b1 = randn(hid, std=0.02, dtype=f32)
    b2 = randn(C, std=0.02, dtype=f32)
    with torch.no_grad():
        a_b, cq, cs = dops.base_attn_plain(xb, lns, lnb, qw.kn, qw.scale, H,
                                           1e-5)
        xm_b = (xb.float() + delta_field._int8_dot(a_b.float(), qp)
                + bp).to(bf)
        xr_b = randn(rows, C, std=STREAM_STD)
        xr = (xr_b.float() + randn(rows, C, std=STAGE_GAP * STREAM_STD,
                                   dtype=f32)).to(bf)
        _, gq, gs, m_b = dops.base_mlp_grad_plain(
            xr_b, lns, lnb, q1.kn, q1.scale, b1, q2.kn, q2.scale, b2, 1e-5,
            strips)
        # the "exact" / "gelu" caches of rows 20-21 (their m equals row
        # 22's only in shape: fc2 reads GELU of the coded e)
        _, e_q, e_s, m_e, g_q, g_s, g_z = dops.base_mlp_e_plain(
            xr_b, lns, lnb, q1.kn, q1.scale, b1, q2.kn, q2.scale, b2, 1e-5,
            strips, emit_gelu=True)

    def held(main, main_ref, part, tol_rel, codes=(), scales=()):
        """The int8 rule on the main output (max-abs one bf16 step of its
        largest value, rel-L2 of its part), codes and scales as above."""
        a, r = main.double(), main_ref.double()
        tol_abs = bf16_step(float(r.abs().max()))
        max_abs = float((a - r).abs().max())
        pa, pr = part(a), part(r)
        rel = float((pa - pr).norm() / pr.norm())
        ok = max_abs <= tol_abs and rel <= tol_rel
        more = ""
        for name, o, rf in codes:
            step, rate = codes_read(torch, o, rf)
            ok = ok and step <= 1 and rate <= STAGE_FLIP_RATE
            more += f"; {name} codes: largest step {step}, flips {rate:.2e}"
        for name, o, rf in scales:
            err = float((o.double() - rf.double()).abs().max())
            ok = ok and err <= STAGE_SCALE_ABS
            more += f"; {name} scales: max_abs {err:.1e}"
        return max_abs, rel, tol_abs, tol_rel, ok, more

    def judge_base_attn(out, ref):  # the cache over all Lp rows
        return held(out[0], ref[0], lambda t: t, INT8_ATTN_REL_L2,
                    codes=[("qkv", out[1], ref[1])],
                    scales=[("qkv", out[2], ref[2])])

    def judge_base_mlp(out, ref, cache="gelu'"):
        """o on o - x, m, and the caches: (codes, scales) of ``cache`` and,
        for row 21, the affine codes, scales and zero points of GELU."""
        codes = [(cache, out[1], ref[1])]
        scales = [(cache, out[2], ref[2])]
        if len(ref) > 4:
            codes.append(("affine GELU", out[4], ref[4]))
            scales += [("affine GELU", out[5], ref[5]),
                       ("affine GELU zero-point", out[6], ref[6])]
        r = held(out[0], ref[0], lambda t: t - xr_b.double(),
                 INT8_MLP_REL_L2, codes=codes, scales=scales)
        m = held(out[3], ref[3], lambda t: t, INT8_MLP_REL_L2)
        return (max(r[0], m[0]), max(r[1], m[1]), r[2], r[3], r[4] and m[4],
                r[5] + f"; m max_abs {m[0]:.3e} rel_l2 {m[1]:.3e}")

    def judge_base_e(out, ref):
        return judge_base_mlp(out, ref, cache="e")

    def lib_codes(t):  # PyTorch's row quantization, torch._int_mm, dequant
        return quant.quantize_rowwise(t)

    def lib_proj(xf, qw_):
        return quant.int8_matmul(*lib_codes(xf), qw_.kn, qw_.scale)

    def ln(t):
        return F.layer_norm(t.float(), (C,), lns, lnb, 1e-5)

    def lib_base_attn():
        qkv = lib_proj(ln(F.pad(xb, (0, 0, 0, lp - L))), qw)
        q8, s8 = lib_codes(qkv)
        return sdpa_packed((q8[:, :L].float() * s8[:, :L]).to(bf)), q8, s8

    def lib_delta_attn():
        qkv = (cq[:, :L].float() * cs[:, :L]
               + lib_proj(ln(x) - ln(xb), qw)).to(bf)
        a = sdpa_packed(qkv).transpose(1, 2).reshape(B, L, C)
        return (x.float() - xb.float() + xm_b.float()
                + lib_proj(a.float() - a_b.float(), qp)).to(bf)

    def gelu_slope(e):  # d/de GELU(e), as autograd's GELU backward has it
        return 0.5 * (1 + torch.erf(e * 0.7071067811865476)) \
            + e * torch.exp(-0.5 * e * e) * 0.3989422804014327

    def lib_base_mlp():
        e = lib_proj(ln(xr_b), q1) + b1
        g8 = lib_codes(gelu_slope(e))
        m = (lib_proj(F.gelu(e), q2) + b2).to(bf)
        return xr_b + m, g8, m

    def lib_delta_mlp():
        dg = lib_proj(ln(xr) - ln(xr_b), q1) * (gq.float() * gs.repeat_interleave(
            hid // strips, dim=1))
        return xr + (m_b.float() + lib_proj(dg, q2)).to(bf)

    def per_strip(t):  # a [rows, strips] scale over the strip's columns
        return t.repeat_interleave(hid // strips, dim=1)

    def lib_base_e(emit_gelu):
        e = lib_proj(ln(xr_b), q1) + b1
        e8 = lib_codes(e)
        g = F.gelu(e8[0].float() * e8[1])
        g8 = lib_codes(g)
        m = (lib_proj(g, q2) + b2).to(bf)
        return (xr_b + m, *e8, m) + (g8 if emit_gelu else ())

    def lib_delta_e(gelu_cache):
        e_b = e_q.float() * per_strip(e_s)
        g_b = (g_q.float() * per_strip(g_s) + per_strip(g_z) if gelu_cache
               else F.gelu(e_b))
        dg = F.gelu(e_b + lib_proj(ln(xr) - ln(xr_b), q1)) - g_b
        return xr + (m_e.float() + lib_proj(dg, q2)).to(bf)

    attn_args = (x, xb, cq, cs, a_b, xm_b, lns, lnb, qw.kn, qw.scale, qp.kn,
                 qp.scale, H, 1e-5)

    def row1_core(qkv, heads, scale_):
        return attn.fused_qkv_attention(qkv, heads, scale_)

    def row1_twin():
        with attention_core(dops, row1_core):
            return dops.delta_attn_plain(*attn_args)
    mlp_args = (xr, xr_b, gq, gs, m_b, lns, lnb, q1.kn, q1.scale, q2.kn,
                q2.scale, 1e-5)
    w_base = (lns, lnb, q1.kn, q1.scale, b1, q2.kn, q2.scale, b2, 1e-5)
    w_delta = (lns, lnb, q1.kn, q1.scale, q2.kn, q2.scale, 1e-5)
    gcache = (g_q, g_s, g_z)
    qkv_ops = 2.0 * B * L * C * 3 * C
    proj_ops = 2.0 * B * L * C * C
    attn_flops = 4.0 * B * H * L * L * d
    mlp_ops = 2.0 * 2.0 * rows * C * hid
    wq, wp = io(qw.q, qw.scale), io(qp.q, qp.scale)
    w12 = io(q1.q, q1.scale, q2.q, q2.scale)
    asrc = "uspace_tpu_torch/ops/csrc/delta_attention.cu"
    delta_attn_io = dict(
        bytes=io(x, xb, cq, cs, a_b, xm_b, lns, lnb) + wq + wp + io(x),
        flops=attn_flops, int8_ops=qkv_ops + proj_ops,
        shape=f"B={B} L={L} (Lp={lp}) C={C} H={H} bf16/int8",
        part=lambda t: t.double() - xm_b.double())
    msrc = "uspace_tpu_torch/ops/csrc/delta_mlp.cu"
    ashape = f"B={B} L={L} (Lp={lp}) C={C} H={H} bf16/int8"
    mshape = f"rows={rows} C={C} hidden={hid} strips={strips} bf16/int8"
    cases = [
        dict(name="base_attn_cache", source=asrc,
             replaces="uspace_tpu/ops/delta.py:158 (_base_attn_cache_kernel)",
             kernel=lambda: dops.base_attn_block(xb, lns, lnb, qw.kn,
                                                 qw.scale, H, 1e-5),
             plain=lambda: dops.base_attn_plain(xb, lns, lnb, qw.kn,
                                                qw.scale, H, 1e-5),
             library=lib_base_attn, judge=judge_base_attn,
             bytes=io(xb, lns, lnb) + wq + io(a_b, cq, cs),
             flops=attn_flops, int8_ops=qkv_ops, shape=ashape,
             controls=[("no qkv re-coding (row 5's route)", lambda: (
                 attn.ln_qkvproj_attention_int8_plain(
                     xb, lns, lnb, qw, H, scale, 1e-5), cq, cs))]),
        dict(name="delta_attn", source=asrc,
             replaces="uspace_tpu/ops/delta.py:184 (_delta_attn_kernel)",
             kernel=lambda: dops.delta_attn_block(*attn_args),
             plain=lambda: dops.delta_attn_plain(*attn_args),
             library=lib_delta_attn, **delta_attn_io,
             tol=(None, DELTA_ATTN_REL_L2)),
        dict(name="delta_attn, twin on row 1's attention core",
             counter="delta_attn", listed=False, source=asrc,
             replaces="uspace_tpu/ops/delta.py:184 (_delta_attn_kernel)",
             kernel=lambda: dops.delta_attn_block(*attn_args),
             plain=row1_twin, library=lib_delta_attn, **delta_attn_io,
             tol=(None, INT8_ATTN_REL_L2),
             controls=[("da coded as int8_dense codes it",
                        lambda: delta_attn_control(
                            torch, attn, dops, quant, x, xb, cq, cs, a_b,
                            xm_b, lns, lnb, qw, qp, row1_core))]),
        dict(name="base_mlp_grad", source=msrc,
             replaces="uspace_tpu/ops/delta.py:454 "
             "(_base_mlp_cache_kernel_gr)",
             kernel=lambda: dops.base_mlp_block(
                 xr_b, lns, lnb, q1.kn, q1.scale, b1, q2.kn, q2.scale, b2,
                 1e-5, mode="grad"),
             plain=lambda: dops.base_mlp_grad_plain(
                 xr_b, lns, lnb, q1.kn, q1.scale, b1, q2.kn, q2.scale, b2,
                 1e-5, strips),
             library=lib_base_mlp, judge=judge_base_mlp,
             bytes=io(xr_b, lns, lnb, b1, b2) + w12 + io(xr_b, gq, gs, m_b),
             flops=0.0, int8_ops=mlp_ops, shape=mshape,
             controls=[(c, lambda c=c: base_mlp_control(
                 torch, attn, mlpk, dops, quant, xr_b, lns, lnb, q1, b1, q2,
                 b2, strips, c)) for c in (
                     "row 15's bf16-chain LN2",
                     "gelu' coded per whole row (the unfused layout)")]),
        dict(name="delta_mlp_lin", source=msrc,
             replaces="uspace_tpu/ops/delta.py:518 (_delta_mlp_kernel_lin)",
             kernel=lambda: dops.delta_mlp_block(*mlp_args, grad=True),
             plain=lambda: dops.delta_mlp_lin_plain(*mlp_args, strips),
             library=lib_delta_mlp,
             bytes=io(xr, xr_b, gq, gs, m_b, lns, lnb) + w12 + io(xr),
             flops=0.0, int8_ops=mlp_ops, shape=mshape,
             tol=(None, INT8_MLP_REL_L2),
             part=lambda t: t.double() - xr.double() - m_b.double(),
             controls=[(c, lambda c=c: delta_mlp_control(
                 torch, attn, mlpk, dops, quant, xr, xr_b, gq, gs, m_b, lns,
                 lnb, q1, q2, strips, c)) for c in (
                     "row 15's bf16-chain LN2", "dg coded per whole row")]),
    ]
    base_controls = ("row 15's bf16-chain LN2", "e coded per whole row",
                     "GELU on the uncoded e")
    for name, line, mode, emit in (
            ("base_mlp_e", "361 (_base_mlp_cache_kernel)", "e", False),
            ("base_mlp_eg", "438 (_base_mlp_cache_kernel_g)", "e+g", True)):
        cases.append(dict(
            name=name, source=msrc, replaces=f"uspace_tpu/ops/delta.py:{line}",
            kernel=lambda mode=mode: dops.base_mlp_block(xr_b, *w_base,
                                                         mode=mode),
            plain=lambda emit=emit: dops.base_mlp_e_plain(
                xr_b, *w_base, strips, emit_gelu=emit),
            library=lambda emit=emit: lib_base_e(emit), judge=judge_base_e,
            bytes=io(xr_b, lns, lnb, b1, b2) + w12
            + io(xr_b, e_q, e_s, m_e, *(gcache if emit else ())),
            flops=0.0, int8_ops=mlp_ops, shape=mshape,
            controls=[(c, lambda c=c, emit=emit: base_e_control(
                torch, mlpk, dops, quant, xr_b, lns, lnb, q1, b1, q2, b2,
                strips, c, emit)) for c in base_controls]))
    for name, line, gc, controls in (
            ("delta_mlp_exact", "639 (_delta_mlp_kernel)", None,
             ("row 15's bf16-chain LN2", "dg coded per whole row")),
            ("delta_mlp_g", "575 (_delta_mlp_kernel_g)", gcache,
             ("row 15's bf16-chain LN2",
              "row 24 anchored at gelu(deq(e_q))"))):
        cases.append(dict(
            name=name, source=msrc, replaces=f"uspace_tpu/ops/delta.py:{line}",
            kernel=lambda gc=gc: dops.delta_mlp_block(
                xr, xr_b, e_q, e_s, m_e, *w_delta, gelu_cache=gc),
            plain=(lambda: dops.delta_mlp_exact_plain(
                xr, xr_b, e_q, e_s, m_e, *w_delta, strips)) if gc is None
            else (lambda: dops.delta_mlp_g_plain(
                xr, xr_b, e_q, e_s, *gcache, m_e, *w_delta, strips)),
            library=lambda gc=gc: lib_delta_e(gc is not None),
            bytes=io(xr, xr_b, e_q, e_s, m_e, lns, lnb, *(gc or ())) + w12
            + io(xr),
            flops=0.0, int8_ops=mlp_ops, shape=mshape,
            tol=(None, INT8_MLP_REL_L2),
            part=lambda t: t.double() - xr.double() - m_e.double(),
            controls=[(c, lambda c=c, gc=gc: delta_e_control(
                torch, mlpk, dops, quant, xr, xr_b, e_q, e_s, gc, m_e, lns,
                lnb, q1, q2, strips, c)) for c in controls]))
    return cases


def int8_conv_check(torch, F, quant):
    """Phase 3b: ops.quant.int8_conv on the card (im2col, torch._int_mm)
    against the same function on the CPU (an exact float64 product), same
    bf16 inputs, f32 output: the int32 sums are exact, so the activation
    codes, the weight codes and every output bit must be equal. Times the
    card's int8_conv and, beside it, cuDNN's bf16 conv of the same shape."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(77)
    out = {}
    for name, (shape, cout, stride) in INT8_CONV_SHAPES.items():
        cin = shape[-1]
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        w = torch.randn((cout, cin, 3, 3), generator=g, device=dev) * \
            (9 * cin) ** -0.5
        bias = torch.randn((cout,), generator=g, device=dev) * 0.1
        st = (stride, stride)

        def card(x=x, w=w, bias=bias, st=st):
            return quant.int8_conv(x, w, bias, st, (1, 1), torch.float32)

        y = card()
        xq, xs = quant.image_codes(x)
        wq = quant.quantized_conv_weight(w)
        torch.cuda.synchronize()
        y_cpu = quant.int8_conv(x.cpu(), w.cpu(), bias.cpu(), st, (1, 1),
                                torch.float32)
        xq_cpu, xs_cpu = quant.image_codes(x.cpu())
        wq_cpu = quant.quantized_conv_weight(w.cpu())
        codes = (torch.equal(xq.cpu(), xq_cpu) and torch.equal(
            xs.cpu(), xs_cpu) and torch.equal(wq.q.cpu(), wq_cpu.q)
            and torch.equal(wq.scale.cpu(), wq_cpu.scale))
        bits = torch.equal(y.cpu(), y_cpu)
        max_abs, _, _ = compare(torch, y.cpu(), y_cpu)
        xn, wb = x.permute(0, 3, 1, 2), w.to(torch.bfloat16)
        ms = time_ms(torch, card)
        bf16_ms = time_ms(torch, lambda: F.conv2d(xn, wb, bias.to(
            torch.bfloat16), st, 1))
        out[name] = dict(shape=f"{list(shape)} -> {cout}, k3 s{stride}",
                         codes_equal=codes, bits_equal=bits,
                         max_abs=max_abs, ms=ms, bf16_conv_ms=bf16_ms)
        log(f"int8_conv {name} {list(shape)} -> {cout}: card vs CPU codes "
            f"equal {codes}, outputs bit-equal {bits} (max_abs "
            f"{max_abs:.3e}); {ms:.4f} ms on the card, cuDNN bf16 conv "
            f"{bf16_ms:.4f} ms")
        if not (codes and bits):
            fail(f"int8_conv {name}: the card differs from the CPU")
    return out


def decode_run(torch, flow, model, z, steps, method="euler"):
    sk = {"solver": "fixed", "solver_fix": method,
          "solver_fix_step": 1.0 / steps}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = flow.decode(lambda t, x: model(x, t)[0], z, sk)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def twin_block(torch, blk, z, skip=None, change=None):
    """One block of the int8 view composed from the kernels' plain twins
    (int8_dense for skip_linear, as the model): on the LN-fused route the
    LN attention twin and int8_dense for proj, on `pallas_block` the int8
    sub-block twin; ``change`` names a control of ``mlp_control`` for its
    MLP."""
    from uspace_tpu_torch.ops import attention as attn
    from uspace_tpu_torch.ops import mlp as mlpk
    from uspace_tpu_torch.ops import quant

    if blk.skip_linear is not None:
        z = blk.skip_linear(torch.cat([z, skip], dim=-1))
    qkv_w = quant.quantized_weight(blk.attn.qkv.weight.t())
    if blk.attn_impl == "pallas_block":
        z = attn.attention_block_int8_plain(
            z, blk.norm1.weight, blk.norm1.bias, qkv_w,
            quant.quantized_weight(blk.attn.proj.weight.t()),
            blk.attn.proj.bias, blk.attn.num_heads, blk.attn.scale,
            blk.norm1.eps)
    else:
        a = attn.ln_qkvproj_attention_int8_plain(
            z, blk.norm1.weight, blk.norm1.bias, qkv_w, blk.attn.num_heads,
            blk.attn.scale, blk.norm1.eps)
        z = z + blk.attn.proj.int8(a).to(z.dtype)
    q1 = quant.quantized_weight(blk.mlp.fc1.weight.t())
    q2 = quant.quantized_weight(blk.mlp.fc2.weight.t())
    z2 = z.reshape(-1, z.shape[-1])
    ln = (blk.norm2.weight, blk.norm2.bias, blk.norm2.eps)
    strips = mlpk.col_slices(q1.q.shape[0])
    if change is None:
        out = mlpk.ln_mlp_int8_plain(z2, *ln[:2], q1, blk.mlp.fc1.bias, q2,
                                     blk.mlp.fc2.bias, strips, ln[2])
    else:
        out = mlp_control(torch, attn, mlpk, quant, z2, q1, blk.mlp.fc1.bias,
                          q2, blk.mlp.fc2.bias, strips, change, ln)
    return out.reshape(z.shape)


def composed_field(torch, model, x, t, block):
    """The model's field with each block computed by ``block(blk, z,
    skip)``, the rest by the model's own modules."""
    from uspace_tpu_torch.models.layers import timestep_embedding, unpatchify

    m = model
    z = m.patch_embed(x)
    t_emb = m.time_embed(timestep_embedding(t, m.embed_dim).to(m.dtype))
    z = torch.cat([t_emb[:, None, :], z], dim=1) + m.pos_embed.to(m.dtype)
    skips = []
    for blk in m.in_blocks:
        z = block(blk, z, None)
        skips.append(z)
    z = block(m.mid_block, z, None)
    for blk in m.out_blocks:
        z = block(blk, z, skips.pop())
    z = unpatchify(m.decoder_pred(m.norm(z))[:, m.extras:, :], m.in_chans)
    return m.final_layer(z.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


BLOCK_CONTROLS = ("the hidden kept in f32", "one hidden grid per row")


def field_check(torch, model, z, t):
    """Phase 4b's full-width field evaluation of the int8 view: block by
    block on the kernels' own inputs (kernels vs twins, and controls vs
    twins: rel-L2 of each block's update), then the whole field against
    the twins' composition and against a control's composition."""
    rels = {"kernels": []}
    rels.update({c: [] for c in BLOCK_CONTROLS})

    def kernel_block(blk, zin, skip):
        out = blk(zin, skip)
        ref = twin_block(torch, blk, zin, skip)
        base = zin  # the update is taken after skip_linear (int8_dense)
        if skip is not None:
            base = blk.skip_linear(torch.cat([zin, skip], dim=-1))
        upd = (ref.double() - base.double()).norm()
        rels["kernels"].append(float((out.double() - ref.double()).norm()
                                     / upd))
        for c in BLOCK_CONTROLS:
            ctl = twin_block(torch, blk, zin, skip, c)
            rels[c].append(float((ctl.double() - ref.double()).norm() / upd))
        return out

    with torch.no_grad():
        v_kernel = composed_field(torch, model, z, t, kernel_block)
        v_direct, _ = model(z, t)
        v_twin = composed_field(torch, model, z, t, lambda b, zi, s:
                                twin_block(torch, b, zi, s))
        v_ctl = composed_field(torch, model, z, t, lambda b, zi, s:
                               twin_block(torch, b, zi, s, BLOCK_CONTROLS[0]))
    if not torch.equal(v_kernel, v_direct):
        fail("the block-by-block field differs from the model's own call")
    f_abs, f_rel, f_cos = compare(torch, v_kernel, v_twin)
    c_abs, c_rel, c_cos = compare(torch, v_ctl, v_twin)
    out = dict(block_rel_l2_max=max(rels["kernels"]),
               block_rel_l2=rels["kernels"],
               controls={c: dict(rel_l2_min=min(rels[c]), rel_l2=rels[c])
                         for c in BLOCK_CONTROLS},
               field=dict(cos=f_cos, rel_l2=f_rel, max_abs=f_abs),
               field_control=dict(change=BLOCK_CONTROLS[0], cos=c_cos,
                                  rel_l2=c_rel, max_abs=c_abs))
    log(f"int8 blocks at batch {B}, kernels vs twins on the same input: "
        f"update rel_l2 max {out['block_rel_l2_max']:.3e} over "
        f"{len(rels['kernels'])} blocks (max {BLOCK_REL_L2})")
    problems = []
    if out["block_rel_l2_max"] > BLOCK_REL_L2:
        problems.append("an int8 block disagrees with its twins")
    for c in BLOCK_CONTROLS:
        lo = out["controls"][c]["rel_l2_min"]
        log(f"  control, {c}: update rel_l2 min {lo:.3e} over the blocks: "
            f"{'fails' if lo > BLOCK_REL_L2 else 'PASSES'} the comparison")
        if lo <= BLOCK_REL_L2:
            problems.append(f"the block limit lets twins with {c} pass")
    log(f"int8 field, kernels vs twins' composition: cos {f_cos:.7f} (min "
        f"{FIELD_MIN_COS}) rel_l2 {f_rel:.3e} (max {FIELD_MAX_REL_L2}) "
        f"max_abs {f_abs:.3e}; twins with {BLOCK_CONTROLS[0]} vs twins: cos "
        f"{c_cos:.7f} rel_l2 {c_rel:.3e}")
    if not (f_cos >= FIELD_MIN_COS and f_rel <= FIELD_MAX_REL_L2):
        problems.append("the int8 field disagrees with its twins' "
                        "composition")
    if problems:
        fail("; ".join(problems))
    return out


def int8_path(torch, flow, attn, mlpk, quant, sample_lfm, cfg, dev, z,
              lat_bf16, by_key):
    """Phase 4b: the int8 W8A8 view's Euler-50 solve at batch 50."""
    model = sample_lfm.build_model(cfg, dev, seed=0, attn_impl="auto",
                                   quant=True)
    t_half = torch.full((B,), 0.5, device=dev)
    with torch.no_grad():  # warm-up: quantizes every weight once
        model(z, torch.zeros(B, device=dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(attn, mlpk)
    quant.reset_quantizations()
    lat, secs = decode_run(torch, flow, model, z, STEPS)
    launches = all_launches(attn, mlpk)
    n_quant = quant.QUANTIZATIONS["weights"]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n = (cfg["nnet"]["depth"] + 1) * STEPS
    want = expected(attn, mlpk, ln_qkvproj_attention_int8=n, ln_mlp_int8=n)
    max_abs, rel, cos = compare(torch, lat, lat_bf16)
    log(f"int8 main path (quant=True, auto): {secs:.3f} s, {B / secs:.3f} "
        f"img/s, launches {launches}, weight quantizations in the solve "
        f"{n_quant}, peak {peak_gb:.2f} GiB; latents vs the bf16 kernel view: "
        f"cos {cos:.7f} (min {QUANT_MIN_COS}) rel_l2 {rel:.3e} (max "
        f"{QUANT_MAX_REL_L2})")
    if launches != want:
        fail(f"int8 main path launches {launches}, expected {want}")
    if n_quant:
        fail(f"{n_quant} weight quantizations inside the timed solve")
    if tuple(lat.shape) != (B, 32, 32, 4) or not torch.isfinite(lat).all():
        fail(f"int8 latents {tuple(lat.shape)} or not finite")
    if not (cos >= QUANT_MIN_COS and rel <= QUANT_MAX_REL_L2):
        fail("the int8 view fails the quality gate against bf16")
    for k in ("ln_qkvproj_attention_int8", "ln_mlp_int8"):
        by_key[k]["launches"] = launches[k]
    return model, dict(
        steps=STEPS, batch=B, seconds=secs, imgs_per_s=B / secs, cos=cos,
        rel_l2=rel, max_abs=max_abs, launches=launches,
        quantizations_in_solve=n_quant, peak_gib=peak_gb,
        field_check=field_check(torch, model, z, t_half))


def adaptive_solve(torch, flow, model, z, max_steps=MAX_STEPS):
    """One dopri5 solve through ``core.flow.decode``: latents, seconds and
    the solver's statistics."""
    stats = {}
    sk = dict(ADAPTIVE_SK, max_steps=max_steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        lat = flow.decode(lambda t, x: model(x, t)[0], z, sk, stats=stats)
    torch.cuda.synchronize()
    return lat, time.perf_counter() - t0, stats


def adaptive_view(torch, flow, attn, mlpk, quant, name, model, z, blocks,
                  kernels):
    """A warm dopri5 solve, then a timed one: its readings, with exactly
    ``blocks * NFE`` launches of each of ``kernels`` and of no other
    kernel, no weight quantization, t = 1 below ``MAX_STEPS``."""
    adaptive_solve(torch, flow, model, z)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(attn, mlpk)
    quant.reset_quantizations()
    lat, secs, st = adaptive_solve(torch, flow, model, z)
    launches = all_launches(attn, mlpk)
    n_quant = quant.QUANTIZATIONS["weights"]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    want = expected(attn, mlpk, **{k: blocks * st["nfe"] for k in kernels})
    rec = dict(nfe=st["nfe"], steps=st["steps"], accepted=st["accepted"],
               rejections=st["steps"] - st["accepted"], t=st["t"],
               seconds=secs, imgs_per_s=B / secs, peak_gib=peak_gb,
               launches=launches, quantizations_in_solve=n_quant)
    log(f"{name}: dopri5 rtol=atol=1e-5 (I controller, safety 0.9): NFE "
        f"{st['nfe']}, steps {st['steps']}, accepted {st['accepted']}, t "
        f"{st['t']}, {secs:.3f} s, {B / secs:.3f} img/s, peak {peak_gb:.2f} "
        f"GiB, launches {launches}, weight quantizations {n_quant}")
    if st["t"] != 1.0 or st["steps"] >= MAX_STEPS:
        fail(f"{name}: the dopri5 solve stopped at t={st['t']} after "
             f"{st['steps']} steps")
    if launches != want:
        fail(f"{name}: launches {launches}, expected {want}")
    if n_quant:
        fail(f"{name}: {n_quant} weight quantizations inside the solve")
    if tuple(lat.shape) != (B, 32, 32, 4) or not torch.isfinite(lat).all():
        fail(f"{name}: latents {tuple(lat.shape)} or not finite")
    return lat, rec


def adaptive_agree(torch, what, lat, ref, limits):
    max_abs, rel, cos = compare(torch, lat, ref)
    min_cos, max_rel = limits
    log(f"  {what}: cos {cos:.7f} (min {min_cos}) rel_l2 {rel:.3e} (max "
        f"{max_rel})")
    if not (cos >= min_cos and rel <= max_rel):
        fail(f"{what}: outside the limits")
    return dict(cos=cos, rel_l2=rel, max_abs=max_abs)


def adaptive_path(torch, flow, attn, mlpk, quant, sample_lfm, cfg, dev, z,
                  model, by_key):
    """Phase 4c: the reference's eval decode, dopri5 at rtol = atol = 1e-5,
    at batch 50 from phase 4's weights and z: the bf16 view on the LN-fused
    route (LN + QKV-projection kernel, plain MLP), the w8 view (the same
    kernel and the w8 MLP sub-block kernel), and the W8A8 view as a control
    capped at W8A8_CONTROL_MAX_STEPS step attempts. Returns the w8 model and
    the bf16 view's latents (phase 22's reference)."""
    blocks = cfg["nnet"]["depth"] + 1
    out = {}
    view = sample_lfm.build_model(cfg, dev, seed=0, attn_impl="pallas_lnmlp")
    view.load_state_dict(model.state_dict())
    lat_bf16, out["bf16"] = adaptive_view(
        torch, flow, attn, mlpk, quant, "adaptive bf16 (pallas_lnmlp)", view,
        z, blocks, ("ln_qkvproj_attention",))
    lat_rk4, secs = decode_run(torch, flow, view, z, STEPS, method="rk4")
    out["bf16"]["rk4_seconds"] = secs
    out["bf16"]["vs_rk4"] = adaptive_agree(
        torch, f"bf16 dopri5 vs rk4-{STEPS} ({4 * STEPS} evaluations, "
        f"{secs:.1f} s)", lat_bf16, lat_rk4, ADAPT_RK4_LIMITS)
    by_key["ln_qkvproj_attention"]["launches"] = \
        out["bf16"]["launches"]["ln_qkvproj_attention"]
    del view, lat_rk4
    w8 = sample_lfm.build_model(cfg, dev, seed=0, attn_impl="auto",
                                quant="w8")
    w8.load_state_dict(model.state_dict())  # the bf16 weights, in f32
    lat_w8, out["w8"] = adaptive_view(
        torch, flow, attn, mlpk, quant, "adaptive w8 (auto)", w8, z, blocks,
        ("ln_qkvproj_attention", "ln_mlp_w8"))
    out["w8"]["vs_bf16"] = adaptive_agree(torch, "w8 dopri5 vs bf16 dopri5",
                                          lat_w8, lat_bf16, ADAPT_W8_LIMITS)
    ratio = out["w8"]["nfe"] / out["bf16"]["nfe"]
    out["w8"]["nfe_ratio"] = ratio
    log(f"  w8 NFE / bf16 NFE = {ratio:.3f} (max {W8_NFE_RATIO})")
    if ratio > W8_NFE_RATIO:
        fail("the w8 view's dopri5 NFE exceeds the bound")
    by_key["ln_mlp_w8"]["launches"] = out["w8"]["launches"]["ln_mlp_w8"]
    q = sample_lfm.build_model(cfg, dev, seed=0, attn_impl="auto", quant=True)
    q.load_state_dict(model.state_dict())
    with torch.no_grad():  # quantizes every weight once
        q(z, torch.zeros(B, device=dev))
    lat_q, secs, st = adaptive_solve(torch, flow, q, z,
                                     W8A8_CONTROL_MAX_STEPS)
    capped = st["t"] != 1.0
    out["w8a8_control"] = dict(
        max_steps=W8A8_CONTROL_MAX_STEPS, nfe=st["nfe"], steps=st["steps"],
        accepted=st["accepted"], t=st["t"], hit_cap=capped, seconds=secs)
    log(f"adaptive W8A8 control (quant=True, at most "
        f"{W8A8_CONTROL_MAX_STEPS} steps): NFE {st['nfe']}, steps "
        f"{st['steps']}, accepted {st['accepted']}, t {st['t']:.6g}"
        f"{' (hit the cap)' if capped else ''}, {secs:.1f} s; w8 view NFE "
        f"{out['w8']['nfe']}")
    del q, lat_q
    return w8, lat_bf16, out


def train_path(torch, attn, cfg, dev, by_key):
    """Phase 7: TRAIN_STEPS timed steps of U-ViT-large at TRAIN_B after
    TRAIN_WARMUP steps, with the JAX bench's optimizer (bench.py:567-581)."""
    from uspace_tpu_torch.cli.train_lfm import build_train_model
    from uspace_tpu_torch.data.datasets import SyntheticFeatures
    from uspace_tpu_torch.train.state import (
        TrainState,
        get_lr_schedule,
        get_optimizer,
    )
    from uspace_tpu_torch.train.step import make_train_step

    model = build_train_model(cfg, dev, seed=0, attn_impl="pallas_packed",
                              remat_exempt=REMAT_EXEMPT)
    n_remat = sum(model.remat)
    lr = get_lr_schedule("customized", 2e-4, warmup_steps=100)
    tx = get_optimizer("adam", lr, betas=(0.99, 0.99), weight_decay=0.03)
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, tx, lr_schedule=lr, ema_rate=0.995,
                           latents_from_moments=True)
    n = TRAIN_WARMUP + TRAIN_STEPS
    data = SyntheticFeatures(num=n * TRAIN_B, shape=(32, 32, 8), seed=0)
    batches = [torch.from_numpy(data.batch(range(i * TRAIN_B,
                                                 (i + 1) * TRAIN_B))["x"]
                                ).to(dev) for i in range(n)]
    gen = torch.Generator(device=dev).manual_seed(1)
    metrics = [step(state, {"x": batches[i]}, gen)
               for i in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attn.reset_launches()
    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP, n):
        metrics.append(step(state, {"x": batches[i]}, gen))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(attn.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in metrics]
    skips = sum(float(m["nonfinite_skip"]) for m in metrics)
    blocks = cfg["nnet"]["depth"] + 1
    want = dict.fromkeys(launches, 0)
    want.update(packed_attention=TRAIN_STEPS * (blocks + n_remat),
                packed_attention_bwd=TRAIN_STEPS * blocks)
    ips = TRAIN_B * TRAIN_STEPS / secs
    log(f"train (pallas_packed, batch {TRAIN_B}, remat_exempt {REMAT_EXEMPT}"
        f": {n_remat} of {blocks} blocks rematted): {TRAIN_STEPS} steps in "
        f"{secs:.3f} s, {ips:.3f} img/s, peak {peak_gb:.2f} GiB, launches "
        f"{launches} (expected {want}), losses {losses[0]:.5f} .. "
        f"{losses[-1]:.5f}, non-finite skips {skips:.0f}, step "
        f"{int(state.step)}")
    if launches != want:
        fail(f"training launches {launches}, expected {want}")
    if not all(map(math.isfinite, losses)) or skips:
        fail(f"training losses {losses}, non-finite skips {skips}")
    for k in ("packed_attention", "packed_attention_bwd"):
        by_key[k]["launches"] = launches[k]
    return dict(batch=TRAIN_B, steps=TRAIN_STEPS, remat_exempt=REMAT_EXEMPT,
                rematted_blocks=n_remat, seconds=secs, imgs_per_s=ips,
                ms_per_step=secs / TRAIN_STEPS * 1e3, peak_gib=peak_gb,
                launches=launches, losses=losses)


def grad_agreement(torch, attn, cfg, dev):
    """Phase 8: one global gradient at GRAD_B from each view, same
    weights and batch (f32 masters, bf16 compute, full remat)."""
    from uspace_tpu_torch.cli.train_lfm import build_train_model
    from uspace_tpu_torch.core import interpolant

    g = torch.Generator(device=dev).manual_seed(5)
    x1 = torch.randn((GRAD_B, 32, 32, 4), generator=g, device=dev) * 0.18
    t, xt, ut = interpolant.sample_path(x1, 1e-4, g)
    grads, launches = {}, {}
    ref_state = None
    for impl in ("xla", "pallas_packed", "auto"):
        model = build_train_model(cfg, dev, seed=2, attn_impl=impl,
                                  remat_exempt=0)
        if ref_state is None:
            ref_state = model.state_dict()
        model.load_state_dict(ref_state)
        attn.reset_launches()
        loss = interpolant.cfm_loss(model(xt, t)[0], ut).mean()
        gs = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        launches[impl] = dict(attn.LAUNCHES)
        grads[impl] = torch.cat([x.flatten() for x in gs])
        del model, gs, loss
    out = {}
    blocks = cfg["nnet"]["depth"] + 1
    zero = dict.fromkeys(attn.LAUNCHES, 0)
    want = {"pallas_packed": dict(zero, packed_attention=2 * blocks,
                                  packed_attention_bwd=blocks),
            "auto": dict(zero, qkvproj_attention=2 * blocks,
                         packed_attention_bwd=blocks)}
    for impl, ref in (("pallas_packed", "xla"), ("auto", "pallas_packed")):
        _, rel, cos = compare(torch, grads[impl], grads[ref])
        log(f"gradient {impl} vs {ref} at batch {GRAD_B}: cos {cos:.7f} "
            f"(min {GRAD_MIN_COS}) rel_l2 {rel:.3e} (max {GRAD_MAX_REL_L2}); "
            f"launches {launches[impl]}")
        if launches[impl] != want[impl]:
            fail(f"{impl} gradient launches {launches[impl]}, expected "
                 f"{want[impl]}")
        if not (cos >= GRAD_MIN_COS and rel <= GRAD_MAX_REL_L2):
            fail(f"{impl} gradient disagrees with {ref}")
        out[f"{impl}_vs_{ref}"] = dict(cos=cos, rel_l2=rel,
                                       launches=launches[impl])
    return out


def train_entry_point(torch, cfg, dev, config="uvit_large"):
    """Phases 9 and 21d: cli.train_lfm.run of ``config`` for 2 steps into a
    temporary workdir; its checkpoint's params load strictly into a fresh
    model."""
    from uspace_tpu_torch.cli import train_lfm
    from uspace_tpu_torch.train import checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = train_lfm.run(config=config, n_steps=2, batch=GRAD_B,
                            seed=3, workdir=tmp, remat_exempt=REMAT_EXEMPT,
                            log=log)
        secs = time.perf_counter() - t0
        losses = [h["loss"] for h in out["history"]]
        del out["state"], out["model"]
        sd = checkpoint.load(out["checkpoint"], map_location=dev)
        fresh = train_lfm.build_train_model(cfg, dev, seed=4)
        fresh.load_state_dict(sd["params"], strict=True)
        step = int(sd["step"])
        size_gb = os.path.getsize(out["checkpoint"]) / 2**30
    impl = train_lfm.train_attn_impl(train_lfm.get_config(config))
    log(f"train_lfm.run ({impl}): 2 steps at batch {GRAD_B} in {secs:.1f} s "
        f"(build and checkpoint included), losses {losses}, checkpoint step "
        f"{step} ({size_gb:.2f} GiB) reloaded with strict=True")
    if step != 2 or not all(map(math.isfinite, losses)):
        fail(f"train_lfm: step {step}, losses {losses}")
    return dict(seconds=secs, losses=losses, checkpoint_gib=size_gb)


def unet_field_check(torch, attn, mlpk, sample_lfm, dev, z):
    """Phase 10b: one evaluation at the JAX bench's UNet shape
    (bench.py:494-504: head channels 64, a seeded [B, 77, 768] context) in
    bf16 with `auto` (5 launches of kernel 7 at D=64) and `xla`, and in f32
    with `xla` as the reference both bf16 views are read against."""
    from uspace_tpu_torch.configs import get_config

    cfg = get_config("unet_large")
    cfg["nnet"]["num_head_channels"] = 64
    g = torch.Generator(device=dev).manual_seed(12)
    ctx = torch.randn((B, 77, 768), generator=g, device=dev)
    t = torch.full((B,), 0.5, device=dev)
    views = {"auto": None, "xla": None, "f32": None}
    state = None
    for name in views:
        c = dict(cfg, compute_dtype="float32") if name == "f32" else cfg
        m = sample_lfm.build_model(c, dev, seed=1,
                                   attn_impl="auto" if name == "auto"
                                   else "xla")
        if state is None:
            state = m.state_dict()
        m.load_state_dict(state)
        reset_launches(attn, mlpk)
        with torch.no_grad():
            views[name] = m(z, t, ctx)[0].float()
        torch.cuda.synchronize()
        if name == "auto":
            launches = all_launches(attn, mlpk)
        del m
    _, rel, cos = compare(torch, views["auto"], views["xla"])
    _, rel_k, _ = compare(torch, views["auto"], views["f32"])
    _, rel_p, _ = compare(torch, views["xla"], views["f32"])
    log(f"UNet bench shape (head channels 64, context [{B}, 77, 768]), one "
        f"evaluation: launches {launches}; auto vs xla cos {cos:.7f} (min "
        f"{UNET_FIELD_MIN_COS}) rel_l2 {rel:.3e} (max "
        f"{UNET_FIELD_MAX_REL_L2}); "
        f"against the f32 field: auto {rel_k:.3e}, xla {rel_p:.3e} (auto at "
        f"most {UNET_F32_RATIO} x xla)")
    if launches != expected(attn, mlpk, attention_fwd=UNET_KERNEL_CALLS):
        fail(f"UNet bench-shape launches {launches}")
    if not (cos >= UNET_FIELD_MIN_COS and rel <= UNET_FIELD_MAX_REL_L2):
        fail("the UNet bench-shape field disagrees with the plain path")
    if rel_k > UNET_F32_RATIO * rel_p:
        fail("the UNet kernel view is further from the f32 field than the "
             "plain view")
    return dict(launches=launches, cos=cos, rel_l2=rel, auto_vs_f32=rel_k,
                xla_vs_f32=rel_p)


def unet_path(torch, flow, attn, mlpk, sample_lfm, dev, by_key):
    """Phase 10: SD-UNet-large (unet_large: 256 channels x (1, 2, 4), head
    channels 32) in bf16 with seeded weights, its zero-initialised output
    convs drawn live (normal x 0.05) in every view alike, Euler-50 at batch
    50 through `core.flow.decode` with `auto`: 5 x 50 launches of kernel 7
    and of no other kernel; latents against the plain path (`xla`) from the
    same z, and a control, kernel 7's output replaced by zeros, that must
    fail the same limits; img/s and peak memory. Returns z and the
    latents."""
    from uspace_tpu_torch.configs import get_config

    held = torch.cuda.memory_allocated() / 2**30  # by the earlier phases
    cfg = get_config("unet_large")
    model = sample_lfm.build_model(cfg, dev, seed=0, attn_impl="auto")
    plain = sample_lfm.build_model(cfg, dev, seed=0, attn_impl="xla")
    plain.load_state_dict(model.state_dict())
    z = torch.randn((B, 32, 32, 4), generator=torch.Generator(
        device=dev).manual_seed(11), device=dev)
    with torch.no_grad():  # warm-up: cuDNN plans, allocator
        for m in (model, plain):
            m(z, torch.zeros(B, device=dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(attn, mlpk)
    lat, secs = decode_run(torch, flow, model, z, STEPS)
    launches = all_launches(attn, mlpk)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n = UNET_KERNEL_CALLS * STEPS
    log(f"UNet main path (auto): {secs:.3f} s, {B / secs:.3f} img/s, "
        f"launches {launches}, peak {peak_gb:.2f} GiB ({held:.2f} GiB of it "
        f"held by earlier phases)")
    if launches != expected(attn, mlpk, attention_fwd=n):
        fail(f"UNet main path launches {launches}, expected {n} of "
             f"attention_fwd and no other")
    by_key["attention_fwd"]["launches"] = launches["attention_fwd"]
    torch.cuda.reset_peak_memory_stats()
    lat_plain, secs_plain = decode_run(torch, flow, plain, z, STEPS)
    peak_plain = torch.cuda.max_memory_allocated() / 2**30
    max_abs, rel, cos = compare(torch, lat, lat_plain)
    real = attn.fused_attention
    attn.fused_attention = lambda q, k, v, scale=None: torch.zeros_like(q)
    try:
        lat_ctl, _ = decode_run(torch, flow, model, z, STEPS)
    finally:
        attn.fused_attention = real
    _, c_rel, c_cos = compare(torch, lat_ctl, lat_plain)
    caught = not (c_cos >= PATH_MIN_COS and c_rel <= PATH_MAX_REL_L2)
    log(f"UNet plain path (xla): {secs_plain:.3f} s, {B / secs_plain:.3f} "
        f"img/s, peak {peak_plain:.2f} GiB; latents cos {cos:.7f} (min "
        f"{PATH_MIN_COS}) rel_l2 {rel:.3e} (max {PATH_MAX_REL_L2}); control, "
        f"kernel 7 output zeroed: cos {c_cos:.7f} rel_l2 {c_rel:.3e}: "
        f"{'fails' if caught else 'PASSES'} the comparison")
    if tuple(lat.shape) != (B, 32, 32, 4) or not torch.isfinite(lat).all():
        fail(f"UNet latents {tuple(lat.shape)} or not finite")
    if not (cos >= PATH_MIN_COS and rel <= PATH_MAX_REL_L2):
        fail("the UNet main path disagrees with the plain path")
    if not caught:
        fail("the UNet path limits let a field without attention pass")
    del plain, model
    out = dict(steps=STEPS, batch=B, seconds=secs, imgs_per_s=B / secs,
               plain_seconds=secs_plain, plain_imgs_per_s=B / secs_plain,
               cos=cos, rel_l2=rel, max_abs=max_abs, launches=launches,
               peak_gib=peak_gb, plain_peak_gib=peak_plain,
               held_by_earlier_phases_gib=held,
               zero_attention_control=dict(cos=c_cos, rel_l2=c_rel))
    out["bench_shape"] = unet_field_check(torch, attn, mlpk, sample_lfm, dev,
                                          z)
    return z, lat, out


def vae_decode(torch, sample_lfm, dev, lat):
    """Phase 11: the f32 SD VAE (seeded weights, TF32 off) decodes phase
    10's latents to [B, 256, 256, 3]: time, peak memory, finite values; one
    image decoded on the card against the same on the CPU, and the same
    with TF32 on as a control the limits must refuse."""
    from uspace_tpu_torch.codecs import vae as vae_mod
    from uspace_tpu_torch.configs import get_config

    @contextlib.contextmanager
    def tf32_on():  # the control: the VAE's f32 convs and matmuls in TF32
        prev = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = prev

    cfg = get_config("unet_large")
    vae = sample_lfm.build_vae(cfg, dev, seed=0)
    with torch.no_grad():
        vae.decode(lat[:2])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        px = vae.decode(lat)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        cpu = sample_lfm.build_vae(cfg, "cpu", seed=0)
        cpu.load_state_dict(vae.state_dict())
        t0 = time.perf_counter()
        one = cpu.decode(lat[:1].cpu())
        cpu_secs = time.perf_counter() - t0
        real = vae_mod.f32_precision
        vae_mod.f32_precision = tf32_on
        try:
            px_tf32 = vae.decode(lat[:1]).cpu()
        finally:
            vae_mod.f32_precision = real
    _, rel, cos = compare(torch, px[:1].cpu(), one)
    _, t_rel, t_cos = compare(torch, px_tf32, one)
    finite = bool(torch.isfinite(px).all())
    log(f"VAE decode (f32, TF32 off) of {B} latents: {tuple(px.shape)} in "
        f"{secs:.3f} s ({B / secs:.2f} img/s), peak {peak_gb:.2f} GiB, "
        f"finite {finite}; one image, card vs CPU ({cpu_secs:.1f} s): cos "
        f"{cos:.8f} (min {VAE_MIN_COS}) rel_l2 {rel:.3e} (max "
        f"{VAE_MAX_REL_L2}); control, TF32 on: cos {t_cos:.8f} rel_l2 "
        f"{t_rel:.3e}")
    if tuple(px.shape) != (B, 256, 256, 3) or not finite:
        fail(f"VAE pixels {tuple(px.shape)}, finite {finite}")
    if not (cos >= VAE_MIN_COS and rel <= VAE_MAX_REL_L2):
        fail("the VAE decode on the card disagrees with the CPU")
    if t_cos >= VAE_MIN_COS and t_rel <= VAE_MAX_REL_L2:
        fail("the VAE limits let a TF32 decode pass")
    return dict(batch=B, seconds=secs, imgs_per_s=B / secs, peak_gib=peak_gb,
                card_vs_cpu=dict(cos=cos, rel_l2=rel),
                tf32_vs_cpu=dict(cos=t_cos, rel_l2=t_rel))


def unet_entry_point(torch, np, sample_lfm, quant=None):
    """Phases 12 and 15: cli.sample_lfm.run(config="unet_large",
    decode=True), in the bf16 view or with ``quant`` the int8 UNet and VAE
    views: two batches of latents and of uint8 pixels."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = sample_lfm.run(config="unet_large", n_samples=2 * B, batch=B,
                               steps=STEPS, seed=3, out=tmp, decode=True,
                               quant=quant)
        secs = time.perf_counter() - t0
        arrays = [np.load(p) for p in paths]
    got = [(a.shape, str(a.dtype)) for a in arrays]
    want = [((B, 32, 32, 4), "float32"), ((B, 256, 256, 3), "uint8")] * 2
    log(f"sample_lfm.run (unet_large, decode, quant={quant}): {got} in "
        f"{secs:.1f} s")
    if got != want or not all(np.isfinite(a).all() for a in arrays[::2]):
        fail(f"sample_lfm (unet_large, decode, quant={quant}) wrote {got}")
    return dict(seconds=secs, arrays=[list(s) for s, _ in got])


def unet_int8_path(torch, flow, attn, mlpk, quant, sample_lfm, dev, z,
                   lat_bf16, bf16_ips):
    """Phase 13: the int8 (convs-only, quant=True) UNet-large view, f32
    weights of phase 10's seed, Euler-50 at batch 50 from phase 10's z with
    `auto`: 250 launches of kernel 7 and no other kernel, no weight
    quantization in the timed solve, img/s against phase 10's bf16 view,
    latents against phase 10's bf16 kernel latents; then one evaluation at
    the JAX bench's shape (head channels 64, a seeded [50, 77, 768]
    context) against the bf16 view of the same weights. Returns the int8
    latents."""
    from uspace_tpu_torch.configs import get_config

    cfg = get_config("unet_large")
    model = sample_lfm.build_model(cfg, dev, seed=0, attn_impl="auto",
                                   quant=True)
    with torch.no_grad():  # warm-up: quantizes every weight once
        model(z, torch.zeros(B, device=dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(attn, mlpk)
    quant.reset_quantizations()
    lat, secs = decode_run(torch, flow, model, z, STEPS)
    launches = all_launches(attn, mlpk)
    n_quant = quant.QUANTIZATIONS["weights"]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    max_abs, rel, cos = compare(torch, lat, lat_bf16)
    min_cos, max_rel = UNET_QUANT_LIMITS
    log(f"UNet int8 view (quant=True, auto): {secs:.3f} s, {B / secs:.3f} "
        f"img/s (bf16 view {bf16_ips:.3f}), launches {launches}, weight "
        f"quantizations in the solve {n_quant}, peak {peak_gb:.2f} GiB; "
        f"latents vs the bf16 kernel view: cos {cos:.7f} (min {min_cos}) "
        f"rel_l2 {rel:.3e} (max {max_rel})")
    if launches != expected(attn, mlpk,
                            attention_fwd=UNET_KERNEL_CALLS * STEPS):
        fail(f"UNet int8 launches {launches}")
    if n_quant:
        fail(f"{n_quant} weight quantizations inside the UNet int8 solve")
    if tuple(lat.shape) != (B, 32, 32, 4) or not torch.isfinite(lat).all():
        fail(f"UNet int8 latents {tuple(lat.shape)} or not finite")
    if not (cos >= min_cos and rel <= max_rel):
        fail("the UNet int8 view disagrees with the bf16 view")
    del model
    bench = get_config("unet_large")
    bench["nnet"]["num_head_channels"] = 64
    g = torch.Generator(device=dev).manual_seed(12)
    ctx = torch.randn((B, 77, 768), generator=g, device=dev)
    t = torch.full((B,), 0.5, device=dev)
    q = sample_lfm.build_model(bench, dev, seed=1, attn_impl="auto",
                               quant=True)
    b = sample_lfm.build_model(bench, dev, seed=1, attn_impl="auto")
    b.load_state_dict(q.state_dict())
    with torch.no_grad():
        vq, vb = (m(z, t, ctx)[0].float() for m in (q, b))
    _, e_rel, e_cos = compare(torch, vq, vb)
    min_cos, max_rel = UNET_QUANT_EVAL_LIMITS
    log(f"UNet int8 view at the bench shape, one evaluation vs the bf16 "
        f"view: cos {e_cos:.7f} (min {min_cos}) rel_l2 {e_rel:.3e} (max "
        f"{max_rel})")
    if not (e_cos >= min_cos and e_rel <= max_rel):
        fail("the UNet int8 view's bench-shape evaluation disagrees with "
             "the bf16 view")
    del q, b
    return lat, dict(steps=STEPS, batch=B, seconds=secs, imgs_per_s=B / secs,
                     bf16_imgs_per_s=bf16_ips, cos=cos, rel_l2=rel,
                     max_abs=max_abs, launches=launches,
                     quantizations_in_solve=n_quant, peak_gib=peak_gb,
                     bench_shape=dict(cos=e_cos, rel_l2=e_rel))


def vae_int8_decode(torch, sample_lfm, dev, lat):
    """Phase 14: the SD VAE's int8 decode view (its decoder's 3x3 convs in
    W8A8) decodes phase 13's latents: time, peak memory, finite pixels, and
    rel-L2 against the f32 decode of the same latents."""
    from uspace_tpu_torch.configs import get_config

    cfg = get_config("unet_large")
    vq = sample_lfm.build_vae(cfg, dev, seed=0, quant=True)
    with torch.no_grad():
        vq.decode(lat[:2])  # quantizes every weight once
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        px = vq.decode(lat)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        del vq
        v = sample_lfm.build_vae(cfg, dev, seed=0)
        t0 = time.perf_counter()
        ref = v.decode(lat)
        torch.cuda.synchronize()
        f32_secs = time.perf_counter() - t0
    _, rel, cos = compare(torch, px, ref)
    finite = bool(torch.isfinite(px).all())
    log(f"VAE int8 decode of {B} latents: {tuple(px.shape)} in {secs:.3f} s "
        f"({B / secs:.2f} img/s; f32 {f32_secs:.3f} s), peak {peak_gb:.2f} "
        f"GiB, finite {finite}; vs the f32 decode: cos {cos:.7f} rel_l2 "
        f"{rel:.3e}")
    if tuple(px.shape) != (B, 256, 256, 3) or not finite:
        fail(f"VAE int8 pixels {tuple(px.shape)}, finite {finite}")
    return dict(batch=B, seconds=secs, imgs_per_s=B / secs,
                f32_seconds=f32_secs, peak_gib=peak_gb, cos=cos, rel_l2=rel)


def unet_train_path(torch, attn, mlpk, dev, by_key):
    """Phase 16: TRAIN_STEPS timed train steps of UNet-large at TRAIN_B
    after TRAIN_WARMUP, f32 masters, bf16 compute, its own `auto`, the
    reference init (zero output convs), phase 7's optimizer and EMA:
    img/s, peak memory, finite losses, no non-finite skip, and per step
    5 launches of kernel 8, 5 of kernel 7 (10 with remat) and no other."""
    from uspace_tpu_torch.cli.train_lfm import build_train_model
    from uspace_tpu_torch.configs import get_config
    from uspace_tpu_torch.data.datasets import SyntheticFeatures
    from uspace_tpu_torch.train.state import (
        TrainState,
        get_lr_schedule,
        get_optimizer,
    )
    from uspace_tpu_torch.train.step import make_train_step

    cfg = get_config("unet_large")
    cfg["nnet"]["use_checkpoint"] = UNET_TRAIN_REMAT
    model = build_train_model(cfg, dev, seed=0)
    lr = get_lr_schedule("customized", 2e-4, warmup_steps=100)
    tx = get_optimizer("adam", lr, betas=(0.99, 0.99), weight_decay=0.03)
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, tx, lr_schedule=lr, ema_rate=0.995,
                           latents_from_moments=True)
    n = TRAIN_WARMUP + TRAIN_STEPS
    data = SyntheticFeatures(num=n * TRAIN_B, shape=(32, 32, 8), seed=0)
    batches = [torch.from_numpy(data.batch(range(i * TRAIN_B,
                                                 (i + 1) * TRAIN_B))["x"]
                                ).to(dev) for i in range(n)]
    gen = torch.Generator(device=dev).manual_seed(1)
    metrics = [step(state, {"x": batches[i]}, gen)
               for i in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(attn, mlpk)
    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP, n):
        metrics.append(step(state, {"x": batches[i]}, gen))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = all_launches(attn, mlpk)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in metrics]
    skips = sum(float(m["nonfinite_skip"]) for m in metrics)
    fwd = UNET_KERNEL_CALLS * (2 if UNET_TRAIN_REMAT else 1)
    want = expected(attn, mlpk, attention_fwd=TRAIN_STEPS * fwd,
                    fused_attention_bwd=TRAIN_STEPS * UNET_KERNEL_CALLS)
    ips = TRAIN_B * TRAIN_STEPS / secs
    log(f"UNet train (auto, batch {TRAIN_B}, remat {UNET_TRAIN_REMAT}): "
        f"{TRAIN_STEPS} steps in {secs:.3f} s, {ips:.3f} img/s, peak "
        f"{peak_gb:.2f} GiB, launches {launches}, losses {losses[0]:.5f} .. "
        f"{losses[-1]:.5f}, non-finite skips {skips:.0f}, step "
        f"{int(state.step)}")
    if launches != want:
        fail(f"UNet training launches {launches}, expected {want}")
    if not all(map(math.isfinite, losses)) or skips:
        fail(f"UNet training losses {losses}, non-finite skips {skips}")
    by_key["fused_attention_bwd"]["launches"] = launches["fused_attention_bwd"]
    return dict(batch=TRAIN_B, steps=TRAIN_STEPS, remat=UNET_TRAIN_REMAT,
                seconds=secs, imgs_per_s=ips,
                ms_per_step=secs / TRAIN_STEPS * 1e3, peak_gib=peak_gb,
                launches=launches, losses=losses)


def unet_grad_agreement(torch, attn, mlpk, dev):
    """Phase 17: one UNet-large gradient at GRAD_B on one batch, f32
    masters, the zero-initialised output convs drawn live (with the
    reference's zeros every attention gradient is zero): the kernel path
    (bf16, auto: 5 launches each of kernels 7 and 8) against the plain
    path (bf16, xla) and both against the f32 field's (xla), globally and
    on the five L = 1024 self-attentions' q, k, v projections; a control
    with kernel 8's outputs zeroed must fail the limits."""
    from uspace_tpu_torch.cli.train_lfm import build_train_model
    from uspace_tpu_torch.configs import get_config
    from uspace_tpu_torch.core import interpolant
    from uspace_tpu_torch.models.unet import ZERO_INIT_STD, SpatialTransformer

    cfg = get_config("unet_large")
    g = torch.Generator(device=dev).manual_seed(5)
    x1 = torch.randn((GRAD_B, 32, 32, 4), generator=g, device=dev) * 0.18
    t, xt, ut = interpolant.sample_path(x1, 1e-4, g)
    grads, launches, state, proj = {}, {}, None, None
    zero_bwd = lambda q, k, v, do, scale=None: tuple(  # noqa: E731
        torch.zeros_like(q) for _ in range(3))
    for name in ("auto", "xla", "f32", "control"):
        c = dict(cfg, compute_dtype="float32") if name == "f32" else cfg
        model = build_train_model(c, dev, seed=2, attn_impl=(
            "xla" if name in ("xla", "f32") else "auto"))
        if state is None:
            model.init_weights(torch.Generator(device=dev).manual_seed(2),
                               zero_init_std=ZERO_INIT_STD)
            state = model.state_dict()
            proj = [f"{n}.transformer_blocks.0.attn1.to_{w}.weight"
                    for n, m in model.named_modules()
                    if isinstance(m, SpatialTransformer)
                    and m.proj_in.in_channels == cfg["nnet"]["model_channels"]
                    for w in "qkv"]
        model.load_state_dict(state)
        reset_launches(attn, mlpk)
        real = attn.fused_attention_bwd
        if name == "control":
            attn.fused_attention_bwd = zero_bwd
        try:
            loss = interpolant.cfm_loss(model(xt, t)[0], ut).mean()
            names, params = zip(*model.named_parameters())
            gs = dict(zip(names, torch.autograd.grad(loss, params)))
        finally:
            attn.fused_attention_bwd = real
        torch.cuda.synchronize()
        launches[name] = all_launches(attn, mlpk)
        grads[name] = (torch.cat([x.flatten() for x in gs.values()]),
                       torch.cat([gs[k].flatten() for k in proj]))
        del model, gs, loss, params
    out = dict(projections=len(proj), launches=launches["auto"])
    want = expected(attn, mlpk, attention_fwd=UNET_KERNEL_CALLS,
                    fused_attention_bwd=UNET_KERNEL_CALLS)
    if launches["auto"] != want:
        fail(f"UNet gradient launches {launches['auto']}, expected {want}")
    if len(proj) != 3 * UNET_KERNEL_CALLS:
        fail(f"{len(proj)} self-attention projections at L = 1024")

    def read(name):
        r = {}
        for i, part in enumerate(("global", "attention_projections")):
            _, rel, cos = compare(torch, grads[name][i], grads["xla"][i])
            _, rel_f, _ = compare(torch, grads[name][i], grads["f32"][i])
            _, rel_p, _ = compare(torch, grads["xla"][i], grads["f32"][i])
            r[part] = dict(cos=cos, rel_l2=rel, vs_f32=rel_f,
                           plain_vs_f32=rel_p,
                           ok=cos >= UNET_GRAD_MIN_COS
                           and rel <= UNET_GRAD_MAX_REL_L2
                           and rel_f <= UNET_F32_RATIO * rel_p)
        return r

    for name in ("auto", "control"):
        out[name] = read(name)
        for part, r in out[name].items():
            log(f"UNet gradient {name} vs xla at batch {GRAD_B}, {part}: cos "
                f"{r['cos']:.7f} (min {UNET_GRAD_MIN_COS}) rel_l2 "
                f"{r['rel_l2']:.3e} (max {UNET_GRAD_MAX_REL_L2}); vs the f32 "
                f"gradient {r['vs_f32']:.3e}, xla's {r['plain_vs_f32']:.3e} "
                f"(at most {UNET_F32_RATIO} x): "
                f"{'within' if r['ok'] else 'OUTSIDE'} the limits")
    if not all(r["ok"] for r in out["auto"].values()):
        fail("the UNet kernel path's gradient disagrees with the plain path")
    if all(r["ok"] for r in out["control"].values()):
        fail("the UNet gradient limits let a zeroed kernel 8 pass")
    return out


def unet_train_entry_point(torch, dev):
    """Phase 18: cli.train_lfm.run(config="unet_large") for 2 steps at the
    config's batch into a temporary workdir; its checkpoint's params load
    strictly into a fresh model."""
    from uspace_tpu_torch.cli import train_lfm
    from uspace_tpu_torch.configs import get_config
    from uspace_tpu_torch.train import checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = train_lfm.run(config="unet_large", n_steps=2, seed=3,
                            workdir=tmp, log=log)
        secs = time.perf_counter() - t0
        losses = [h["loss"] for h in out["history"]]
        del out["state"], out["model"]
        sd = checkpoint.load(out["checkpoint"], map_location=dev)
        fresh = train_lfm.build_train_model(get_config("unet_large"), dev,
                                            seed=4)
        fresh.load_state_dict(sd["params"], strict=True)
        step = int(sd["step"])
        size_gb = os.path.getsize(out["checkpoint"]) / 2**30
        del sd, fresh
    log(f"train_lfm.run (unet_large): 2 steps in {secs:.1f} s (build and "
        f"checkpoint included), losses {losses}, checkpoint step {step} "
        f"({size_gb:.2f} GiB) reloaded with strict=True")
    if step != 2 or not all(map(math.isfinite, losses)):
        fail(f"train_lfm (unet_large): step {step}, losses {losses}")
    return dict(seconds=secs, losses=losses, checkpoint_gib=size_gb)


def block_bf16_path(torch, flow, attn, mlpk, sample_lfm, cfg, dev, z,
                    lat_plain, by_key):
    """Phase 19: the bf16 view on `pallas_block` (the whole attention
    sub-block kernel, then the plain MLP after LN2), phase 4's weights (seed
    0) and z, Euler-50 at batch 50: exactly 21 x 50 launches of row 10 and
    of no other kernel, latents against phase 4's plain (`xla`) latents,
    img/s and peak memory. Returns the model."""
    model = sample_lfm.build_model(cfg, dev, seed=0, attn_impl="pallas_block")
    with torch.no_grad():
        model(z.to(torch.bfloat16), torch.zeros(B, device=dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(attn, mlpk)
    lat, secs = decode_run(torch, flow, model, z, STEPS)
    launches = all_launches(attn, mlpk)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n = (cfg["nnet"]["depth"] + 1) * STEPS
    max_abs, rel, cos = compare(torch, lat, lat_plain)
    log(f"pallas_block bf16: {secs:.3f} s, {B / secs:.3f} img/s, launches "
        f"{launches}, peak {peak_gb:.2f} GiB; latents vs phase 4's plain "
        f"path: cos {cos:.7f} (min {PATH_MIN_COS}) rel_l2 {rel:.3e} (max "
        f"{PATH_MAX_REL_L2})")
    if launches != expected(attn, mlpk, attention_block=n):
        fail(f"pallas_block bf16 launches {launches}, expected {n} of "
             f"attention_block and no other")
    if tuple(lat.shape) != (B, 32, 32, 4) or not torch.isfinite(lat).all():
        fail(f"pallas_block bf16 latents {tuple(lat.shape)} or not finite")
    if not (cos >= PATH_MIN_COS and rel <= PATH_MAX_REL_L2):
        fail("the pallas_block bf16 view disagrees with the plain path")
    by_key["attention_block"]["launches"] = launches["attention_block"]
    return model, dict(steps=STEPS, batch=B, seconds=secs,
                       imgs_per_s=B / secs, cos=cos, rel_l2=rel,
                       max_abs=max_abs, launches=launches, peak_gib=peak_gb)


def block_int8_path(torch, flow, attn, mlpk, quant, sample_lfm, cfg, dev, z,
                    lat_bf16, by_key):
    """Phase 20: the W8A8 view on `pallas_block` (the int8 attention
    sub-block kernel, then the int8 MLP sub-block kernel), phase 4b's f32
    weights and z, Euler-50 at batch 50: exactly 21 x 50 launches of rows 11
    and 15 and of no other kernel, no weight quantization in the timed
    solve, the JAX bench's quality gate against phase 4's bf16 kernel
    latents, img/s; one full-width evaluation block by block against the
    twins, with controls, and the whole field against the twins'
    composition."""
    model = sample_lfm.build_model(cfg, dev, seed=0, attn_impl="pallas_block",
                                   quant=True)
    with torch.no_grad():  # quantizes every weight once
        model(z, torch.zeros(B, device=dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(attn, mlpk)
    quant.reset_quantizations()
    lat, secs = decode_run(torch, flow, model, z, STEPS)
    launches = all_launches(attn, mlpk)
    n_quant = quant.QUANTIZATIONS["weights"]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n = (cfg["nnet"]["depth"] + 1) * STEPS
    want = expected(attn, mlpk, attention_block_int8=n, ln_mlp_int8=n)
    max_abs, rel, cos = compare(torch, lat, lat_bf16)
    log(f"pallas_block int8 (quant=True): {secs:.3f} s, {B / secs:.3f} "
        f"img/s, launches {launches}, weight quantizations in the solve "
        f"{n_quant}, peak {peak_gb:.2f} GiB; latents vs the bf16 kernel "
        f"view: cos {cos:.7f} (min {QUANT_MIN_COS}) rel_l2 {rel:.3e} (max "
        f"{QUANT_MAX_REL_L2})")
    if launches != want:
        fail(f"pallas_block int8 launches {launches}, expected {want}")
    if n_quant:
        fail(f"{n_quant} weight quantizations inside the timed solve")
    if tuple(lat.shape) != (B, 32, 32, 4) or not torch.isfinite(lat).all():
        fail(f"pallas_block int8 latents {tuple(lat.shape)} or not finite")
    if not (cos >= QUANT_MIN_COS and rel <= QUANT_MAX_REL_L2):
        fail("the pallas_block int8 view fails the quality gate")
    by_key["attention_block_int8"]["launches"] = \
        launches["attention_block_int8"]
    t_half = torch.full((B,), 0.5, device=dev)
    out = dict(steps=STEPS, batch=B, seconds=secs, imgs_per_s=B / secs,
               cos=cos, rel_l2=rel, max_abs=max_abs, launches=launches,
               quantizations_in_solve=n_quant, peak_gib=peak_gb,
               field_check=field_check(torch, model, z, t_half))
    del model
    return out


def block_views(torch, flow, attn, mlpk, sample_lfm, cfg, dev, z, ref_short):
    """Phase 21a: the w8 and w8a8_mlp views on `pallas_block` (row 10, then
    the w8 MLP, row 17, or the int8 MLP, row 14), f32 weights of phase 4's
    seed, SHORT_STEPS Euler steps from phase 4's z: exact launches, and the
    quantized views' limits against phase 5's plain latents."""
    per = (cfg["nnet"]["depth"] + 1) * SHORT_STEPS
    out = {}
    for q, counts in (("w8", dict(attention_block=per, mlp_w8=per)),
                      ("w8a8_mlp", dict(attention_block=per, mlp_int8=per))):
        view = sample_lfm.build_model(cfg, dev, seed=0,
                                      attn_impl="pallas_block", quant=q)
        reset_launches(attn, mlpk)
        lat, secs = decode_run(torch, flow, view, z, SHORT_STEPS)
        got = all_launches(attn, mlpk)
        _, rel, cos = compare(torch, lat, ref_short)
        log(f"pallas_block {q}: {SHORT_STEPS} Euler steps in {secs:.3f} s, "
            f"launches {got} (expected {counts}), cos {cos:.7f} rel_l2 "
            f"{rel:.3e} against the plain path")
        if got != expected(attn, mlpk, **counts):
            fail(f"pallas_block {q}: launches {got}, expected {counts}")
        if not (cos >= QUANT_MIN_COS and rel <= QUANT_MAX_REL_L2):
            fail(f"pallas_block {q} disagrees with the plain path")
        out[q] = dict(steps=SHORT_STEPS, seconds=secs, cos=cos, rel_l2=rel,
                      launches=counts)
        del view
    return out


def block_grad_agreement(torch, attn, mlpk, cfg, dev):
    """Phase 21c: the global gradient at GRAD_B on one batch (f32 masters,
    bf16 compute, full remat), `pallas_block` against `xla`: row 10 runs
    once per block forward and once more in each remat recompute; its
    backward is the plain recompute VJP, no kernel."""
    from uspace_tpu_torch.cli.train_lfm import build_train_model
    from uspace_tpu_torch.core import interpolant

    g = torch.Generator(device=dev).manual_seed(5)
    x1 = torch.randn((GRAD_B, 32, 32, 4), generator=g, device=dev) * 0.18
    t, xt, ut = interpolant.sample_path(x1, 1e-4, g)
    grads, launches, state = {}, {}, None
    for impl in ("xla", "pallas_block"):
        model = build_train_model(cfg, dev, seed=2, attn_impl=impl,
                                  remat_exempt=0)
        if state is None:
            state = model.state_dict()
        model.load_state_dict(state)
        reset_launches(attn, mlpk)
        loss = interpolant.cfm_loss(model(xt, t)[0], ut).mean()
        gs = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        launches[impl] = all_launches(attn, mlpk)
        grads[impl] = torch.cat([x.flatten() for x in gs])
        del model, gs, loss
    blocks = cfg["nnet"]["depth"] + 1
    want = expected(attn, mlpk, attention_block=2 * blocks)
    _, rel, cos = compare(torch, grads["pallas_block"], grads["xla"])
    log(f"gradient pallas_block vs xla at batch {GRAD_B}: cos {cos:.7f} "
        f"(min {GRAD_MIN_COS}) rel_l2 {rel:.3e} (max {GRAD_MAX_REL_L2}); "
        f"launches {launches['pallas_block']}")
    if launches["pallas_block"] != want:
        fail(f"pallas_block gradient launches {launches['pallas_block']}, "
             f"expected {want}")
    if not (cos >= GRAD_MIN_COS and rel <= GRAD_MAX_REL_L2):
        fail("the pallas_block gradient disagrees with xla")
    return dict(cos=cos, rel_l2=rel, launches=launches["pallas_block"])


def mlp_bf16_fields(torch, attn, mlpk, sample_lfm, cfg, model, z):
    """Phase 21b: rows 12 and 13 inside the bf16 field at full width (no
    model route runs them, as in the JAX package): one evaluation of phase
    19's model at batch 50 with each block's MLP half as row 13
    (`fused_mlp_block_q(quant=False)`) and one with it as x + row 12 on
    LN2(x), each against the model's own evaluation (the plain MLP, whose
    bf16 roundings sit elsewhere): 21 launches of the kernel and of no
    other but row 10, the one-evaluation routing limits, and at most
    UNET_F32_RATIO times the model's own distance to the f32 field (one
    bf16 evaluation of a random-weight field differs from another about as
    much as either from f32, §6 PR 5 of PERF.md)."""
    t = torch.full((B,), 0.5, device=z.device)
    f32 = sample_lfm.build_model(dict(cfg, compute_dtype="float32"),
                                 z.device, seed=0, attn_impl="xla")
    f32.load_state_dict(model.state_dict())
    with torch.no_grad():
        ref32 = f32(z, t)[0].float()
    del f32

    def with_mlp(mlp_half):
        def block(blk, zin, skip):
            if blk.skip_linear is not None:
                zin = blk.skip_linear(torch.cat([zin, skip], dim=-1))
            a, n1 = blk.attn, blk.norm1
            y = attn.fused_attention_block(
                zin, n1.weight, n1.bias, a.qkv.weight.t(), a.proj.weight.t(),
                a.proj.bias, a.num_heads, scale=a.scale, eps=n1.eps)
            return mlp_half(blk, y)
        return block

    def row13(blk, y):
        m = blk.mlp
        return mlpk.fused_mlp_block_q(
            y, blk.norm2.weight, blk.norm2.bias, m.fc1.weight.t(), m.fc1.bias,
            m.fc2.weight.t(), m.fc2.bias, eps=blk.norm2.eps, quant=False)

    def row12(blk, y):
        m = blk.mlp
        return y + mlpk.fused_mlp(blk.norm2(y), m.fc1.weight.t(), m.fc1.bias,
                                  m.fc2.weight.t(), m.fc2.bias)

    with torch.no_grad():
        ref, _ = model(z, t)
    _, rel_p, _ = compare(torch, ref.float(), ref32)
    blocks = len(model.in_blocks) + 1 + len(model.out_blocks)
    out = {}
    for name, half in (("ln_mlp_bf16", row13), ("mlp_bf16", row12)):
        reset_launches(attn, mlpk)
        with torch.no_grad():
            v = composed_field(torch, model, z, t, with_mlp(half))
        torch.cuda.synchronize()
        got = all_launches(attn, mlpk)
        max_abs, rel, cos = compare(torch, v.float(), ref.float())
        _, rel_k, _ = compare(torch, v.float(), ref32)
        log(f"bf16 field with each MLP half on {name}: launches {got}; vs "
            f"the model's own (plain MLP): cos {cos:.7f} (min "
            f"{FIELD_MIN_COS}) rel_l2 {rel:.3e} (max {FIELD_MAX_REL_L2}); "
            f"against the f32 field {rel_k:.3e}, the model's own "
            f"{rel_p:.3e} (at most {UNET_F32_RATIO} x)")
        if got != expected(attn, mlpk, attention_block=blocks,
                           **{name: blocks}):
            fail(f"the {name} field: launches {got}")
        if not (cos >= FIELD_MIN_COS and rel <= FIELD_MAX_REL_L2):
            fail(f"the bf16 field on {name} disagrees with the model's")
        if rel_k > UNET_F32_RATIO * rel_p:
            fail(f"the bf16 field on {name} is further from the f32 field "
                 f"than the model's own")
        out[name] = dict(cos=cos, rel_l2=rel, max_abs=max_abs, vs_f32=rel_k,
                         model_vs_f32=rel_p, launches=got[name])
    return out


def block_entry_points(torch, np, sample_lfm, cfg, dev):
    """Phase 21d: cli.sample_lfm.run(config="uvit_large",
    attn_impl="pallas_block") for one batch in the bf16 view and one with
    quant=True, then cli.train_lfm.run for 2 steps of a config whose
    nnet.attn_impl is "pallas_block" (its checkpoint reloaded strictly)."""
    out = {}
    for q in (None, True):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            paths = sample_lfm.run(config="uvit_large", n_samples=B, batch=B,
                                   steps=STEPS, seed=3, out=tmp, quant=q,
                                   attn_impl="pallas_block")
            secs = time.perf_counter() - t0
            a = np.load(paths[0])
        log(f"sample_lfm.run (pallas_block, quant={q}): {a.shape} in "
            f"{secs:.1f} s")
        if len(paths) != 1 or a.shape != (B, 32, 32, 4) or not \
                np.isfinite(a).all():
            fail(f"sample_lfm (pallas_block, quant={q}) wrote {a.shape}")
        out["sample_lfm" + ("_int8" if q else "") + "_seconds"] = secs
    block_cfg = dict(cfg, nnet=dict(cfg["nnet"], attn_impl="pallas_block"))
    out["train_lfm"] = train_entry_point(torch, cfg, dev, config=block_cfg)
    return out


def stage_delta_path(torch, flow, attn, mlpk, quant, sample_lfm, cfg, dev, z,
                     lat_bf16, adaptive, by_key, hidden_mode="grad"):
    """Phase 22 (``hidden_mode`` "grad") and phase 23 ("exact", "gelu"): the
    base-anchored stage-delta int8 field of phase 4's weights (seed 0), its
    int8 codes fitted once by prepare_delta_params outside the solve: a
    delta evaluation at the base's own point equal to the base bit for bit
    ("gelu": within STAGE_GELU_ZERO_REL); a delta at (0.32, z + 0.02 n)
    within STAGE_TRACK_REL of a base evaluation there; phase 23 also one
    fused base evaluation against the unfused one (STAGE_FUSED_REL); dopri5
    at rtol = atol = 1e-5 (I controller, safety 0.9) at batch 50 through
    core.flow.decode with solver_kwargs["stage_delta"], a warm solve and a
    timed one: t = 1, exactly 21 x (steps + 2) launches each of row 18 and
    the mode's base MLP kernel and 21 x 5 x steps each of row 19 and its
    delta MLP kernel, and none of any other kernel, 0 weight quantizations
    in the solve, NFE at most STAGE_NFE_RATIO x phase 4c's bf16 NFE and
    latents within STAGE_LIMITS of its latents; then
    cli.sample_lfm.run(field="stage_delta_int8", hidden_mode=...) for one
    batch and cli.profile_field's base and delta evaluation profiles."""
    import numpy as np

    from uspace_tpu_torch.cli import profile_field
    from uspace_tpu_torch.core import delta_field

    blocks = cfg["nnet"]["depth"] + 1
    base_mlp, delta_mlp = STAGE_MLP[hidden_mode]
    what = f"stage delta ({hidden_mode})"
    out = {}
    model = sample_lfm.build_model(cfg, dev, seed=0, attn_impl="auto")
    quant.reset_quantizations()
    t0 = time.perf_counter()
    dp = delta_field.prepare_delta_params(model)
    torch.cuda.synchronize()
    out["prepare_seconds"] = time.perf_counter() - t0
    out["prepare_quantizations"] = quant.QUANTIZATIONS["weights"]
    vf_base, vf_delta = delta_field.make_delta_field(
        model, dp, hidden_mode=hidden_mode)
    g = torch.Generator(device=dev).manual_seed(22)
    with torch.no_grad():
        f0, cache = vf_base(torch.tensor(0.3), z)
        fd = vf_delta(torch.tensor(0.3), z, cache)
        exact = bool(torch.equal(f0, fd))
        _, rel0, _ = compare(torch, fd, f0)
        z1 = z + 0.02 * torch.randn(z.shape, generator=g, device=dev)
        f1 = vf_delta(torch.tensor(0.32), z1, cache)
        f1_full, _ = vf_base(torch.tensor(0.32), z1)
        _, rel_track, _ = compare(torch, f1, f1_full)
        del cache
        rel_fused = None
        if hidden_mode != "grad":
            fu, _ = delta_field.anchored_vf_base(
                model, dp, torch.tensor(0.3), z, fused=False,
                hidden_mode=hidden_mode)
            _, rel_fused, _ = compare(torch, f0, fu)
            del fu
    log(f"{what}: {out['prepare_quantizations']} weight quantizations "
        f"in prepare_delta_params ({out['prepare_seconds']:.2f} s); zero "
        f"delta equal to the base bit for bit: {exact} (rel-L2 {rel0:.1e}"
        f"{f', max {STAGE_GELU_ZERO_REL}' if hidden_mode == 'gelu' else ''}"
        f"); a delta at (0.32, z + 0.02 n) vs a base there: rel-L2 "
        f"{rel_track:.3e} (max {STAGE_TRACK_REL})"
        + ("" if rel_fused is None else f"; fused vs unfused base: rel-L2 "
           f"{rel_fused:.3e} (max {STAGE_FUSED_REL})"))
    if hidden_mode == "gelu":
        if not rel0 < STAGE_GELU_ZERO_REL:
            fail(f"the {what} zero-distance evaluation is not near the base")
    elif not exact:
        fail(f"the {what} zero-distance evaluation is not the base's")
    if not rel_track < STAGE_TRACK_REL:
        fail(f"the {what} evaluation does not track the base")
    if rel_fused is not None and not rel_fused < STAGE_FUSED_REL:
        fail(f"the {what} fused base disagrees with the unfused one")
    out.update(zero_delta_exact=exact, zero_delta_rel_l2=rel0,
               tracking_rel_l2=rel_track, fused_vs_unfused_rel_l2=rel_fused)

    sk = dict(ADAPTIVE_SK, stage_delta=(vf_base, vf_delta))

    def solve():
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            lat = flow.decode(None, z, sk, stats=stats)
        torch.cuda.synchronize()
        return lat, time.perf_counter() - t0, stats

    solve()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(attn, mlpk)
    quant.reset_quantizations()
    lat, secs, st = solve()
    launches = all_launches(attn, mlpk)
    n_quant = quant.QUANTIZATIONS["weights"]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    steps = st["steps"]
    want = expected(attn, mlpk, **{"base_attn_cache": blocks * (steps + 2),
                                   base_mlp: blocks * (steps + 2),
                                   "delta_attn": blocks * 5 * steps,
                                   delta_mlp: blocks * 5 * steps})
    nfe_bf16 = adaptive["bf16"]["nfe"]
    ratio = st["nfe"] / nfe_bf16
    log(f"{what} dopri5 rtol=atol=1e-5 (I controller, safety 0.9): NFE "
        f"{st['nfe']}, steps {steps}, accepted {st['accepted']}, t "
        f"{st['t']}, {secs:.3f} s, {B / secs:.3f} img/s, "
        f"{secs / st['nfe'] * 1e3:.2f} ms per evaluation, peak "
        f"{peak_gb:.2f} GiB, launches {launches}, weight quantizations "
        f"{n_quant}; NFE / bf16 NFE ({nfe_bf16}) = {ratio:.3f} (max "
        f"{STAGE_NFE_RATIO}); phase 4c's W8A8 control: NFE "
        f"{adaptive['w8a8_control']['nfe']}"
        f"{' (it hit its cap)' if adaptive['w8a8_control']['hit_cap'] else ''}")
    if st["t"] != 1.0 or steps >= MAX_STEPS:
        fail(f"the {what} solve stopped at t={st['t']} after {steps} steps")
    if launches != want:
        fail(f"{what} launches {launches}, expected {want}")
    if n_quant:
        fail(f"{n_quant} weight quantizations inside the {what} solve")
    if tuple(lat.shape) != (B, 32, 32, 4) or not torch.isfinite(lat).all():
        fail(f"{what} latents {tuple(lat.shape)} or not finite")
    if ratio > STAGE_NFE_RATIO:
        fail(f"the {what} solve's NFE exceeds the bound")
    out.update(nfe=st["nfe"], steps=steps, accepted=st["accepted"],
               rejections=steps - st["accepted"], t=st["t"], seconds=secs,
               imgs_per_s=B / secs, ms_per_eval=secs / st["nfe"] * 1e3,
               peak_gib=peak_gb, launches=launches,
               quantizations_in_solve=n_quant, nfe_ratio=ratio,
               bf16_nfe=nfe_bf16,
               w8a8_control_nfe=adaptive["w8a8_control"]["nfe"])
    out["vs_bf16"] = adaptive_agree(
        torch, f"{what} dopri5 vs bf16 dopri5", lat, lat_bf16, STAGE_LIMITS)
    for k in ("base_attn_cache", base_mlp, "delta_attn", delta_mlp):
        by_key[k]["launches"] = max(by_key[k]["launches"], launches[k])
    del model, dp, vf_base, vf_delta, sk, lat

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        st_cli = []
        paths = sample_lfm.run(config="uvit_large", n_samples=B, batch=B,
                               seed=3, out=tmp, solver="adaptive",
                               field="stage_delta_int8",
                               hidden_mode=hidden_mode, stats=st_cli)
        secs_cli = time.perf_counter() - t0
        a = np.load(paths[0])
    log(f"sample_lfm.run (field=stage_delta_int8, hidden_mode={hidden_mode}, "
        f"solver=adaptive): {a.shape} in {secs_cli:.1f} s, {st_cli}")
    if len(paths) != 1 or a.shape != (B, 32, 32, 4) or not \
            np.isfinite(a).all() or st_cli[0]["t"] != 1.0:
        fail(f"sample_lfm ({what}) wrote {a.shape}, {st_cli}")
    out["sample_lfm"] = dict(seconds=secs_cli, **st_cli[0])
    rep = profile_field.profile("uvit_large", batch=B,
                                field="stage_delta_int8",
                                hidden_mode=hidden_mode)
    out["profile"] = {}
    for part, p in rep["parts"].items():
        log(f"profile_field --field stage_delta_int8 --hidden_mode "
            f"{hidden_mode}, {part} evaluation: wall "
            f"{p['wall_ms_per_eval']:.2f} ms, device "
            f"{p['device_ms_per_eval']:.2f} ms, idle {p['idle_share']:.3f}; "
            + ", ".join(f"{k} {v:.3f}" for k, v in p["groups_ms"].items()))
        out["profile"][part] = {k: p[k] for k in (
            "wall_ms_per_eval", "device_ms_per_eval", "idle_share",
            "groups_ms")}
    return out


def unet512_path(torch, np, flow, attn, mlpk, sample_lfm, dev, by_key):
    """Phase 24: SD-UNet-large at SD 1.x's 512 x 512 (unet_large_512: 64 x
    64 latents) in bf16 with seeded weights (output convs drawn live),
    Euler-50 at batch 50 through `core.flow.decode` on `auto`: 5 x 50
    launches of row 9 (L = 4096) and of row 7 (L = 1024) and of no other
    kernel, img/s, peak memory; at batch UNET512_CMP_B from the same z,
    `auto` against `xla` (whose [B, 8, 4096, 4096] f32 scores do not fit at
    batch 50) within the path limits, and a control with row 9's output
    zeroed that must fail them; `sample_lfm.run(config="unet_large_512",
    decode=True)` to finite 512-pixel images."""
    from uspace_tpu_torch.configs import get_config

    cfg = get_config("unet_large_512")
    c, h, w = cfg["z_shape"]
    model = sample_lfm.build_model(cfg, dev, seed=0, attn_impl="auto")
    z = torch.randn((B, h, w, c), generator=torch.Generator(
        device=dev).manual_seed(13), device=dev)
    with torch.no_grad():  # warm-up: cuDNN plans, allocator
        model(z, torch.zeros(B, device=dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(attn, mlpk)
    lat, secs = decode_run(torch, flow, model, z, STEPS)
    launches = all_launches(attn, mlpk)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n = UNET_KERNEL_CALLS * STEPS
    log(f"UNet 512 px (auto, {h} x {w} latents): {secs:.3f} s, "
        f"{B / secs:.3f} img/s, launches {launches}, peak {peak_gb:.2f} GiB")
    if launches != expected(attn, mlpk, flash=n, attention_fwd=n):
        fail(f"UNet 512 px launches {launches}, expected {n} of flash and "
             f"of attention_fwd and no other")
    by_key["flash"]["launches"] = launches["flash"]
    if tuple(lat.shape) != (B, h, w, c) or not torch.isfinite(lat).all():
        fail(f"UNet 512 px latents {tuple(lat.shape)} or not finite")

    plain = sample_lfm.build_model(cfg, dev, seed=0, attn_impl="xla")
    plain.load_state_dict(model.state_dict())
    zs = z[:UNET512_CMP_B]
    lat_k, secs_k = decode_run(torch, flow, model, zs, STEPS)
    torch.cuda.reset_peak_memory_stats()
    lat_p, secs_p = decode_run(torch, flow, plain, zs, STEPS)
    peak_plain = torch.cuda.max_memory_allocated() / 2**30
    max_abs, rel, cos = compare(torch, lat_k, lat_p)
    real = attn.flash_attention_blocked
    attn.flash_attention_blocked = lambda q, k, v, scale=None: \
        torch.zeros_like(q)
    try:
        lat_ctl, _ = decode_run(torch, flow, model, zs, STEPS)
    finally:
        attn.flash_attention_blocked = real
    _, c_rel, c_cos = compare(torch, lat_ctl, lat_p)
    caught = not (c_cos >= PATH_MIN_COS and c_rel <= PATH_MAX_REL_L2)
    log(f"UNet 512 px at batch {UNET512_CMP_B}: auto {secs_k:.3f} s, xla "
        f"{secs_p:.3f} s (peak {peak_plain:.2f} GiB); latents cos {cos:.7f} "
        f"(min {PATH_MIN_COS}) rel_l2 {rel:.3e} (max {PATH_MAX_REL_L2}); "
        f"control, row 9 output zeroed: cos {c_cos:.7f} rel_l2 {c_rel:.3e}: "
        f"{'fails' if caught else 'PASSES'} the comparison")
    if not (cos >= PATH_MIN_COS and rel <= PATH_MAX_REL_L2):
        fail("the 512-px UNet disagrees with the plain path")
    if not caught:
        fail("the 512-px UNet limits let a field without row 9 pass")
    del model, plain

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = sample_lfm.run(config="unet_large_512",
                               n_samples=UNET512_CLI_N, batch=UNET512_CLI_N,
                               steps=STEPS, seed=3, out=tmp, decode=True)
        secs_cli = time.perf_counter() - t0
        arrays = [np.load(p) for p in paths]
    got = [(a.shape, str(a.dtype)) for a in arrays]
    want = [((UNET512_CLI_N, h, w, c), "float32"),
            ((UNET512_CLI_N, 8 * h, 8 * w, 3), "uint8")]
    log(f"sample_lfm.run (unet_large_512, decode): {got} in {secs_cli:.1f} s")
    if got != want or not np.isfinite(arrays[0]).all():
        fail(f"sample_lfm (unet_large_512, decode) wrote {got}")
    return dict(steps=STEPS, batch=B, seconds=secs, imgs_per_s=B / secs,
                launches=launches, peak_gib=peak_gb,
                compare_batch=UNET512_CMP_B, auto_seconds=secs_k,
                plain_seconds=secs_p, plain_peak_gib=peak_plain, cos=cos,
                rel_l2=rel, max_abs=max_abs,
                zero_row9_control=dict(cos=c_cos, rel_l2=c_rel),
                sample_lfm_seconds=secs_cli)


def _rms(torch, t):
    return float(t.double().pow(2).mean().sqrt())


def editing_path(torch, np, attn, mlpk, sample_lfm, dev, config):
    """Phase 25 on one model: `dissect_lfm.run`'s read (EDIT_READ_N
    `SyntheticAttrFeatures` samples at the model's latent shape, the mid
    tap captured over the config's Euler-50 inversion), build_attr and
    build_pca (npz only), then through the `DissectSession` itself (no PNG
    on the card) the write sweep of attribute 0 at scales (-s, 0, +s) on
    EDIT_WRITE_N samples and the encode -> decode roundtrip. Holds: exact
    launches per evaluated batch in the read and the sweep; the scale-0 row
    equal bit for bit to a plain decode of the same z; the read features of
    `auto` and of `xla` on 2 samples, each against the f32 field's, the
    kernel route within UNET_F32_RATIO of the plain route's distance and
    both within UNET_FIELD limits of each other; the edit moving the
    latents by more than EDIT_MIN_NOISE times the routes' own difference
    (a plain decode of the same z on `xla`), with (x+ - x0) and (x0 - x-)
    at cosine EDIT_MIN_COS or more. s takes the direction to
    EDIT_REL[config] of the tap's rms. The roundtrip errors are
    readings."""
    from uspace_tpu_torch.cli import dissect_common, dissect_lfm
    from uspace_tpu_torch.configs import get_config
    from uspace_tpu_torch.data.datasets import batches, get_dataset
    from uspace_tpu_torch.editing.directions import (orthogonality_error,
                                                     select_direction)
    from uspace_tpu_torch.editing.drivers import DissectSession
    from uspace_tpu_torch.train.step import sample_from_moments

    cfg = get_config(config)
    d = cfg["dissection"]
    steps = round(1.0 / d["solver_kwargs"]["solver_fix_step"])
    if cfg["nnet"]["name"] == "unet_t2i":
        per_eval = dict(flash=UNET_KERNEL_CALLS,
                        attention_fwd=UNET_KERNEL_CALLS)
    else:
        per_eval = dict(qkvproj_attention=cfg["nnet"]["depth"] + 1)
    per_batch = {k: v * steps for k, v in per_eval.items()}
    c, h, w = cfg["z_shape"]
    out = dict(config=config, steps=steps)
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(workdir=tmp, read_path_root=tmp, n_samples=EDIT_READ_N,
                  mini_batch_size=EDIT_READ_N, pca_n=EDIT_PCA_N, device=dev)
        reset_launches(attn, mlpk)
        t0 = time.perf_counter()
        read_path = dissect_lfm.run(cfg, "read", **kw)
        torch.cuda.synchronize()
        out["read_seconds"] = time.perf_counter() - t0
        out["read_launches"] = got = all_launches(attn, mlpk)
        if got != expected(attn, mlpk, **per_batch):
            fail(f"{config} read launches {got}, expected {per_batch}")
        t0 = time.perf_counter()
        paths = {m: dissect_lfm.run(cfg, f"build_{m}", **kw)
                 for m in ("attr", "pca")}
        out["build_seconds"] = time.perf_counter() - t0
        with np.load(read_path) as r:
            read = {k: r[k] for k in r.files}
        dirs = {}
        for m, p in paths.items():
            with np.load(p) as f:
                dirs[m] = f["directions"]
    feats, t_grid = read["feats"], read["t_grid"]
    tap = feats.shape[2:]
    shapes_ok = (feats.shape[:2] == (EDIT_READ_N, steps)
                 and read["latent"].shape == (EDIT_READ_N, h, w, c)
                 and dirs["attr"].shape[:2] == (steps, 4)
                 and dirs["pca"].shape[:2] == (steps, EDIT_PCA_N)
                 and dirs["attr"].shape[2:] == tap
                 and all(np.isfinite(a).all() for a in
                         (feats, read["latent"], *dirs.values())))
    ortho = orthogonality_error(torch.as_tensor(dirs["pca"][steps // 2]))
    log(f"{config} dissect read: {EDIT_READ_N} samples, feats "
        f"{feats.shape}, {out['read_seconds']:.1f} s, launches "
        f"{out['read_launches']}; build_attr {dirs['attr'].shape}, build_pca "
        f"{dirs['pca'].shape} in {out['build_seconds']:.1f} s, PCA "
        f"orthogonality error {ortho:.2e}")
    if not shapes_ok:
        fail(f"{config} dissect artifacts have the wrong shapes or are not "
             f"finite")
    out["pca_orthogonality_error"] = ortho

    # the same weights on the plain route (bf16) and in f32 (plain route)
    session, _ = dissect_common.build_session(cfg, dev)
    views = {"xla": sample_lfm.build_model(cfg, dev, seed=0,
                                           attn_impl="xla"),
             "f32": sample_lfm.build_model(dict(cfg, compute_dtype="float32"),
                                           dev, seed=0, attn_impl="xla")}
    for m in views.values():
        m.load_state_dict(session.model.state_dict())
    others = {k: DissectSession(m, solver_kwargs=d["solver_kwargs"])
              for k, m in views.items()}
    data = get_dataset(**cfg["dataset"]).get_split("train")
    two = next(batches(data, 2))
    f = {k: torch.as_tensor(s_.read([two], generator=torch.Generator(
        device=dev).manual_seed(5))["feats"])
        for k, s_ in (("auto", session), *others.items())}
    _, f_rel, f_cos = compare(torch, f["auto"], f["xla"])
    _, rel_k, _ = compare(torch, f["auto"], f["f32"])
    _, rel_p, _ = compare(torch, f["xla"], f["f32"])
    del f
    log(f"{config} read features on 2 samples: auto vs xla cos {f_cos:.7f} "
        f"(min {UNET_FIELD_MIN_COS}) rel_l2 {f_rel:.3e} (max "
        f"{UNET_FIELD_MAX_REL_L2}); against the f32 field's: auto "
        f"{rel_k:.3e}, xla {rel_p:.3e} (auto at most {UNET_F32_RATIO} x "
        f"xla)")
    if not (f_cos >= UNET_FIELD_MIN_COS and f_rel <= UNET_FIELD_MAX_REL_L2):
        fail(f"{config}: the read features disagree with the plain path")
    if rel_k > UNET_F32_RATIO * rel_p:
        fail(f"{config}: the kernel route's read features are further from "
             f"the f32 field's than the plain route's")

    grid = select_direction(torch.as_tensor(dirs["attr"]), 0)
    rel_s = EDIT_REL[config]
    scale = rel_s * _rms(torch, torch.as_tensor(feats)) / _rms(torch, grid)
    z = torch.randn((EDIT_WRITE_N, h, w, c), generator=torch.Generator(
        device=dev).manual_seed(17), device=dev)
    reset_launches(attn, mlpk)
    t0 = time.perf_counter()
    sweep = session.write_sweep(grid, (-scale, 0.0, scale), EDIT_WRITE_N,
                                grid_dt=float(t_grid[1] - t_grid[0]),
                                grid_t0=float(t_grid[0]), fixed_z=z)
    torch.cuda.synchronize()
    secs_w = time.perf_counter() - t0
    got = all_launches(attn, mlpk)
    want = {k: 3 * v for k, v in per_batch.items()}
    x0 = session.decode(z)
    exact = bool(torch.equal(sweep[1], x0))
    noise = float((others["xla"].decode(z) - x0).norm() / x0.norm())
    del views, others
    x_m, x_0, x_p = sweep
    move = float((x_p - x_0).norm() / x_0.norm())
    move_m = float((x_0 - x_m).norm() / x_0.norm())
    a, b = (x_p - x_0).double().flatten(), (x_0 - x_m).double().flatten()
    same_way = float((a @ b) / (a.norm() * b.norm()))
    log(f"{config} write sweep of attribute 0 at scales (-s, 0, s), s = "
        f"{scale:.4g} ({rel_s} of the tap's rms), {EDIT_WRITE_N} samples: "
        f"{secs_w:.1f} s, launches {got}; scale 0 equals a plain decode bit "
        f"for bit: {exact}; moves |x+ - x0| {move:.3e}, |x0 - x-| "
        f"{move_m:.3e} of |x0|, the routes' difference {noise:.3e} (moves at "
        f"least {EDIT_MIN_NOISE} x it); cos(x+ - x0, x0 - x-) {same_way:.5f} "
        f"(min {EDIT_MIN_COS})")
    if got != expected(attn, mlpk, **want):
        fail(f"{config} write sweep launches {got}, expected {want}")
    if not exact:
        fail(f"{config}: the scale-0 write differs from a plain decode")
    if not (min(move, move_m) > EDIT_MIN_NOISE * noise
            and same_way >= EDIT_MIN_COS and torch.isfinite(sweep).all()):
        fail(f"{config}: the edit does not move the latents one way")

    x = sample_from_moments(torch.as_tensor(
        next(batches(data, EDIT_WRITE_N))["x"], device=dev),
        torch.Generator(device=dev).manual_seed(19))
    t0 = time.perf_counter()
    errs = session.roundtrip_error(x)
    secs_r = time.perf_counter() - t0
    log(f"{config} roundtrip (vis_reversible) of {EDIT_WRITE_N} samples: "
        f"{errs} in {secs_r:.1f} s")
    if not all(math.isfinite(v) for v in errs.values()):
        fail(f"{config}: the roundtrip error is not finite")
    del session
    out.update(read_features=dict(cos=f_cos, rel_l2=f_rel, auto_vs_f32=rel_k,
                                  xla_vs_f32=rel_p),
               write=dict(scale=scale, rel_of_tap=rel_s, seconds=secs_w,
                          launches=got, scale0_exact=exact, move_plus=move,
                          move_minus=move_m, route_difference=noise,
                          cos_same_way=same_way),
               roundtrip=dict(errs, seconds=secs_r))
    return out


def toy_uvit_path(torch, flow, attn, mlpk, sample_lfm, dev):
    """Phase 26: a U-ViT at the shape of the JAX package's U-ViT toys
    (uspace_tpu/configs/synthetic_attr_e2e.py:30: embed 128, depth 6, 4
    heads of 32, 8 x 8 x 4 latents, L = 17) with seeded weights, where the
    packed core and its backward run at head dim 32: TOY_TRAIN_STEPS train
    steps at TOY_TRAIN_B on `pallas_packed` (the toys' training route,
    cli/train_lfm.py) with exact launches of rows 1 and 4 and finite
    losses; Euler-STEPS at TOY_SAMPLE_B on `auto` (row 2 in every block)
    against `xla` from the same z within the path limits, exact launches;
    then the W8A8 view at head dim 32 (TOY_Q_EMBED in heads of 32, the
    same depth and latents): Euler-STEPS at TOY_SAMPLE_B on `pallas_qkvproj`
    (row 6, the int8 MLP, row 14) and on `pallas_block` (row 11, the int8
    MLP sub-block, row 15), exact launches, each against `xla`'s W8A8 view
    (bf16 attention, row 14) from the same z at the quality gate."""
    from uspace_tpu_torch.cli.train_lfm import build_train_model
    from uspace_tpu_torch.configs import get_config, uvit_nnet
    from uspace_tpu_torch.data.datasets import SyntheticFeatures
    from uspace_tpu_torch.train.state import (
        TrainState,
        get_lr_schedule,
        get_optimizer,
    )
    from uspace_tpu_torch.train.step import make_train_step

    cfg = get_config("uvit_large")
    cfg.update(z_shape=(4, 8, 8), nnet=uvit_nnet(
        embed_dim=128, depth=6, num_heads=4, img_size=8,
        use_checkpoint=False))
    blocks = cfg["nnet"]["depth"] + 1
    model = build_train_model(cfg, dev, seed=0, attn_impl="pallas_packed")
    n_remat = sum(model.remat)
    lr = get_lr_schedule("customized", 2e-4, warmup_steps=0)
    tx = get_optimizer("adam", lr, betas=(0.9, 0.999), weight_decay=0.0)
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, tx, lr_schedule=lr, ema_rate=0.999,
                           latents_from_moments=True)
    data = SyntheticFeatures(num=TOY_TRAIN_STEPS * TOY_TRAIN_B,
                             shape=(8, 8, 8), seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    reset_launches(attn, mlpk)
    t0 = time.perf_counter()
    metrics = [step(state, {"x": torch.from_numpy(data.batch(range(
        i * TOY_TRAIN_B, (i + 1) * TOY_TRAIN_B))["x"]).to(dev)}, gen)
        for i in range(TOY_TRAIN_STEPS)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = all_launches(attn, mlpk)
    losses = [float(m["loss"]) for m in metrics]
    want = dict(packed_attention=TOY_TRAIN_STEPS * (blocks + n_remat),
                packed_attention_bwd=TOY_TRAIN_STEPS * blocks)
    log(f"toy U-ViT (D=32) train, pallas_packed: {TOY_TRAIN_STEPS} steps at "
        f"batch {TOY_TRAIN_B} in {secs:.3f} s, losses {losses}, launches "
        f"{got} (expected {want})")
    if got != expected(attn, mlpk, **want):
        fail(f"toy U-ViT training launches {got}, expected {want}")
    if not all(map(math.isfinite, losses)):
        fail(f"toy U-ViT training losses {losses}")
    train = dict(steps=TOY_TRAIN_STEPS, batch=TOY_TRAIN_B, seconds=secs,
                 losses=losses, launches=want)
    del model, state, step

    kmodel = sample_lfm.build_model(cfg, dev, seed=0, attn_impl="auto")
    plain = sample_lfm.build_model(cfg, dev, seed=0, attn_impl="xla")
    plain.load_state_dict(kmodel.state_dict())
    z = torch.randn((TOY_SAMPLE_B, 8, 8, 4), generator=torch.Generator(
        device=dev).manual_seed(7), device=dev)
    reset_launches(attn, mlpk)
    lat, secs_k = decode_run(torch, flow, kmodel, z, STEPS)
    got = all_launches(attn, mlpk)
    lat_p, secs_p = decode_run(torch, flow, plain, z, STEPS)
    max_abs, rel, cos = compare(torch, lat, lat_p)
    n = blocks * STEPS
    log(f"toy U-ViT (D=32) Euler-{STEPS} at batch {TOY_SAMPLE_B}: auto "
        f"{secs_k:.3f} s, xla {secs_p:.3f} s, launches {got} (expected "
        f"{n} of qkvproj_attention); latents cos {cos:.7f} (min "
        f"{PATH_MIN_COS}) rel_l2 {rel:.3e} (max {PATH_MAX_REL_L2})")
    if got != expected(attn, mlpk, qkvproj_attention=n):
        fail(f"toy U-ViT Euler launches {got}, expected {n} of "
             f"qkvproj_attention")
    if tuple(lat.shape) != (TOY_SAMPLE_B, 8, 8, 4) or not (
            cos >= PATH_MIN_COS and rel <= PATH_MAX_REL_L2):
        fail("toy U-ViT (D=32) latents disagree with the plain path")
    euler = dict(steps=STEPS, batch=TOY_SAMPLE_B, seconds=secs_k,
                 plain_seconds=secs_p, cos=cos, rel_l2=rel, max_abs=max_abs,
                 launches=n)
    del kmodel, plain

    qcfg = get_config("uvit_large")
    qcfg.update(z_shape=(4, 8, 8), nnet=uvit_nnet(
        embed_dim=TOY_Q_EMBED, depth=6, num_heads=TOY_Q_EMBED // 32,
        img_size=8, use_checkpoint=False))
    qref = sample_lfm.build_model(qcfg, dev, seed=0, attn_impl="xla",
                                  quant=True)
    lat_x, secs_x = decode_run(torch, flow, qref, z, STEPS)
    w8a8 = dict(xla_seconds=secs_x)
    for impl, counts in (
            ("pallas_qkvproj", dict(qkvproj_attention_int8=n, mlp_int8=n)),
            ("pallas_block", dict(attention_block_int8=n, ln_mlp_int8=n))):
        view = sample_lfm.build_model(qcfg, dev, seed=0, attn_impl=impl,
                                      quant=True)
        view.load_state_dict(qref.state_dict())
        reset_launches(attn, mlpk)
        lat_v, secs_v = decode_run(torch, flow, view, z, STEPS)
        got = all_launches(attn, mlpk)
        max_abs, rel, cos = compare(torch, lat_v, lat_x)
        log(f"toy U-ViT W8A8 (embed {TOY_Q_EMBED}, D=32) {impl}: Euler-"
            f"{STEPS} at batch {TOY_SAMPLE_B} in {secs_v:.3f} s (xla "
            f"{secs_x:.3f} s), launches {got} (expected {counts}); latents "
            f"vs xla's W8A8 view cos {cos:.8f} (min {QUANT_MIN_COS}) rel_l2 "
            f"{rel:.3e} (max {QUANT_MAX_REL_L2})")
        if got != expected(attn, mlpk, **counts):
            fail(f"toy U-ViT W8A8 {impl} launches {got}, expected {counts}")
        if tuple(lat_v.shape) != (TOY_SAMPLE_B, 8, 8, 4) or not (
                cos >= QUANT_MIN_COS and rel <= QUANT_MAX_REL_L2):
            fail(f"toy U-ViT W8A8 {impl} fails the quality gate against "
                 f"xla's W8A8 view")
        w8a8[impl] = dict(seconds=secs_v, cos=cos, rel_l2=rel,
                          max_abs=max_abs, launches=counts)
        del view
    return dict(train=train, euler=euler, w8a8=w8a8)


def main():
    ap = argparse.ArgumentParser(description="Smoke test of the port on one "
                                 "NVIDIA card")
    ap.add_argument("--out", default="",
                    help="also write the whole report here as JSON")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    if not os.path.isdir(os.path.join(HERE, "uspace_tpu_torch")):
        fail("uspace_tpu_torch/ is not beside chip_smoke.py: run it from a "
             "checkout of the repository")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch.nn.functional as F

    from uspace_tpu_torch.cli import sample_lfm
    from uspace_tpu_torch.configs import get_config
    from uspace_tpu_torch.core import flow
    from uspace_tpu_torch.ops import _build, quant
    from uspace_tpu_torch.ops import attention as attn
    from uspace_tpu_torch.ops import mlp as mlpk

    report = {}
    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi unavailable"
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"device: {kind} x {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    report.update(card=card, kind=kind, torch=torch.__version__)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # 2. build
    t0 = time.perf_counter()
    _build.build()
    for name in _build.SIGNATURES:
        _build.load(name)
    report["build_s"] = time.perf_counter() - t0
    log(f"built kernels in {report['build_s']:.1f} s")

    # 3. kernels vs twins; int8_conv on the card vs the CPU
    kernels, report["kernel_shapes"], report["controls"] = check_kernels(
        torch, F, attn, mlpk, quant)
    by_key = {k["name"]: k for k in kernels}
    report["int8_conv"] = int8_conv_check(torch, F, quant)

    # 4. the main path: U-ViT-large Euler-50 at batch 50
    cfg = get_config("uvit_large")
    model = sample_lfm.build_model(cfg, dev, seed=0, attn_impl="auto")
    plain = sample_lfm.build_model(cfg, dev, seed=0, attn_impl="xla")
    plain.load_state_dict(model.state_dict())
    z = torch.randn((B, 32, 32, 4), generator=torch.Generator(
        device=dev).manual_seed(7), device=dev)
    with torch.no_grad():  # warm-up: cuBLAS/cuDNN handles, allocator
        for m in (model, plain):
            m(z.to(torch.bfloat16), torch.zeros(B, device=dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(attn, mlpk)
    lat, secs = decode_run(torch, flow, model, z, STEPS)
    launches = all_launches(attn, mlpk)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n_main = (cfg["nnet"]["depth"] + 1) * STEPS
    log(f"main path (auto): {secs:.3f} s, {B / secs:.3f} img/s, launches "
        f"{launches}, peak {peak_gb:.2f} GiB")
    if launches != expected(attn, mlpk, qkvproj_attention=n_main):
        fail(f"main path launches {launches}, expected {n_main} of "
             f"qkvproj_attention and no other")
    by_key["qkvproj_attention"]["launches"] = launches["qkvproj_attention"]
    lat_plain, secs_plain = decode_run(torch, flow, plain, z, STEPS)
    max_abs, rel, cos = compare(torch, lat, lat_plain)
    log(f"plain path (xla): {secs_plain:.3f} s, {B / secs_plain:.3f} img/s; "
        f"latents cos {cos:.7f} (min {PATH_MIN_COS}) rel_l2 {rel:.3e} "
        f"(max {PATH_MAX_REL_L2})")
    if tuple(lat.shape) != (B, 32, 32, 4) or lat.dtype != torch.float32:
        fail(f"latents {tuple(lat.shape)} {lat.dtype}")
    if not (cos >= PATH_MIN_COS and rel <= PATH_MAX_REL_L2):
        fail("main path disagrees with the plain path")
    report["main_path"] = dict(
        steps=STEPS, batch=B, seconds=secs, imgs_per_s=B / secs,
        plain_seconds=secs_plain, plain_imgs_per_s=B / secs_plain,
        cos=cos, rel_l2=rel, max_abs=max_abs, launches=launches,
        peak_gib=peak_gb)

    # 4b. the int8 W8A8 view's main path
    qmodel, report["int8_main_path"] = int8_path(
        torch, flow, attn, mlpk, quant, sample_lfm, cfg, dev, z, lat, by_key)

    # 4c. adaptive sampling: dopri5 in the bf16 and w8 views
    w8model, lat_dopri5, report["adaptive"] = adaptive_path(
        torch, flow, attn, mlpk, quant, sample_lfm, cfg, dev, z, model,
        by_key)

    # 5. the other kernel views, a few Euler steps each: bf16 views against
    # the plain path's limits, int8 views against the quality gate
    ref_short, _ = decode_run(torch, flow, plain, z, SHORT_STEPS)
    per = (cfg["nnet"]["depth"] + 1) * SHORT_STEPS
    skips = cfg["nnet"]["depth"] // 2
    views = (
        ("pallas_packed", False, dict(packed_attention=per)),
        ("pallas_lnmlp", False, dict(ln_qkvproj_attention=per)),
        ("pallas_qkvproj", True, dict(qkvproj_attention_int8=per,
                                      mlp_int8=per)),
        ("xla", True, dict(mlp_int8=per)),
        ("pallas_qkvproj", "w8", dict(qkvproj_attention=per, mlp_w8=per)),
        ("xla", "w8", dict(mlp_w8=per)),
    )
    for impl, q, counts in views:
        src = {False: model, True: qmodel, "w8": w8model}[q]
        view = sample_lfm.build_model(cfg, dev, seed=0, attn_impl=impl,
                                      quant=q)
        view.load_state_dict(src.state_dict())
        reset_launches(attn, mlpk)
        out, secs_v = decode_run(torch, flow, view, z, SHORT_STEPS)
        got = all_launches(attn, mlpk)
        _, rel_v, cos_v = compare(torch, out, ref_short)
        name = impl + {False: "", True: " int8", "w8": " w8"}[q]
        min_cos, max_rel = ((QUANT_MIN_COS, QUANT_MAX_REL_L2) if q
                            else (PATH_MIN_COS, PATH_MAX_REL_L2))
        log(f"{name}: {SHORT_STEPS} Euler steps in {secs_v:.3f} s, launches "
            f"{got} (expected {counts}), cos {cos_v:.7f} rel_l2 {rel_v:.3e} "
            f"against the plain path ({skips} int8 skip_linear layers per "
            f"evaluation in the int8 views)")
        if got != expected(attn, mlpk, **counts):
            fail(f"{name}: launches {got}, expected {counts}")
        if not (cos_v >= min_cos and rel_v <= max_rel):
            fail(f"{name} disagrees with the plain path")
        for k, n in counts.items():
            if by_key[k]["launches"] < 1:
                by_key[k]["launches"] = n
        report[name.replace(" ", "_")] = dict(
            steps=SHORT_STEPS, seconds=secs_v, cos=cos_v, rel_l2=rel_v,
            launches=counts)
        del view

    # 5b. the w8 view's Euler-50 against phase 4's bf16 latents: closer
    # than the W8A8 view (the JAX package's test of the view)
    reset_launches(attn, mlpk)
    lat_w8, secs_w8 = decode_run(torch, flow, w8model, z, STEPS)
    got = all_launches(attn, mlpk)
    _, rel_w8, cos_w8 = compare(torch, lat_w8, lat)
    rel_q = report["int8_main_path"]["rel_l2"]
    log(f"w8 Euler-{STEPS} (auto): {secs_w8:.3f} s, {B / secs_w8:.3f} img/s, "
        f"launches {got}; latents vs the bf16 kernel view: cos {cos_w8:.7f} "
        f"rel_l2 {rel_w8:.3e} (W8A8 view: {rel_q:.3e})")
    if got != expected(attn, mlpk, ln_qkvproj_attention=n_main,
                       ln_mlp_w8=n_main):
        fail(f"w8 Euler-{STEPS}: launches {got}")
    if not rel_w8 < rel_q:
        fail("the w8 view is not closer to the bf16 view than W8A8")
    report["w8_euler"] = dict(steps=STEPS, seconds=secs_w8,
                              imgs_per_s=B / secs_w8, cos=cos_w8,
                              rel_l2=rel_w8, w8a8_rel_l2=rel_q)
    del model, plain, qmodel, w8model

    # 6. the sampling entry point: bf16 and int8 views, and the w8 view's
    # adaptive solve (the config's dopri5 with the PI controller)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        st = []
        paths = sample_lfm.run(config="uvit_large", n_samples=B, batch=B,
                               seed=3, out=tmp, quant="w8",
                               solver="adaptive", stats=st)
        secs_cli = time.perf_counter() - t0
        a = np.load(paths[0])
        log(f"sample_lfm.run (quant=w8, solver=adaptive): {a.shape} in "
            f"{secs_cli:.1f} s, {st}")
        if len(paths) != 1 or a.shape != (B, 32, 32, 4) or not \
                np.isfinite(a).all() or st[0]["t"] != 1.0:
            fail(f"sample_lfm (w8, adaptive) wrote {a.shape}, {st}")
    report["sample_lfm_w8_adaptive"] = dict(seconds=secs_cli, **st[0])
    for q in (None, True):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            paths = sample_lfm.run(config="uvit_large", n_samples=2 * B,
                                   batch=B, steps=STEPS, seed=3, out=tmp,
                                   quant=q)
            secs_cli = time.perf_counter() - t0
            arrays = [np.load(p) for p in paths]
            shapes = [a.shape for a in arrays]
            log(f"sample_lfm.run (quant={q}): {len(paths)} batches {shapes} "
                f"in {secs_cli:.1f} s")
            if shapes != [(B, 32, 32, 4)] * 2 or not all(
                    np.isfinite(a).all() for a in arrays):
                fail(f"sample_lfm (quant={q}) wrote {shapes}")
        report["sample_lfm_seconds" + ("_int8" if q else "")] = secs_cli

    # 7. the training path
    report["train"] = train_path(torch, attn, cfg, dev, by_key)

    # 8. gradient agreement: kernel vs plain, auto vs pallas_packed
    report["grad_agreement"] = grad_agreement(torch, attn, cfg, dev)

    # 9. the training entry point
    report["train_lfm"] = train_entry_point(torch, cfg, dev)

    # 10.-12. the SD-UNet path: Euler-50, the VAE decode, the entry point
    z_unet, lat_unet, report["unet"] = unet_path(torch, flow, attn, mlpk,
                                                 sample_lfm, dev, by_key)
    for k in report["kernel_shapes"]:  # D=64 runs on the bench-shape path
        if k["name"] == "attention_fwd D=64":
            k["launches"] = report["unet"]["bench_shape"]["launches"][
                "attention_fwd"]
    report["vae"] = vae_decode(torch, sample_lfm, dev, lat_unet)
    report["sample_lfm_unet"] = unet_entry_point(torch, np, sample_lfm)

    # 13.-15. the int8 views: the UNet's Euler-50, the VAE's decode, the
    # entry point with both
    lat_q, report["unet_int8"] = unet_int8_path(
        torch, flow, attn, mlpk, quant, sample_lfm, dev, z_unet, lat_unet,
        report["unet"]["imgs_per_s"])
    report["vae_int8"] = vae_int8_decode(torch, sample_lfm, dev, lat_q)
    del lat_q, lat_unet, z_unet
    report["sample_lfm_unet_int8"] = unet_entry_point(torch, np, sample_lfm,
                                                      quant=True)

    # 16.-18. UNet training: the train step, gradient agreement, the entry
    # point
    report["unet_train"] = unet_train_path(torch, attn, mlpk, dev, by_key)
    report["unet_grad_agreement"] = unet_grad_agreement(torch, attn, mlpk,
                                                        dev)
    report["unet_train_lfm"] = unet_train_entry_point(torch, dev)

    # 19.-21. the whole-sub-block route (pallas_block): bf16 and W8A8
    # Euler-50, the w8 and w8a8_mlp views, the gradient, rows 12 and 13
    # inside the bf16 field, the entry points
    bmodel, report["pallas_block"] = block_bf16_path(
        torch, flow, attn, mlpk, sample_lfm, cfg, dev, z, lat_plain, by_key)
    report["pallas_block_int8"] = block_int8_path(
        torch, flow, attn, mlpk, quant, sample_lfm, cfg, dev, z, lat, by_key)
    report["pallas_block_views"] = block_views(
        torch, flow, attn, mlpk, sample_lfm, cfg, dev, z, ref_short)
    report["pallas_block_mlp_fields"] = fields = mlp_bf16_fields(
        torch, attn, mlpk, sample_lfm, cfg, bmodel, z)
    for k in ("mlp_bf16", "ln_mlp_bf16"):
        by_key[k]["launches"] = fields[k]["launches"]
    del bmodel
    report["pallas_block_grad"] = block_grad_agreement(torch, attn, mlpk,
                                                       cfg, dev)
    report["pallas_block_entry_points"] = block_entry_points(
        torch, np, sample_lfm, cfg, dev)

    # 22. the stage-delta int8 field: zero delta, tracking, the dopri5
    # solve against phase 4c's bf16 solve, the entry points
    report["stage_delta"] = stage_delta_path(
        torch, flow, attn, mlpk, quant, sample_lfm, cfg, dev, z, lat_dopri5,
        report["adaptive"], by_key)

    # 23. the field's "exact" and "gelu" hidden modes: the same checks, and
    # the fused base against the unfused one
    report["stage_delta_modes"] = {
        mode: stage_delta_path(torch, flow, attn, mlpk, quant, sample_lfm,
                               cfg, dev, z, lat_dopri5, report["adaptive"],
                               by_key, hidden_mode=mode)
        for mode in ("exact", "gelu")}

    # 24. SD-UNet-large at 512 px: row 9 on the main path
    report["unet_512"] = unet512_path(torch, np, flow, attn, mlpk,
                                      sample_lfm, dev, by_key)

    # 25. u-space editing: read, directions, write, roundtrip on both models
    report["editing"] = {
        name: editing_path(torch, np, attn, mlpk, sample_lfm, dev, name)
        for name in ("uvit_large", "unet_large_512")}

    # 26. the U-ViT toys' shape: the kernels at head dim 32 on a train step
    # and an Euler-50 solve, and the W8A8 view's rows 6 and 11 there
    report["toy_uvit_d32"] = toy = toy_uvit_path(torch, flow, attn, mlpk,
                                                 sample_lfm, dev)
    d32 = {"packed_attention": toy["train"]["launches"]["packed_attention"],
           "packed_attention_bwd":
               toy["train"]["launches"]["packed_attention_bwd"],
           "qkvproj_attention": toy["euler"]["launches"],
           "qkvproj_attention_int8": toy["w8a8"]["pallas_qkvproj"][
               "launches"]["qkvproj_attention_int8"],
           "attention_block_int8": toy["w8a8"]["pallas_block"]["launches"][
               "attention_block_int8"]}
    for k in report["kernel_shapes"]:
        name, _, dim = k["name"].partition(" ")
        if dim == f"D={C // H32}" and name in d32:
            k["launches"] = d32[name]

    for k in kernels:
        if k["launches"] < 1:
            fail(f"{k['name']} was never launched on its path")
    report["kernels"] = kernels
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
