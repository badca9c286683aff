#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and nvcc
(``/usr/local/cuda``). It imports nothing of JAX. Phases, each printed:

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of ``tpuir_torch/csrc/*.cu`` with nvcc (one process a
   source, all at once), timed.
2. K1 (``fused_transformer_block``) against its plain PyTorch version (TF32
   off) at the five block shapes of Restormer@256, batch 8, in both
   LayerNorm variants, with kernel and plain times from CUDA events; then,
   at each shape, the tensor-core GEMM core that K1's four 1x1 products run
   on (``ops/tc_gemm.gemm_f32x3``, 3xTF32) alone at each product's shape:
   its max error against float64 and its TFLOP/s beside ``torch.matmul``
   in float32 (TF32 off) on the same operands, a yardstick of the GEMM
   step only (the port never calls ``torch.matmul`` for them).
3. The Restormer path: seeded weights for the released color-denoising
   sigma=25 Restormer (full width) are written as a released ``.pth``,
   loaded through ``tpuir_torch.zoo.get_model_instance``, and three
   synthetic requests are served through ``core.engine.run_model_inference``
   with host AWGN and scored with ``calculate_metrics``, three rounds. K1's
   launch count must be 44 per forward chunk, and the kernel path must
   repeat bit for bit. The same requests through the same weights with
   plain blocks (served in turns with the kernel path), and the smallest
   request on the CPU, must agree to 1 uint8 LSB.
4. K6 (``mixer_prologue``), K2 (``nss_scan``, shift off and on, 128x128 at
   batch 8 and the 96x72 tile at batch 1) and K7 (``mixer_epilogue``)
   against their plain versions at MaIR-CDN@128, batch 8, full width, on
   seeded weights and the activations the plain mixer makes, with times
   from CUDA events (plain, kernel, kernel, plain); and the GEMM core at
   K6's in_proj and K7's out_proj shapes beside ``torch.matmul``, as in
   phase 2.
5. The MaIR path: seeded weights for the released sigma=25 MaIR-CDN (full
   width and depth) are written as ``MaIR/denoising/MaIR_CDN_s25.pth`` and
   loaded through the zoo; a 256x256 request (9 tiles, chunks 8+1), a
   200x150 request (4 tiles) and a 96x72 request (one rectangular tile) are
   served with host AWGN and scored, three rounds. Each of K6, K2 and K7
   must launch 36 times per forward chunk, and the kernel path must repeat
   bit for bit; one round with plain mixers, and the 96x72 request on the
   CPU, must agree with it to 1 uint8 LSB.

6. K6, K2 and K7 at the five level shapes of MaIRUNet's 384x384 tile at
   batch 8 (d_state 4, 8, 8, 16 and 32), K2 at the rectangular 384x328
   tile of a 481x321 request (batch 2), and K3
   (``selective_scan_fused_proj``) at that request's two K3 levels, 96x82
   and 48x41 (batch 2, d_state 16 and 32), against their plain versions on
   seeded MaIRUNet weights; K2 and K3 must repeat bit for bit. Kernel times
   from CUDA events, the plain version timed once a shape, K3's beside its
   MUFU floor (one exp2 a state update); the GEMM core at
   K6's in_proj and K7's out_proj shapes of each level beside
   ``torch.matmul``, as in phase 2.
7. The MaIRUNet path: seeded weights for the released real-denoising
   MaIRUNet (full width and depth) are written as
   ``MaIR/denoising/MaIR_RealDN.pth`` and loaded through the zoo; noisy
   inputs made on the host from a seed are served as they are
   (``need_degradation=False``): a 720x1280 frame (15 tiles, chunks 8+7,
   every level on K2) on the kernel path only, and 256x256 (one tile),
   481x321 (two 384x328 tiles, K3 at 96x82 and 48x41) and 120x90 (one tile
   padded to 120x96, K3 at 30x24 and 15x12) on both paths, three kernel
   rounds. Launches per chunk follow each level's route (44 each of K6, K2,
   K7 where every level is on K2; 24 of those and 20 of K3 otherwise); the
   kernel path must repeat bit for bit and agree with the plain path, and
   with the CPU on 120x90, to 1 uint8 LSB.
8. K5 (``nss_scan_fused``) against its plain version (the id table against
   the kernel's stripe arithmetic): MaIR-CDN@128 at batch 8 with the shift
   off and on (timed plain, kernel, kernel, plain), the 96x72 tile at batch
   1 (y23 72x96), MaIRUNet's five level shapes of a 384x384 tile at batch 8
   and the 384x328 tile at batch 2; it must repeat bit for bit.
9. The fused route: MaIR-CDN and MaIRUNet built through the zoo with
   ``nss="fused"`` on the seeded weights of phases 5 and 7. MaIR-CDN serves
   phase 5's three requests, three rounds: 36 K5 launches a chunk and none
   of K6, K2 or K7, repeatable, within 1 uint8 LSB of phase 5's stripe-route
   outputs, and on 96x72 of the fused route's plain path and of the CPU;
   engine Mpix/s beside the stripe route's. MaIRUNet serves the 481x321
   request, three rounds: 24 K5 and 20 K3 launches a chunk, within 1 LSB of
   phase 7's output.
10. K4 (``selective_scan_kernel``): its entry point at MaIR-CDN's shape
    (B 8, K 4, L 16,384, D 234, N 16), at MaIRUNet's latent (B 8, K 4,
    L 2,304, D 768, N 32) and at a ragged case with K 2 and no D or delta
    bias, then each output against ``selective_scan``, repeated bit for bit.
11. P1 (``utils/micro_rate.probe``) against ``probe_plain`` at the JAX
    probe's shapes (x (8, 512, 128), 32 rounds) for mul, fma and exp2,
    within rtol 1e-5 and bit for bit on repeat; then the rate entry point
    (the three elementwise rates), the float32 (TF32 off), TF32 and bf16
    ``torch.matmul`` rates at 8192^3, and the scan floor at MaIR-CDN@128
    and the MUFU floors (two exp2 a state update for the three-pass scan of
    K2, K5 and K4, one for K3's one-pass scan) from the measured rates,
    beside K2's, K5's, K4's and K3's times of phases 4, 8, 10 and 6.
12. Restormer's serving precision. The GEMM core's bf16-operand kernel
    alone at K1 serving's apply, projection and project_out shapes (against
    float64 products of its operands, beside ``torch.matmul`` in bf16); K1's
    serving body at the five Restormer@256 block shapes, batch 8, both
    LayerNorm variants, held stage by stage against functions of its own
    previous stage (``utils/serving_check.py``), bit for bit on repeat, timed
    beside its plain version and beside the recorded times of the unfused
    body it replaced (``K1_SERVING_REPLACED_MS``); its mutation controls (``python -m
    tpuir_torch.utils.serving_mutants --bodies K1``: 16 required faults);
    then the released sigma=25 Restormer built through the
    zoo with ``precision="serving"`` on phase 3's weights serves phase 3's
    requests, three rounds: 44 serving-body launches a chunk and no parity
    K1 launch, repeatable, within 2 uint8 LSB of the same path with plain
    serving blocks, PSNR within 0.05 dB of phase 3's parity outputs.
13. MaIR-CDN's serving precision. The GEMM core's bf16-operand kernel
    alone at K7's out_proj shape (beside ``torch.matmul`` in bf16), and
    ``torch.matmul`` bf16 alone at K6's in_proj shape (K6 serving takes
    in_proj fused with its depthwise conv); the serving bodies of K6, K2
    (shift off and on) and K7 at MaIR-CDN@128, batch 8, and at the 96x72
    tile, batch 1, on phase 4's seeded activations (bf16 where the body
    takes bf16), each held stage by stage against float64 functions of its
    own previous stage (``utils/serving_check.py``: K6's and K7's bf16
    weight copies, K6's in_proj halves and x, K2's x_dbl, y and pooled,
    K7's bf16 gated rows and out_proj), bit for bit on repeat, timed beside
    its plain version and beside the recorded times of the bodies they
    replaced (``SERVING_REPLACED_MS``); the mutation controls for the three bodies
    (``utils/serving_mutants.py --bodies mixer``: each fault in its own
    copy, built there; the check must reject the required ones and accept
    the unmutated copy, and prints its verdict on the reported ones); then
    the released sigma=25 MaIR-CDN built through the zoo with
    ``precision="serving"`` on phase 5's weights serves phase 5's requests,
    three rounds: 36 launches a chunk of each serving body and none of the
    parity K6, K2 or K7, repeatable, within 2 uint8 LSB of the same path
    with plain serving mixers, PSNR within 0.05 dB of phase 5's parity
    outputs.
14. MaIRUNet's serving precision and MaIR serving off the stripe route.
    The serving bodies of K6, K2 and K7 at MaIRUNet's five level shapes of
    a 384x384 tile (batch 8) and K2's at the 384x328 tile (batch 2), K3's
    (``selective_scan_fused_proj`` with ``serving=True``) at the 481x321
    request's 96x82 and 48x41 levels (batch 2), and K5's
    (``nss_scan_fused`` with ``serving=True``) at MaIR-CDN@128 (batch 8,
    shift off and on), the 96x72 tile and the 384x328 tile (batch 2), on
    phase 6's and phase 8's seeded weights and activations (bf16 where a
    body takes bf16): each held stage by stage (``utils/serving_check.py``:
    K3's x_dbl and float32 y, K5's x_dbl, bf16 y01 and y23 and pooled), bit
    for bit on repeat, timed beside its plain version (K6, K2 and K7 also beside
    the recorded times of the bodies they replaced, by level and per
    MaIRUNet@384 forward; K5 at MaIR-CDN@128 and 384x328 beside its
    replaced body's, ``K5S_REPLACED_MS``); their mutation
    controls (``utils/serving_mutants.py --bodies seq``); then, through the
    zoo with ``precision="serving"`` on the seeded weights of phases 5 and
    7, three rounds each: MaIRUNet on phase 7's 256x256, 481x321 and 120x90
    inputs (44 launches a chunk each of the K6, K2 and K7 serving bodies
    where every level is on K2; 24 of those and 20 of K3's otherwise; none
    of a parity body), MaIR-CDN with ``nss="fused"`` on phase 5's requests
    (36 K5 serving launches a chunk), MaIRUNet with ``nss="fused"`` on
    481x321 (24 K5 and 20 K3 serving launches a chunk) and MaIR-CDN with
    ``nss="0"`` on 96x72 (36 K3 serving launches a chunk): each repeatable,
    within 2 uint8 LSB of the same path with plain serving mixers, PSNR
    within 0.05 dB of the parity outputs of phase 5 or 7, engine Mpix/s
    beside parity's.
15. K2's bf16-recurrence serving body (``nss_scan`` with ``serving=True,
    recur_bf16=True``) at MaIR-CDN@128, batch 8 (shift off and on, timed
    beside its plain version) and at the 96x72 tile, batch 1 (shift on), on
    phase 4's seeded activations rounded to bf16: held stage by stage
    (``utils/serving_check.check_nss_scan_recur_serving``: x_dbl against
    float64, the level-2 carries bit for bit against their emulation from
    the kernel's own x_dbl, y and pooled against float64 sums), bit for bit
    on repeat; its mutation controls (``utils/serving_mutants.py --bodies
    recur``: 5 required faults); then the seeded sigma=15 MaIR-CDN (phase
    5's weights) on phase 5's 200x150 and 96x72 requests and the seeded
    real-denoising MaIRUNet (phase 7's) on its 256x256 and 120x90 inputs,
    each built through the zoo in parity, in serving and in serving with
    ``recur_bf16=True``: the recur path three rounds (36 launches a chunk
    of the recur body and none of ``nss_scan_serving``; MaIRUNet: one a
    stripe-route level's block, K3's serving body elsewhere), repeatable,
    within 2 uint8 LSB of the same path with plain mixers
    (``nss_scan_recur_plain``), PSNR within 0.25 dB of parity (the mode is
    opt-in and not held to serving's 0.05 dB: ``RECUR_PSNR_DB``); each request
    prints PSNR(recur) - PSNR(serving), PSNR(recur) - PSNR(parity), the LSB
    to the plain recur path and engine Mpix/s beside serving's.
16. The evaluation harness on the card: seeded ``{'params': sd}``
    checkpoints of the sigma=15 color Restormer and MaIR-CDN and two
    synthetic CBSD68 images in a temporary tree;
    ``tpuir_torch.harness.Harness(device="cuda")`` runs
    ``gaussian_color_nonblind`` for both models in parity, in serving and
    in serving with ``recur_bf16``, and ``save_results`` writes each run's
    ``results_summary.csv``, whose columns must be tpuir's. Each run's
    launches are counted (K1 or its serving body 44 a chunk; K6, K2 and K7,
    their serving bodies, or the recur body in K2's place, 36 a chunk);
    every row's PSNR must lie within 0.01 dB and its SSIM within 1e-3 of
    the same run with the models' plain twins, the text columns equal.
17. The plain-conv families, which carry no hand kernel (cuDNN convs and
    plain PyTorch): seeded checkpoints in the released formats in a
    temporary tree (DnCNN's ``dncnn_25.pth`` and ``dncnn_color_blind.pth``,
    REDNet's ``50.pt`` and the same weights as a ``50.caffemodel``,
    DeblurGANv2's ``fpn_mobilenet.h5`` and ``fpn_inception.h5``), each
    built through the zoo at full width and depth in parity and in serving
    and served through the engine: DnCNN gray sigma=25 and color blind and
    REDNet sigma=50 (from the ``.pt``, then from the ``.caffemodel``) on a
    BSD68-sized 481x321 request with host AWGN, DeblurGANv2 MobileNet and
    Inception on a GoPro-sized 720x1280 frame blurred by a 9-pixel
    horizontal box, scored against the sharp frame. Each path serves
    ``PLAIN_ROUNDS`` rounds with the kernels' counts set to 0 and must
    launch no hand kernel and repeat bit for bit; parity must agree with
    the port's CPU path within 1 uint8 LSB and serving's PSNR with
    parity's within 0.05 dB; one patch at the model's patch size alone and
    the same patch in a batch of 8 must agree within ``PLAIN_BATCH_TOL``
    (DeblurGANv2's per-sample norms); the ``.caffemodel`` must serve the
    ``.pt``'s output bit for bit. Engine Mpix/s is printed for parity and
    serving.
18. The engine's in-flight window, its host split, and the user entry
    points. Every phase above serves through the window (``max_in_flight``
    4, the default). (a) Restormer sigma=25 on phase 3's 512x512 request,
    MaIR-CDN sigma=25 on phase 5's 256x256 and REDNet sigma=50 on phase
    17's 481x321, each in parity and serving, and MaIRUNet on phase 7's
    720x1280 frame (parity), built through the zoo from seeded checkpoints,
    and Restormer and REDNet serving again at engine batch 2 (5 and 10
    chunks: every staging buffer refilled, the window full), are served
    with ``max_in_flight`` 1, 2 and 4 in turns, three rounds: the outputs
    must be bit-equal across windows and rounds and each serve's launches
    the same, a chunk's as its path's; engine Mpix/s for each window.
    (b) Each batch-8 request of (a), DnCNN gray sigma=25 on 481x321 and
    DeblurGANv2 MobileNet and Inception on 720x1280 in parity and serving,
    split by ``utils.profiling.engine_split`` (host ms by step, median of 3)
    and ``profiled_requests`` (the card's copy and kernel ms, busy ms and
    idle share over two requests). (c) ``demo_core.run_restoration`` on
    ``cuda:0`` with the seeded sigma=25 color Restormer and MaIR-CDN, on a
    200x150 image with AWGN: its output must equal ``run_model_inference``
    on the same model and noisy input bit for bit, with K1's and K6's,
    K2's and K7's launches counted. (d) ``scripts.test_demo``'s gaussian
    color non-blind suite on a temporary demo directory (both PNGs written,
    PSNR finite), ``scripts.test_patch_size`` for DnCNN gray (its trials
    and result) and ``scripts.validate_serving`` for DnCNN and Restormer on
    one synthetic image (its JSON written to a temporary path, serving
    within 0.05 dB of parity).

Each path's launch counts are set to 0 just before it is served (K4's and
P1's entry points: just before they are called) and read just after; a
kernel's launches in the JSON line are the sum over the paths it runs on.
The second-to-last line is the kernels' JSON summary: per kernel its
launches, max|kernel - plain| over every check (P1: relative), kernel and
plain ms (K1: per Restormer@256 forward; K6, K2, K7, K5: per call at
MaIR-CDN@128, batch 8; K3: per forward chunk of the 481x321 request, its 12
calls at 96x82 and 8 at 48x41; K4: per call at MaIR-CDN's shape; P1: per
call at the JAX shapes, the mean over the three ops; K1 serving: per
Restormer@256 forward), the least time the card could take for the same
work (``bound_ms``: the largest of its bytes over 3.35 TB/s, its float32
operations over 67 TFLOP/s, an exponential counted as one, and, for the
scans K2, K3, K4 and K5, their exponentials, one a state update, at the
special-function lanes' 4.19 T/s, an eighth of the float32 lanes' 33.5 T
instructions/s; the H100 SXM's data-sheet rates, computed from this run's
shapes; P1, a rate probe: its mul and fma at 33.5 T instructions/s, its
exp2 at an eighth of that) and which bounds it ("operations" for either
rate of operations). K1, K6 and K7, whose products run on the tensor cores
in 3xTF32, also carry ``bound_tc_ms``: their 1x1
products' operations at the TF32 rate over 3 (494.7 / 3 TFLOP/s) plus the
rest at 67 TFLOP/s, or the bytes over 3.35 TB/s where that is larger. K1
serving's ``bound_ms`` is the larger of its bytes (bf16 block IO, float32
weights) over 3.35 TB/s and its products (the Gram and the attention
apply at one head's width) at the dense bf16 rate, 989 TFLOP/s, plus the
rest at 67 TFLOP/s. The MaIR mixer's serving bodies (K6, K2, K7 serving:
per call at MaIR-CDN@128, batch 8; K2 the mean over both shifts) take the
same ``bound_ms``: bf16 where the body moves bf16, their products at the
bf16 rate, and for K2 also its exponentials, one a state update, at the
special-function lanes' rate; so do K3 serving (per forward chunk of the
481x321 request, as K3) and K5 serving (per call at MaIR-CDN@128, batch 8,
the mean over both shifts); so does K2's recur body (per call at
MaIR-CDN@128, batch 8, the mean over both shifts: the serving body's work).
The last line is ``{"ok": true, "device":
{...}}``. Any failed phase raises,
exits non-zero and prints no last line; so does a machine without a CUDA
card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
BATCH = 8
ATOL, RTOL = 5e-5, 1e-4  # float32 sums in another order than cuBLAS/cuDNN
SCAN_ATOL, SCAN_RTOL = 5e-5, 1e-3  # the scan's own (tests/test_torch_nss.py)
# Restormer@256 block shapes (H = W, C, heads) and how many of the 44 blocks
# of one forward run at each.
BLOCK_SHAPES = [
    ("level1", 256, 48, 1, 4),
    ("level2", 128, 96, 2, 12),
    ("level3", 64, 192, 4, 12),
    ("latent", 32, 384, 8, 8),
    ("decoder1+refinement", 256, 96, 1, 8),
]
REQUESTS = [(512, 512), (481, 321), (200, 150)]  # H x W x 3 uint8
MAIR_REQUESTS = [(256, 256), (200, 150), (96, 72)]
MAIR_TILE = 128  # MaIR-CDN's patch: the kernels' shapes on its path
MAIR_BLOCKS = 36
# MaIRUNet@384 at batch 8: (label, tile side, the stage whose block 0 gives
# the mixer's weights, that width's blocks a forward)
UNET_LEVELS = [
    ("encoder1", 384, "encoder_level1", 4),
    ("decoder1+refinement", 384, "decoder_level1", 8),
    ("level2", 192, "encoder_level2", 12),
    ("level3", 96, "encoder_level3", 12),
    ("latent", 48, "latent", 8),
]
# the 481x321 request's two 384x328 tiles: K2a's case, and K3's two levels
UNET_RECT = (384, 328, "encoder_level1")
UNET_K3_LEVELS = [("level3", 96, 82, "encoder_level3", 12), ("latent", 48, 41, "latent", 8)]
UNET_KERNEL_ONLY = [(720, 1280)]  # a GoPro frame
UNET_REQUESTS = [(256, 256), (481, 321), (120, 90)]
UNET_NOISE = 15.0  # sigma of the host noise on the real-denoising inputs
UNET_FUSED_REQUEST = (481, 321)  # MaIRUNet on the fused route: K5 at 384x328, 192x164
# K4 at (label, B, K, L, D, N, with D and delta_bias)
K4_CASES = [("MaIR-CDN@128", 8, 4, 128 * 128, 234, 16, True),
            ("MaIRUNet latent@384", 8, 4, 48 * 48, 768, 32, True),
            ("ragged", 3, 2, 777, 100, 9, False)]
PROBE_RTOL = 1e-5
# the stages of MaIRUNet and their pyramid level
UNET_STAGES = [("encoder_level1", 0), ("encoder_level2", 1), ("encoder_level3", 2),
               ("latent", 3), ("decoder_level3", 2), ("decoder_level2", 1),
               ("decoder_level1", 0), ("refinement", 0)]
ROUNDS = 3
SIGMA = 25
CONFIG = dict(layer_norm_bias=False)  # the color-denoising Restormer (BiasFree)
ITERS = 10  # launches a CUDA-event timing averages over
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12
F32X3_FLOP_PER_S = 494.7e12 / 3  # dense TF32 tensor-core rate, three products a float32 one
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core rate
# The recorded times of the serving body this one replaced (float32
# intermediates, the products and depthwise convs in separate launches, the
# Gram on the ALU): ms a block at each BLOCK_SHAPES shape (BiasFree, batch 8)
# and a forward. They are the first of the two readings of that body in
# PERF.md §6, taken by utils/gemm_bench.py --kernels K1s --tree <its checkout>
# in turns with this body on an NVIDIA H100 80GB HBM3 at 700.00 W. A recorded
# figure, not a measurement of this run: printed beside this run's times as
# such, and to be timed again with gemm_bench.py --tree on another card.
K1_SERVING_REPLACED_MS = {"level1": 2.760, "level2": 1.398, "level3": 0.772, "latent": 0.588,
                          "decoder1+refinement": 5.436, "forward": 85.263}
# The same for the MaIR mixer's serving bodies of K6 (in_proj on the core's
# old bf16 mode, then the depthwise conv: two launches, the float32 x half
# through device memory) and K7 (float32 gated rows, out_proj on that mode):
# ms a call at MaIR-CDN@128 and at each UNET_LEVELS shape (batch 8), and
# per MaIRUNet@384 forward, as PERF.md section 6 records them (chip_smoke.py
# phases 13 and 14 on an NVIDIA H100 80GB HBM3 at 700.00 W). Recorded
# figures, printed beside this run's times as such.
K6_SERVING_REPLACED_MS = {"MaIR-CDN@128": 0.531, "encoder1": 1.260,
                          "decoder1+refinement": 2.557, "level2": 0.697, "level3": 0.422,
                          "latent": 0.282, "forward": 41.19}
K7_SERVING_REPLACED_MS = {"MaIR-CDN@128": 0.349, "encoder1": 0.927,
                          "decoder1+refinement": 1.745, "level2": 0.472, "level3": 0.293,
                          "latent": 0.204, "forward": 28.49}
# and of K2's (the chunked passes of csrc/chunk_scan.cuh on bf16 x and y: two
# exponentials a state update, a thread a channel), also at the 384x328 tile
# (batch 2), as PERF.md section 6 records them
K2S_REPLACED_MS = {"MaIR-CDN@128": 2.935, "encoder1": 4.826, "decoder1+refinement": 11.916,
                   "level2": 3.071, "level3": 2.465, "latent": 2.405, "rect": 1.215,
                   "forward": 200.32}
# and of K5's (the same passes along the stripe arithmetic): ms a call at
# MaIR-CDN@128 (batch 8, the mean over both shifts) and at the 384x328 tile
# (batch 2, MaIRUNet's level-1 widths)
K5S_REPLACED_MS = {"MaIR-CDN@128": 2.918, "rect": 1.186}
SERVING_REPLACED_MS = {"K6s": K6_SERVING_REPLACED_MS, "K2s": K2S_REPLACED_MS,
                       "K7s": K7_SERVING_REPLACED_MS, "K5s": K5S_REPLACED_MS}
SERVING_LSB = 2  # serving path against its plain-block twin, in uint8 LSB
SERVING_PSNR_DB = 0.05  # serving against parity, per request (BASELINE.json's contract)
# The bf16 recurrence (recur_bf16) is an opt-in mode that the JAX package keeps
# off every default and never held to that contract: on the card it costs
# MaIRUNet 0.08 dB at 256x256 (PERF.md), so its gate against parity is only a
# bound that a broken body would cross; its correctness gate is its plain twin.
RECUR_PSNR_DB = 0.25
# P1's ops a second: a float32 mul or FMA is one instruction of the 128
# float32 lanes an SM (67 TFLOP/s counts an FMA as two flops), an exp2 one
# of the 16 special-function lanes (the Hopper architecture white paper)
P1_OP_PER_S = {"mul": FP32_FLOP_PER_S / 2, "fma": FP32_FLOP_PER_S / 2,
               "exp2": FP32_FLOP_PER_S / 2 / 8}
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "fused_transformer_block": ("tpuir_torch/csrc/fused_block.cu", "tpuir/ops/fused_block.py:338"),
    "mixer_prologue": ("tpuir_torch/csrc/nss_prologue.cu", "tpuir/ops/nss_prologue.py:121"),
    "nss_scan": ("tpuir_torch/csrc/nss_scan.cu", "tpuir/ops/nss_stripe.py:484"),
    "mixer_epilogue": ("tpuir_torch/csrc/nss_epilogue.cu", "tpuir/ops/nss_epilogue.py:140"),
    "selective_scan_fused_proj": ("tpuir_torch/csrc/scan_fused_proj.cu",
                                  "tpuir/ops/scan_pallas.py:340"),
    "nss_scan_fused": ("tpuir_torch/csrc/nss_fused.cu", "tpuir/ops/nss_fused.py:247"),
    "selective_scan": ("tpuir_torch/csrc/selective_scan.cu", "tpuir/ops/scan_pallas.py:117"),
    "rate_probe": ("tpuir_torch/csrc/rate_probe.cu", "benchmarks/micro_vpu.py:60"),
    # the same TPU kernels' serving bodies (K1: mm_bf16, fast_gelu; the others: serving=True)
    "fused_transformer_block_serving": ("tpuir_torch/csrc/fused_block.cu",
                                        "tpuir/ops/fused_block.py:338"),
    "mixer_prologue_serving": ("tpuir_torch/csrc/nss_prologue.cu",
                               "tpuir/ops/nss_prologue.py:121"),
    "nss_scan_serving": ("tpuir_torch/csrc/nss_scan.cu", "tpuir/ops/nss_stripe.py:484"),
    "mixer_epilogue_serving": ("tpuir_torch/csrc/nss_epilogue.cu",
                               "tpuir/ops/nss_epilogue.py:140"),
    "selective_scan_fused_proj_serving": ("tpuir_torch/csrc/scan_fused_proj.cu",
                                          "tpuir/ops/scan_pallas.py:340"),
    "nss_scan_fused_serving": ("tpuir_torch/csrc/nss_fused.cu", "tpuir/ops/nss_fused.py:247"),
    # K2's serving body with the bf16 level-1 recurrence (recur_bf16=True)
    "nss_scan_recur_serving": ("tpuir_torch/csrc/nss_scan.cu", "tpuir/ops/nss_stripe.py:218"),
}
MIXER_SERVING = ("mixer_prologue_serving", "nss_scan_serving", "mixer_epilogue_serving")
RECUR_SIGMA = 15  # the recur path's MaIR-CDN (the harness's sigma=15 row)
RECUR_MAIR_REQUESTS = [(200, 150), (96, 72)]
RECUR_UNET_REQUESTS = [(256, 256), (120, 90)]
HARNESS_IMAGES = [(96, 72), (64, 80)]  # one tile each for both models
HARNESS_PSNR_DB, HARNESS_SSIM = 0.01, 1e-3  # a harness row against its plain-path twin
# Phase 17, the plain-conv families: a BSD68-sized and a GoPro-sized request
# (H x W), the rounds each path serves, and the bound on |one patch alone -
# the same patch in a batch of 8| of a model's step output in [0, 1]
# (float32 noise: cuDNN may sum in another order at another batch).
PLAIN_BSD68 = (481, 321)
PLAIN_GOPRO = (720, 1280)
PLAIN_ROUNDS = 2
PLAIN_BATCH_TOL = 1e-4


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of fn() on the card, from CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, exps: float = 0):
    """(least ms on the card, what bounds it) for work of nbytes, flops and
    ``exps`` exponentials on the special-function lanes (``mufu_ms``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / FP32_FLOP_PER_S, mufu_ms(exps) / 1e3)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def mufu_ms(exps):
    """Least ms for ``exps`` exp2 on the special-function lanes,
    ``P1_OP_PER_S["exp2"]``: a scan's MUFU floor, one exp2 a state update."""
    return 1e3 * exps / P1_OP_PER_S["exp2"]


def bound_tc(nbytes: float, gemm_flops: float, flops: float) -> float:
    """Least ms on the card for work whose ``gemm_flops`` of ``flops`` run on
    the tensor cores in 3xTF32 and the rest at the float32 rate."""
    t_ops = gemm_flops / F32X3_FLOP_PER_S + (flops - gemm_flops) / FP32_FLOP_PER_S
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, t_ops)


def k1_products(batch, hw, C):
    """K1's four 1x1 products as (label, images, M, N, K, one weight an
    image): qkv, the folded projection (one C x C weight an image),
    project_in, project_out."""
    h, px = int(C * 2.66), batch * hw * hw
    return [("qkv", 1, px, 3 * C, C, False), ("proj", batch, hw * hw, C, C, True),
            ("ffn_in", 1, px, 2 * h, C, False), ("ffn_out", 1, px, C, h, False)]


def k1_work(batch, hw, C, heads, ln_bias=False):
    """(bytes, float32 operations) of one TransformerBlock: x in, out out,
    weights once; the 1x1 products, the depthwise convs, the Gram and the
    attention-weighted sum, the GELU gate."""
    h = int(C * 2.66)
    hc = C // heads
    px = batch * hw * hw
    weights = 3 * C * C + 27 * C + heads + C * C + 2 * h * C + 18 * h + h * C + 2 * C
    weights += 2 * C if ln_bias else 0
    nbytes = 4 * (2 * px * C + weights)
    flops = px * (2 * C * 3 * C + 18 * 3 * C + 4 * C * hc + 2 * C * C
                  + 2 * C * 2 * h + 18 * 2 * h + 8 * h + 2 * h * C)
    return nbytes, flops


def gemm_yardstick(label, images, M, N, K, per_image, device, seed):
    """The GEMM core alone (``ops/tc_gemm.gemm_f32x3``, 3xTF32) at one product
    shape, against float64 and beside ``torch.matmul`` in float32 (TF32 off)
    on the same seeded operands (unit-scale A, fan-in-scaled W): prints max
    |error|, its share of atol + rtol * |ref| and TFLOP/s of each; fails if
    the core misses the tolerance."""
    import torch

    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.ops.tc_gemm import gemm_f32x3

    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(images, M, K, device=device, generator=gen)
    w = torch.randn(*((images,) if per_image else ()), N, K, device=device,
                    generator=gen) * K ** -0.5
    with torch.inference_mode(), true_float32():
        mm = lambda: torch.matmul(a, w.transpose(-1, -2))  # noqa: E731
        core = lambda: gemm_f32x3(a, w)  # noqa: E731
        ref = torch.matmul(a.double(), w.double().transpose(-1, -2))
        stats = []
        for fn in (core, mm):
            err = (fn() - ref).abs()
            stats.append((err.max().item(), (err / (ATOL + RTOL * ref.abs())).max().item()))
            del err
        del ref
        core(), mm()
        t_mm = cuda_ms(mm, ITERS)
        t_core = (cuda_ms(core, ITERS) + cuda_ms(core, ITERS)) / 2
        t_mm = (t_mm + cuda_ms(mm, ITERS)) / 2
    tflop = 2 * images * M * N * K / 1e12
    print(f"  GEMM core {label:26s} {images}x({M}x{K} . {N}x{K}^T)  core {t_core:.3f} ms "
          f"{tflop / t_core * 1e3:6.1f} TFLOP/s max|err| {stats[0][0]:.2e} "
          f"({stats[0][1]:.3f} of tol)  torch.matmul f32 {t_mm:.3f} ms "
          f"{tflop / t_mm * 1e3:6.1f} TFLOP/s max|err| {stats[1][0]:.2e} ({stats[1][1]:.3f})",
          flush=True)
    if not stats[0][1] <= 1.0:
        fail(f"the GEMM core misses atol {ATOL:g} + rtol {RTOL:g} against float64 at {label}")


def prologue_work(px, dm, di):
    """K6: h in, x and z out, weights; in_proj, the depthwise conv, bias + SiLU."""
    return (4 * (px * dm + 2 * px * di + 2 * di * dm + 10 * di),
            px * (2 * dm * 2 * di + 18 * di + 5 * di))


def scan_work(px, di, n, r):
    """K2: x and the id table in, y (4 directions) and pooled out, weights;
    per direction and pixel the x_dbl and dt projections, softplus, per
    state update exp(dt*A), dt*B*x, the FMA into h and C.h, then D*x and
    the pooled sum. An exponential counts as one operation, and as one of
    the exponentials (the third value, one a state update)."""
    c = r + 2 * n
    nbytes = 4 * (px * di + 4 * px + 4 * px * di + 4 * (c * di + di * r + di * n + 2 * di))
    flops = 4 * px * (2 * c * di + 2 * r * di + 4 * di + 7 * di * n + 4 * di)
    return nbytes, flops, 4 * px * di * n


def k5_work(px, di, n, r):
    """K5: scan_work less the id table, which K5 does not read."""
    nbytes, flops, exps = scan_work(px, di, n, r)
    return nbytes - 4 * 4 * px, flops, exps


def k4_work(seqs, L, di, n):
    """K4: u and delta in, B and C in, y out (seqs = B*K sequences of L
    positions), A, D and the bias; per position and channel the bias add,
    softplus, D*u, and per state update exp(dt*A), dt*B*u, the FMA into h
    and C.h; one exponential a state update."""
    pos = seqs * L
    nbytes = 4 * (3 * pos * di + 2 * pos * n + seqs * (di * n + 2 * di))
    flops = pos * (5 * di + 7 * di * n + 2 * di)
    return nbytes, flops, pos * di * n


def k3_work(seqs, L, di, n, r):
    """K3: xs in, y out (seqs = B*4 sequences of L positions), weights; per
    position the x_dbl and dt projections, softplus, per state update
    exp(dt*A), dt*B*x, the FMA into h and C.h, then D*x; one exponential a
    state update."""
    c = r + 2 * n
    pos = seqs * L
    nbytes = 4 * (2 * pos * di + 4 * (c * di + di * r + di * n + 2 * di))
    flops = pos * (2 * c * di + 2 * r * di + 4 * di + 7 * di * n + 2 * di)
    return nbytes, flops, pos * di * n


def epilogue_work(px, di, dm, images):
    """K7: four direction images, z, gates and weights in, out out; the gated
    sum, LayerNorm, SiLU gate, out_proj."""
    return (4 * (4 * px * di + px * di + 4 * images * di + 2 * di + dm * di + px * dm),
            px * (8 * di + 8 * di + 6 * di + 2 * di * dm))


def timed_pair(kern, plain, iters=ITERS, plain_iters=None):
    """(kernel ms, plain ms) from CUDA events in turns: plain, kernel, kernel, plain."""
    plain_iters = plain_iters or iters
    kern(), plain()  # warm-up
    t_plain = cuda_ms(plain, plain_iters)
    t_kern = cuda_ms(kern, iters)
    t_kern = (t_kern + cuda_ms(kern, iters)) / 2
    t_plain = (t_plain + cuda_ms(plain, plain_iters)) / 2
    return t_kern, t_plain


def as_tuple(t):
    return t if isinstance(t, tuple) else (t,)


def compare(got, want, atol, rtol):
    """(max |got - want|, whether every element of got is finite and within
    atol + rtol * |want|) over a tensor or a tuple of them."""
    import torch

    worst, ok = 0.0, True
    for g, w in zip(as_tuple(got), as_tuple(want)):
        err = (g - w).abs()
        worst = max(worst, err.max().item())
        ok &= bool((err <= atol + rtol * w.abs()).all().item()) and bool(
            torch.isfinite(g).all().item())
    return worst, ok


def compare_scan(got, want):
    """compare() for K2's (y, pooled): pooled is a sum over the path of
    values the two versions round differently, so its bound scales with the
    sum of |y| over the path, not with the sum itself."""
    import torch

    (y, pooled), (ry, rpooled) = got, want
    worst, ok = compare(y, ry, SCAN_ATOL, SCAN_RTOL)
    err = (pooled - rpooled).abs()
    ok &= bool((err <= SCAN_ATOL + SCAN_RTOL * ry.abs().sum((2, 3))).all().item()) and bool(
        torch.isfinite(pooled).all().item())
    return max(worst, err.max().item()), ok


def compare_fused(got, want):
    """compare_scan() for K5's (y01, y23, pooled)."""
    import torch

    (y01, y23, pooled), (r01, r23, rpooled) = got, want
    worst, ok = compare((y01, y23), (r01, r23), SCAN_ATOL, SCAN_RTOL)
    err = (pooled - rpooled).abs()
    sum_y = torch.cat([r01.abs().sum((2, 3)), r23.abs().sum((2, 3))], 1)
    ok &= bool((err <= SCAN_ATOL + SCAN_RTOL * sum_y).all().item()) and bool(
        torch.isfinite(pooled).all().item())
    return max(worst, err.max().item()), ok


def phase_kernel_vs_plain(device, batch=BATCH, shapes=BLOCK_SHAPES):
    """K1 against its plain version at each block shape, both LN variants.

    Before each shape, the GEMM core alone at K1's four product shapes
    (``gemm_yardstick``). Returns (max |delta|, per-forward kernel ms,
    per-forward plain ms, per-forward bound ms, what bounds it, per-forward
    3xTF32 bound ms), the per-forward figures summing each BiasFree shape's
    over its blocks.
    """
    import torch

    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.models.restormer import init_block_params
    from tpuir_torch.ops.fused_block import fused_transformer_block, fused_transformer_block_plain

    worst = 0.0
    fwd_ms = fwd_plain_ms = fwd_bytes = fwd_flops = fwd_gemm = 0.0
    with torch.inference_mode(), true_float32():
        for name, hw, C, heads, count in shapes:
            gemm = 0  # the four products' operations
            for label, images, M, N, K, per_image in k1_products(batch, hw, C):
                gemm_yardstick(f"K1 {name} {label}", images, M, N, K, per_image, device,
                               SEED + K)
                gemm += 2 * images * M * N * K
            for ln_bias in (False, True):
                p = {k: v.to(device) for k, v in
                     init_block_params(C, heads, ln_bias, SEED + C).items()}
                x = torch.from_numpy(
                    np.random.RandomState(SEED + hw).rand(batch, hw, hw, C).astype(np.float32)
                ).to(device).permute(0, 3, 1, 2)
                kern = lambda: fused_transformer_block(x, p, heads, ln_bias)  # noqa: E731
                plain = lambda: fused_transformer_block_plain(x, p, heads, ln_bias)  # noqa: E731
                got, want = kern(), plain()
                torch.cuda.synchronize()
                max_err, bound_ok = compare(got, want, ATOL, RTOL)
                del got, want
                t_kern, t_plain = timed_pair(kern, plain)
                nbytes, flops = k1_work(batch, hw, C, heads, ln_bias)
                b_ms, _ = bound(nbytes, flops)
                tc_ms = bound_tc(nbytes, gemm, flops)
                print(f"K1 {name:20s} B={batch} {hw}x{hw} C={C:3d} heads={heads} "
                      f"h={int(C * 2.66):4d} ln_bias={int(ln_bias)}  max|d|={max_err:.3e} "
                      f"(atol {ATOL:g} + rtol {RTOL:g}*|plain|: {'ok' if bound_ok else 'MISS'})  "
                      f"kernel {t_kern:.3f} ms  plain {t_plain:.3f} ms  bound {b_ms:.3f} ms "
                      f"(3xTF32: {tc_ms:.3f} ms)", flush=True)
                if not bound_ok:
                    fail(f"K1 disagrees with its plain version at {name} ln_bias={ln_bias}")
                worst = max(worst, max_err)
                if not ln_bias:
                    fwd_ms += count * t_kern
                    fwd_plain_ms += count * t_plain
                    fwd_bytes += count * nbytes
                    fwd_flops += count * flops
                    fwd_gemm += count * gemm
                del x, p
    return (worst, fwd_ms, fwd_plain_ms) + bound(fwd_bytes, fwd_flops) + (
        bound_tc(fwd_bytes, fwd_gemm, fwd_flops),)


def synthetic_image(h, w, seed):
    """A smooth uint8 test image (gradients plus a few discs), seeded."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([(yy / h), (xx / w), 0.5 + 0.5 * np.sin((xx + yy) / 23.0)], -1)
    for _ in range(6):
        cy, cx, r = rng.rand() * h, rng.rand() * w, 10 + rng.rand() * min(h, w) / 4
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.rand(3)
    return np.clip(np.round(img * 255), 0, 255).astype(np.uint8)


def noisy_image(clean, seed, sigma=UNET_NOISE):
    """A real-denoising input: clean plus seeded Gaussian noise, in uint8."""
    noise = np.random.RandomState(seed).randn(*clean.shape) * sigma
    return np.clip(np.round(clean + noise), 0, 255).astype(np.uint8)


def serve(model, images, sigma=SIGMA, targets=None):
    """Serve each image; with ``sigma`` the engine adds host AWGN, with
    ``sigma=None`` the image is served as it is. Scored against ``targets``
    (default: the images)."""
    from tpuir_torch.core.engine import run_model_inference
    from tpuir_torch.core.metrics import calculate_metrics

    outs = []
    for img, ref in zip(images, targets or images):
        pred, t_ms = run_model_inference(
            model, img, patch_size=model.patch_size, patch_overlap=model.patch_overlap,
            need_degradation=sigma is not None, noise_level=sigma,
        )
        if pred.shape != img.shape or pred.dtype != np.uint8:
            fail(f"output {pred.shape} {pred.dtype} for input {img.shape} {img.dtype}")
        psnr, ssim = calculate_metrics(pred, ref)
        if not (np.isfinite(psnr) and np.isfinite(ssim)):
            fail(f"non-finite metrics {psnr} {ssim}")
        outs.append((pred, t_ms, psnr, ssim))
    return outs


def chunks_for(model, h, w) -> int:
    from tpuir_torch.core.tiling import tile_indices

    _, hs, ws = tile_indices(h, w, model.patch_size, model.patch_overlap)
    return -(-len(hs) * len(ws) // model.batch_size)


def plain_twin(model, net):
    """The same weights as ``model`` with plain blocks, on its device."""
    from tpuir_torch.core.engine import InferenceModel

    net.load_state_dict(model.net.state_dict())
    return InferenceModel(
        name=f"{model.name} (plain)", net=net.to(model.device).eval(), device=model.device,
        patch_size=model.patch_size, patch_overlap=model.patch_overlap,
        pad_factor=model.pad_factor, batch_size=model.batch_size,
        compute_dtype=model.compute_dtype,
    )


def serve_and_check(label, model, plain, cpu_model, requests, per_chunk, order,
                    sigma=SIGMA, kernel_only=()):
    """Serve ``requests`` on the kernel and plain paths in the given order of
    rounds (``kernel_only`` requests first, in the kernel rounds only), with
    the kernels' counts set to 0 just before and read just after; check the
    counts against ``per_chunk(h, w)`` ({kernel: launches a forward chunk}),
    repeatability, kernel vs plain and card vs CPU (on the last request).
    With ``sigma=None`` the inputs are noisy images served as they are.
    Returns ({kernel: launches}, {path: Mpix/s over ``requests``},
    {(h, w): (the kernel path's output, its median ms)} over every request)."""
    import torch

    from tpuir_torch.ops import _kernels

    sizes = list(kernel_only) + list(requests)
    clean = [synthetic_image(h, w, SEED + i) for i, (h, w) in enumerate(sizes)]
    images = clean if sigma is not None else [
        noisy_image(c, SEED + 100 + i) for i, c in enumerate(clean)]
    shared = slice(len(kernel_only), None)
    mpix = sum(h * w for h, w in requests) / 1e6
    serve(model, images[-1:], sigma)  # warm-up: cuDNN and allocator, not counted
    serve(plain, images[-1:], sigma)
    torch.cuda.synchronize()
    paths = {"kernel": (model, images, clean), "plain": (plain, images[shared], clean[shared])}
    served = {"kernel": [], "plain": []}
    _kernels.reset_launches()
    for name in order:
        net, imgs, refs = paths[name]
        served[name].append(serve(net, imgs, sigma, refs))
    rounds = order.count("kernel")
    want = {}
    for h, w in sizes:
        for k, n in per_chunk(h, w).items():
            want[k] = want.get(k, 0) + n * chunks_for(model, h, w) * rounds
    launches = {k: _kernels.LAUNCHES[k] for k in want}
    for k, n in launches.items():
        print(f"{label}: {k} launches {n} (expected {want[k]} over {rounds} rounds of "
              f"{', '.join(f'{h}x{w}' for h, w in sizes)})", flush=True)
        if n != want[k]:
            fail(f"{k} launched {n} times on the {label} path, expected {want[k]}")

    for i, (h, w) in enumerate(kernel_only):
        pred, _, psnr, ssim = served["kernel"][0][i]
        if any(not np.array_equal(rnd[i][0], pred) for rnd in served["kernel"]):
            fail(f"the {label} kernel path is not repeatable on {h}x{w}")
        ms = float(np.median([rnd[i][1] for rnd in served["kernel"]]))
        print(f"{label} request {h}x{w}x3: PSNR {psnr:.4f} dB SSIM {ssim:.5f}  kernel path "
              f"{ms:.1f} ms {h * w / 1e3 / ms:.3f} Mpix/s (kernel path only)", flush=True)
    kernel_rounds = [rnd[shared] for rnd in served["kernel"]]
    total = {"kernel": 0.0, "plain": 0.0}
    for i, (h, w) in enumerate(requests):
        pred, _, psnr, ssim = kernel_rounds[0][i]
        ppred = served["plain"][0][i]
        if any(not np.array_equal(rnd[i][0], pred) for rnd in kernel_rounds):
            fail(f"the {label} kernel path is not repeatable on {h}x{w}")
        ms = {"kernel": float(np.median([rnd[i][1] for rnd in kernel_rounds])),
              "plain": float(np.median([rnd[i][1] for rnd in served["plain"]]))}
        lsb = int(np.abs(pred.astype(int) - ppred[0].astype(int)).max())
        for k in total:
            total[k] += ms[k]
        print(f"{label} request {h}x{w}x3: PSNR {psnr:.4f} dB SSIM {ssim:.5f}  kernel path "
              f"{ms['kernel']:.1f} ms {h * w / 1e3 / ms['kernel']:.3f} Mpix/s  plain path "
              f"{ms['plain']:.1f} ms {h * w / 1e3 / ms['plain']:.3f} Mpix/s  "
              f"max|kernel-plain| {lsb} LSB", flush=True)
        if lsb > 1:
            fail(f"{label}: kernel and plain paths differ by {lsb} uint8 LSB on {h}x{w}")

    # the last request once more, on the CPU: an independent float32 reference
    (cpu_pred, _, _, _), = serve(cpu_model, images[-1:], sigma, clean[-1:])
    lsb = int(np.abs(cpu_pred.astype(int) - served["kernel"][0][-1][0].astype(int)).max())
    print(f"{label} request {requests[-1][0]}x{requests[-1][1]}x3 card vs CPU: max {lsb} LSB",
          flush=True)
    if lsb > 1:
        fail(f"{label}: card and CPU differ by {lsb} uint8 LSB")
    rate = {k: mpix / (v / 1e3) for k, v in total.items()}
    print(f"{label} engine over the {len(requests)} requests ({mpix:.4f} Mpix): kernel path "
          f"{rate['kernel']:.3f} Mpix/s, plain path {rate['plain']:.3f} Mpix/s", flush=True)
    outs = {hw: (served["kernel"][0][i][0],
                 float(np.median([rnd[i][1] for rnd in served["kernel"]])))
            for i, hw in enumerate(sizes)}
    return launches, rate, outs


def phase_main_path(device, requests=REQUESTS):
    """Serve Restormer on the kernel and plain paths; returns
    ({"fused_transformer_block": launches}, {path: Mpix/s}, outputs)."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.models.restormer import Restormer, init_state_dict

    with tempfile.TemporaryDirectory(prefix="tpuir_torch_smoke_") as wdir:
        path = os.path.join(wdir, "Restormer", "denoising", "gaussian_color_denoising_sigma25.pth")
        os.makedirs(os.path.dirname(path))
        torch.save({"params": init_state_dict(CONFIG, seed=SEED)}, path)
        model = zoo.get_model_instance("denoising", "gaussian", "Restormer", gray=False,
                                       sigma=SIGMA, weights_dir=wdir, device=device)
        cpu_model = zoo.get_model_instance("denoising", "gaussian", "Restormer", gray=False,
                                           sigma=SIGMA, weights_dir=wdir, device="cpu")
    print(f"main path: Restormer color sigma={SIGMA}, {model.param_count:,} params, "
          f"patch {model.patch_size} overlap {model.patch_overlap} batch {model.batch_size}",
          flush=True)
    plain = plain_twin(model, Restormer(**CONFIG, fused=False))
    # ROUNDS rounds, the two paths in turns (k p, p k, k p)
    order = [n for r in range(ROUNDS) for n in (("kernel", "plain") if r % 2 == 0
                                                else ("plain", "kernel"))]
    return serve_and_check("Restormer", model, plain, cpu_model, requests,
                           lambda h, w: {"fused_transformer_block": 44}, order)


def mixer_weights(sd, prefix, device):
    """A mixer's weights (its keys under ``prefix``) on ``device``, with its
    widths: (weights, d_model, d_inner, d_state)."""
    w = {k[len(prefix):]: v.to(device) for k, v in sd.items() if k.startswith(prefix)}
    two_di, dm = w["in_proj.weight"].shape
    return w, dm, two_di // 2, w["A_logs"].shape[1]


def mixer_operands(w, batch, hw, seed):
    """The operands of K6, K2 and K7 for mixer weights ``w`` on a unit-scale
    input of (batch, H, W), made by the plain versions: (prologue args,
    scan kwargs, epilogue kwargs, {kernel: its plain output}, {kernel: its
    plain version's ms}, each call timed once from CUDA events)."""
    import torch

    from tpuir_torch.ops.nss_epilogue import mixer_epilogue_plain
    from tpuir_torch.ops.nss_prologue import mixer_prologue_plain
    from tpuir_torch.ops.nss_stripe import nss_scan_plain

    want, plain_ms = {}, {}

    def timed(name, fn, *args, **kw):
        out = []
        plain_ms[name] = cuda_ms(lambda: out.append(fn(*args, **kw)), 1)
        want[name] = out[0]
        return out[0]

    di, dm = w["in_proj.weight"].shape[0] // 2, w["in_proj.weight"].shape[1]
    n = w["A_logs"].shape[1]
    h_img, w_img = hw
    device = w["in_proj.weight"].device
    h = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        batch, h_img, w_img, dm).astype(np.float32)).to(device)
    pro = (h, w["in_proj.weight"], w["conv2d.weight"], w["conv2d.bias"])
    x, z = timed("mixer_prologue", mixer_prologue_plain, *pro)
    scan = dict(x=x, x_proj_w=w["x_proj_weight"], dt_w=w["dt_projs_weight"],
                A=-torch.exp(w["A_logs"]).reshape(4, di, n), D=w["Ds"].reshape(4, di),
                delta_bias=w["dt_projs_bias"])
    y, pooled = timed("nss_scan", nss_scan_plain, **scan)
    gw = w["gating.gating.1.weight"].reshape(di, 4, 4)
    gb = w["gating.gating.1.bias"].reshape(di, 4)
    gates = torch.sigmoid(torch.einsum("bid,doi->bod", pooled / (h_img * w_img), gw)
                          + gb.t()[None]).contiguous()
    epi = dict(y=y, gates=gates, z=z, ln_w=w["out_norm.weight"], ln_b=w["out_norm.bias"],
               w_out=w["out_proj.weight"])
    timed("mixer_epilogue", mixer_epilogue_plain, **epi)
    return pro, scan, epi, want, plain_ms


def mixer_inputs(device, batch, hw, seed=SEED):
    """Seeded MaIR-CDN mixer weights (block 0 of the released layout) and the
    activations the plain mixer makes from a unit-scale input of (batch, H, W)."""
    from tpuir_torch import zoo
    from tpuir_torch.models.mair import init_state_dict

    w, _, _, _ = mixer_weights(init_state_dict(zoo.MAIR_CDN_CONFIG, seed=seed),
                               "layers.0.residual_group.blocks.0.self_attention.", device)
    return mixer_operands(w, batch, hw, seed)[:3]


def phase_mair_kernels(device):
    """K6, K2 and K7 against their plain versions at MaIR-CDN@128, batch 8
    (K2 also at the 96x72 tile, batch 1), after the GEMM core alone at K6's
    in_proj shape (``gemm_yardstick``). Returns {kernel: (max|d|, ms, plain
    ms, bound ms, bound by)}, each per call at batch 8, 128x128 (K2: the
    mean over both shifts)."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.ops.nss_epilogue import mixer_epilogue, mixer_epilogue_plain
    from tpuir_torch.ops.nss_prologue import mixer_prologue, mixer_prologue_plain
    from tpuir_torch.ops.nss_stripe import nss_scan, nss_scan_plain

    cfg = zoo.MAIR_CDN_CONFIG
    dm = cfg["embed_dim"]
    di = int(cfg["ssm_ratio"] * dm)
    n, r = cfg["d_state"], -(-dm // 16)
    res = {}
    with torch.inference_mode(), true_float32():
        t = MAIR_TILE
        pro, scan, epi = mixer_inputs(device, BATCH, (t, t))
        px = BATCH * t * t
        gemm_yardstick(f"K6 MaIR-CDN@{t} in_proj", 1, px, 2 * di, dm, False, device, SEED)
        gemm_yardstick(f"K7 MaIR-CDN@{t} out_proj", 1, px, dm, di, False, device, SEED)
        plain_bound = lambda g, w: compare(g, w, ATOL, RTOL)  # noqa: E731
        cases = [
            ("mixer_prologue", f"K6 B={BATCH} {t}x{t}", lambda: mixer_prologue(*pro),
             lambda: mixer_prologue_plain(*pro), plain_bound, ITERS, ITERS,
             prologue_work(px, dm, di)),
            ("mixer_epilogue", f"K7 B={BATCH} {t}x{t}", lambda: mixer_epilogue(**epi),
             lambda: mixer_epilogue_plain(**epi), plain_bound, ITERS, ITERS,
             epilogue_work(px, di, dm, BATCH)),
        ]
        for shift in (False, True):
            cases.append((
                "nss_scan", f"K2 B={BATCH} {t}x{t} shift={int(shift)}",
                lambda shift=shift: nss_scan(**scan, shift=shift),
                lambda shift=shift: nss_scan_plain(**scan, shift=shift),
                compare_scan, 3, 1, scan_work(px, di, n, r)))
        for name, label, kern, plain, check, iters, plain_iters, work in cases:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            max_err, ok = check(got, want)
            del got, want
            t_kern, t_plain = timed_pair(kern, plain, iters, plain_iters)
            b_ms, b_by = bound(*work)
            tol = (f"atol {SCAN_ATOL:g} + rtol {SCAN_RTOL:g}*|plain| (pooled: *sum|y|)"
                   if name == "nss_scan" else f"atol {ATOL:g} + rtol {RTOL:g}*|plain|")
            print(f"{label:26s} max|d|={max_err:.3e} ({tol}: {'ok' if ok else 'MISS'})  "
                  f"kernel {t_kern:.3f} ms  plain {t_plain:.3f} ms  bound {b_ms:.3f} ms ({b_by})",
                  flush=True)
            if not ok:
                fail(f"{label} disagrees with its plain version")
            prev = res.get(name)
            row = (max_err, t_kern, t_plain, b_ms, b_by)
            if prev:  # K2: the mean over both shifts
                row = (max(prev[0], max_err), (prev[1] + t_kern) / 2, (prev[2] + t_plain) / 2,
                       b_ms, b_by)
            res[name] = row
        del pro, scan, epi

        # the rectangular tile the 96x72 request gives (K2a's case)
        _, scan, _ = mixer_inputs(device, 1, (96, 72))
        for shift in (False, True):
            got = nss_scan(**scan, shift=shift)
            want = nss_scan_plain(**scan, shift=shift)
            torch.cuda.synchronize()
            max_err, ok = compare_scan(got, want)
            print(f"K2 B=1 96x72 shift={int(shift)}      max|d|={max_err:.3e} "
                  f"({'ok' if ok else 'MISS'})", flush=True)
            if not ok:
                fail(f"K2 disagrees with its plain version at 96x72 shift={shift}")
            res["nss_scan"] = (max(res["nss_scan"][0], max_err),) + res["nss_scan"][1:]
    return res


def phase_mair_path(device, requests=MAIR_REQUESTS):
    """Serve MaIR-CDN on the kernel and plain paths; returns
    ({kernel: launches}, {path: Mpix/s}, {(h, w): (kernel output, ms)})."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.models.mair import MaIR, init_state_dict

    with tempfile.TemporaryDirectory(prefix="tpuir_torch_smoke_") as wdir:
        path = os.path.join(wdir, "MaIR", "denoising", f"MaIR_CDN_s{SIGMA}.pth")
        os.makedirs(os.path.dirname(path))
        torch.save({"params": init_state_dict(zoo.MAIR_CDN_CONFIG, seed=SEED)}, path)
        model = zoo.get_model_instance("denoising", "gaussian", "MaIR", sigma=SIGMA,
                                       weights_dir=wdir, device=device)
        cpu_model = zoo.get_model_instance("denoising", "gaussian", "MaIR", sigma=SIGMA,
                                           weights_dir=wdir, device="cpu")
    print(f"main path: MaIR-CDN sigma={SIGMA}, {model.param_count:,} params, "
          f"patch {model.patch_size} overlap {model.patch_overlap} batch {model.batch_size}",
          flush=True)
    plain = plain_twin(model, MaIR(**zoo.MAIR_CDN_CONFIG, fused=False))
    # the plain scan is slow: one plain round between the kernel rounds
    order = ["kernel", "plain"] + ["kernel"] * (ROUNDS - 1)
    per_chunk = dict.fromkeys(("mixer_prologue", "nss_scan", "mixer_epilogue"), MAIR_BLOCKS)
    return serve_and_check("MaIR", model, plain, cpu_model, requests, lambda h, w: per_chunk,
                           order)


def check_case(label, kern, want, check, iters, plain_ms, work, repeat=False):
    """Run kern once against the plain result ``want`` (and, with
    ``repeat``, once more for bit-for-bit repeatability), time it from CUDA
    events, print one line and fail on a miss. Returns (max|d|, kernel ms,
    plain ms, bound ms, bound by)."""
    import torch

    got = kern()
    torch.cuda.synchronize()
    max_err, ok = check(got, want)
    if repeat and not all(map(torch.equal, as_tuple(got), as_tuple(kern()))):
        fail(f"{label} does not repeat bit for bit")
    del got
    t_kern = cuda_ms(kern, iters)
    b_ms, b_by = bound(*work)
    print(f"{label:34s} max|d|={max_err:.3e} ({'ok' if ok else 'MISS'})  kernel {t_kern:.3f} ms  "
          f"plain {plain_ms:.3f} ms  bound {b_ms:.3f} ms ({b_by})", flush=True)
    if not ok:
        fail(f"{label} disagrees with its plain version")
    return max_err, t_kern, plain_ms, b_ms, b_by


def phase_unet_kernels(device):
    """K6, K2 and K7 at MaIRUNet's five level shapes of a 384x384 tile at
    batch 8, K2 at the 384x328 tile (batch 2), and K3 at the 481x321
    request's two K3 levels (batch 2), each against its plain version (TF32
    off), the plain version timed once a shape. Returns ({kernel: max|d|},
    {row label: (max|d|, ms, plain ms, bound ms, bound by)}, K3's row per
    forward chunk of the 481x321 request, K3's state updates a chunk). The
    GEMM core alone runs at each level's in_proj shape first
    (``gemm_yardstick``)."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.models.mair_unet import init_state_dict
    from tpuir_torch.ops.nss_epilogue import mixer_epilogue
    from tpuir_torch.ops.nss_prologue import mixer_prologue
    from tpuir_torch.ops.nss_stripe import nss_scan
    from tpuir_torch.ops.scan_fused_proj import (selective_scan_fused_proj,
                                                 selective_scan_fused_proj_plain)
    from tpuir_torch.ops.scan_ids import scan_index_tensors

    sd = init_state_dict(zoo.MAIR_UNET_CONFIG, seed=SEED)
    worst, rows = {}, {}
    tc_fwd = {"K6": 0.0, "K7": 0.0}  # the 3xTF32 bounds per forward
    plain_bound = lambda g, w: compare(g, w, ATOL, RTOL)  # noqa: E731
    scan_bound = lambda g, w: compare(g, w, SCAN_ATOL, SCAN_RTOL)  # noqa: E731

    def keep(name, label, row):
        worst[name] = max(worst.get(name, 0.0), row[0])
        rows[label] = row

    with torch.inference_mode(), true_float32():
        cases = [(label, t, t, stage, BATCH) for label, t, stage, _ in UNET_LEVELS]
        cases.append(("rect", UNET_RECT[0], UNET_RECT[1], UNET_RECT[2], 2))
        for label, hh, ww, stage, batch in cases:
            w, dm, di, n = mixer_weights(sd, f"{stage}.0.self_attention.", device)
            r = w["dt_projs_weight"].shape[-1]
            px = batch * hh * ww
            pro, scan, epi, want, plain_ms = mixer_operands(w, batch, (hh, ww), SEED)
            tag = f"B={batch} {hh}x{ww} Dm={dm} Di={di} N={n}"
            if label != "rect":
                gemm_yardstick(f"K6 MaIRUNet {label} in_proj", 1, px, 2 * di, dm, False, device,
                               SEED)
                gemm_yardstick(f"K7 MaIRUNet {label} out_proj", 1, px, dm, di, False, device,
                               SEED)
                calls = dict((lb, c) for lb, _, _, c in UNET_LEVELS)[label]
                for short, (nbytes, flops), gemm in (
                        ("K6", prologue_work(px, dm, di), px * 4 * dm * di),
                        ("K7", epilogue_work(px, di, dm, batch), px * 2 * di * dm)):
                    tc_fwd[short] += calls * bound_tc(nbytes, gemm, flops)
            kernels = [
                ("mixer_prologue", "K6", lambda: mixer_prologue(*pro), plain_bound,
                 prologue_work(px, dm, di)),
                ("nss_scan", "K2", lambda: nss_scan(**scan), compare_scan,
                 scan_work(px, di, n, r)),
                ("mixer_epilogue", "K7", lambda: mixer_epilogue(**epi), plain_bound,
                 epilogue_work(px, di, dm, batch)),
            ]
            for name, short, kern, check, work in kernels:
                if label == "rect" and name != "nss_scan":
                    continue  # the rectangular tile is K2a's case
                keep(name, f"{short} {label}", check_case(
                    f"{short} {tag}", kern, want[name], check, 3, plain_ms[name], work,
                    repeat=name == "nss_scan"))
            del pro, scan, epi, want, kernels
            torch.cuda.empty_cache()
        for short in ("K6", "K2", "K7"):
            fwd = [(count, rows[f"{short} {label}"]) for label, _, _, count in UNET_LEVELS]
            print(f"{short} per MaIRUNet@384 forward (batch {BATCH}, "
                  f"{sum(c for c, _ in fwd)} calls): kernel {sum(c * r[1] for c, r in fwd):.3f} "
                  f"ms, plain {sum(c * r[2] for c, r in fwd):.3f} ms, bound "
                  f"{sum(c * r[3] for c, r in fwd):.3f} ms"
                  + (f" (3xTF32: {tc_fwd[short]:.3f} ms)" if short in tc_fwd else ""), flush=True)

        k3_ms = k3_plain = k3_bytes = k3_flops = 0.0
        k3_updates = 0
        for label, hh, ww, stage, count in UNET_K3_LEVELS:
            w, dm, di, n = mixer_weights(sd, f"{stage}.0.self_attention.", device)
            r = w["dt_projs_weight"].shape[-1]
            _, scan, _, _, _ = mixer_operands(w, 2, (hh, ww), SEED)
            ids, _ = scan_index_tensors(hh, ww, 4, 0, device)
            L = hh * ww
            xs = scan["x"].reshape(2, L, di)[:, ids]
            args = (xs, scan["x_proj_w"], scan["dt_w"], scan["A"], scan["D"],
                    scan["delta_bias"])
            want = []
            plain_ms = cuda_ms(lambda: want.append(selective_scan_fused_proj_plain(*args)), 1)
            work = k3_work(2 * 4, L, di, n, r)
            row = check_case(f"K3 B=2 {hh}x{ww} Di={di} N={n}",
                             lambda: selective_scan_fused_proj(*args), want[0], scan_bound, 10,
                             plain_ms, work, repeat=True)
            updates = work[2]
            print(f"{'':34s} MUFU floor {mufu_ms(updates):.4f} ms (one exp2 a state update, "
                  f"{updates:,} updates)", flush=True)
            keep("selective_scan_fused_proj", f"K3 {label}", row)
            k3_ms += count * row[1]
            k3_plain += count * row[2]
            k3_bytes += count * work[0]
            k3_flops += count * work[1]
            k3_updates += count * updates
            del scan, xs, args, want
    k3_row = ((worst["selective_scan_fused_proj"], k3_ms, k3_plain)
              + bound(k3_bytes, k3_flops, k3_updates))
    print(f"K3 per forward chunk of the 481x321 request (12 calls at 96x82, 8 at 48x41, "
          f"batch 2): kernel {k3_ms:.3f} ms, plain {k3_plain:.3f} ms, bound {k3_row[3]:.3f} ms "
          f"({k3_row[4]}), MUFU floor {mufu_ms(k3_updates):.3f} ms", flush=True)
    return worst, rows, k3_row, k3_updates


def unet_per_chunk(model, fused=False, serving=False):
    """{kernel: launches a forward chunk} of MaIRUNet for an h x w request:
    each stage's blocks on K6, K2 and K7 (with ``fused``: on K5) where its
    level's H and W are multiples of scan_len 4 (so even), else on K3, as
    the JAX module routes them (``tpuir/models/mair.py:196-213``); with
    ``serving``, their serving bodies."""
    from tpuir_torch.core.tiling import tile_indices

    def per_chunk(h, w):
        ps, _, _ = tile_indices(h, w, model.patch_size, model.patch_overlap)
        ph, pw = (-(-min(ps, s) // model.pad_factor) * model.pad_factor for s in (h, w))
        on_level = ("nss_scan_fused",) if fused else ("mixer_prologue", "nss_scan",
                                                      "mixer_epilogue")
        suffix = "_serving" if serving else ""
        out = {k + suffix: 0 for k in on_level + ("selective_scan_fused_proj",)}
        for stage, lvl in UNET_STAGES:
            n = len(getattr(model.net, stage))
            if (ph >> lvl) % 4 == 0 and (pw >> lvl) % 4 == 0:
                for k in on_level:
                    out[k + suffix] += n
            else:
                out["selective_scan_fused_proj" + suffix] += n
        return out

    return per_chunk


def phase_unet_path(device):
    """Serve MaIRUNet (real denoising) on the kernel and plain paths; returns
    ({kernel: launches}, {path: Mpix/s}, {(h, w): (kernel output, ms)})."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.models.mair_unet import MaIRUNet, init_state_dict

    with tempfile.TemporaryDirectory(prefix="tpuir_torch_smoke_") as wdir:
        path = os.path.join(wdir, "MaIR", "denoising", "MaIR_RealDN.pth")
        os.makedirs(os.path.dirname(path))
        torch.save({"params": init_state_dict(zoo.MAIR_UNET_CONFIG, seed=SEED)}, path)
        model = zoo.get_model_instance("denoising", "real", "MaIR", weights_dir=wdir,
                                       device=device)
        cpu_model = zoo.get_model_instance("denoising", "real", "MaIR", weights_dir=wdir,
                                           device="cpu")
    print(f"main path: MaIRUNet real denoising, {model.param_count:,} params, "
          f"patch {model.patch_size} overlap {model.patch_overlap} batch {model.batch_size}",
          flush=True)
    per_chunk = unet_per_chunk(model)
    for h, w in UNET_KERNEL_ONLY + UNET_REQUESTS:
        print(f"MaIRUNet {h}x{w}: {chunks_for(model, h, w)} chunks, per chunk "
              f"{per_chunk(h, w)}", flush=True)
    plain = plain_twin(model, MaIRUNet(**zoo.MAIR_UNET_CONFIG, fused=False))
    # the plain scan is slow: one plain round between the kernel rounds
    order = ["kernel", "plain"] + ["kernel"] * (ROUNDS - 1)
    return serve_and_check("MaIRUNet", model, plain, cpu_model, UNET_REQUESTS, per_chunk,
                           order, sigma=None, kernel_only=UNET_KERNEL_ONLY)


def scan_operands(w, batch, hw, seed):
    """K2's and K5's operands for mixer weights ``w``: x from the plain
    prologue on a unit-scale input of (batch, H, W), and the scan weights."""
    import torch

    from tpuir_torch.ops.nss_prologue import mixer_prologue_plain

    di, dm = w["in_proj.weight"].shape[0] // 2, w["in_proj.weight"].shape[1]
    n = w["A_logs"].shape[1]
    h = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        batch, hw[0], hw[1], dm).astype(np.float32)).to(w["in_proj.weight"].device)
    x, _ = mixer_prologue_plain(h, w["in_proj.weight"], w["conv2d.weight"], w["conv2d.bias"])
    return dict(x=x, x_proj_w=w["x_proj_weight"], dt_w=w["dt_projs_weight"],
                A=-torch.exp(w["A_logs"]).reshape(4, di, n), D=w["Ds"].reshape(4, di),
                delta_bias=w["dt_projs_bias"])


def phase_fused_kernels(device):
    """K5 against its plain version (TF32 off): MaIR-CDN@128 at batch 8 with
    the shift off and on (timed in turns, plain kernel kernel plain), the
    96x72 tile at batch 1, MaIRUNet's five level shapes of a 384x384 tile
    at batch 8 and the 384x328 tile at batch 2 (the plain version timed once
    a shape); it must repeat bit for bit. Returns (max|d|, ms, plain ms,
    bound ms, bound by), per call at MaIR-CDN@128, the mean over both
    shifts."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.models.mair_unet import init_state_dict
    from tpuir_torch.ops.nss_fused import nss_scan_fused, nss_scan_fused_plain

    cfg = zoo.MAIR_CDN_CONFIG
    dm = cfg["embed_dim"]
    di, n, r = int(cfg["ssm_ratio"] * dm), cfg["d_state"], -(-dm // 16)
    worst, cdn = 0.0, []
    with torch.inference_mode(), true_float32():
        t = MAIR_TILE
        _, scan, _ = mixer_inputs(device, BATCH, (t, t))
        for shift in (False, True):
            kern = lambda shift=shift: nss_scan_fused(**scan, shift=shift)  # noqa: E731
            plain = lambda shift=shift: nss_scan_fused_plain(**scan, shift=shift)  # noqa: E731
            got, want = kern(), plain()
            torch.cuda.synchronize()
            max_err, ok = compare_fused(got, want)
            if not all(map(torch.equal, got, kern())):
                fail(f"K5 at {t}x{t} shift={shift} does not repeat bit for bit")
            del got, want
            t_kern, t_plain = timed_pair(kern, plain, 3, 1)
            b_ms, b_by = bound(*k5_work(BATCH * t * t, di, n, r))
            print(f"K5 B={BATCH} {t}x{t} shift={int(shift)}      max|d|={max_err:.3e} "
                  f"({'ok' if ok else 'MISS'})  kernel {t_kern:.3f} ms  plain {t_plain:.3f} ms  "
                  f"bound {b_ms:.3f} ms ({b_by})", flush=True)
            if not ok:
                fail(f"K5 disagrees with its plain version at {t}x{t} shift={shift}")
            worst = max(worst, max_err)
            cdn.append((t_kern, t_plain, b_ms, b_by))
        del scan
        # the rectangular tile the 96x72 request gives: y23 is 72x96
        _, scan, _ = mixer_inputs(device, 1, (96, 72))
        for shift in (False, True):
            got = nss_scan_fused(**scan, shift=shift)
            max_err, ok = compare_fused(got, nss_scan_fused_plain(**scan, shift=shift))
            print(f"K5 B=1 96x72 shift={int(shift)}      max|d|={max_err:.3e} "
                  f"({'ok' if ok else 'MISS'})", flush=True)
            if not ok:
                fail(f"K5 disagrees with its plain version at 96x72 shift={shift}")
            worst = max(worst, max_err)
        del scan

        sd = init_state_dict(zoo.MAIR_UNET_CONFIG, seed=SEED)
        cases = [(label, tt, tt, stage, BATCH, count) for label, tt, stage, count in UNET_LEVELS]
        cases.append(("rect", UNET_RECT[0], UNET_RECT[1], UNET_RECT[2], 2, 0))
        fwd = [0.0, 0.0, 0.0]
        for label, hh, ww, stage, batch, count in cases:
            w, dm_, di_, n_ = mixer_weights(sd, f"{stage}.0.self_attention.", device)
            scan = scan_operands(w, batch, (hh, ww), SEED)
            want = []
            plain_ms = cuda_ms(lambda: want.append(nss_scan_fused_plain(**scan)), 1)
            row = check_case(f"K5 B={batch} {hh}x{ww} Dm={dm_} Di={di_} N={n_}",
                             lambda: nss_scan_fused(**scan), want[0], compare_fused, 3, plain_ms,
                             k5_work(batch * hh * ww, di_, n_, w["dt_projs_weight"].shape[-1]),
                             repeat=True)
            worst = max(worst, row[0])
            for i in range(3):
                fwd[i] += count * row[1 + i]
            del scan, want
            torch.cuda.empty_cache()
        print(f"K5 per MaIRUNet@384 forward on the fused route (batch {BATCH}, "
              f"{sum(c for *_, c in cases)} calls): kernel {fwd[0]:.3f} ms, plain {fwd[1]:.3f} ms, "
              f"bound {fwd[2]:.3f} ms", flush=True)
    mean = lambda i: sum(c[i] for c in cdn) / len(cdn)  # noqa: E731
    return worst, mean(0), mean(1), mean(2), cdn[0][3]


def serve_kernel_rounds(label, model, images, sizes, per_chunk, sigma, refs=None):
    """Serve ``images`` ROUNDS times on ``model`` with the kernels' counts
    set to 0 just before and read just after; check the counts against
    ``per_chunk(h, w)`` (kernels not named there must not launch) and
    repeatability. Returns ({kernel: launches}, [(output, median ms)])."""
    import torch

    from tpuir_torch.ops import _kernels

    serve(model, images[-1:], sigma, (refs or images)[-1:])  # warm-up, not counted
    torch.cuda.synchronize()
    _kernels.reset_launches()
    rounds = [serve(model, images, sigma, refs) for _ in range(ROUNDS)]
    launches = dict(_kernels.LAUNCHES)
    want = dict.fromkeys(launches, 0)
    for h, w in sizes:
        for k, n in per_chunk(h, w).items():
            want[k] += n * chunks_for(model, h, w) * ROUNDS
    for k, n in launches.items():
        if n or want[k]:
            print(f"{label}: {k} launches {n} (expected {want[k]} over {ROUNDS} rounds of "
                  f"{', '.join(f'{h}x{w}' for h, w in sizes)})", flush=True)
        if n != want[k]:
            fail(f"{k} launched {n} times on the {label} path, expected {want[k]}")
    outs = []
    for i, (h, w) in enumerate(sizes):
        pred = rounds[0][i][0]
        if any(not np.array_equal(rnd[i][0], pred) for rnd in rounds):
            fail(f"the {label} kernel path is not repeatable on {h}x{w}")
        outs.append((pred, float(np.median([rnd[i][1] for rnd in rounds]))))
    return {k: n for k, n in launches.items() if n}, outs


def lsb(a, b) -> int:
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def phase_fused_path(device, mair_stripe, unet_stripe):
    """Serve MaIR-CDN and MaIRUNet built with ``nss="fused"``: MaIR-CDN's
    three requests (36 K5 launches a chunk, no K6, K2 or K7) within 1 LSB of
    the stripe route's kernel outputs ``mair_stripe`` ({(h, w): (output,
    ms)}), of the fused route's plain path and of the CPU on 96x72; MaIRUNet's
    481x321 request (24 K5 and 20 K3 launches a chunk) within 1 LSB of
    ``unet_stripe``. Returns {kernel: launches}."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.models.mair import MaIR
    from tpuir_torch.models.mair import init_state_dict as mair_state_dict
    from tpuir_torch.models.mair_unet import init_state_dict as unet_state_dict

    with tempfile.TemporaryDirectory(prefix="tpuir_torch_smoke_") as wdir:
        os.makedirs(os.path.join(wdir, "MaIR", "denoising"))
        torch.save({"params": mair_state_dict(zoo.MAIR_CDN_CONFIG, seed=SEED)},
                   os.path.join(wdir, "MaIR", "denoising", f"MaIR_CDN_s{SIGMA}.pth"))
        torch.save({"params": unet_state_dict(zoo.MAIR_UNET_CONFIG, seed=SEED)},
                   os.path.join(wdir, "MaIR", "denoising", "MaIR_RealDN.pth"))
        model = zoo.get_model_instance("denoising", "gaussian", "MaIR", sigma=SIGMA,
                                       weights_dir=wdir, device=device, nss="fused")
        cpu_model = zoo.get_model_instance("denoising", "gaussian", "MaIR", sigma=SIGMA,
                                           weights_dir=wdir, device="cpu", nss="fused")
        unet = zoo.get_model_instance("denoising", "real", "MaIR", weights_dir=wdir,
                                      device=device, nss="fused")
    print(f"fused route: MaIR-CDN sigma={SIGMA} and MaIRUNet real denoising, nss=fused",
          flush=True)
    images = [synthetic_image(h, w, SEED + i) for i, (h, w) in enumerate(MAIR_REQUESTS)]
    launches, outs = serve_kernel_rounds(
        "MaIR-CDN fused", model, images, MAIR_REQUESTS,
        lambda h, w: {"nss_scan_fused": MAIR_BLOCKS}, SIGMA)
    for (h, w), (pred, ms) in zip(MAIR_REQUESTS, outs):
        diff = lsb(pred, mair_stripe[(h, w)][0])
        print(f"MaIR-CDN fused request {h}x{w}x3: kernel path {ms:.1f} ms "
              f"{h * w / 1e3 / ms:.3f} Mpix/s (stripe route {mair_stripe[(h, w)][1]:.1f} ms)  "
              f"max|fused-stripe| {diff} LSB", flush=True)
        if diff > 1:
            fail(f"the fused and stripe routes differ by {diff} uint8 LSB on {h}x{w}")
    mpix = sum(h * w for h, w in MAIR_REQUESTS) / 1e6
    rate = mpix / (sum(ms for _, ms in outs) / 1e3)
    stripe_rate = mpix / (sum(mair_stripe[hw][1] for hw in MAIR_REQUESTS) / 1e3)
    print(f"MaIR-CDN engine over the {len(MAIR_REQUESTS)} requests ({mpix:.4f} Mpix): fused "
          f"route {rate:.3f} Mpix/s, stripe route {stripe_rate:.3f} Mpix/s", flush=True)
    # the last request on the fused route's plain path and on the CPU
    plain = plain_twin(model, MaIR(**zoo.MAIR_CDN_CONFIG, fused=False, nss="fused"))
    for name, net in (("plain path", plain), ("CPU", cpu_model)):
        (pred, _, _, _), = serve(net, images[-1:], SIGMA)
        diff = lsb(pred, outs[-1][0])
        h, w = MAIR_REQUESTS[-1]
        print(f"MaIR-CDN fused request {h}x{w}x3 kernel path vs {name}: max {diff} LSB",
              flush=True)
        if diff > 1:
            fail(f"the fused route's kernel path and {name} differ by {diff} LSB on {h}x{w}")
    del model, plain, cpu_model

    h, w = UNET_FUSED_REQUEST
    i = (UNET_KERNEL_ONLY + UNET_REQUESTS).index(UNET_FUSED_REQUEST)  # phase 7's image
    clean = synthetic_image(h, w, SEED + i)
    img = noisy_image(clean, SEED + 100 + i)
    per_chunk = unet_per_chunk(unet, fused=True)
    print(f"MaIRUNet fused {h}x{w}: {chunks_for(unet, h, w)} chunks, per chunk "
          f"{per_chunk(h, w)}", flush=True)
    unet_launches, ((pred, ms),) = serve_kernel_rounds(
        "MaIRUNet fused", unet, [img], [UNET_FUSED_REQUEST], per_chunk, None, [clean])
    diff = lsb(pred, unet_stripe[UNET_FUSED_REQUEST][0])
    print(f"MaIRUNet fused request {h}x{w}x3: kernel path {ms:.1f} ms {h * w / 1e3 / ms:.3f} "
          f"Mpix/s (stripe route {unet_stripe[UNET_FUSED_REQUEST][1]:.1f} ms, "
          f"{h * w / 1e3 / unet_stripe[UNET_FUSED_REQUEST][1]:.3f} Mpix/s)  "
          f"max|fused-stripe| {diff} LSB", flush=True)
    if diff > 1:
        fail(f"MaIRUNet's fused and stripe routes differ by {diff} uint8 LSB on {h}x{w}")
    for k, n in unet_launches.items():
        launches[k] = launches.get(k, 0) + n
    return launches


def phase_selective_scan(device):
    """K4: its entry point driven once on each of K4_CASES with the counts
    set to 0 just before and read just after, then each output held against
    ``selective_scan`` (TF32 off), repeated bit for bit and timed (CUDA
    events; plain once). Returns (launches, (max|d|, ms, plain ms, bound ms,
    bound by) at MaIR-CDN's shape)."""
    import torch

    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.ops import _kernels
    from tpuir_torch.ops.selective_scan import selective_scan, selective_scan_kernel

    gen = torch.Generator(device=device).manual_seed(SEED)

    def operands(b, k, L, d, n, with_d):
        f = lambda *s: torch.randn(*s, device=device, generator=gen)  # noqa: E731
        return dict(u=f(b, k, L, d), delta=f(b, k, L, d) * 0.5,
                    A=-torch.exp(f(k, d, n) * 0.5), Bmat=f(b, k, L, n), Cmat=f(b, k, L, n),
                    D=f(k, d) if with_d else None, delta_bias=f(k, d) * 0.3 if with_d else None)

    worst, first = 0.0, None
    with torch.inference_mode(), true_float32():
        cases = [(label, b, k, L, d, n, with_d, operands(b, k, L, d, n, with_d))
                 for label, b, k, L, d, n, with_d in K4_CASES]
        _kernels.reset_launches()
        ys = [selective_scan_kernel(**case[-1]) for case in cases]
        torch.cuda.synchronize()
        launches = _kernels.LAUNCHES["selective_scan"]
        print(f"K4 entry point: {launches} launches over {len(cases)} calls", flush=True)
        if launches != len(cases):
            fail(f"K4's entry point launched {launches} times for {len(cases)} calls")
        for (label, b, k, L, d, n, with_d, ops), y in zip(cases, ys):
            want = []
            plain_ms = cuda_ms(lambda: want.append(selective_scan(**ops)), 1)
            max_err, ok = compare(y, want[0], SCAN_ATOL, SCAN_RTOL)
            if not torch.equal(y, selective_scan_kernel(**ops)):
                fail(f"K4 {label} does not repeat bit for bit")
            del want
            t_kern = cuda_ms(lambda: selective_scan_kernel(**ops), ITERS)
            b_ms, b_by = bound(*k4_work(b * k, L, d, n))
            print(f"K4 {label:20s} B={b} K={k} L={L} D={d} N={n} D,bias={'yes' if with_d else 'no'}"
                  f"  max|d|={max_err:.3e} ({'ok' if ok else 'MISS'})  kernel {t_kern:.3f} ms  "
                  f"plain {plain_ms:.3f} ms  bound {b_ms:.3f} ms ({b_by})", flush=True)
            if not ok:
                fail(f"K4 disagrees with its plain version at {label}")
            worst = max(worst, max_err)
            first = first or (t_kern, plain_ms, b_ms, b_by)
        del cases, ys
        torch.cuda.empty_cache()
    return launches, (worst,) + first


def phase_probe(device, scan_ms):
    """P1 against ``probe_plain`` at the JAX probe's shapes (x (8, 512, 128),
    rounds 32) for each op, within PROBE_RTOL and bit for bit on repeat;
    then the rate entry point (counts set to 0 just before, read just after),
    the GEMM rates and the two scan floors beside ``scan_ms`` ({kernel: (ms
    a call, its state updates, its exp2 a state update)}): 3 mul + 3 fma +
    1 exp a state update, and the MUFU floor (the kernel's exp2 a state
    update), each at the measured rates and scaled to the kernel's updates. Returns (launches,
    (max rel|d|, mean ms, mean plain ms, bound ms, bound by) over the three
    ops at rounds 32); the bound is the larger of the bytes over 3.35 TB/s
    and the mean over the ops of their operations at ``P1_OP_PER_S``."""
    import torch

    from tpuir_torch.ops import _kernels
    from tpuir_torch.utils import micro_rate

    x = torch.from_numpy(np.random.RandomState(SEED).rand(
        micro_rate.STREAMS, *micro_rate.BLOCK).astype(np.float32)).to(device)
    worst, rows = 0.0, []
    for op in micro_rate.OPS:
        got = micro_rate.probe(x, op)
        want = micro_rate.probe_plain(x, op)
        rel = ((got - want).abs() / want.abs()).max().item()
        ok = rel <= PROBE_RTOL and bool(torch.isfinite(got).all().item())
        if not torch.equal(got, micro_rate.probe(x, op)):
            fail(f"P1 {op} does not repeat bit for bit")
        t_kern = cuda_ms(lambda: micro_rate.probe(x, op), ITERS)
        t_plain = cuda_ms(lambda: micro_rate.probe_plain(x, op), 3)
        t_bytes = 1e3 * 4 * (x.numel() + x[0].numel()) / HBM_BYTES_PER_S
        t_ops = 1e3 * x.numel() * micro_rate.ROUNDS / P1_OP_PER_S[op]
        b_ms, b_by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
        print(f"P1 {op:4s} x (8, 512, 128) rounds {micro_rate.ROUNDS}  max rel|d|={rel:.3e} "
              f"(rtol {PROBE_RTOL:g}: {'ok' if ok else 'MISS'})  kernel {t_kern:.4f} ms  "
              f"plain {t_plain:.3f} ms  bound {b_ms:.5f} ms ({b_by})", flush=True)
        if not ok:
            fail(f"P1 {op} disagrees with its plain version")
        worst = max(worst, rel)
        rows.append((t_kern, t_plain, t_bytes, t_ops))

    _kernels.reset_launches()
    rates = micro_rate.elementwise_rates(device)
    launches = _kernels.LAUNCHES["rate_probe"]
    if not launches:
        fail("the rate entry point launched no probe")
    for op, rate in rates.items():
        print(f"P1 rate {op:4s} {rate:12.1f} Gelem/s (rounds {micro_rate.TIMED_ROUNDS})",
              flush=True)
    for name, tf in micro_rate.gemm_rates(device).items():
        print(f"torch.matmul {name} 8192^3 {tf:9.1f} TFLOP/s", flush=True)
    floor, mufu = micro_rate.scan_floor_ms(rates), micro_rate.mufu_floor_ms(rates)
    print(f"scan floor at MaIR-CDN@128, batch 8, d_inner 234 (3 mul + 3 fma + 1 exp a state "
          f"update at the measured rates): {floor:.4f} ms; three-pass MUFU floor (2 exp2 a "
          f"state update at the measured exp2 rate): {mufu:.4f} ms; "
          + ", ".join(f"{k} {ms:.3f} ms ({ms / micro_rate.scan_floor_ms(rates, n):.2f}x, "
                      f"{ms / micro_rate.mufu_floor_ms(rates, n, exps):.2f}x its MUFU floor "
                      f"of {exps} exp2 an update)"
                      for k, (ms, n, exps) in scan_ms.items()),
          flush=True)
    mean = lambda i: sum(r[i] for r in rows) / len(rows)  # noqa: E731
    return launches, (worst, mean(0), mean(1), max(mean(2), mean(3)),
                      "bytes" if mean(2) >= mean(3) else "operations")


def k1_serving_products(batch, hw, C):
    """The products of K1's serving body on the core's bf16-operand kernel as
    (label, images, M, N, K, one weight an image): the attention apply
    (blockdiag(A_b), one C x C weight an image), the projection and
    project_out (K the gate's row stride, h rounded up to 8). qkv and
    project_in run fused with their depthwise convs."""
    hp, px = -(-int(C * 2.66) // 8) * 8, batch * hw * hw
    return [("apply", batch, hw * hw, C, C, True), ("proj", 1, px, C, C, False),
            ("ffn_out", 1, px, C, hp, False)]


def k1_serving_work(batch, hw, C, heads, ln_bias=False):
    """(bytes, tensor-core operations, other operations) of one serving
    block: bf16 x in and out, float32 weights once; its products (the four
    1x1 products, the Gram and the attention apply at one head's width) at
    the bf16 tensor-core rate; the depthwise convs and the GELU gate at the
    float32 rate."""
    h, hc, px = int(C * 2.66), C // heads, batch * hw * hw
    weights = 3 * C * C + 27 * C + heads + C * C + 2 * h * C + 18 * h + h * C + 2 * C
    weights += 2 * C if ln_bias else 0
    nbytes = 2 * 2 * px * C + 4 * weights
    gemm = px * (2 * C * 3 * C + 4 * C * hc + 2 * C * C + 2 * C * 2 * h + 2 * h * C)
    return nbytes, gemm, px * (18 * 3 * C + 18 * 2 * h + 8 * h)


def bound_bf16(nbytes, gemm_flops, flops, exps=0):
    """(least ms, what bounds it) for work of nbytes whose gemm_flops run on
    the tensor cores in bf16 and the other flops at the float32 rate, or
    whose ``exps`` exponentials take the special-function lanes longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(gemm_flops / BF16_FLOP_PER_S + flops / FP32_FLOP_PER_S, mufu_ms(exps) / 1e3)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gemm_bf16_yardstick(label, images, M, N, K, per_image, device, seed, core=True):
    """The GEMM core's bf16-operand kernel alone at one product shape
    (``ops/tc_gemm.gemm_bf16_operands``), held against float64 products of
    its bf16 operands, and beside ``torch.matmul`` on them in bf16 (a bf16
    output): prints max |error|, its share of atol + rtol * |ref| and
    TFLOP/s of each; fails if the core misses the tolerance. With ``core``
    False, ``torch.matmul`` alone: the library's time at a product shape
    that no standalone kernel of the port takes."""
    import torch

    from tpuir_torch.ops.tc_gemm import gemm_bf16_operands

    gen = torch.Generator(device=device).manual_seed(seed)
    a16 = torch.randn(images, M, K, device=device, generator=gen).to(torch.bfloat16)
    w16 = (torch.randn(*((images,) if per_image else ()), N, K, device=device,
                       generator=gen) * K ** -0.5).to(torch.bfloat16)
    tflop = 2 * images * M * N * K / 1e12
    with torch.inference_mode():
        mm = lambda: torch.matmul(a16, w16.transpose(-1, -2))  # noqa: E731
        kern = lambda: gemm_bf16_operands(a16, w16)  # noqa: E731
        ref = torch.matmul(a16.double(), w16.double().transpose(-1, -2))
        stats = []
        for fn in (kern, mm) if core else (mm,):
            err = (fn().double() - ref).abs()
            stats.append((err.max().item(), (err / (ATOL + RTOL * ref.abs())).max().item()))
            del err
        del ref
        mm()
        t_mm = cuda_ms(mm, ITERS)
        if not core:
            t_mm = (t_mm + cuda_ms(mm, ITERS)) / 2
            print(f"  torch.matmul bf16 {label:26s} {images}x({M}x{K} . {N}x{K}^T) "
                  f"{t_mm:.3f} ms {tflop / t_mm * 1e3:6.1f} TFLOP/s max|err| "
                  f"{stats[0][0]:.2e} (bf16 out; the library's yardstick, no kernel of the "
                  f"port's)", flush=True)
            return
        kern()
        t_core = (cuda_ms(kern, ITERS) + cuda_ms(kern, ITERS)) / 2
        t_mm = (t_mm + cuda_ms(mm, ITERS)) / 2
    print(f"  bf16-operand core {label:26s} {images}x({M}x{K} . {N}x{K}^T)  core {t_core:.3f} ms "
          f"{tflop / t_core * 1e3:6.1f} TFLOP/s max|err| {stats[0][0]:.2e} "
          f"({stats[0][1]:.3f} of tol)  torch.matmul bf16 {t_mm:.3f} ms "
          f"{tflop / t_mm * 1e3:6.1f} TFLOP/s max|err| {stats[1][0]:.2e} (bf16 out)", flush=True)
    if not stats[0][1] <= 1.0:
        fail(f"the bf16-operand core misses atol {ATOL:g} + rtol {RTOL:g} against float64 "
             f"products of its bf16 operands at {label}")


def ulp2_ratio(got, want) -> float:
    """max |got - want| in units of 2^-6 * max(|want|, 1), two bf16 ulps."""
    return ((got - want).abs() / (2.0 ** -6 * want.abs().clamp_min(1.0))).max().item()


def phase_serving_kernels(device, batch=BATCH, shapes=BLOCK_SHAPES):
    """K1's serving body stage by stage at each block shape, both LN
    variants, on bf16 inputs; bit for bit on repeat.

    End to end the body cannot be held to its plain version at these
    widths: a float32 sum that differs in its last bit from another order's
    flips a bf16 operand of the next product now and then, and the flips
    cascade. So each stage the kernel writes (``ops/fused_block.
    serving_stages``, its two parts on the check's own scratch) is held to
    its function of the kernel's own previous stage
    (``utils/serving_check.check_serving_stages``): the LayerNorm
    statistics, the Gram sums and the norms bit for bit against emulations
    of the kernel's float32 arithmetic, each product within 5e-5 + 1e-4
    |ref| of float64 sums of its bf16 operands, the bf16 output the
    rounding of a value within that of its float64 reference. The output
    against the plain version (max|d|, and tpuir's block criteria, two bf16
    ulps and 1/20 of the serving-parity gap) is printed beside, for the
    record. Before each shape, the bf16 core alone at the body's five
    product shapes (``gemm_bf16_yardstick``); after,
    the check's mutation controls (``mutant_controls("K1")``: 16 required
    faults). Returns (max |kernel -
    plain|, per-forward kernel ms, per-forward plain ms, bound ms, what
    bounds it), the per-forward figures summing each BiasFree shape's over
    its blocks.
    """
    import torch

    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.models.restormer import init_block_params
    from tpuir_torch.ops.fused_block import (
        fused_transformer_block,
        fused_transformer_block_plain,
        fused_transformer_block_serving_plain,
        serving_stages,
    )
    from tpuir_torch.utils.serving_check import check_serving_stages

    worst = 0.0
    fwd_ms = fwd_plain_ms = fwd_bytes = fwd_gemm = fwd_other = 0.0
    with torch.inference_mode(), true_float32():
        for name, hw, C, heads, count in shapes:
            for label, images, M, N, K, per_image in k1_serving_products(batch, hw, C):
                gemm_bf16_yardstick(f"K1s {name} {label}", images, M, N, K, per_image, device,
                                    SEED + K)
            for ln_bias in (False, True):
                p = {k: v.to(device) for k, v in
                     init_block_params(C, heads, ln_bias, SEED + C).items()}
                x = torch.from_numpy(
                    np.random.RandomState(SEED + hw).rand(batch, hw, hw, C).astype(np.float32)
                ).to(device).to(torch.bfloat16).permute(0, 3, 1, 2)
                kern = lambda: fused_transformer_block(  # noqa: E731
                    x, p, heads, ln_bias, serving=True)
                plain = lambda: fused_transformer_block_serving_plain(  # noqa: E731
                    x, p, heads, ln_bias)
                got, again = kern(), kern()
                torch.cuda.synchronize()
                repeat = torch.equal(got, again)
                stages = serving_stages(x, p, heads, ln_bias)
                # the two parts give the whole body's output (on a CPU tensor both are
                # plain versions, with different sum orders)
                parts = device.type != "cuda" or torch.equal(stages["out"], got)
                verdicts = check_serving_stages(x, p, heads, ln_bias, stages)
                del stages, again
                got, want = got.float(), plain().float()
                gap = (want - fused_transformer_block_plain(x.float(), p, heads, ln_bias)
                       ).abs().mean().item()
                max_err = (got - want).abs().max().item()
                tp_ratio, tp_mean = ulp2_ratio(got, want), (got - want).abs().mean().item() / gap
                del got, want
                t_kern, t_plain = timed_pair(kern, plain)
                nbytes, gemm, other = k1_serving_work(batch, hw, C, heads, ln_bias)
                b_ms, _ = bound_bf16(nbytes, gemm, other)
                missed = [v.name for v in verdicts if not v.ok]
                print(f"K1 serving {name:20s} B={batch} {hw}x{hw} C={C:3d} heads={heads} "
                      f"ln_bias={int(ln_bias)}  stages {'ok' if not missed else 'MISS'}; "
                      f"against plain max|d| {max_err:.3e} ({tp_ratio:.2f} x 2 ulps, mean "
                      f"{tp_mean:.3f} of the gap); repeat {'bit for bit' if repeat else 'DIFFERS'}"
                      f"; parts {'= whole' if parts else 'DIFFER'}  kernel {t_kern:.3f} ms  "
                      f"plain {t_plain:.3f} ms  bound {b_ms:.3f} ms"
                      + (f"  (the replaced body, recorded on an H100 at 700 W: "
                         f"{K1_SERVING_REPLACED_MS[name]:.3f} ms)" if not ln_bias else ""),
                      flush=True)
                for v in verdicts:
                    print(f"    {v.name:18s} {'ok  ' if v.ok else 'MISS'} {v.detail}", flush=True)
                if missed:
                    fail(f"K1 serving misses its stage checks at {name} ln_bias={ln_bias}: "
                         f"{', '.join(missed)}")
                if not repeat or not parts:
                    fail(f"K1 serving is not repeatable at {name} ln_bias={ln_bias}")
                worst = max(worst, max_err)
                if not ln_bias:
                    fwd_ms += count * t_kern
                    fwd_plain_ms += count * t_plain
                    fwd_bytes += count * nbytes
                    fwd_gemm += count * gemm
                    fwd_other += count * other
                del x, p
    torch.cuda.empty_cache()  # each copy's float64 check at level 1 holds several GB of the card
    mutant_controls("K1", jobs=4)
    return (worst, fwd_ms, fwd_plain_ms) + bound_bf16(fwd_bytes, fwd_gemm, fwd_other)


def phase_serving_path(device, parity_outs, requests=REQUESTS):
    """Serve Restormer through the zoo with ``precision="serving"`` on phase
    3's seeded weights and requests (host AWGN sigma 25), ROUNDS rounds: 44
    serving-body launches a chunk and no parity K1 launch, bit for bit on
    repeat, within SERVING_LSB of the same path with plain serving blocks,
    and within SERVING_PSNR_DB of phase 3's parity outputs ``parity_outs``
    ({(h, w): (output, ms)}) on every request; engine Mpix/s beside phase
    3's (``check_serving_path``). Returns {kernel: launches}."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.models.restormer import Restormer, init_state_dict

    with tempfile.TemporaryDirectory(prefix="tpuir_torch_smoke_") as wdir:
        path = os.path.join(wdir, "Restormer", "denoising", "gaussian_color_denoising_sigma25.pth")
        os.makedirs(os.path.dirname(path))
        torch.save({"params": init_state_dict(CONFIG, seed=SEED)}, path)
        model = zoo.get_model_instance("denoising", "gaussian", "Restormer", gray=False,
                                       sigma=SIGMA, weights_dir=wdir, precision="serving",
                                       device=device)
    print(f"serving path: Restormer color sigma={SIGMA}, precision=serving, compute_dtype "
          f"{model.compute_dtype}, patch {model.patch_size} batch {model.batch_size}", flush=True)
    clean = [synthetic_image(h, w, SEED + i) for i, (h, w) in enumerate(requests)]
    return check_serving_path(
        "Restormer serving", model, plain_twin(model, Restormer(**CONFIG, fused=False,
                                                                serving=True)),
        clean, requests, lambda h, w: {"fused_transformer_block_serving": 44}, SIGMA,
        parity_outs)


def check_serving_path(label, model, plain, images, sizes, per_chunk, sigma, parity_outs,
                       refs=None, psnr_db=SERVING_PSNR_DB):
    """Serve ``images`` (of ``sizes``) through the serving ``model`` ROUNDS
    times (``serve_kernel_rounds``: launches against ``per_chunk``, bit for
    bit on repeat) and once through its plain twin ``plain``; with ``sigma``
    the engine adds host AWGN, with None the images are served as they are,
    scored against ``refs`` (default: the images). On every request the
    serving output must lie within SERVING_LSB of the plain twin's, and its
    PSNR within ``psnr_db`` of the parity outputs ``parity_outs`` ({(h,
    w): (output, ms)}); engine Mpix/s is printed beside parity's. Returns
    {kernel: launches}."""
    from tpuir_torch.core.metrics import calculate_metrics

    refs = refs or images
    launches, outs = serve_kernel_rounds(label, model, images, sizes, per_chunk, sigma, refs)
    plain_outs = serve(plain, images, sigma, refs)
    for (h, w), ref, (pred, ms), (ppred, _, _, _) in zip(sizes, refs, outs, plain_outs):
        psnr, ssim = calculate_metrics(pred, ref)
        par_pred, par_ms = parity_outs[(h, w)]
        par_psnr, par_ssim = calculate_metrics(par_pred, ref)
        diff = lsb(pred, ppred)
        print(f"{label} request {h}x{w}x3: PSNR {psnr:.4f} dB SSIM {ssim:.5f} "
              f"(parity {par_psnr:.4f} dB {par_ssim:.5f}, delta {psnr - par_psnr:+.4f} dB, "
              f"max|serving-parity| {lsb(pred, par_pred)} LSB)  serving {ms:.1f} ms "
              f"{h * w / 1e3 / ms:.3f} Mpix/s (parity {par_ms:.1f} ms)  max|kernel-plain| "
              f"{diff} LSB", flush=True)
        if diff > SERVING_LSB:
            fail(f"the {label} path and its plain twin differ by {diff} LSB on {h}x{w}")
        if abs(psnr - par_psnr) > psnr_db:
            fail(f"{label} PSNR {psnr:.4f} dB is {psnr - par_psnr:+.4f} dB from parity on "
                 f"{h}x{w}")
    mpix = sum(h * w for h, w in sizes) / 1e6
    rate = mpix / (sum(ms for _, ms in outs) / 1e3)
    par_rate = mpix / (sum(parity_outs[hw][1] for hw in sizes) / 1e3)
    print(f"{label} engine over the {len(sizes)} requests ({mpix:.4f} Mpix): serving "
          f"{rate:.3f} Mpix/s, parity {par_rate:.3f} Mpix/s", flush=True)
    return launches


def serving_prologue_work(px, dm, di):
    """K6 serving: (bytes, products, other operations): h float32 in, x and z
    bf16 out, float32 weights; in_proj at the bf16 rate, the depthwise conv,
    bias + SiLU at the float32 rate."""
    return (4 * px * dm + 2 * 2 * px * di + 4 * (2 * di * dm + 10 * di),
            px * 2 * dm * 2 * di, px * (18 * di + 5 * di))


def serving_scan_work(px, di, n, r):
    """K2 serving: (bytes, products, other operations, exponentials): bf16 x
    in and bf16 y out, the id table, float32 weights; x_proj and dt_proj at
    the bf16 rate, the rest of ``scan_work`` at the float32 rate, one exp2 a
    state update."""
    c = r + 2 * n
    nbytes = 2 * px * di + 4 * 4 * px + 2 * 4 * px * di + 4 * 4 * (c * di + di * r + di * n
                                                                    + 2 * di)
    return (nbytes, 4 * px * (2 * c * di + 2 * r * di), 4 * px * (8 * di + 7 * di * n),
            4 * px * di * n)


def serving_epilogue_work(px, di, dm, images):
    """K7 serving: (bytes, products, other operations): four bf16 direction
    images and bf16 z in, float32 gates and weights, float32 out; out_proj at
    the bf16 rate, the gated sum, LayerNorm and SiLU gate at the float32
    rate."""
    return (2 * (4 * px * di + px * di) + 4 * (4 * images * di + 2 * di + dm * di + px * dm),
            px * 2 * di * dm, px * (8 * di + 8 * di + 6 * di))


def mixer_serving_bodies(pro, scan, epi, px, images, shifts=(False, True)):
    """The serving bodies of K6, K2 (at each of ``shifts``) and K7 on the
    operands ``mixer_operands`` makes (bf16 where a body takes bf16), for
    ``check_serving_body``: (kernel name, short label, shift, stages, their
    check, kernel, plain, the kernel's outputs among its stages, iterations
    timed, plain's, work) each, ``px`` pixels over ``images`` images."""
    import torch

    from tpuir_torch.ops.nss_epilogue import (mixer_epilogue, mixer_epilogue_serving_plain,
                                              mixer_epilogue_serving_stages)
    from tpuir_torch.ops.nss_prologue import (mixer_prologue, mixer_prologue_serving_plain,
                                              mixer_prologue_serving_stages)
    from tpuir_torch.ops.nss_stripe import (nss_scan, nss_scan_serving_plain,
                                            nss_scan_serving_stages)
    from tpuir_torch.utils import serving_check as ck

    bf = torch.bfloat16
    x = scan["x"].to(bf)
    sw = {k: v for k, v in scan.items() if k != "x"}
    y, z = epi["y"].to(bf), epi["z"].to(bf)
    ew = {k: v for k, v in epi.items() if k not in ("y", "z")}
    dm, di = pro[1].shape[1], pro[1].shape[0] // 2
    n, r = sw["A"].shape[-1], sw["dt_w"].shape[-1]
    bodies = [("mixer_prologue_serving", "K6s", None,
               lambda: mixer_prologue_serving_stages(*pro),
               lambda st: ck.check_prologue_serving(*pro, st),
               lambda: mixer_prologue(*pro, serving=True),
               lambda: mixer_prologue_serving_plain(*pro),
               lambda st: (st["x"], st["z"]), ITERS, ITERS, serving_prologue_work(px, dm, di))]
    for shift in shifts:
        bodies.append((
            "nss_scan_serving", "K2s", shift,
            lambda shift=shift: nss_scan_serving_stages(x, **sw, shift=shift),
            lambda st, shift=shift: ck.check_scan_serving(x, **sw, scan_len=4, shift=shift,
                                                          st=st),
            lambda shift=shift: nss_scan(x, **sw, shift=shift, serving=True),
            lambda shift=shift: nss_scan_serving_plain(x, **sw, shift=shift),
            lambda st: (st["y"], st["pooled"]), 3, 1, serving_scan_work(px, di, n, r)))
    bodies.append(("mixer_epilogue_serving", "K7s", None,
                   lambda: mixer_epilogue_serving_stages(y, z=z, **ew),
                   lambda st: ck.check_epilogue_serving(y, z=z, **ew, st=st),
                   lambda: mixer_epilogue(y, z=z, **ew, serving=True),
                   lambda: mixer_epilogue_serving_plain(y, z=z, **ew),
                   lambda st: st["out"], ITERS, ITERS, serving_epilogue_work(px, di, dm, images)))
    return bodies


def check_serving_body(label, stages, check, kern, plain, outs, work, iters=ITERS,
                       plain_iters=ITERS, timing="turns", replaced=None):
    """One serving body held stage by stage: its stage entry ``stages()``
    twice, bit for bit, the wrapper ``kern()``'s output the stages' ``outs``,
    each stage within ``check`` (``utils/serving_check.py``); its output
    against ``plain()`` (max|d|, and tpuir's criterion of two bf16 ulps)
    printed for the record. ``timing``: "turns" (CUDA events, plain,
    kernel, kernel, plain), "once" (the plain version timed once, the
    kernel over ``iters``) or None; ``replaced``: the recorded ms of the body
    this one replaced, printed beside as such. Prints one line and the
    stages, fails on a miss. Returns (max |kernel - plain|, ms, plain ms,
    bound ms, bound by) from ``work``'s ``bound_bf16``."""
    import torch

    st = {k: v.clone() for k, v in stages().items()}
    again = stages()
    got = kern()
    torch.cuda.synchronize()
    repeat = all(torch.equal(st[k], again[k]) for k in st) and all(
        torch.equal(g, s) for g, s in zip(as_tuple(got), as_tuple(outs(st))))
    del again
    verdicts = check(st)
    del st
    want = []
    t_plain = cuda_ms(lambda: want.append(plain()), 1)
    max_err, ulps = 0.0, 0.0
    for g, w in zip(as_tuple(got), as_tuple(want[0])):
        max_err = max(max_err, (g.float() - w.float()).abs().max().item())
        if g.dtype == torch.bfloat16:
            ulps = max(ulps, ulp2_ratio(g.float(), w.float()))
    del got, want
    t_kern = None
    if timing == "turns":
        t_kern, t_plain = timed_pair(kern, plain, iters, plain_iters)
    elif timing == "once":
        t_kern = cuda_ms(kern, iters)
    else:
        t_plain = None
    b_ms, b_by = bound_bf16(*work)
    missed = [v.name for v in verdicts if not v.ok]
    times = (f"kernel {t_kern:.3f} ms  plain {t_plain:.3f} ms  bound {b_ms:.3f} ms ({b_by})"
             if timing else "(not timed)")
    if timing and replaced is not None:
        times += f"  (the replaced body, recorded on an H100 at 700 W: {replaced:.3f} ms)"
    print(f"{label:30s} stages {'ok' if not missed else 'MISS'}; against plain max|d| "
          f"{max_err:.3e}" + (f" ({ulps:.2f} x 2 bf16 ulps)" if ulps else "")
          + f"; repeat {'bit for bit' if repeat else 'DIFFERS'}  {times}", flush=True)
    for v in verdicts:
        print(f"    {v.name:16s} {'ok  ' if v.ok else 'MISS'} {v.detail}", flush=True)
    if missed:
        fail(f"{label} misses its stage checks: {', '.join(missed)}")
    if not repeat:
        fail(f"{label} is not repeatable")
    return max_err, t_kern, t_plain, b_ms, b_by


def phase_mair_serving_kernels(device, batch=BATCH, tile=MAIR_TILE, rect=(96, 72)):
    """The serving bodies of K6, K2 and K7 stage by stage, timed, and their
    mutation controls.

    At MaIR-CDN@``tile``, batch ``batch`` (timed: plain, kernel, kernel,
    plain), and at the ``rect`` tile, batch 1, on phase 4's seeded
    activations (the plain parity mixer's, rounded to bf16 where a body
    takes bf16): each body's stages (``ops/*.mixer_*_serving_stages``,
    ``nss_scan_serving_stages``) twice, bit for bit, the wrapper's output
    the same, each stage held to its float64 function of the kernel's own
    previous stage (``utils/serving_check.py``); the output against the
    plain version (max|d|, and tpuir's criterion of two bf16 ulps) printed
    for the record; K6's, K2's and K7's times beside those of the bodies they
    replaced (``SERVING_REPLACED_MS``). Before, the bf16-operand core alone
    at K7's out_proj shape (K padded to 8) and ``torch.matmul`` bf16 at
    K6's in_proj shape (``gemm_bf16_yardstick``); after,
    ``utils/serving_mutants.run_mutants("mixer")``. Returns {kernel: (max
    |kernel - plain|, ms, plain ms, bound ms, bound by)} per call at
    ``tile``, K2 the mean over both shifts."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.ops.nss_epilogue import padded_inner

    cfg = zoo.MAIR_CDN_CONFIG
    dm = cfg["embed_dim"]
    di = int(cfg["ssm_ratio"] * dm)
    res = {}
    with torch.inference_mode(), true_float32():
        px = batch * tile * tile
        gemm_bf16_yardstick(f"K6s MaIR-CDN@{tile} in_proj", 1, px, 2 * di, dm, False, device,
                            SEED, core=False)
        gemm_bf16_yardstick(f"K7s MaIR-CDN@{tile} out_proj", 1, px, dm,
                            padded_inner(di, serving=True), False, device, SEED)
        for b, hw, timed in ((batch, (tile, tile), True), (1, rect, False)):
            pro, scan, epi = mixer_inputs(device, b, hw)
            px = b * hw[0] * hw[1]
            for (name, short, shift, stages, check, kern, plain, outs, iters, plain_iters,
                 work) in mixer_serving_bodies(pro, scan, epi, px, b):
                label = (f"{short} B={b} {hw[0]}x{hw[1]}"
                         + (f" shift={int(shift)}" if shift is not None else ""))
                replaced = SERVING_REPLACED_MS.get(short, {}).get(f"MaIR-CDN@{tile}")
                row = check_serving_body(label, stages, check, kern, plain, outs, work, iters,
                                         plain_iters, "turns" if timed else None, replaced)
                prev = res.get(name)
                if timed:
                    if prev and prev[1] is not None:  # K2: the mean over both shifts
                        row = (max(prev[0], row[0]), (prev[1] + row[1]) / 2,
                               (prev[2] + row[2]) / 2) + row[3:]
                else:
                    row = (max(prev[0], row[0]),) + prev[1:]
                res[name] = row
            del pro, scan, epi
            torch.cuda.empty_cache()
    mutant_controls("mixer", jobs=8)
    return res


def mutant_controls(bodies, jobs):
    """``utils/serving_mutants.run_mutants(bodies)``: each fault in its own
    copy of ``tpuir_torch/``, built there from this tree's objects (only
    the sources the fault reaches are recompiled), ``jobs`` copies at once;
    fails if the check accepts a required mutant or rejects the unmutated
    copy."""
    from tpuir_torch.utils.serving_mutants import failures, run_mutants

    t0 = time.time()
    verdicts = run_mutants(bodies, jobs=jobs)
    bad = failures(bodies, verdicts)
    print(f"{bodies} serving mutants ({time.time() - t0:.0f} s): "
          + (f"FAILED {bad}" if bad else "every required mutant rejected, the unmutated "
             "copy accepted"), flush=True)
    if bad:
        fail(f"the {bodies} serving check's mutation controls failed: {bad}")


def phase_mair_serving_path(device, parity_outs, requests=MAIR_REQUESTS):
    """Serve MaIR-CDN through the zoo with ``precision="serving"`` on phase
    5's seeded weights and requests (host AWGN sigma 25), ROUNDS rounds: 36
    launches a chunk of each serving body and none of the parity K6, K2 and
    K7, bit for bit on repeat, within SERVING_LSB of the same path with
    plain serving mixers, and within SERVING_PSNR_DB of phase 5's parity
    outputs ``parity_outs`` ({(h, w): (output, ms)}) on every request;
    engine Mpix/s beside phase 5's (``check_serving_path``). Returns
    {kernel: launches}."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.models.mair import MaIR, init_state_dict

    with tempfile.TemporaryDirectory(prefix="tpuir_torch_smoke_") as wdir:
        path = os.path.join(wdir, "MaIR", "denoising", f"MaIR_CDN_s{SIGMA}.pth")
        os.makedirs(os.path.dirname(path))
        torch.save({"params": init_state_dict(zoo.MAIR_CDN_CONFIG, seed=SEED)}, path)
        model = zoo.get_model_instance("denoising", "gaussian", "MaIR", sigma=SIGMA,
                                       weights_dir=wdir, precision="serving", device=device)
    print(f"serving path: MaIR-CDN sigma={SIGMA}, precision=serving, compute_dtype "
          f"{model.compute_dtype}, patch {model.patch_size} batch {model.batch_size}", flush=True)
    clean = [synthetic_image(h, w, SEED + i) for i, (h, w) in enumerate(requests)]
    return check_serving_path(
        "MaIR-CDN serving", model,
        plain_twin(model, MaIR(**zoo.MAIR_CDN_CONFIG, fused=False, serving=True)), clean,
        requests, lambda h, w: dict.fromkeys(MIXER_SERVING, MAIR_BLOCKS), SIGMA, parity_outs)


def serving_k3_work(seqs, L, di, n, r):
    """K3 serving: (bytes, products, other operations, exponentials): bf16 xs
    in, float32 y out, float32 weights; x_proj and dt_proj at the bf16
    rate, the rest of ``k3_work`` at the float32 rate, one exp2 a state
    update."""
    c, pos = r + 2 * n, seqs * L
    nbytes = 2 * pos * di + 4 * pos * di + 4 * 4 * (c * di + di * r + di * n + 2 * di)
    return (nbytes, pos * (2 * c * di + 2 * r * di), pos * (4 * di + 7 * di * n + 2 * di),
            pos * di * n)


def serving_k5_work(px, di, n, r):
    """K5 serving: ``serving_scan_work`` less the id table, which K5 does not read."""
    nbytes, gemm, other, exps = serving_scan_work(px, di, n, r)
    return nbytes - 4 * 4 * px, gemm, other, exps


def phase_seq_serving_kernels(device, levels=UNET_LEVELS, rect=UNET_RECT,
                              k3_levels=UNET_K3_LEVELS, tile=MAIR_TILE, cdn_batch=BATCH):
    """Phase 14's kernels: the serving bodies at MaIRUNet's widths and K3's
    and K5's serving bodies, each stage by stage (``check_serving_body``),
    bit for bit on repeat, timed beside its plain version; then their
    mutation controls (``utils/serving_mutants.py --bodies seq``).

    K6, K2 and K7 serving at MaIRUNet's five level shapes of a 384x384 tile
    (batch 8) and K2 serving at the 384x328 tile (batch 2), on phase 6's
    seeded weights and activations (bf16 where a body takes bf16), the plain
    version timed once; K3 serving at the 481x321 request's two K3 levels
    (batch 2), its plain version timed once; K5 serving at MaIR-CDN@128
    (batch 8, shift off and on, timed in turns), the 96x72 tile (batch 1,
    not timed) and the 384x328 tile (batch 2, MaIRUNet's level-0 weights,
    the plain version timed once). Returns ({kernel: (max |kernel - plain|,
    ms, plain ms, bound ms, bound by)} of K3 serving per forward chunk of
    the 481x321 request and K5 serving per call at MaIR-CDN@128 (the mean
    over both shifts), {kernel: max |kernel - plain|} of K6, K2 and K7
    serving here)."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.models.mair_unet import init_state_dict
    from tpuir_torch.ops.nss_fused import (nss_scan_fused, nss_scan_fused_serving_plain,
                                           nss_scan_fused_serving_stages)
    from tpuir_torch.ops.scan_fused_proj import (selective_scan_fused_proj,
                                                 selective_scan_fused_proj_serving_plain,
                                                 selective_scan_fused_proj_serving_stages)
    from tpuir_torch.ops.scan_ids import scan_index_tensors
    from tpuir_torch.utils import serving_check as ck

    bf = torch.bfloat16
    sd = init_state_dict(zoo.MAIR_UNET_CONFIG, seed=SEED)
    worst, rows = {}, {}
    fwd = {}  # per MaIRUNet@384 forward: [ms, plain ms, bytes, products, other, exps]

    def keep(name, row):
        worst[name] = max(worst.get(name, 0.0), row[0])

    with torch.inference_mode(), true_float32():
        cases = [(label, t, t, stage, BATCH, count) for label, t, stage, count in levels]
        cases.append(("rect", rect[0], rect[1], rect[2], 2, 0))
        for label, hh, ww, stage, b, count in cases:
            w, dm, di, n = mixer_weights(sd, f"{stage}.0.self_attention.", device)
            pro, scan, epi, _, _ = mixer_operands(w, b, (hh, ww), SEED)
            for (name, short, _, stages, check, kern, plain, outs, iters, _,
                 work) in mixer_serving_bodies(pro, scan, epi, b * hh * ww, b, (False,)):
                if label == "rect" and name != "nss_scan_serving":
                    continue  # the rectangular tile is K2a's case
                row = check_serving_body(f"{short} B={b} {hh}x{ww} Di={di} N={n}", stages,
                                         check, kern, plain, outs, work, 3, timing="once",
                                         replaced=SERVING_REPLACED_MS.get(short, {}).get(label))
                keep(name, row)
                acc = fwd.setdefault(short, [0.0] * 6)
                for i, v in enumerate(row[1:3] + work):
                    acc[i] += count * v
            del pro, scan, epi
            torch.cuda.empty_cache()
        for short, (ms, plain_ms, *work) in fwd.items():
            b_ms, b_by = bound_bf16(*work)
            was = SERVING_REPLACED_MS.get(short, {}).get("forward")
            print(f"{short} per MaIRUNet@384 forward (batch {BATCH}, "
                  f"{sum(c for *_, c in levels)} calls): kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})"
                  + (f" (the replaced body, recorded on an H100 at 700 W: {was:.2f} ms)"
                     if was else ""), flush=True)

        # K3 serving at the 481x321 request's two K3 levels, per forward chunk
        k3 = [0.0] * 6
        for label, hh, ww, stage, count in k3_levels:
            w, dm, di, n = mixer_weights(sd, f"{stage}.0.self_attention.", device)
            r = w["dt_projs_weight"].shape[-1]
            _, scan, _, _, _ = mixer_operands(w, 2, (hh, ww), SEED)
            ids, _ = scan_index_tensors(hh, ww, 4, 0, device)
            L = hh * ww
            xs = scan.pop("x").reshape(2, L, di)[:, ids].to(bf)
            work = serving_k3_work(2 * 4, L, di, n, r)
            row = check_serving_body(
                f"K3s B=2 {hh}x{ww} Di={di} N={n}",
                lambda: selective_scan_fused_proj_serving_stages(xs, **scan),
                lambda st: ck.check_seq_scan_serving(xs, **scan, st=st),
                lambda: selective_scan_fused_proj(xs, **scan, serving=True),
                lambda: selective_scan_fused_proj_serving_plain(xs, **scan),
                lambda st: st["y"], work, 10, timing="once")
            keep("selective_scan_fused_proj_serving", row)
            for i, v in enumerate(row[1:3] + work):
                k3[i] += count * v
            del scan, xs
        k3_row = ((worst["selective_scan_fused_proj_serving"], k3[0], k3[1])
                  + bound_bf16(*k3[2:]))
        print(f"K3 serving per forward chunk of the 481x321 request (12 calls at 96x82, 8 at "
              f"48x41, batch 2): kernel {k3[0]:.3f} ms, plain {k3[1]:.3f} ms, bound "
              f"{k3_row[3]:.3f} ms ({k3_row[4]})", flush=True)

        # K5 serving: MaIR-CDN@128 (timed in turns), 96x72, and the 384x328 tile
        cdn = []
        unet_w = mixer_weights(sd, f"{rect[2]}.0.self_attention.", device)[0]
        k5_cases = [(cdn_batch, (tile, tile), None, (False, True), "turns", f"MaIR-CDN@{tile}"),
                    (1, (96, 72), None, (False, True), None, None),
                    (2, rect[:2], unet_w, (False,), "once", "rect")]
        for b, (hh, ww), w, shifts, timing, key in k5_cases:
            scan = (mixer_inputs(device, b, (hh, ww))[1] if w is None
                    else scan_operands(w, b, (hh, ww), SEED))
            x = scan.pop("x").to(bf)
            di, n, r = x.shape[-1], scan["A"].shape[-1], scan["dt_w"].shape[-1]
            for shift in shifts:
                row = check_serving_body(
                    f"K5s B={b} {hh}x{ww} Di={di} N={n} shift={int(shift)}",
                    lambda: nss_scan_fused_serving_stages(x, **scan, shift=shift),
                    lambda st: ck.check_fused_scan_serving(x, **scan, scan_len=4, shift=shift,
                                                           st=st),
                    lambda: nss_scan_fused(x, **scan, shift=shift, serving=True),
                    lambda: nss_scan_fused_serving_plain(x, **scan, shift=shift),
                    lambda st: (st["y01"], st["y23"], st["pooled"]),
                    serving_k5_work(b * hh * ww, di, n, r), 3, 1, timing,
                    replaced=K5S_REPLACED_MS.get(key))
                keep("nss_scan_fused_serving", row)
                if hh == tile and ww == tile:
                    cdn.append(row)
            del scan, x
            torch.cuda.empty_cache()
    mean = lambda i: sum(c[i] for c in cdn) / len(cdn)  # noqa: E731
    rows["nss_scan_fused_serving"] = (worst.pop("nss_scan_fused_serving"), mean(1), mean(2),
                                      cdn[0][3], cdn[0][4])
    rows["selective_scan_fused_proj_serving"] = k3_row
    worst.pop("selective_scan_fused_proj_serving")
    mutant_controls("seq", jobs=8)
    return rows, worst


def phase_seq_serving_path(device, unet_outs, mair_outs, unet_requests=UNET_REQUESTS,
                           mair_requests=MAIR_REQUESTS, seq_request=MAIR_REQUESTS[-1]):
    """Phase 14's paths, built through the zoo with ``precision="serving"``
    on the seeded weights of phases 5 and 7, each checked by
    ``check_serving_path`` (ROUNDS rounds, launches a chunk by route, bit
    for bit on repeat, within SERVING_LSB of its plain serving twin,
    PSNR within SERVING_PSNR_DB of parity, engine Mpix/s beside parity's):
    MaIRUNet on phase 7's noisy ``unet_requests`` against phase 7's parity
    outputs ``unet_outs``; MaIR-CDN with ``nss="fused"`` on phase 5's
    ``mair_requests`` and MaIRUNet with ``nss="fused"`` on the 481x321
    request; MaIR-CDN with ``nss="0"`` on ``seq_request`` only (each mixer
    on K3), against phase 5's ``mair_outs``. Returns {kernel: launches}."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.models.mair import MaIR
    from tpuir_torch.models.mair import init_state_dict as mair_state_dict
    from tpuir_torch.models.mair_unet import MaIRUNet
    from tpuir_torch.models.mair_unet import init_state_dict as unet_state_dict

    sizes = UNET_KERNEL_ONLY + UNET_REQUESTS  # phase 7's images, by index
    unet_images = {}
    for hw in set(unet_requests) | {UNET_FUSED_REQUEST}:
        i = sizes.index(hw)
        clean = synthetic_image(*hw, SEED + i)
        unet_images[hw] = (noisy_image(clean, SEED + 100 + i), clean)
    mair_clean = {hw: synthetic_image(*hw, SEED + i) for i, hw in enumerate(MAIR_REQUESTS)}
    cfg_unet, cfg_cdn = zoo.MAIR_UNET_CONFIG, zoo.MAIR_CDN_CONFIG
    # (label, MaIRUNet or not, nss, the K5 or K3 kernel of MaIR-CDN's every mixer, requests)
    runs = [("MaIRUNet serving", True, "stripe", None, unet_requests),
            ("MaIR-CDN fused serving", False, "fused", "nss_scan_fused_serving", mair_requests),
            ("MaIRUNet fused serving", True, "fused", None, [UNET_FUSED_REQUEST]),
            ("MaIR-CDN nss=0 serving", False, "0", "selective_scan_fused_proj_serving",
             [seq_request])]
    launches = {}
    with tempfile.TemporaryDirectory(prefix="tpuir_torch_smoke_") as wdir:
        os.makedirs(os.path.join(wdir, "MaIR", "denoising"))
        torch.save({"params": mair_state_dict(cfg_cdn, seed=SEED)},
                   os.path.join(wdir, "MaIR", "denoising", f"MaIR_CDN_s{SIGMA}.pth"))
        torch.save({"params": unet_state_dict(cfg_unet, seed=SEED)},
                   os.path.join(wdir, "MaIR", "denoising", "MaIR_RealDN.pth"))
        for label, unet, nss, kernel, reqs in runs:
            if unet:
                model = zoo.get_model_instance("denoising", "real", "MaIR", weights_dir=wdir,
                                               precision="serving", device=device, nss=nss)
                plain = MaIRUNet(**cfg_unet, fused=False, nss=nss, serving=True)
                per_chunk = unet_per_chunk(model, fused=nss == "fused", serving=True)
                images = [unet_images[hw][0] for hw in reqs]
                refs, sigma, parity = [unet_images[hw][1] for hw in reqs], None, unet_outs
            else:
                model = zoo.get_model_instance("denoising", "gaussian", "MaIR", sigma=SIGMA,
                                               weights_dir=wdir, precision="serving",
                                               device=device, nss=nss)
                plain = MaIR(**cfg_cdn, fused=False, nss=nss, serving=True)
                per_chunk = lambda h, w, k=kernel: {k: MAIR_BLOCKS}  # noqa: E731
                images = refs = [mair_clean[hw] for hw in reqs]
                sigma, parity = SIGMA, mair_outs
            print(f"{label}: nss={nss}, compute_dtype {model.compute_dtype}, patch "
                  f"{model.patch_size} batch {model.batch_size}; per chunk "
                  + ", ".join(f"{h}x{w}: {chunks_for(model, h, w)} x {per_chunk(h, w)}"
                              for h, w in reqs), flush=True)
            got = check_serving_path(label, model, plain_twin(model, plain), images, reqs,
                                     per_chunk, sigma, parity, refs)
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
            del model, plain
            torch.cuda.empty_cache()
    return launches


def phase_recur_kernels(device, batch=BATCH, tile=MAIR_TILE, rect=(96, 72)):
    """K2's bf16-recurrence body stage by stage (``check_serving_body`` with
    ``check_nss_scan_recur_serving``) at MaIR-CDN@``tile``, batch ``batch``,
    shift off and on (timed: plain, kernel, kernel, plain), and at the
    ``rect`` tile, batch 1, shift on, on phase 4's seeded activations
    rounded to bf16; then its mutation controls. Returns
    (max |kernel - plain|, ms, plain ms, bound ms, bound by) per call at
    ``tile``, the mean over both shifts."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.ops.nss_stripe import nss_scan, nss_scan_recur_plain, nss_scan_recur_stages
    from tpuir_torch.utils import serving_check as ck

    cfg = zoo.MAIR_CDN_CONFIG
    di = int(cfg["ssm_ratio"] * cfg["embed_dim"])
    rows = []
    with torch.inference_mode(), true_float32():
        for b, hw, shifts, timed in ((batch, (tile, tile), (False, True), True),
                                     (1, rect, (True,), False)):
            _, scan, _ = mixer_inputs(device, b, hw)
            x = scan.pop("x").to(torch.bfloat16)
            n, r = scan["A"].shape[-1], scan["dt_w"].shape[-1]
            for shift in shifts:
                rows.append(check_serving_body(
                    f"K2r B={b} {hw[0]}x{hw[1]} shift={int(shift)}",
                    lambda: nss_scan_recur_stages(x, **scan, shift=shift),
                    lambda st: ck.check_nss_scan_recur_serving(x, **scan, scan_len=4,
                                                               shift=shift, st=st),
                    lambda: nss_scan(x, **scan, shift=shift, serving=True, recur_bf16=True),
                    lambda: nss_scan_recur_plain(x, **scan, shift=shift),
                    lambda st: (st["y"], st["pooled"]),
                    serving_scan_work(b * hw[0] * hw[1], di, n, r), 3, 1,
                    "turns" if timed else None))
            del x, scan
            torch.cuda.empty_cache()
    mutant_controls("recur", jobs=6)
    timed_rows = rows[:2]
    return (max(row[0] for row in rows), sum(row[1] for row in timed_rows) / 2,
            sum(row[2] for row in timed_rows) / 2, timed_rows[0][3], timed_rows[0][4])


def recur_per_chunk(per_chunk):
    """A serving path's {kernel: launches a chunk} with K2's recur body in
    place of K2's serving body, which must not launch."""
    def recur(h, w):
        out = dict(per_chunk(h, w))
        out["nss_scan_recur_serving"] = out.pop("nss_scan_serving")
        out["nss_scan_serving"] = 0
        return out

    return recur


def phase_recur_path(device):
    """MaIR-CDN sigma=15 and the real-denoising MaIRUNet built through the zoo
    in parity, serving and serving with ``recur_bf16=True`` on the seeded
    weights of phases 5 and 7: each request served once in parity and in
    serving, then the recur path checked by ``check_serving_path`` against
    parity and its plain twin (``MaIR(fused=False, serving=True,
    recur_bf16=True)``); per request PSNR(recur) - PSNR(serving) and the
    recur path's Mpix/s beside serving's are printed. Returns {kernel:
    launches} of the recur paths."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.core.metrics import calculate_metrics
    from tpuir_torch.models.mair import MaIR
    from tpuir_torch.models.mair import init_state_dict as mair_state_dict
    from tpuir_torch.models.mair_unet import MaIRUNet
    from tpuir_torch.models.mair_unet import init_state_dict as unet_state_dict

    cfg_cdn, cfg_unet = zoo.MAIR_CDN_CONFIG, zoo.MAIR_UNET_CONFIG
    sizes = UNET_KERNEL_ONLY + UNET_REQUESTS  # phase 7's images, by index
    unet = {}
    for hw in RECUR_UNET_REQUESTS:
        i = sizes.index(hw)
        clean = synthetic_image(*hw, SEED + i)
        unet[hw] = (noisy_image(clean, SEED + 100 + i), clean)
    cdn = {hw: synthetic_image(*hw, SEED + i) for i, hw in enumerate(RECUR_MAIR_REQUESTS)}
    launches = {}
    with tempfile.TemporaryDirectory(prefix="tpuir_torch_smoke_") as wdir:
        os.makedirs(os.path.join(wdir, "MaIR", "denoising"))
        torch.save({"params": mair_state_dict(cfg_cdn, seed=SEED)},
                   os.path.join(wdir, "MaIR", "denoising", f"MaIR_CDN_s{RECUR_SIGMA}.pth"))
        torch.save({"params": unet_state_dict(cfg_unet, seed=SEED)},
                   os.path.join(wdir, "MaIR", "denoising", "MaIR_RealDN.pth"))
        for label, is_unet in (("MaIR-CDN recur", False), ("MaIRUNet recur", True)):
            subtask, sigma = ("real", None) if is_unet else ("gaussian", RECUR_SIGMA)
            reqs = RECUR_UNET_REQUESTS if is_unet else RECUR_MAIR_REQUESTS
            images = [unet[hw][0] for hw in reqs] if is_unet else [cdn[hw] for hw in reqs]
            refs = [unet[hw][1] for hw in reqs] if is_unet else images

            def build(precision, recur=None):
                return zoo.get_model_instance("denoising", subtask, "MaIR", sigma=sigma,
                                              weights_dir=wdir, precision=precision,
                                              device=device, recur_bf16=recur)

            outs = {}
            for mode in ("parity", "serving"):
                model = build(mode, False)
                serve(model, images[-1:], sigma, refs[-1:])  # warm-up
                outs[mode] = {hw: (pred, ms) for hw, (pred, ms, _, _) in
                              zip(reqs, serve(model, images, sigma, refs))}
                del model
            model = build("serving", True)
            net = (MaIRUNet(**cfg_unet, fused=False, serving=True, recur_bf16=True) if is_unet
                   else MaIR(**cfg_cdn, fused=False, serving=True, recur_bf16=True))
            per_chunk = (unet_per_chunk(model, serving=True) if is_unet else
                         lambda h, w: dict.fromkeys(MIXER_SERVING, MAIR_BLOCKS))
            print(f"{label}: recur_bf16 on, patch {model.patch_size} batch {model.batch_size}; "
                  "per chunk " + ", ".join(f"{h}x{w}: {chunks_for(model, h, w)} x "
                                           f"{recur_per_chunk(per_chunk)(h, w)}"
                                           for h, w in reqs), flush=True)
            got = check_serving_path(label, model, plain_twin(model, net), images, reqs,
                                     recur_per_chunk(per_chunk), sigma, outs["parity"], refs,
                                     RECUR_PSNR_DB)
            rec = {hw: (pred, ms) for hw, (pred, ms, _, _) in
                   zip(reqs, serve(model, images, sigma, refs))}
            for hw, ref in zip(reqs, refs):
                p_rec = calculate_metrics(rec[hw][0], ref)[0]
                p_srv, p_par = (calculate_metrics(outs[m][hw][0], ref)[0]
                                for m in ("serving", "parity"))
                px = hw[0] * hw[1] / 1e3
                print(f"{label} request {hw[0]}x{hw[1]}x3: PSNR(recur) - PSNR(serving) "
                      f"{p_rec - p_srv:+.4f} dB, PSNR(recur) - PSNR(parity) "
                      f"{p_rec - p_par:+.4f} dB, max|recur-serving| "
                      f"{lsb(rec[hw][0], outs['serving'][hw][0])} LSB; engine recur "
                      f"{px / rec[hw][1]:.3f} Mpix/s, serving {px / outs['serving'][hw][1]:.3f} "
                      f"Mpix/s", flush=True)
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
            del model, net
            torch.cuda.empty_cache()
    return launches


def plain_harness(**kw):
    """``tpuir_torch.harness.Harness(**kw)`` serving the plain twins of the
    zoo's models (Restormer's plain blocks, MaIR's plain mixers in the same
    precision and recurrence)."""
    from tpuir_torch import harness, zoo
    from tpuir_torch.models.mair import MaIR
    from tpuir_torch.models.restormer import Restormer

    class Plain(harness.Harness):
        def _model(self, task, subtask, model_name, gray, sigma):
            model = super()._model(task, subtask, model_name, gray, sigma)
            if model.name == "Restormer":
                net = Restormer(**CONFIG, fused=False, serving=model.compute_dtype is not None)
            else:
                mixer = next(m for m in model.net.modules() if hasattr(m, "recur_bf16"))
                net = MaIR(**zoo.MAIR_CDN_CONFIG, fused=False, serving=mixer.serving,
                           recur_bf16=mixer.recur_bf16)
            twin = plain_twin(model, net)
            twin.name, twin.param_count = model.name, model.param_count
            return twin

    return Plain(**kw)


def phase_harness(device):
    """The port's evaluation harness on the card (see phase 16 in the module
    docstring). Returns {kernel: launches}."""
    import torch

    from tpuir_torch import harness
    from tpuir_torch.core.image_io import imwrite_uint
    from tpuir_torch.models.mair import init_state_dict as mair_state_dict
    from tpuir_torch.models.restormer import init_state_dict as restormer_state_dict
    from tpuir_torch.ops import _kernels

    per_chunk = {
        ("parity", False): {"fused_transformer_block": 44, "mixer_prologue": 36,
                            "nss_scan": 36, "mixer_epilogue": 36},
        ("serving", False): {"fused_transformer_block_serving": 44,
                             **dict.fromkeys(MIXER_SERVING, MAIR_BLOCKS)},
        ("serving", True): {"fused_transformer_block_serving": 44,
                            "mixer_prologue_serving": 36, "nss_scan_recur_serving": 36,
                            "mixer_epilogue_serving": 36},
    }
    launches = {}
    with tempfile.TemporaryDirectory(prefix="tpuir_torch_harness_") as root:
        wdir = os.path.join(root, "weights")
        for rel, sd in (("Restormer/denoising/gaussian_color_denoising_sigma15.pth",
                         restormer_state_dict(CONFIG, seed=SEED)),
                        (f"MaIR/denoising/MaIR_CDN_s{RECUR_SIGMA}.pth",
                         mair_state_dict(None, seed=SEED))):
            os.makedirs(os.path.dirname(os.path.join(wdir, rel)), exist_ok=True)
            torch.save({"params": sd}, os.path.join(wdir, rel))
        ds = os.path.join(root, "datasets", "denoising", "gaussian", "test", "CBSD68")
        os.makedirs(ds)
        for i, (h, w) in enumerate(HARNESS_IMAGES):
            imwrite_uint(os.path.join(ds, f"{i + 1:02d}.png"), synthetic_image(h, w, SEED + 7 + i))
        saved = os.environ.get("TPUIR_DATASET_DIR")
        os.environ["TPUIR_DATASET_DIR"] = os.path.join(root, "datasets")
        cell = dict(datasets=("CBSD68",), sigmas=(RECUR_SIGMA,), models=("Restormer", "MaIR"))
        for (precision, recur), want_chunk in per_chunk.items():
            tag = f"{precision}{' recur' if recur else ''}"
            kw = dict(weights_dir=wdir, save_images=False, device=device, precision=precision,
                      recur_bf16=recur)
            h = harness.Harness(results_dir=os.path.join(root, tag.replace(" ", "_")), **kw)
            _kernels.reset_launches()
            t0 = time.time()
            h.gaussian_color_nonblind(**cell)
            torch.cuda.synchronize()
            secs = time.time() - t0
            got = {k: n for k, n in _kernels.LAUNCHES.items() if n}
            want = {k: n * len(HARNESS_IMAGES) for k, n in want_chunk.items()}  # a chunk an image
            print(f"harness {tag}: {len(h.results_table)} rows in {secs:.1f} s; launches {got}",
                  flush=True)
            if got != want:
                fail(f"harness {tag}: launches {got}, expected {want}")
            path = h.save_results()
            with open(path) as f:
                header = f.readline().strip().split(",")
            if tuple(header) != harness.COLUMNS:
                fail(f"harness {tag}: CSV columns {header}")
            plain = plain_harness(results_dir=os.path.join(root, "plain"), **kw)
            plain.gaussian_color_nonblind(**cell)
            if [r["Model"] for r in h.results_table] != ["Restormer", "MaIR"]:
                fail(f"harness {tag}: rows {[r['Model'] for r in h.results_table]}")
            for row, ref in zip(h.results_table, plain.results_table):
                text = [c for c in harness.COLUMNS[:6] if row[c] != ref[c]]
                dp, ds_ = abs(row["PSNR"] - ref["PSNR"]), abs(row["SSIM"] - ref["SSIM"])
                print(f"harness {tag} row {row['Model']}: PSNR {row['PSNR']:.4f} dB SSIM "
                      f"{row['SSIM']:.5f} (plain path {ref['PSNR']:.4f} dB {ref['SSIM']:.5f}), "
                      f"{row['Avg_Time_ms']:.1f} ms an image", flush=True)
                if text or dp > HARNESS_PSNR_DB or ds_ > HARNESS_SSIM:
                    fail(f"harness {tag} row {row['Model']} against the plain path: columns "
                         f"{text} differ, PSNR by {dp:.4f} dB, SSIM by {ds_:.5f}")
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
        if saved is None:
            del os.environ["TPUIR_DATASET_DIR"]
        else:
            os.environ["TPUIR_DATASET_DIR"] = saved
    return launches


def write_plain_conv_checkpoints(wdir):
    """Phase 17's seeded checkpoints in the released formats under ``wdir``:
    DnCNN's ``.pth`` state dicts (gray sigma=25, color blind), REDNet's
    ``50.pt`` and the same weights as ``50.caffemodel`` under ``wdir/caffe``,
    DeblurGANv2's ``.h5`` pickles (``model``, DataParallel ``module.``
    keys). Returns the caffemodel's weights root."""
    import torch

    from tpuir_torch.models import dncnn, rednet
    from tpuir_torch.models.deblurgan import fpn_inception, fpn_mobilenet
    from tpuir_torch.weights.caffe import write_caffemodel

    def save(rel, obj):
        path = os.path.join(wdir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(obj, path)

    save("DnCNN/dncnn_25.pth", dncnn.init_state_dict(1, 17, seed=SEED))
    save("DnCNN/dncnn_color_blind.pth", dncnn.init_state_dict(3, 20, seed=SEED + 1))
    red = rednet.init_state_dict(seed=SEED + 2)
    save("REDNet/50.pt", red)
    caffe_root = os.path.join(wdir, "caffe")
    os.makedirs(os.path.join(caffe_root, "REDNet"))
    write_caffemodel(os.path.join(caffe_root, "REDNet", "50.caffemodel"),
                     {k: v.numpy() for k, v in red.items()})
    for variant, mod in (("mobilenet", fpn_mobilenet), ("inception", fpn_inception)):
        sd = mod.init_state_dict(seed=SEED + 3)
        save(f"DeblurGANv2/fpn_{variant}.h5", {"model": {f"module.{k}": v for k, v in sd.items()}})
    return caffe_root


def motion_blurred(img, length=9):
    """A horizontal box blur of ``length`` pixels (edges repeated): a
    synthetic motion-blurred input whose target is ``img``."""
    pad = np.pad(img.astype(np.float64), ((0, 0), (length // 2, length // 2), (0, 0)), "edge")
    out = sum(pad[:, i:i + img.shape[1]] for i in range(length)) / length
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def batch_invariance(model, chans, seed):
    """max|step(patch) - step(batch of 8)[3]| of ``model`` (parity) at its
    patch size, on random uint8 patches normalized by its own hook."""
    import torch

    ps = model.patch_size
    raw = (np.random.RandomState(seed).rand(8, ps, ps, chans) * 255).astype(np.uint8)
    x = torch.from_numpy(np.stack([model.normalize(p) for p in raw])).to(model.device)
    x = x.permute(0, 3, 1, 2)  # NHWC viewed as NCHW, as the engine hands chunks over
    batched, alone = model.step(x), model.step(x[3:4])
    return float((batched[3] - alone[0]).abs().max())


def phase_plain_conv(device, bsd68=PLAIN_BSD68, gopro=PLAIN_GOPRO):
    """The plain-conv families on the card (see phase 17 in the module
    docstring). Returns {cell: (parity Mpix/s, serving Mpix/s)}."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.ops import _kernels

    clean = synthetic_image(*bsd68, SEED + 40)
    gray = np.round(clean.astype(np.float64).mean(-1, keepdims=True)).astype(np.uint8)
    sharp = synthetic_image(*gopro, SEED + 41)
    blurred = motion_blurred(sharp)
    # (label, zoo route, weights root ("caffe": the caffemodel's), input,
    # target, host AWGN sigma or None)
    cells = [
        ("DnCNN gray sigma=25", ("denoising", "gaussian", "DnCNN", True, 25), "", gray, gray, 25),
        ("DnCNN color blind", ("denoising", "gaussian", "DnCNN", False, None), "", clean, clean,
         25),
        ("REDNet sigma=50 .pt", ("denoising", "gaussian", "REDNet", True, 50), "", gray, gray,
         50),
        ("REDNet sigma=50 .caffemodel", ("denoising", "gaussian", "REDNet", True, 50), "caffe",
         gray, gray, 50),
        ("DeblurGANv2 (MobileNet)", ("deblurring", "motion", "DeblurGANv2 (MobileNet)", False,
                                     None), "", blurred, sharp, None),
        ("DeblurGANv2 (Inception)", ("deblurring", "motion", "DeblurGANv2 (Inception)", False,
                                     None), "", blurred, sharp, None),
    ]
    rates, parity_out = {}, {}
    with tempfile.TemporaryDirectory(prefix="tpuir_torch_plain_conv_") as wdir:
        caffe_root = write_plain_conv_checkpoints(wdir)
        for label, (task, subtask, name, is_gray, sigma), root, img, target, noise in cells:
            t0 = time.time()
            kw = dict(gray=is_gray, sigma=sigma, weights_dir=caffe_root if root else wdir)
            models = {p: zoo.get_model_instance(task, subtask, name, precision=p, device=device,
                                                **kw) for p in ("parity", "serving")}
            cpu_model = zoo.get_model_instance(task, subtask, name, device="cpu", **kw)
            for m in models.values():  # warm-up: cuDNN and allocator, not counted
                serve(m, [img], noise, [target])
            torch.cuda.synchronize()
            _kernels.reset_launches()
            served = {p: [serve(m, [img], noise, [target])[0] for _ in range(PLAIN_ROUNDS)]
                      for p, m in models.items()}
            torch.cuda.synchronize()
            launched = {k: n for k, n in _kernels.LAUNCHES.items() if n}
            if launched:
                fail(f"{label}: hand kernels launched on a plain-conv path: {launched}")
            h, w = img.shape[:2]
            ms = {p: float(np.median([r[1] for r in rounds])) for p, rounds in served.items()}
            for p, rounds in served.items():
                if any(not np.array_equal(r[0], rounds[0][0]) for r in rounds):
                    fail(f"{label}: the {p} path is not repeatable")
            (pred, _, psnr, ssim), (spred, _, spsnr, sssim) = (served["parity"][0],
                                                               served["serving"][0])
            (cpu_pred, _, _, _), = serve(cpu_model, [img], noise, [target])
            cpu_lsb = lsb(pred, cpu_pred)
            dpsnr = spsnr - psnr
            inv = batch_invariance(models["parity"], img.shape[2], SEED + 50)
            rates[label] = tuple(h * w / 1e3 / ms[p] for p in ("parity", "serving"))
            print(f"plain-conv {label}: {models['parity'].param_count:,} params, patch "
                  f"{models['parity'].patch_size} overlap {models['parity'].patch_overlap}, "
                  f"request {h}x{w}x{img.shape[2]}; parity PSNR {psnr:.4f} dB SSIM {ssim:.5f}, "
                  f"{ms['parity']:.1f} ms {rates[label][0]:.3f} Mpix/s; serving PSNR {spsnr:.4f} "
                  f"dB SSIM {sssim:.5f} (PSNR {dpsnr:+.4f} dB), {ms['serving']:.1f} ms "
                  f"{rates[label][1]:.3f} Mpix/s; card vs CPU {cpu_lsb} LSB; repeatable over "
                  f"{PLAIN_ROUNDS} rounds each; one patch alone vs in a batch of 8: max|d| "
                  f"{inv:.3e}; no hand-kernel launch  [{time.time() - t0:.0f} s]", flush=True)
            if cpu_lsb > 1:
                fail(f"{label}: card and CPU differ by {cpu_lsb} uint8 LSB")
            if abs(dpsnr) > SERVING_PSNR_DB:
                fail(f"{label}: serving PSNR {spsnr:.4f} dB against parity's {psnr:.4f}")
            if not inv <= PLAIN_BATCH_TOL:
                fail(f"{label}: a patch alone and in a batch of 8 differ by {inv:.3e}")
            parity_out[label] = pred
            del models, cpu_model
            torch.cuda.empty_cache()
    if not np.array_equal(parity_out["REDNet sigma=50 .pt"],
                          parity_out["REDNet sigma=50 .caffemodel"]):
        fail("REDNet from the .caffemodel differs from the same weights' .pt")
    print("plain-conv REDNet sigma=50: the .caffemodel serves the .pt's output bit for bit",
          flush=True)
    return rates


# Phase 18: (label, utils.profiling model, precision, per-chunk launches,
# engine batch) of the window's requests (utils.profiling.ENGINE_REQUESTS'
# sizes), then the requests that are only split. At batch 8 a request has
# 2-3 chunks, so the ring of min(4, chunks) staging buffers is never reused
# at max_in_flight 4; the batch-2 requests (5 and 10 chunks) refill every
# buffer and fill the window at each of WINDOWS.
WINDOW_CELLS = [
    ("Restormer sigma=25", "restormer", "parity", {"fused_transformer_block": 44}, 8),
    ("Restormer sigma=25", "restormer", "serving", {"fused_transformer_block_serving": 44}, 8),
    ("Restormer sigma=25", "restormer", "serving", {"fused_transformer_block_serving": 44}, 2),
    ("MaIR-CDN sigma=25", "mair", "parity", dict.fromkeys(
        ("mixer_prologue", "nss_scan", "mixer_epilogue"), MAIR_BLOCKS), 8),
    ("MaIR-CDN sigma=25", "mair", "serving", dict.fromkeys(MIXER_SERVING, MAIR_BLOCKS), 8),
    ("REDNet sigma=50", "rednet", "parity", {}, 8),
    ("REDNet sigma=50", "rednet", "serving", {}, 8),
    ("REDNet sigma=50", "rednet", "serving", {}, 2),
    ("MaIRUNet", "mairunet", "parity", dict.fromkeys(
        ("mixer_prologue", "nss_scan", "mixer_epilogue"), 44), 8),
]
WINDOWS = (1, 2, 4)
SPLIT_CELLS = [("DnCNN gray sigma=25", "dncnn"), ("DeblurGANv2 (MobileNet)", "deblurgan-mobilenet"),
               ("DeblurGANv2 (Inception)", "deblurgan-inception")]
DEMO_IMAGE = (200, 150)


def window_request(key):
    """Phase 18's request of ``key``: (image, host AWGN sigma or None), the
    earlier phases' requests of the same size."""
    from tpuir_torch.utils.profiling import ENGINE_REQUESTS

    (_, _, _, gray, _), (h, w), sigma = ENGINE_REQUESTS[key]
    if key in ("rednet", "dncnn"):
        clean = synthetic_image(h, w, SEED + 40)
        return np.round(clean.astype(np.float64).mean(-1, keepdims=True)).astype(np.uint8), sigma
    if key == "mairunet":
        return noisy_image(synthetic_image(h, w, SEED), SEED + 100), None
    if key.startswith("deblurgan"):
        return motion_blurred(synthetic_image(h, w, SEED + 41)), None
    return synthetic_image(h, w, SEED), sigma


def seeded_zoo_model(key, precision, wdir, device):
    from tpuir_torch import zoo
    from tpuir_torch.utils.profiling import ENGINE_REQUESTS

    (task, subtask, name, gray, sigma), _, _ = ENGINE_REQUESTS[key]
    return zoo.get_model_instance(task, subtask, name, gray=gray, sigma=sigma, weights_dir=wdir,
                                  precision=precision, device=device)


def print_split(label, precision, model, img, sigma):
    """Phase 18 (b): one request's host split and the card's."""
    from tpuir_torch.core.engine import run_model_inference
    from tpuir_torch.utils.profiling import HOST_STEPS, card_line, engine_split, profiled_requests

    want, _ = run_model_inference(model, img, need_degradation=sigma is not None,
                                  noise_level=sigma)
    splits = []
    for _ in range(ROUNDS):
        out, ms = engine_split(model, img, sigma)
        if not np.array_equal(out, want):
            fail(f"{label} {precision}: the split's output differs from the engine's")
        splits.append(ms)
    host = {k: float(np.median([s[k] for s in splits])) for k in HOST_STEPS + ("wall",)}
    dev = profiled_requests(lambda: engine_split(model, img, sigma))
    h, w = img.shape[:2]
    card = card_line(dev) + (" (profiled)" if dev else "")
    print(f"split {label} {precision} {h}x{w}: wall {host['wall']:.2f} ms "
          f"{h * w / 1e3 / host['wall']:.3f} Mpix/s; host " + " ".join(
              f"{k} {host[k]:.2f}" for k in HOST_STEPS) + f"; {card}", flush=True)


def phase_window(device, cells=WINDOW_CELLS, split_cells=SPLIT_CELLS):
    """Phase 18 (a) and (b). Returns {kernel: launches}."""
    import torch

    from tpuir_torch.core.engine import run_model_inference
    from tpuir_torch.ops import _kernels
    from tpuir_torch.utils.profiling import write_seeded_checkpoint

    launches = {}
    with tempfile.TemporaryDirectory(prefix="tpuir_torch_window_") as wdir:
        for key in dict.fromkeys(cell[1] for cell in cells):
            write_seeded_checkpoint(key, wdir, seed=SEED)
        for label, key, precision, per_chunk, batch in cells:
            model = seeded_zoo_model(key, precision, wdir, device)
            model.batch_size = batch
            img, sigma = window_request(key)
            h, w = img.shape[:2]
            serve_kw = dict(need_degradation=sigma is not None, noise_level=sigma)
            run_model_inference(model, img, **serve_kw)  # warm-up, not counted
            torch.cuda.synchronize()
            chunks = chunks_for(model, h, w)
            want = {k: n * chunks for k, n in per_chunk.items()}
            outs, ms = [], {m: [] for m in WINDOWS}
            for r in range(ROUNDS):
                for mif in WINDOWS[r % len(WINDOWS):] + WINDOWS[:r % len(WINDOWS)]:
                    _kernels.reset_launches()
                    pred, t_ms = run_model_inference(model, img, max_in_flight=mif, **serve_kw)
                    torch.cuda.synchronize()
                    got = {k: n for k, n in _kernels.LAUNCHES.items() if n}
                    if got != want:
                        fail(f"window {label} {precision} max_in_flight={mif}: launches {got}, "
                             f"expected {want}")
                    for k, n in got.items():
                        launches[k] = launches.get(k, 0) + n
                    outs.append(pred)
                    ms[mif].append(t_ms)
            if any(not np.array_equal(o, outs[0]) for o in outs):
                fail(f"window {label} {precision}: outputs differ across windows or rounds")
            print(f"window {label} {precision} {h}x{w} batch {batch} ({chunks} chunks): bit-equal "
                  f"over max_in_flight {', '.join(map(str, WINDOWS))}, {ROUNDS} rounds; launches "
                  f"a serve {want}; engine " + ", ".join(
                      f"max_in_flight={m} {h * w / 1e3 / float(np.median(v)):.3f} Mpix/s"
                      for m, v in ms.items()), flush=True)
            if batch == 8:
                print_split(label, precision, model, img, sigma)
            del model
            torch.cuda.empty_cache()
        for label, key in split_cells:
            write_seeded_checkpoint(key, wdir, seed=SEED)
            for precision in ("parity", "serving"):
                model = seeded_zoo_model(key, precision, wdir, device)
                img, sigma = window_request(key)
                run_model_inference(model, img, need_degradation=sigma is not None,
                                    noise_level=sigma)  # warm-up
                print_split(label, precision, model, img, sigma)
                del model
                torch.cuda.empty_cache()
    return launches


def phase_entry_points(device, demo_image=DEMO_IMAGE):
    """Phase 18 (c) and (d). Returns {kernel: launches}."""
    import torch

    from tpuir_torch import demo_core, zoo
    from tpuir_torch.config import get_patch_config
    from tpuir_torch.core.engine import run_model_inference
    from tpuir_torch.core.image_io import imread_uint8, imwrite_uint
    from tpuir_torch.core.metrics import calculate_metrics
    from tpuir_torch.ops import _kernels
    from tpuir_torch.scripts import compute_flops, test_demo, test_patch_size, validate_serving
    from tpuir_torch.utils.profiling import write_seeded_checkpoint

    per_chunk = {"Restormer": {"fused_transformer_block": 44},
                 "MaIR": dict.fromkeys(("mixer_prologue", "nss_scan", "mixer_epilogue"),
                                       MAIR_BLOCKS)}
    launches = {}
    with tempfile.TemporaryDirectory(prefix="tpuir_torch_entry_") as root:
        wdir = os.path.join(root, "weights")
        for key in ("restormer", "mair"):
            write_seeded_checkpoint(key, wdir, seed=SEED)
        clean = synthetic_image(*demo_image, SEED + 60)
        label = "Gaussian (Color, Non-blind)"
        for name, want_chunk in per_chunk.items():
            built = []

            def get_model(*args, **kw):
                built.append(zoo.get_model_instance(*args, weights_dir=wdir, **kw))
                return built[-1]

            pc = get_patch_config("denoising", "gaussian", name)
            _kernels.reset_launches()
            before, after, t = demo_core.run_restoration(
                clean, label, name, SIGMA, True, pc["patch_size"], pc["patch_overlap"],
                device_name=str(device), get_model=get_model)
            torch.cuda.synchronize()
            got = {k: n for k, n in _kernels.LAUNCHES.items() if n}
            model = built[0]
            want = {k: n * chunks_for(model, *before.shape[:2]) for k, n in want_chunk.items()}
            if got != want or model.device != device:
                fail(f"demo {name}: launches {got} on {model.device}, expected {want} on {device}")
            direct, _ = run_model_inference(model, before, patch_size=pc["patch_size"],
                                            patch_overlap=pc["patch_overlap"])
            if not np.array_equal(direct, after):
                fail(f"demo {name}: run_restoration differs from run_model_inference")
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
            print(f"demo run_restoration {name} on {device} {demo_image[0]}x{demo_image[1]} "
                  f"sigma={SIGMA} ({t}): equals run_model_inference bit for bit; launches {got}",
                  flush=True)
            del built, model

        demo_dir = os.path.join(root, "demo")
        os.makedirs(demo_dir)
        suite = next(s for s in test_demo.SUITES if s[0] == "denoising_gaussian_color_nonblind")
        prefix = suite[0]
        noisy = noisy_image(clean, SEED + 61, SIGMA)
        imwrite_uint(os.path.join(demo_dir, f"{prefix}_noisy.bmp"), noisy)
        imwrite_uint(os.path.join(demo_dir, f"{prefix}_target.png"), clean)
        test_demo.run_suite(*suite, demo_dir=demo_dir, weights_dir=wdir, show=False,
                            device=str(device))
        for name in suite[5]:
            path = os.path.join(demo_dir, f"{prefix}_result_{name}.png")
            if not os.path.exists(path):
                fail(f"test_demo wrote no {os.path.basename(path)}")
            psnr, ssim = calculate_metrics(imread_uint8(path), clean)
            if not (np.isfinite(psnr) and np.isfinite(ssim)):
                fail(f"test_demo {name}: PSNR {psnr} SSIM {ssim}")
            print(f"test_demo {prefix} {name}: PNG written, PSNR {psnr:.4f} dB SSIM {ssim:.5f}",
                  flush=True)

        name, build, in_ch = next(t for t in compute_flops.model_table()
                                  if t[0] == "DnCNN (nonblind, gray)")
        trials = []
        fits = test_patch_size.card_fits(test_patch_size.bundle(name, build, in_ch, device),
                                         in_ch)
        best = test_patch_size.find_max_patch_size(lambda s: trials.append(s) or fits(s))
        print(f"test_patch_size {name}: trials {trials}, max patch size {best}", flush=True)

        res = validate_serving.validate(["DnCNN", "Restormer"], os.path.join(root, "none"),
                                        device=device)
        path = os.path.join(root, "serving_deltas_torch.json")
        with open(path, "w") as f:
            json.dump(res, f)
        for fam, entry in res["trained_like"].items():
            if abs(entry["psnr_delta_db"]) > SERVING_PSNR_DB:
                fail(f"validate_serving {fam}: serving {entry['psnr_delta_db']:+.4f} dB "
                     "from parity")
        print(f"validate_serving: {os.path.basename(path)} written ({os.path.getsize(path)} "
              f"bytes); trained-like serving - parity PSNR " + ", ".join(
                  f"{fam} {-e['psnr_delta_db']:+.4f} dB ({e['weights']})"
                  for fam, e in res["trained_like"].items()), flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "tpuir_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository (tpuir_torch/ missing)",
              file=sys.stderr)
        return 1
    from tpuir_torch import zoo
    from tpuir_torch.ops import _kernels

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)
    t0 = time.time()
    so = _kernels.build()
    _kernels.library()
    print(f"kernels built in {time.time() - t0:.1f} s: {os.path.relpath(so, root)}", flush=True)
    for line in _kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    device = torch.device("cuda", 0)
    t0 = time.time()
    k1_err, k1_ms, k1_plain_ms, k1_bound, k1_by, k1_tc = phase_kernel_vs_plain(device)
    print(f"K1 per forward (44 BiasFree blocks, batch {BATCH}): kernel {k1_ms:.2f} ms, "
          f"plain {k1_plain_ms:.2f} ms, bound {k1_bound:.2f} ms ({k1_by}), 3xTF32 bound "
          f"{k1_tc:.2f} ms; max|d| {k1_err:.3e}  [{time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    launches, _, restormer_outs = phase_main_path(device)
    print(f"[Restormer path {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    rows = {"fused_transformer_block": (k1_err, k1_ms, k1_plain_ms, k1_bound, k1_by)}
    rows.update(phase_mair_kernels(device))
    cfg = zoo.MAIR_CDN_CONFIG
    px, dm, di = BATCH * MAIR_TILE ** 2, cfg["embed_dim"], int(cfg["ssm_ratio"] * cfg["embed_dim"])
    nbytes, flops = prologue_work(px, dm, di)
    ebytes, eflops = epilogue_work(px, di, dm, BATCH)
    bounds_tc = {"fused_transformer_block": k1_tc,  # per forward, K6 and K7 per call at CDN@128
                 "mixer_prologue": bound_tc(nbytes, px * 4 * dm * di, flops),
                 "mixer_epilogue": bound_tc(ebytes, px * 2 * di * dm, eflops)}
    print(f"[MaIR kernels {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    mair_launches, _, mair_outs = phase_mair_path(device)
    launches.update(mair_launches)
    print(f"[MaIR path {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    unet_worst, _, k3_row, k3_updates = phase_unet_kernels(device)
    rows["selective_scan_fused_proj"] = k3_row
    for name, err in unet_worst.items():
        rows[name] = (max(rows[name][0], err),) + rows[name][1:]
    print(f"[MaIRUNet kernels {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    unet_launches, _, unet_outs = phase_unet_path(device)
    for name, n in unet_launches.items():
        launches[name] = launches.get(name, 0) + n
    print(f"[MaIRUNet path {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    rows["nss_scan_fused"] = phase_fused_kernels(device)
    print(f"[K5 {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    for name, n in phase_fused_path(device, mair_outs, unet_outs).items():
        launches[name] = launches.get(name, 0) + n
    print(f"[fused route {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    launches["selective_scan"], rows["selective_scan"] = phase_selective_scan(device)
    print(f"[K4 {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    from tpuir_torch.utils.micro_rate import cdn_scan_updates

    cdn = cdn_scan_updates()  # K4's first case has MaIR-CDN@128's shape
    scan_ms = {"K2": (rows["nss_scan"][1], cdn, 2), "K5": (rows["nss_scan_fused"][1], cdn, 2),
               "K4 at MaIR-CDN's shape": (rows["selective_scan"][1], cdn, 2),
               "K3 per 481x321 chunk": (rows["selective_scan_fused_proj"][1], k3_updates, 1)}
    launches["rate_probe"], rows["rate_probe"] = phase_probe(device, scan_ms)
    print(f"[P1 {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    row = phase_serving_kernels(device)
    rows["fused_transformer_block_serving"] = row
    print(f"K1 serving per forward (44 BiasFree blocks, batch {BATCH}): kernel {row[1]:.2f} ms "
          f"(the replaced body, recorded on an H100 at 700 W: "
          f"{K1_SERVING_REPLACED_MS['forward']:.3f} ms), plain {row[2]:.2f} ms, "
          f"bound {row[3]:.2f} ms ({row[4]}); max|d| {row[0]:.3e}", flush=True)
    launches.update(phase_serving_path(device, restormer_outs))
    print(f"[serving {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    rows.update(phase_mair_serving_kernels(device))
    print(f"[MaIR serving kernels {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    launches.update(phase_mair_serving_path(device, mair_outs))
    print(f"[MaIR serving path {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    seq_rows, mixer_worst = phase_seq_serving_kernels(device)
    rows.update(seq_rows)
    for name, err in mixer_worst.items():
        rows[name] = (max(rows[name][0], err),) + rows[name][1:]
    print(f"[MaIRUNet and off-stripe serving kernels {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    for name, n in phase_seq_serving_path(device, unet_outs, mair_outs).items():
        launches[name] = launches.get(name, 0) + n
    print(f"[MaIRUNet and off-stripe serving paths {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    rows["nss_scan_recur_serving"] = phase_recur_kernels(device)
    print(f"[recur kernels {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    for name, n in phase_recur_path(device).items():
        launches[name] = launches.get(name, 0) + n
    print(f"[recur paths {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    for name, n in phase_harness(device).items():
        launches[name] = launches.get(name, 0) + n
    print(f"[harness {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    phase_plain_conv(device)
    print(f"[plain-conv families {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    for phase in (phase_window, phase_entry_points):
        for name, n in phase(device).items():
            launches[name] = launches.get(name, 0) + n
    print(f"[window, split and entry points {time.time() - t0:.0f} s]", flush=True)

    print(card)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": KERNELS[name][0],
        "replaces": KERNELS[name][1], "launches": launches[name], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        **({"bound_tc_ms": bounds_tc[name]} if name in bounds_tc else {}),
    } for name, (err, ms, plain_ms, b_ms, b_by) in rows.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
