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
   from CUDA events, the plain version timed once a shape; the GEMM core at
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
    and the three-pass MUFU floor (two exp2 a state update) from the
    measured rates, beside K2's, K5's, K4's and K3's times of phases 4, 8,
    10 and 6.

Each path's launch counts are set to 0 just before it is served (K4's and
P1's entry points: just before they are called) and read just after; a
kernel's launches in the JSON line are the sum over the paths it runs on.
The second-to-last line is the kernels' JSON summary: per kernel its
launches, max|kernel - plain| over every check (P1: relative), kernel and
plain ms (K1: per Restormer@256 forward; K6, K2, K7, K5: per call at
MaIR-CDN@128, batch 8; K3: per forward chunk of the 481x321 request, its 12
calls at 96x82 and 8 at 48x41; K4: per call at MaIR-CDN's shape; P1: per
call at the JAX shapes, the mean over the three ops), the least time the
card could take for the same work (``bound_ms``: the larger of its bytes
over 3.35 TB/s and its float32 operations over 67 TFLOP/s, an exponential
counted as one, the H100 SXM's data-sheet rates, computed from this run's
shapes; P1, a rate probe: its mul and fma at the float32 lanes' 33.5 T
instructions/s, its exp2 at the special-function lanes' eighth of that)
and which of the two bounds it. K1, K6 and K7, whose products run on
the tensor cores in 3xTF32, also carry ``bound_tc_ms``: their 1x1
products' operations at the TF32 rate over 3 (494.7 / 3 TFLOP/s) plus the
rest at 67 TFLOP/s, or the bytes over 3.35 TB/s where that is larger. The
last line is ``{"ok": true, "device": {...}}``. Any failed phase raises, exits non-zero and prints no
last line; so does a machine without a CUDA card.
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
}


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


def bound(nbytes: float, flops: float):
    """(least ms on the card, what bounds it) for work of nbytes and flops."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
    the pooled sum. An exponential counts as one operation."""
    c = r + 2 * n
    nbytes = 4 * (px * di + 4 * px + 4 * px * di + 4 * (c * di + di * r + di * n + 2 * di))
    flops = 4 * px * (2 * c * di + 2 * r * di + 4 * di + 7 * di * n + 4 * di)
    return nbytes, flops


def k5_work(px, di, n, r):
    """K5: scan_work less the id table, which K5 does not read."""
    nbytes, flops = scan_work(px, di, n, r)
    return nbytes - 4 * 4 * px, flops


def k4_work(seqs, L, di, n):
    """K4: u and delta in, B and C in, y out (seqs = B*K sequences of L
    positions), A, D and the bias; per position and channel the bias add,
    softplus, D*u, and per state update exp(dt*A), dt*B*u, the FMA into h
    and C.h."""
    pos = seqs * L
    nbytes = 4 * (3 * pos * di + 2 * pos * n + seqs * (di * n + 2 * di))
    flops = pos * (5 * di + 7 * di * n + 2 * di)
    return nbytes, flops


def k3_work(seqs, L, di, n, r):
    """K3: xs in, y out (seqs = B*4 sequences of L positions), weights; per
    position the x_dbl and dt projections, softplus, per state update
    exp(dt*A), dt*B*x, the FMA into h and C.h, then D*x."""
    c = r + 2 * n
    pos = seqs * L
    nbytes = 4 * (2 * pos * di + 4 * (c * di + di * r + di * n + 2 * di))
    flops = pos * (2 * c * di + 2 * r * di + 4 * di + 7 * di * n + 2 * di)
    return nbytes, flops


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
            keep("selective_scan_fused_proj", f"K3 {label}", row)
            k3_ms += count * row[1]
            k3_plain += count * row[2]
            k3_bytes += count * work[0]
            k3_flops += count * work[1]
            k3_updates += count * 2 * 4 * L * di * n
            del scan, xs, args, want
    k3_row = (worst["selective_scan_fused_proj"], k3_ms, k3_plain) + bound(k3_bytes, k3_flops)
    print(f"K3 per forward chunk of the 481x321 request (12 calls at 96x82, 8 at 48x41, "
          f"batch 2): kernel {k3_ms:.3f} ms, plain {k3_plain:.3f} ms, bound {k3_row[3]:.3f} ms "
          f"({k3_row[4]})", flush=True)
    return worst, rows, k3_row, k3_updates


def unet_per_chunk(model, fused=False):
    """{kernel: launches a forward chunk} of MaIRUNet for an h x w request:
    each stage's blocks on K6, K2 and K7 (with ``fused``: on K5) where its
    level's H and W are multiples of scan_len 4 (so even), else on K3, as
    the JAX module routes them (``tpuir/models/mair.py:196-213``)."""
    from tpuir_torch.core.tiling import tile_indices

    def per_chunk(h, w):
        ps, _, _ = tile_indices(h, w, model.patch_size, model.patch_overlap)
        ph, pw = (-(-min(ps, s) // model.pad_factor) * model.pad_factor for s in (h, w))
        on_level = ("nss_scan_fused",) if fused else ("mixer_prologue", "nss_scan",
                                                      "mixer_epilogue")
        out = dict.fromkeys(on_level + ("selective_scan_fused_proj",), 0)
        for stage, lvl in UNET_STAGES:
            n = len(getattr(model.net, stage))
            if (ph >> lvl) % 4 == 0 and (pw >> lvl) % 4 == 0:
                for k in on_level:
                    out[k] += n
            else:
                out["selective_scan_fused_proj"] += n
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
    a call, its state updates)}): 3 mul + 3 fma + 1 exp a state update, and
    the three-pass MUFU floor (two exp2 a state update), each at the
    measured rates and scaled to the kernel's updates. Returns (launches,
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
                      f"{ms / micro_rate.mufu_floor_ms(rates, n):.2f}x MUFU)"
                      for k, (ms, n) in scan_ms.items()),
          flush=True)
    mean = lambda i: sum(r[i] for r in rows) / len(rows)  # noqa: E731
    return launches, (worst, mean(0), mean(1), max(mean(2), mean(3)),
                      "bytes" if mean(2) >= mean(3) else "operations")


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
    launches, _, _ = phase_main_path(device)
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
    scan_ms = {"K2": (rows["nss_scan"][1], cdn), "K5": (rows["nss_scan_fused"][1], cdn),
               "K4 at MaIR-CDN's shape": (rows["selective_scan"][1], cdn),
               "K3 per 481x321 chunk": (rows["selective_scan_fused_proj"][1], k3_updates)}
    launches["rate_probe"], rows["rate_probe"] = phase_probe(device, scan_ms)
    print(f"[P1 {time.time() - t0:.0f} s]", flush=True)

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
