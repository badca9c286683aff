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
   LayerNorm variants, with kernel and plain times from CUDA events.
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
   from CUDA events (plain, kernel, kernel, plain).
5. The MaIR path: seeded weights for the released sigma=25 MaIR-CDN (full
   width and depth) are written as ``MaIR/denoising/MaIR_CDN_s25.pth`` and
   loaded through the zoo; a 256x256 request (9 tiles, chunks 8+1), a
   200x150 request (4 tiles) and a 96x72 request (one rectangular tile) are
   served with host AWGN and scored, three rounds. Each of K6, K2 and K7
   must launch 36 times per forward chunk, and the kernel path must repeat
   bit for bit; one round with plain mixers, and the 96x72 request on the
   CPU, must agree with it to 1 uint8 LSB.

Each path's launch counts are set to 0 just before it is served and read
just after. The second-to-last line is the kernels' JSON summary: per
kernel its launches on its path, max|kernel - plain|, kernel and plain ms,
the least time the card could take for the same work (``bound_ms``: the
larger of its bytes over 3.35 TB/s and its float32 operations over
67 TFLOP/s, the H100 SXM's data-sheet rates, computed from this run's
shapes) and which of the two bounds it. The last line is
``{"ok": true, "device": {...}}``. Any failed phase raises, exits non-zero
and prints no last line; so does a machine without a CUDA card.
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
ROUNDS = 3
SIGMA = 25
CONFIG = dict(layer_norm_bias=False)  # the color-denoising Restormer (BiasFree)
ITERS = 10  # launches a CUDA-event timing averages over
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "fused_transformer_block": ("tpuir_torch/csrc/fused_block.cu", "tpuir/ops/fused_block.py:338"),
    "mixer_prologue": ("tpuir_torch/csrc/nss_prologue.cu", "tpuir/ops/nss_prologue.py:121"),
    "nss_scan": ("tpuir_torch/csrc/nss_scan.cu", "tpuir/ops/nss_stripe.py:484"),
    "mixer_epilogue": ("tpuir_torch/csrc/nss_epilogue.cu", "tpuir/ops/nss_epilogue.py:140"),
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


def compare(got, want, atol, rtol):
    """(max |got - want|, whether every element of got is finite and within
    atol + rtol * |want|) over a tensor or a tuple of them."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst, ok = 0.0, True
    for g, w in zip(got, want):
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


def phase_kernel_vs_plain(device, batch=BATCH, shapes=BLOCK_SHAPES):
    """K1 against its plain version at each block shape, both LN variants.

    Returns (max |delta|, per-forward kernel ms, per-forward plain ms,
    per-forward bound ms, what bounds it), the per-forward figures summing
    each BiasFree shape's over its blocks.
    """
    import torch

    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.models.restormer import init_block_params
    from tpuir_torch.ops.fused_block import fused_transformer_block, fused_transformer_block_plain

    worst = 0.0
    fwd_ms = fwd_plain_ms = fwd_bytes = fwd_flops = 0.0
    with torch.inference_mode(), true_float32():
        for name, hw, C, heads, count in shapes:
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
                print(f"K1 {name:20s} B={batch} {hw}x{hw} C={C:3d} heads={heads} "
                      f"h={int(C * 2.66):4d} ln_bias={int(ln_bias)}  max|d|={max_err:.3e} "
                      f"(atol {ATOL:g} + rtol {RTOL:g}*|plain|: {'ok' if bound_ok else 'MISS'})  "
                      f"kernel {t_kern:.3f} ms  plain {t_plain:.3f} ms  bound {b_ms:.3f} ms",
                      flush=True)
                if not bound_ok:
                    fail(f"K1 disagrees with its plain version at {name} ln_bias={ln_bias}")
                worst = max(worst, max_err)
                if not ln_bias:
                    fwd_ms += count * t_kern
                    fwd_plain_ms += count * t_plain
                    fwd_bytes += count * nbytes
                    fwd_flops += count * flops
                del x, p
    return (worst, fwd_ms, fwd_plain_ms) + bound(fwd_bytes, fwd_flops)


def synthetic_image(h, w, seed):
    """A smooth uint8 test image (gradients plus a few discs), seeded."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([(yy / h), (xx / w), 0.5 + 0.5 * np.sin((xx + yy) / 23.0)], -1)
    for _ in range(6):
        cy, cx, r = rng.rand() * h, rng.rand() * w, 10 + rng.rand() * min(h, w) / 4
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.rand(3)
    return np.clip(np.round(img * 255), 0, 255).astype(np.uint8)


def serve(model, images, sigma=SIGMA):
    from tpuir_torch.core.engine import run_model_inference
    from tpuir_torch.core.metrics import calculate_metrics

    outs = []
    for img in images:
        pred, t_ms = run_model_inference(
            model, img, patch_size=model.patch_size, patch_overlap=model.patch_overlap,
            need_degradation=True, noise_level=sigma,
        )
        if pred.shape != img.shape or pred.dtype != np.uint8:
            fail(f"output {pred.shape} {pred.dtype} for input {img.shape} {img.dtype}")
        psnr, ssim = calculate_metrics(pred, img)
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


def serve_and_check(label, model, plain, cpu_model, requests, kernels, per_chunk, order):
    """Serve ``requests`` on the kernel and plain paths in the given order of
    rounds, with the kernels' counts set to 0 just before and read just
    after; check the counts, repeatability, kernel vs plain and card vs CPU
    (on the last request). Returns ({kernel: launches}, {path: Mpix/s})."""
    import torch

    from tpuir_torch.ops import _kernels

    images = [synthetic_image(h, w, SEED + i) for i, (h, w) in enumerate(requests)]
    mpix = sum(h * w for h, w in requests) / 1e6
    serve(model, images[-1:])  # warm-up: cuDNN and allocator, not counted
    serve(plain, images[-1:])
    torch.cuda.synchronize()
    paths = {"kernel": model, "plain": plain}
    served = {"kernel": [], "plain": []}
    _kernels.reset_launches()
    for name in order:
        served[name].append(serve(paths[name], images))
    launches = {k: _kernels.LAUNCHES[k] for k in kernels}
    n_chunks = sum(chunks_for(model, h, w) for h, w in requests)
    rounds = order.count("kernel")
    for k, n in launches.items():
        print(f"{label}: {k} launches {n} ({per_chunk} blocks x {n_chunks} chunks x "
              f"{rounds} rounds = {per_chunk * n_chunks * rounds})", flush=True)
        if n != per_chunk * n_chunks * rounds:
            fail(f"{k} launched {n} times on the {label} path, expected "
                 f"{per_chunk * n_chunks * rounds}")

    total = {"kernel": 0.0, "plain": 0.0}
    for i, (h, w) in enumerate(requests):
        pred, _, psnr, ssim = served["kernel"][0][i]
        ppred = served["plain"][0][i]
        if any(not np.array_equal(rnd[i][0], pred) for rnd in served["kernel"]):
            fail(f"the {label} kernel path is not repeatable on {h}x{w}")
        ms = {k: float(np.median([rnd[i][1] for rnd in v])) for k, v in served.items()}
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
    (cpu_pred, _, _, _), = serve(cpu_model, images[-1:])
    lsb = int(np.abs(cpu_pred.astype(int) - served["kernel"][0][-1][0].astype(int)).max())
    print(f"{label} request {requests[-1][0]}x{requests[-1][1]}x3 card vs CPU: max {lsb} LSB",
          flush=True)
    if lsb > 1:
        fail(f"{label}: card and CPU differ by {lsb} uint8 LSB")
    rate = {k: mpix / (v / 1e3) for k, v in total.items()}
    print(f"{label} engine over the {len(requests)} requests ({mpix:.4f} Mpix): kernel path "
          f"{rate['kernel']:.3f} Mpix/s, plain path {rate['plain']:.3f} Mpix/s", flush=True)
    return launches, rate


def phase_main_path(device, requests=REQUESTS):
    """Serve Restormer on the kernel and plain paths; returns
    ({"fused_transformer_block": launches}, {path: Mpix/s})."""
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
                           ["fused_transformer_block"], 44, order)


def mixer_inputs(device, batch, hw, seed=SEED):
    """Seeded MaIR-CDN mixer weights (block 0 of the released layout) and the
    activations the plain mixer makes from a unit-scale input of (batch, H, W)."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.models.mair import init_state_dict
    from tpuir_torch.ops.nss_prologue import mixer_prologue_plain
    from tpuir_torch.ops.nss_stripe import nss_scan_plain

    cfg = zoo.MAIR_CDN_CONFIG
    prefix = "layers.0.residual_group.blocks.0.self_attention."
    sd = {k[len(prefix):]: v.to(device) for k, v in init_state_dict(cfg, seed=seed).items()
          if k.startswith(prefix)}
    di = sd["conv2d.weight"].shape[0]
    n = sd["A_logs"].shape[1]
    h_img, w_img = hw
    h = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        batch, h_img, w_img, cfg["embed_dim"]).astype(np.float32)).to(device)
    pro = (h, sd["in_proj.weight"], sd["conv2d.weight"], sd["conv2d.bias"])
    x, z = mixer_prologue_plain(*pro)
    scan = dict(x=x, x_proj_w=sd["x_proj_weight"], dt_w=sd["dt_projs_weight"],
                A=-torch.exp(sd["A_logs"]).reshape(4, di, n), D=sd["Ds"].reshape(4, di),
                delta_bias=sd["dt_projs_bias"])
    y, pooled = nss_scan_plain(**scan)
    gw = sd["gating.gating.1.weight"].reshape(di, 4, 4)
    gb = sd["gating.gating.1.bias"].reshape(di, 4)
    gates = torch.sigmoid(torch.einsum("bid,doi->bod", pooled / (h_img * w_img), gw)
                          + gb.t()[None]).contiguous()
    epi = dict(y=y, gates=gates, z=z, ln_w=sd["out_norm.weight"], ln_b=sd["out_norm.bias"],
               w_out=sd["out_proj.weight"])
    return pro, scan, epi


def phase_mair_kernels(device):
    """K6, K2 and K7 against their plain versions at MaIR-CDN@128, batch 8
    (K2 also at the 96x72 tile, batch 1). Returns {kernel: (max|d|, ms,
    plain ms, bound ms, bound by)}, each per call at batch 8, 128x128 (K2:
    the mean over both shifts)."""
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
    ({kernel: launches}, {path: Mpix/s})."""
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
    return serve_and_check("MaIR", model, plain, cpu_model, requests,
                           ["mixer_prologue", "nss_scan", "mixer_epilogue"], MAIR_BLOCKS, order)


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
    k1_err, k1_ms, k1_plain_ms, k1_bound, k1_by = phase_kernel_vs_plain(device)
    print(f"K1 per forward (44 BiasFree blocks, batch {BATCH}): kernel {k1_ms:.2f} ms, "
          f"plain {k1_plain_ms:.2f} ms, bound {k1_bound:.2f} ms ({k1_by}); "
          f"max|d| {k1_err:.3e}  [{time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    launches, _ = phase_main_path(device)
    print(f"[Restormer path {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    rows = {"fused_transformer_block": (k1_err, k1_ms, k1_plain_ms, k1_bound, k1_by)}
    rows.update(phase_mair_kernels(device))
    print(f"[MaIR kernels {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    mair_launches, _ = phase_mair_path(device)
    launches.update(mair_launches)
    print(f"[MaIR path {time.time() - t0:.0f} s]", flush=True)

    print(card)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": KERNELS[name][0],
        "replaces": KERNELS[name][1], "launches": launches[name], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    } for name, (err, ms, plain_ms, b_ms, b_by) in rows.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
