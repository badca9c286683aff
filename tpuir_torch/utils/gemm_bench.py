"""Time K1, K6, K7 and the three models' forwards at the main paths' shapes.

    python tpuir_torch/utils/gemm_bench.py [--tree DIR] [--iters 5] [--no-forwards]
                                           [--kernels core,K1,K1s,K6,K6s,K7,K7s]
                                           [--forwards LABELS] [--trace-dir DIR]

On the card, with CUDA events (one warm-up, then the mean of ``--iters``
calls) on seeded operands with TF32 off, it times K1
(``fused_transformer_block``) at Restormer@256's five block shapes (batch
8, BiasFree) and per forward (blocks a shape x its time); K1's serving
body (``K1s``: bf16 x, ``serving=True``) at the same shapes and per
forward, each shape also by kernel from ``torch.profiler`` (device ms a
block, launches, registers a thread, shared bytes a block, blocks an SM as
the trace reports them, and, where ``K1S_BYTES`` counts a launch's
bytes, the bytes a second it reached), with the Restormer@256 serving
forward among the forwards; K6
(``mixer_prologue``) and K7 (``mixer_epilogue``) at MaIR-CDN@128 (batch 8)
and at the five level shapes of MaIRUNet's 384x384 tile (batch 8) and per
forward, in parity and (``K6s``, ``K7s``) in serving precision, the serving
bodies also by kernel at each shape (``MIXER_BYTES``); and one batch-8
forward of Restormer@256, MaIR-CDN@128 and MaIRUNet@384 (full width and
depth, weights drawn from a seed, every block on its kernels), each also in
serving precision (MaIR's with TF32 at PyTorch's defaults, as the engine
serves it), MaIR's also in serving precision on the fused NSS route
(``nss="fused"``: K5); left out with ``--no-forwards``, chosen by label prefix with
``--forwards``; ``--kernels`` keeps only the parts it names. K1, K6 and K7 take their
products in the 3xTF32 arithmetic of the tensor-core GEMM core
(``csrc/tc_gemm.cuh``); where the tree has it (``ops/tc_gemm.py``), the
core alone is timed first at a few of their product shapes, in TFLOP/s.

``--tree DIR`` imports ``tpuir_torch`` from another checkout (the parent
commit unpacked under ``build/``, say) instead of this one, so that two
trees can be timed in turns on one card, one process each. The card's
``nvidia-smi`` name and power limit come first; the last line is the same
as one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

BATCH = 8
# Restormer@256: (label, H = W, C, heads, blocks a forward)
BLOCK_SHAPES = [("level1", 256, 48, 1, 4), ("level2", 128, 96, 2, 12),
                ("level3", 64, 192, 4, 12), ("latent", 32, 384, 8, 8),
                ("decoder1+refinement", 256, 96, 1, 8)]
# K6 and K7: (label, tile side, d_model, d_inner, calls a MaIRUNet@384 forward)
CDN = ("MaIR-CDN@128", 128, 180, 234)
UNET_LEVELS = [("enc-1", 384, 48, 96, 4), ("dec-1", 384, 96, 192, 8),
               ("level-2", 192, 96, 192, 12), ("level-3", 96, 192, 384, 12),
               ("latent", 48, 384, 768, 8)]
RESTORMER_CONFIG = dict(layer_norm_bias=False)  # released color denoising (BiasFree)
# Bytes one launch of a K1 serving kernel moves (each input read once, each
# output written once), by a fragment of its name, from (pixels, C, h):
# the unfused body's kernels (float32 intermediates), then the fused body's. A
# fragment that occurs twice in a body (the unfused body's two LayerNorm
# statistics) moves the same bytes each time.
K1S_BYTES = [
    ("widen_kernel", lambda px, C, h: px * 6 * C),
    ("ln_stats_kernel<true>(", lambda px, C, h: px * (4 * C + 8)),
    ("BlockOut<1,", lambda px, C, h: px * 16 * C),
    ("dwconv3x3_kernel<0>", lambda px, C, h: px * 24 * C),
    ("gram_partial_kernel", lambda px, C, h: px * 8 * C),
    ("BlockOut<5, float, float> >(tc::Args,", lambda px, C, h: px * 8 * C),
    ("BlockOut<2, float, __nv_bfloat16> >(tc::Args,", lambda px, C, h: px * 10 * C),
    ("BlockOut<3,", lambda px, C, h: px * (4 * C + 8 * h)),
    ("dwconv3x3_kernel<2>", lambda px, C, h: px * 12 * h),
    ("BlockOut<4, __nv_bfloat16, float> >(tc::Args,", lambda px, C, h: px * (6 * C + 4 * h)),
    # the fused body: bf16 x, q | k | v, ao and gate; the fused kernels' bytes
    # count each input once (their halo re-reads come from L2)
    ("ln_stats_kernel<true, __nv_bfloat16>", lambda px, C, h: px * (2 * C + 8)),
    ("ln_stats_kernel<true, float>", lambda px, C, h: px * (4 * C + 8)),
    ("conv_product_kernel<__nv_bfloat16, false>", lambda px, C, h: px * (2 * C + 8 + 6 * C)),
    ("conv_product_kernel<float, true>", lambda px, C, h: px * (4 * C + 8 + 2 * h)),
    ("gram_mma_kernel", lambda px, C, h: px * 4 * C),
    ("BlockOut<5, __nv_bfloat16, float> >(tc::ArgsBf16", lambda px, C, h: px * 4 * C),
    ("BlockOut<2, float, __nv_bfloat16> >(tc::ArgsBf16", lambda px, C, h: px * 8 * C),
    ("BlockOut<4, __nv_bfloat16, float> >(tc::ArgsBf16", lambda px, C, h: px * (6 * C + 2 * h)),
]
# Bytes one launch of a MaIR serving kernel moves, by a fragment of its name,
# from (pixels, d_model, d_inner): K6's fused kernel (h in, x and z out;
# halo re-reads from L2 not counted), K7's combine (four bf16 directions and
# z in, the bf16 gated rows out, padded to 8) and out_proj (the gated rows
# in, float32 out).
MIXER_BYTES = [
    ("prologue_bf16_kernel", lambda px, dm, di: px * (4 * dm + 4 * di)),
    ("combine_norm_gate_kernel", lambda px, dm, di: px * (10 * di + 2 * (-(-di // 8) * 8))),
    ("gemm_bf16_kernel", lambda px, dm, di: px * (2 * (-(-di // 8) * 8) + 4 * dm)),
]
# the core alone: (label, M, N, K), one weight, unit-scale A, fan-in-scaled W
CORE_SHAPES = [("K1 level1 qkv", 524288, 144, 48), ("K1 decoder1 qkv", 524288, 288, 96),
               ("K1 decoder1 ffn_in", 524288, 510, 96), ("K1 decoder1 ffn_out", 524288, 96, 255),
               ("K1 latent ffn_out", 8192, 384, 1021), ("K6 MaIR-CDN@128", 131072, 468, 180),
               ("K6 MaIRUNet latent", 18432, 1536, 384),
               ("K7 MaIR-CDN@128 out_proj", 131072, 180, 234)]


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def trace_args(path: str) -> dict:
    """{kernel name: (registers a thread, shared bytes a block, blocks an SM)}
    from a chrome trace that torch.profiler exported; blocks an SM is the
    most that the registers (65,536 an SM, 8 a thread at a time), shared
    memory (233,472 bytes an SM, 1 KB reserved a block) and threads (2,048)
    let reside."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    out = {}
    for e in events:
        a = e.get("args", {})
        if e.get("cat") == "kernel" and "registers per thread" in a:
            threads = a["block"][0] * a["block"][1] * a["block"][2]
            regs, smem = a["registers per thread"], a.get("shared memory") or 0
            blocks = min(65536 // (-(-regs // 8) * 8 * threads), 233472 // (smem + 1024),
                         2048 // threads, 32)
            out[e["name"]] = (regs, smem, blocks)
    return out


def by_kernel(fn, label, px, dims, table, trace_dir):
    """Profile two calls of fn; print each kernel's device ms a call,
    launches a call, registers, shared bytes, blocks an SM and, where
    ``table`` ((name fragment, bytes from (px, *dims)) pairs) counts it,
    GB/s. Returns {kernel: ms a call}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpuir_torch.utils.profiling import kernel_times

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{label}.json".replace(" ", "_"))
    prof.export_chrome_trace(path)
    args = trace_args(path)
    out = {}
    for name, (ms, n) in sorted(kernel_times(prof).items(), key=lambda kv: -kv[1][0]):
        ms, n = ms / 2, n // 2
        nb = next((f(px, *dims) for frag, f in table if frag in name), None)
        rate = f" {nb * n / ms / 1e6:7.1f} GB/s" if nb else ""
        regs, smem, blocks = next((v for k, v in args.items() if k[:60] == name[:60]),
                                  (None, None, None))
        print(f"    {ms:8.3f} ms {n:2d}x regs {regs} smem {smem} blocks/SM {blocks}{rate}  "
              f"{name[:110]}", flush=True)
        out[name[:110]] = ms
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="import tpuir_torch from this checkout")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--no-forwards", action="store_true", help="leave out the forwards")
    ap.add_argument("--forwards", default="",
                    help="keep only the forwards whose label starts with one of these "
                         "(comma-separated; default all)")
    ap.add_argument("--kernels", default="core,K1,K6,K7",
                    help="the parts to time, of core (the GEMM core alone), K1, K1s (K1's "
                         "serving body), K6, K6s, K7, K7s (their serving bodies)")
    ap.add_argument("--trace-dir", default="build/gemm_bench",
                    help="where the serving bodies' by-kernel traces go")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree) if args.tree
                    else str(Path(__file__).resolve().parents[2]))
    import torch

    if not torch.cuda.is_available():
        print("gemm_bench: no CUDA device", file=sys.stderr)
        return 1
    from tpuir_torch import zoo
    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.models import mair, mair_unet, restormer
    from tpuir_torch.ops import _kernels
    from tpuir_torch.ops.fused_block import fused_transformer_block
    from tpuir_torch.ops.nss_epilogue import mixer_epilogue
    from tpuir_torch.ops.nss_prologue import mixer_prologue
    from tpuir_torch.utils.profiling import cuda_ms

    card = card_line()
    print(card, flush=True)
    tree = str(Path(_kernels.__file__).resolve().parents[2])
    lib = str(_kernels.build())
    _kernels.library()
    print(f"tree {tree}: {os.path.relpath(lib, tree)}", flush=True)
    res = {"card": card, "tree": tree, "ms": {}}
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.randn(*s) * scale).astype(np.float32)).to(dev)

    def timed(label, fn):
        ms = cuda_ms(fn, args.iters)
        res["ms"][label] = ms
        print(f"{label:40s} {ms:9.3f} ms", flush=True)
        return ms

    with torch.inference_mode(), true_float32():
        try:
            from tpuir_torch.ops.tc_gemm import gemm_f32x3
        except ImportError:  # a tree from before the core
            gemm_f32x3 = None
        parts = set(args.kernels.split(","))
        for label, M, N, K in CORE_SHAPES if gemm_f32x3 and "core" in parts else ():
            a, w = f(M, K), f(N, K, scale=K ** -0.5)
            ms = timed(f"core {label} {M}x{N}x{K}", lambda: gemm_f32x3(a, w))
            res["ms"][f"core {label} TFLOP/s"] = 2 * M * N * K / ms / 1e9
            print(f"    {2 * M * N * K / ms / 1e9:.1f} TFLOP/s", flush=True)
            del a, w
        fwd = 0.0
        for label, hw, C, heads, count in BLOCK_SHAPES if "K1" in parts else ():
            p = {k: v.to(dev) for k, v in restormer.init_block_params(C, heads, False, C).items()}
            x = f(BATCH, hw, hw, C).permute(0, 3, 1, 2)
            fwd += count * timed(f"K1 {label} [{count}]",
                                 lambda: fused_transformer_block(x, p, heads, False))
            del p, x
        if "K1" in parts:
            res["ms"]["K1 per Restormer@256 forward"] = fwd
            print(f"K1 per Restormer@256 forward (batch {BATCH}): {fwd:.3f} ms", flush=True)
        fwd = 0.0
        for label, hw, C, heads, count in BLOCK_SHAPES if "K1s" in parts else ():
            p = {k: v.to(dev) for k, v in restormer.init_block_params(C, heads, False, C).items()}
            x = torch.from_numpy(rng.rand(BATCH, hw, hw, C).astype(np.float32)).to(dev).to(
                torch.bfloat16).permute(0, 3, 1, 2)
            call = lambda: fused_transformer_block(x, p, heads, False, serving=True)  # noqa: E731
            fwd += count * timed(f"K1s {label} [{count}]", call)
            res["ms"][f"K1s {label} by kernel"] = by_kernel(
                call, f"k1s_{label}", BATCH * hw * hw, (C, int(C * 2.66)), K1S_BYTES,
                args.trace_dir)
            del p, x
        if "K1s" in parts:
            res["ms"]["K1s per Restormer@256 forward"] = fwd
            print(f"K1s per Restormer@256 forward (batch {BATCH}): {fwd:.3f} ms", flush=True)

        def k6(t, dm, di, serving=False):
            ops = (f(BATCH, t, t, dm), f(2 * di, dm, scale=dm ** -0.5),
                   f(di, 1, 3, 3, scale=0.3), f(di, scale=0.05))
            return lambda: mixer_prologue(*ops, serving=serving)

        def k7(t, dm, di, serving=False):
            io = torch.bfloat16 if serving else torch.float32
            gates = torch.from_numpy(rng.rand(BATCH, 4, di).astype(np.float32)).to(dev)
            ops = dict(y=f(BATCH, 4, t, t, di, scale=0.5).to(io), gates=gates,
                       z=f(BATCH, t, t, di, scale=0.5).to(io), ln_w=1.0 + f(di, scale=0.2),
                       ln_b=f(di, scale=0.1), w_out=f(dm, di, scale=di ** -0.5))
            return lambda: mixer_epilogue(**ops, serving=serving)

        for name, call in (("K6", k6), ("K6s", k6), ("K7", k7), ("K7s", k7)):
            if name not in parts:
                continue
            serving = name.endswith("s")
            label, t, dm, di = CDN
            fn = call(t, dm, di, serving)
            timed(f"{name} {label}", fn)
            if serving:
                res["ms"][f"{name} {label} by kernel"] = by_kernel(
                    fn, f"{name}_{label}", BATCH * t * t, (dm, di), MIXER_BYTES, args.trace_dir)
            fwd = 0.0
            for label, t, dm, di, calls in UNET_LEVELS:
                fn = call(t, dm, di, serving)
                fwd += calls * timed(f"{name} MaIRUNet {label} [{calls}]", fn)
                if serving:
                    res["ms"][f"{name} MaIRUNet {label} by kernel"] = by_kernel(
                        fn, f"{name}_{label}", BATCH * t * t, (dm, di), MIXER_BYTES,
                        args.trace_dir)
                del fn
                torch.cuda.empty_cache()
            res["ms"][f"{name} per MaIRUNet@384 forward"] = fwd
            print(f"{name} per MaIRUNet@384 forward (batch {BATCH}): {fwd:.3f} ms", flush=True)
            torch.cuda.empty_cache()

    # (label, tile, model, weights, TF32 pinned off): MaIR's serving forwards
    # run with TF32 at PyTorch's defaults, as the engine serves them
    nets = [("Restormer@256", 256, lambda: restormer.Restormer(**RESTORMER_CONFIG, fused=True),
             lambda: restormer.init_state_dict(RESTORMER_CONFIG, seed=0), True),
            ("Restormer@256 serving", 256,
             lambda: restormer.Restormer(**RESTORMER_CONFIG, fused=True, serving=True),
             lambda: restormer.init_state_dict(RESTORMER_CONFIG, seed=0), True),
            ("MaIR-CDN@128", 128, lambda: mair.MaIR(**zoo.MAIR_CDN_CONFIG, fused=True),
             lambda: mair.init_state_dict(zoo.MAIR_CDN_CONFIG, seed=0), True),
            ("MaIR-CDN@128 serving", 128,
             lambda: mair.MaIR(**zoo.MAIR_CDN_CONFIG, fused=True, serving=True),
             lambda: mair.init_state_dict(zoo.MAIR_CDN_CONFIG, seed=0), False),
            ("MaIRUNet@384", 384,
             lambda: mair_unet.MaIRUNet(**zoo.MAIR_UNET_CONFIG, fused=True),
             lambda: mair_unet.init_state_dict(zoo.MAIR_UNET_CONFIG, seed=0), True),
            ("MaIRUNet@384 serving", 384,
             lambda: mair_unet.MaIRUNet(**zoo.MAIR_UNET_CONFIG, fused=True, serving=True),
             lambda: mair_unet.init_state_dict(zoo.MAIR_UNET_CONFIG, seed=0), False),
            # the fused NSS route (K5 where a level's H and W are multiples of scan_len)
            ("MaIR-CDN@128 serving fused", 128,
             lambda: mair.MaIR(**zoo.MAIR_CDN_CONFIG, fused=True, nss="fused", serving=True),
             lambda: mair.init_state_dict(zoo.MAIR_CDN_CONFIG, seed=0), False),
            ("MaIRUNet@384 serving fused", 384,
             lambda: mair_unet.MaIRUNet(**zoo.MAIR_UNET_CONFIG, fused=True, nss="fused",
                                        serving=True),
             lambda: mair_unet.init_state_dict(zoo.MAIR_UNET_CONFIG, seed=0), False)]
    keep = tuple(f for f in args.forwards.split(",") if f) or ("",)
    for label, tile, build, weights, pin in [] if args.no_forwards else nets:
        if not label.startswith(keep):
            continue
        net = build()
        net.load_state_dict(weights())
        net = net.to(dev).eval().requires_grad_(False)
        x = torch.from_numpy(rng.rand(BATCH, 3, tile, tile).astype(np.float32)).to(dev)
        with torch.inference_mode(), true_float32() if pin else contextlib.nullcontext():
            timed(f"forward {label} batch {BATCH}", lambda: net(x))
        del net, x
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
