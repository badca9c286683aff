"""Time K1, K6, K7 and the three models' forwards at the main paths' shapes.

    python tpuir_torch/utils/gemm_bench.py [--tree DIR] [--iters 5] [--no-forwards]
                                           [--kernels core,K1,K6,K7]

On the card, with CUDA events (one warm-up, then the mean of ``--iters``
calls) on seeded operands with TF32 off, it times K1
(``fused_transformer_block``) at Restormer@256's five block shapes (batch
8, BiasFree) and per forward (blocks a shape x its time); K6
(``mixer_prologue``) and K7 (``mixer_epilogue``) at MaIR-CDN@128 (batch 8)
and at the five level shapes of MaIRUNet's 384x384 tile (batch 8) and per
forward; and one batch-8 forward of Restormer@256, MaIR-CDN@128 and
MaIRUNet@384 (full width and depth, weights drawn from a seed, every block
on its kernels; left out with ``--no-forwards``); ``--kernels`` keeps
only the parts it names. K1, K6 and K7 take their
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="import tpuir_torch from this checkout")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--no-forwards", action="store_true", help="leave out the three forwards")
    ap.add_argument("--kernels", default="core,K1,K6,K7",
                    help="the parts to time, of core (the GEMM core alone), K1, K6, K7")
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

        def k6(t, dm, di):
            ops = (f(BATCH, t, t, dm), f(2 * di, dm, scale=dm ** -0.5),
                   f(di, 1, 3, 3, scale=0.3), f(di, scale=0.05))
            return lambda: mixer_prologue(*ops)

        def k7(t, dm, di):
            gates = torch.from_numpy(rng.rand(BATCH, 4, di).astype(np.float32)).to(dev)
            ops = dict(y=f(BATCH, 4, t, t, di, scale=0.5), gates=gates,
                       z=f(BATCH, t, t, di, scale=0.5), ln_w=1.0 + f(di, scale=0.2),
                       ln_b=f(di, scale=0.1), w_out=f(dm, di, scale=di ** -0.5))
            return lambda: mixer_epilogue(**ops)

        for name, call in (("K6", k6), ("K7", k7)):
            if name not in parts:
                continue
            label, t, dm, di = CDN
            timed(f"{name} {label}", call(t, dm, di))
            fwd = 0.0
            for label, t, dm, di, calls in UNET_LEVELS:
                fwd += calls * timed(f"{name} MaIRUNet {label} [{calls}]", call(t, dm, di))
            res["ms"][f"{name} per MaIRUNet@384 forward"] = fwd
            print(f"{name} per MaIRUNet@384 forward (batch {BATCH}): {fwd:.3f} ms", flush=True)
            torch.cuda.empty_cache()

        nets = [("Restormer@256", 256, lambda: restormer.Restormer(**RESTORMER_CONFIG, fused=True),
                 lambda: restormer.init_state_dict(RESTORMER_CONFIG, seed=0)),
                ("MaIR-CDN@128", 128, lambda: mair.MaIR(**zoo.MAIR_CDN_CONFIG, fused=True),
                 lambda: mair.init_state_dict(zoo.MAIR_CDN_CONFIG, seed=0)),
                ("MaIRUNet@384", 384,
                 lambda: mair_unet.MaIRUNet(**zoo.MAIR_UNET_CONFIG, fused=True),
                 lambda: mair_unet.init_state_dict(zoo.MAIR_UNET_CONFIG, seed=0))]
        for label, tile, build, weights in [] if args.no_forwards else nets:
            net = build()
            net.load_state_dict(weights())
            net = net.to(dev).eval().requires_grad_(False)
            x = torch.from_numpy(rng.rand(BATCH, 3, tile, tile).astype(np.float32)).to(dev)
            timed(f"forward {label} batch {BATCH}", lambda: net(x))
            del net, x
            torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
