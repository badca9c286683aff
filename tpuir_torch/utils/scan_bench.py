"""Time the chunked-scan kernels (K2, K5, K3, K4) at the main paths' shapes.

    python tpuir_torch/utils/scan_bench.py [--tree DIR] [--iters 5] [--sass FILE]

On the card, with CUDA events (one warm-up, then the mean of ``--iters``
calls) on seeded, fan-in-scaled operands with TF32 off, it times K2
(``nss_scan``) and K5 (``nss_scan_fused``) at MaIR-CDN@128, batch 8 (the
mean over both shifts) and at the five level shapes of MaIRUNet's 384x384
tile at batch 8, with their calls a forward; K3
(``selective_scan_fused_proj``) at the 481x321 request's two K3 levels
(batch 2) and per forward chunk; K4 (``selective_scan_kernel``) at
MaIR-CDN's shape and at MaIRUNet's latent. K2, K3, K4 and K5 share their
scan passes (``csrc/chunk_scan.cuh``).

``--tree DIR`` imports ``tpuir_torch`` from another checkout (the parent
commit unpacked under ``build/``, say) instead of this one, so that two
trees can be timed in turns on one card, one process each. ``--sass FILE``
prints, for each ``scan_chunk_kernel`` instance of the tree's kernel
library, its SASS instruction count and its MUFU.EX2 and MUFU.LG2 counts
(``cuobjdump -sass``), and writes the SASS of K2's two passes at d_state
16 to FILE. K2 at MaIR-CDN@128 (shift 0), enc-1 and dec-1, and K4, are
also broken down by kernel (``torch.profiler``). The card's ``nvidia-smi`` name and power
limit come first; the last line is the same as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

# (label, tile side, d_inner, d_state, dt rank, calls a MaIRUNet@384 forward)
UNET_LEVELS = [("enc-1", 384, 96, 4, 3, 4), ("dec-1", 384, 192, 8, 6, 8),
               ("level-2", 192, 192, 8, 6, 12), ("level-3", 96, 384, 16, 12, 12),
               ("latent", 48, 768, 32, 24, 8)]
CDN = ("MaIR-CDN@128", 128, 234, 16, 12)
# K3 on the 481x321 request: (label, H, W, d_inner, d_state, dt rank, calls a chunk), batch 2
K3_LEVELS = [("level-3 96x82", 96, 82, 384, 16, 12, 12),
             ("latent 48x41", 48, 41, 768, 32, 24, 8)]
# K4: (label, B, K, L, D, N)
K4_CASES = [("MaIR-CDN", 8, 4, 128 * 128, 234, 16), ("MaIRUNet latent", 8, 4, 48 * 48, 768, 32)]


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def sass_counts(lib: str, out: str) -> dict:
    """{scan_chunk_kernel instance: (instructions, MUFU.EX2, MUFU.LG2)} from
    ``cuobjdump -sass lib``; the SASS of K2's two passes at d_state 16 is
    written to ``out``."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    counts, name, kept = {}, None, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if "scan_chunk_kernel" in m.group(1) else None
            if name:
                counts[name] = [0, 0, 0]
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[name][0] += 1
            counts[name][1] += "MUFU.EX2" in line
            counts[name][2] += "MUFU.LG2" in line
        if name and "Li16ENS_12ImageIdsPath" in name:  # K2's passes at d_state 16
            kept.append(line)
    with open(out, "w") as f:
        f.write("\n".join(kept))
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="import tpuir_torch from this checkout")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--sass", help="write cuobjdump -sass of the library here")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree) if args.tree
                    else str(Path(__file__).resolve().parents[2]))
    import torch

    if not torch.cuda.is_available():
        print("scan_bench: no CUDA device", file=sys.stderr)
        return 1
    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.ops import _kernels
    from tpuir_torch.ops.nss_fused import nss_scan_fused
    from tpuir_torch.ops.nss_stripe import nss_scan
    from tpuir_torch.ops.scan_fused_proj import selective_scan_fused_proj
    from tpuir_torch.ops.selective_scan import selective_scan_kernel
    from tpuir_torch.utils.profiling import cuda_ms, kernel_times, trace_fn

    card = card_line()
    print(card, flush=True)
    tree = str(Path(_kernels.__file__).resolve().parents[2])
    lib = str(_kernels.build())
    _kernels.library()
    print(f"tree {tree}: {os.path.relpath(lib, tree)}", flush=True)
    res = {"card": card, "tree": tree, "ms": {}}
    if args.sass:
        res["sass"] = sass_counts(lib, args.sass)
        for name, (n, ex2, lg2) in res["sass"].items():
            print(f"  SASS {n:5d} instructions, {ex2:3d} MUFU.EX2, {lg2:2d} MUFU.LG2  {name}")

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.randn(*s) * scale).astype(np.float32)).to(dev)

    def scan_ops(b, hh, ww, di, n, r):
        return (f(b, hh, ww, di), f(4, r + 2 * n, di, scale=di ** -0.5),
                f(4, di, r, scale=r ** -0.5), -torch.exp(f(4, di, n, scale=0.3)),
                f(4, di, scale=0.3), f(4, di, scale=0.3))

    def timed(label, fn, split=False):
        ms = cuda_ms(fn, args.iters)
        res["ms"][label] = ms
        print(f"{label:34s} {ms:9.3f} ms", flush=True)
        if split:  # device ms of each kernel of one call, from torch.profiler
            _, prof = trace_fn(fn)
            for name, (kms, _) in kernel_times(prof).items():
                name = re.sub(r"\(anonymous namespace\)::|^void |\(.*$", "", name)
                res["ms"][f"{label}: {name}"] = kms
                print(f"    {kms:9.3f} ms  {name}", flush=True)
        return ms

    with torch.inference_mode(), true_float32():
        label, t, di, n, r = CDN
        ops = scan_ops(8, t, t, di, n, r)
        for name, fn in (("K2", nss_scan), ("K5", nss_scan_fused)):
            both = [timed(f"{name} {label} shift={s}", lambda s=s: fn(*ops, shift=bool(s)),
                          split=s == 0) for s in (0, 1)]
            res["ms"][f"{name} {label}"] = sum(both) / 2
        del ops
        fwd = {"K2": 0.0, "K5": 0.0}
        for label, t, di, n, r, calls in UNET_LEVELS:
            ops = scan_ops(8, t, t, di, n, r)
            for name, fn in (("K2", nss_scan), ("K5", nss_scan_fused)):
                fwd[name] += calls * timed(f"{name} MaIRUNet {label} [{calls}]", lambda: fn(*ops),
                                           split=name == "K2" and label in ("enc-1", "dec-1"))
            del ops
            torch.cuda.empty_cache()
        for name, ms in fwd.items():
            res["ms"][f"{name} per MaIRUNet@384 forward"] = ms
            print(f"{name} per MaIRUNet@384 forward (batch 8): {ms:.3f} ms", flush=True)
        k3 = 0.0
        for label, hh, ww, di, n, r, calls in K3_LEVELS:
            x, wxp, wdt, A, D, bias = scan_ops(2, 4, hh * ww, di, n, r)
            k3 += calls * timed(f"K3 {label} B=2 [{calls}]", lambda: selective_scan_fused_proj(
                x.reshape(2, 4, hh * ww, di), wxp, wdt, A, D, bias))
            del x
        res["ms"]["K3 per 481x321 chunk"] = k3
        print(f"K3 per forward chunk of the 481x321 request: {k3:.3f} ms", flush=True)
        for label, b, k, L, d, n in K4_CASES:
            u, delta = f(b, k, L, d), f(b, k, L, d, scale=0.5)
            A, Bm, Cm = -torch.exp(f(k, d, n, scale=0.5)), f(b, k, L, n), f(b, k, L, n)
            D, bias = f(k, d), f(k, d, scale=0.3)
            timed(f"K4 {label}", lambda: selective_scan_kernel(u, delta, A, Bm, Cm, D, bias),
                  split=True)
            del u, delta, Bm, Cm
            torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
