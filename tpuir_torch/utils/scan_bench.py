"""Time the scan kernels (K2, K5, K3, K4) at the main paths' shapes.

    python tpuir_torch/utils/scan_bench.py [--tree DIR] [--iters 5]
                                           [--kernels K2,K5,K3,K4,K2s] [--accuracy]

On the card, with CUDA events (one warm-up, then the mean of ``--iters``
calls) on seeded, fan-in-scaled operands with TF32 off, it times K2
(``nss_scan``) and K5 (``nss_scan_fused``) at MaIR-CDN@128, batch 8 (the
mean over both shifts) and at the five level shapes of MaIRUNet's 384x384
tile at batch 8, with their calls a forward; K3
(``selective_scan_fused_proj``) at the 481x321 request's two K3 levels
(batch 2) and per forward chunk; K4 (``selective_scan_kernel``) at
MaIR-CDN's shape and at MaIRUNet's latent; with ``K2s`` in ``--kernels``,
K2's serving body (``nss_scan(..., serving=True)``, bf16 x) at
MaIR-CDN@128, batch 8. K2, K4 and K5 share their scan passes
(``csrc/chunk_scan.cuh``). ``--kernels`` keeps only the ones it names
(default: all but K2s).

``--tree DIR`` imports ``tpuir_torch`` from another checkout (the parent
commit unpacked under ``build/``, say) instead of this one, so that two
trees can be timed in turns on one card, one process each. The two trees'
SASS is compared by ``utils/sass_diff.py``.

K2 at MaIR-CDN@128 (shift 0), enc-1 and dec-1, K3 at both its levels, and
K4, are also broken down by kernel (``torch.profiler``); for K3 each
kernel's registers a thread (``ptxas -v`` in the build log, where this
process built the library), block size and shared memory (the profiler's
trace), and the blocks of it an SM holds at once, from those
(``resident_blocks``). ``--accuracy`` also holds K3 at both levels against
its plain version, and both of them against the plain version in float64,
as shares of the scan's card tolerance. The card's ``nvidia-smi`` name and
power limit come first; the last line is the same as one JSON object.
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


# An H100 SM: registers, threads, blocks and shared memory it holds at once
SM_REGS, SM_THREADS, SM_BLOCKS, SM_SMEM = 65536, 2048, 32, 233472


def resident_blocks(regs: int, threads: int, smem: int) -> int:
    """Blocks of ``threads`` threads, ``regs`` registers a thread and ``smem``
    bytes of shared memory that one SM holds at once (CUDA's occupancy
    arithmetic: registers allocated 256 a warp, 1 KB of shared memory
    reserved a block)."""
    warps = (threads + 31) // 32
    per_warp = (regs * 32 + 255) // 256 * 256
    by_regs = (SM_REGS // per_warp) // warps if per_warp else SM_BLOCKS
    return min(by_regs, SM_THREADS // (warps * 32), SM_BLOCKS, SM_SMEM // (smem + 1024))


def short_name(name: str) -> str:
    """A kernel's demangled name without namespaces, return type or arguments."""
    return re.sub(r"\(anonymous namespace\)::|^void |\(.*$", "", name)


def ptxas_registers(log: str) -> dict:
    """{short kernel name: registers a thread} from nvcc's ``-Xptxas=-v``
    output, the names demangled by ``c++filt`` (or the toolkit's
    ``cu++filt``); empty if neither is found."""
    regs, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
    tool = shutil.which("c++filt") or shutil.which("cu++filt") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cu++filt")
    if not regs or not os.path.exists(tool):
        return {}
    names = list(regs)
    plain = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                           check=True).stdout.splitlines()
    return {short_name(p): regs[n] for n, p in zip(names, plain)}


def launch_shapes(prof) -> dict:
    """{kernel name: (block threads, shared bytes a block)} of a profile's
    kernels, from its chrome trace."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    out = {}
    for e in events:
        args = e.get("args") or {}
        if e.get("cat") == "kernel" and "block" in args:
            threads = int(np.prod(args["block"]))
            out[e["name"]] = (threads, int(args.get("shared memory", 0)))
    return out


SCAN_ATOL, SCAN_RTOL = 5e-5, 1e-3  # the scan's card tolerance (tests/test_torch_scan_fused.py)


def k3_accuracy(label, ops, res) -> None:
    """Print max|d| and its worst share of SCAN_ATOL + SCAN_RTOL * |want| for
    K3 against its plain version, and for each of them against the plain
    version in float64 (TF32 off)."""
    import torch

    from tpuir_torch.ops.scan_fused_proj import (selective_scan_fused_proj,
                                                 selective_scan_fused_proj_plain)

    kern = selective_scan_fused_proj(*ops)
    plain = selective_scan_fused_proj_plain(*ops)
    f64 = selective_scan_fused_proj_plain(*(t.double() for t in ops))
    for name, got, want in (("kernel vs plain", kern, plain), ("kernel vs float64", kern, f64),
                            ("plain vs float64", plain, f64)):
        err = (got.double() - want.double()).abs()
        share = (err / (SCAN_ATOL + SCAN_RTOL * want.double().abs())).max().item()
        res.setdefault("accuracy", {})[f"{label}: {name}"] = [err.max().item(), share]
        print(f"    {name:18s} max|d| {err.max().item():.3e}, {share:.3f} of the tolerance",
              flush=True)
    del kern, plain, f64
    torch.cuda.empty_cache()


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="import tpuir_torch from this checkout")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--kernels", default="K2,K5,K3,K4",
                    help="comma-separated subset of K2,K5,K3,K4,K2s to time")
    ap.add_argument("--accuracy", action="store_true",
                    help="K3 against its plain version and both against float64")
    args = ap.parse_args(argv)
    want = set(args.kernels.split(","))
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

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.randn(*s) * scale).astype(np.float32)).to(dev)

    def scan_ops(b, hh, ww, di, n, r):
        return (f(b, hh, ww, di), f(4, r + 2 * n, di, scale=di ** -0.5),
                f(4, di, r, scale=r ** -0.5), -torch.exp(f(4, di, n, scale=0.3)),
                f(4, di, scale=0.3), f(4, di, scale=0.3))

    regs = ptxas_registers(_kernels.build_log)

    def timed(label, fn, split=False, occupancy=False):
        ms = cuda_ms(fn, args.iters)
        res["ms"][label] = ms
        print(f"{label:34s} {ms:9.3f} ms", flush=True)
        if split:  # device ms of each kernel of one call, from torch.profiler
            _, prof = trace_fn(fn)
            shapes = launch_shapes(prof) if occupancy else {}
            for name, (kms, _) in kernel_times(prof).items():
                short = short_name(name)
                res["ms"][f"{label}: {short}"] = kms
                extra = ""
                if name in shapes:
                    threads, smem = shapes[name]
                    reg = regs.get(short)
                    blocks = resident_blocks(reg, threads, smem) if reg else None
                    extra = (f"  [{threads} threads, {smem} B shared, "
                             f"{reg if reg else '?'} registers, {blocks or '?'} blocks/SM]")
                    res.setdefault("occupancy", {})[f"{label}: {short}"] = [threads, smem, reg,
                                                                             blocks]
                print(f"    {kms:9.3f} ms  {short}{extra}", flush=True)
        return ms

    stripe = [(name, fn) for name, fn in (("K2", nss_scan), ("K5", nss_scan_fused))
              if name in want]
    with torch.inference_mode(), true_float32():
        label, t, di, n, r = CDN
        ops = scan_ops(8, t, t, di, n, r) if stripe else None  # (K2s makes its own)
        for name, fn in stripe:
            both = [timed(f"{name} {label} shift={s}", lambda s=s: fn(*ops, shift=bool(s)),
                          split=s == 0) for s in (0, 1)]
            res["ms"][f"{name} {label}"] = sum(both) / 2
        if "K2s" in want:
            ops = scan_ops(8, t, t, di, n, r)
            ops = (ops[0].to(torch.bfloat16),) + ops[1:]
            both = [timed(f"K2s {label} shift={s}",
                          lambda s=s: nss_scan(*ops, shift=bool(s), serving=True), split=s == 0)
                    for s in (0, 1)]
            res["ms"][f"K2s {label}"] = sum(both) / 2
        del ops
        fwd = {name: 0.0 for name, _ in stripe}
        for label, t, di, n, r, calls in UNET_LEVELS if stripe else ():
            ops = scan_ops(8, t, t, di, n, r)
            for name, fn in stripe:
                fwd[name] += calls * timed(f"{name} MaIRUNet {label} [{calls}]", lambda: fn(*ops),
                                           split=name == "K2" and label in ("enc-1", "dec-1"))
            del ops
            torch.cuda.empty_cache()
        for name, ms in fwd.items():
            res["ms"][f"{name} per MaIRUNet@384 forward"] = ms
            print(f"{name} per MaIRUNet@384 forward (batch 8): {ms:.3f} ms", flush=True)
        k3 = 0.0
        for label, hh, ww, di, n, r, calls in K3_LEVELS if "K3" in want else ():
            x, wxp, wdt, A, D, bias = scan_ops(2, 4, hh * ww, di, n, r)
            k3 += calls * timed(f"K3 {label} B=2 [{calls}]", lambda: selective_scan_fused_proj(
                x.reshape(2, 4, hh * ww, di), wxp, wdt, A, D, bias), split=True, occupancy=True)
            if args.accuracy:
                k3_accuracy(f"K3 {label}", (x.reshape(2, 4, hh * ww, di), wxp, wdt, A, D, bias),
                            res)
            del x
        if "K3" in want:
            res["ms"]["K3 per 481x321 chunk"] = k3
            print(f"K3 per forward chunk of the 481x321 request: {k3:.3f} ms", flush=True)
        for label, b, k, L, d, n in K4_CASES if "K4" in want else ():
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
