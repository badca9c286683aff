"""Where the fused product-and-conv kernels of K1's and K6's serving bodies,
and the scans of K2's and K5's, spend their time, on the card.

    python tpuir_torch/utils/k1s_phases.py [--body K1s|K6s|K2s|K5s|passes|K2s-layouts]
                                           [--rounds 2] [--tree DIR]

Builds copies of ``tpuir_torch/`` (this tree's, or with ``--tree`` the
checkout at DIR's) under ``build/<body>_phases/``, each with one phase of
the body's kernel taken out, and times the body in each with
``utils/gemm_bench.py --kernels <body>`` (the scans: ``utils/scan_bench.py``
with the kernels of ``scan_kernels``), in turns with the unchanged copy. A
copy's output is wrong; only its time is read. What a phase's removal saves
is an upper bound on what making it free would save.

* ``K1s`` (``PHASES``): ``conv_product_kernel`` (``csrc/fused_block.cu``)
  without the depthwise 3x3 and its stores (``conv``), the tensor-core
  product (``product``) or the halo's LayerNorm into A' (``halo``). Each
  line: the copy, the round, K1 serving's ms a Restormer@256 forward (five
  block shapes, batch 8), and the two fused kernels' ms at each shape (the
  gate's, then qkv's).
* ``K6s`` (``K6S_PHASES``): ``prologue_bf16_kernel`` (``csrc/nss_prologue.cu``)
  without the 3x3, its bias, SiLU and stores (``conv``), the x half's
  product (``x product``), the z half's product (``z product``) or the
  halo's A (``halo``). Each line: the copy, the round, K6 serving's ms at
  MaIR-CDN@128 and a MaIRUNet@384 forward (batch 8).
* ``K2s`` (``K2S_PHASES``) and ``K5s`` (``K5S_PHASES``): the serving walk
  (``walk_chunk`` in ``csrc/nss_walk.cuh``), timed through K2's or K5's
  serving body, without dt's R-term dot and softplus (``dt``), the
  exponential of each update (``exp``: the decay taken as dt * A), the
  butterfly over a channel's lanes (``butterfly``), the y stores (``y
  store``), the x_dbl rows' staging (``x_dbl staging``), or the walk of
  every chunk but the last before the carries (``pass 1``); K5s also
  without the stripe arithmetic (``stripe arithmetic``: each position read
  and written at its own index).
* ``passes`` (``PASS_PHASES``): the chunked passes of
  ``csrc/chunk_scan.cuh`` without dt's R-term dot (``dt dot``), softplus
  (``softplus``), the exponential of each update (``exp``), the gathered u
  (``u``), the y stores (``y store``), or pass 1 (``pass 1``), timed
  through the parity bodies of K2 and K5, or through K5's serving body on
  a tree (``--tree``) whose serving body still runs the passes.
* ``K2s-layouts`` (``K2S_LAYOUTS``): not phases but the walk's other
  choices, each copy one of them: a channel's states as G lanes x S states
  for one state ceiling (``WalkLanes`` in ``csrc/nss_walk.cuh`` and
  ``WALK_LANES`` in ``ops/nss_stripe.py``),
  another share of the card from which one chunk is walked (half; 1:
  chunks wherever they fit), one wave of chunks instead of two
  (``serving_chunks``), or 8 warps a block (``kWalkWarps``,
  ``WALK_BLOCK_WARPS``), timed through K2's serving body. Its output is
  right.
  Each line of these four: the copy, the round, and for each body timed its
  ms at MaIR-CDN@128 (the mean over both shifts), enc-1, dec-1 and a
  MaIRUNet@384 forward (batch 8).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
FB, PRO = "fused_block.cu", "nss_prologue.cu"
# copy -> its edits, as serving_mutants.plant takes them: [(source under csrc/,
# text, its replacement)], each text occurring once
PHASES = {
    "unchanged": [],
    "conv": [(FB, "for (int it = tid; it < NS * kTH * (kTW / RUN); it += kThreads) {",
              "for (int it = tid; it < 0; it += kThreads) {")],
    "product": [(FB, "for (int k0 = 0; k0 < C; k0 += 16) {",
                 "for (int k0 = 0; k0 < 0; k0 += 16) {")],
    "halo": [(FB, "for (int e0 = tid; e0 < kHaloRows * CG; e0 += kBatch * kThreads) {",
              "for (int e0 = tid; e0 < 0; e0 += kBatch * kThreads) {")],
}
K6S_PHASES = {
    "unchanged": [],
    "conv": [(PRO, "for (int it = tid; it < kNP * kTH * (kTW / kRun); it += kThreads) {",
              "for (int it = tid; it < 0; it += kThreads) {")],
    "x product": [(PRO, "k0 < p.kp; k0 += 16) {  // the x product's k steps",
                   "k0 < 0; k0 += 16) {  // the x product's k steps")],
    "z product": [(PRO, "k0 < p.kp; k0 += 16) {  // the z product's k steps",
                   "k0 < 0; k0 += 16) {  // the z product's k steps")],
    "halo": [(PRO, "for (int e0 = tid; e0 < kHaloRows * G; e0 += kBatch * kThreads) {",
              "for (int e0 = tid; e0 < 0; e0 += kBatch * kThreads) {")],
}
WALK, SCAN = "nss_walk.cuh", "chunk_scan.cuh"
K2S_PHASES = {
    "unchanged": [],
    "dt": [(WALK, "      for (int r = 0; r < R4; r += 4) {\n        float4 x4",
            "      for (int r = 0; r < 0; r += 4) {\n        float4 x4"),
           (WALK, "const float dt = live ? softplus(dr[cc]) : 0.f;",
            "const float dt = live ? dr[cc] : 0.f;")],
    "exp": [(WALK, "h[s] = fmaf(exp2_mufu(dt * A2[s]), h[s], du * bv[s]);",
             "h[s] = fmaf(dt * A2[s], h[s], du * bv[s]);")],
    "butterfly": [(WALK, "      sum_over_lanes<G>(p, lane);\n", "")],
    "y store": [(WALK, "          *reinterpret_cast<__nv_bfloat162*>(y_b + id[row] * D + dp) =\n"
                       "              __floats2bfloat162_rn(y0, y1);  // y's rounding\n", "")],
    "x_dbl staging": [(WALK, "for (int e = tid; e < T * q4; e += NT) {",
                       "for (int e = tid; e < 0; e += NT) {")],
    "pass 1": [(WALK, "    ends<<<dim3(blocks, a.nchunk - 1, (unsigned)BK), kWalkWarps * 32, smem, "
                      "st>>>(a);\n", "")],
}
# K5's walk: the same phases, and the stripe arithmetic (each position read
# and written at its own index)
K5S_PHASES = {
    **K2S_PHASES,
    "stripe arithmetic": [
        (WALK, "  if (live) nss_pixel(k, t, a.H, a.W, a.scan_len, a.shift != 0, pixel, out);\n",
         "  if (live) pixel = out = t;\n")],
}
PASS_PHASES = {
    "unchanged": [],
    "dt dot": [(SCAN, "      if constexpr (!kDeltaRows) {\n        for (int r = 0; r < R4; r += 4) {",
                "      if constexpr (!kDeltaRows) {\n        for (int r = 0; r < 0; r += 4) {")],
    "softplus": [(SCAN, "dtg[g] = p + g < nt ? softplus(dr[g]) : 0.f;",
                  "dtg[g] = p + g < nt ? dr[g] : 0.f;")],
    "exp": [(SCAN, "h[n] = fmaf(exp2_mufu(dt * A2[n]), h[n], du * bq[j]);",
             "h[n] = fmaf(dt * A2[n], h[n], du * bq[j]);")],
    "u": [(SCAN, "auto load_u = [&](int q) { return q < nc ? xb[rows_s[q] * D] : u0; };",
           "auto load_u = [&](int q) { return u0; };")],
    "y store": [(SCAN, "scan_store(yb + outs_s[p0 + p + g] * D, out);", "(void)0;"),
                (SCAN, "scan_store(yb + rows_s[p0 + p + g] * D, out);", "(void)0;")],
    "pass 1": [(SCAN, "  scan_chunk_kernel<false, MAXN, Path><<<grid, bw, smem, st>>>(a);\n", "")],
}
STRIPE = "../ops/nss_stripe.py"


WALK_LANES = {4: (4, 1), 8: (2, 4), 16: (4, 4), 32: (8, 4)}  # the walk's (G, S) by MAXN


def _lanes(maxn: int, g: int, s: int) -> list:
    """The edits that lay MAXN states out as G lanes x S states."""
    was_g, was_s = WALK_LANES[maxn]
    lanes = lambda m: {**{k: v[0] for k, v in WALK_LANES.items()}, **m}  # noqa: E731
    return [(WALK, f"struct WalkLanes<{maxn}> {{ static constexpr int S = {was_s}, G = {was_g}; }};",
             f"struct WalkLanes<{maxn}> {{ static constexpr int S = {s}, G = {g}; }};"),
            (STRIPE, f"WALK_LANES = {lanes({})}", f"WALK_LANES = {lanes({maxn: g})}")]


K2S_LAYOUTS = {
    "unchanged": [],
    "N4 as 2 x 2": _lanes(4, 2, 2),
    "N8 as 4 x 2": _lanes(8, 4, 2),
    "N16 as 16 x 1": _lanes(16, 16, 1),
    "N16 as 2 x 8": _lanes(16, 2, 8),
    "N32 as 16 x 2": _lanes(32, 16, 2),
    "8 warps a block": [(WALK, "constexpr int kWalkWarps = 4;", "constexpr int kWalkWarps = 8;"),
                        (STRIPE, "WALK_BLOCK_WARPS = 4\n", "WALK_BLOCK_WARPS = 8\n")],
    "one chunk from half the card": [(STRIPE, "WALK_ONE_CHUNK_SHARE = 0.25\n",
                                      "WALK_ONE_CHUNK_SHARE = 0.5\n")],
    "chunks always": [(STRIPE, "WALK_ONE_CHUNK_SHARE = 0.25\n", "WALK_ONE_CHUNK_SHARE = 1\n")],
    "one wave": [(STRIPE, "WALK_WAVES = 2\n", "WALK_WAVES = 1\n")],
}
BODIES = {"K1s": PHASES, "K6s": K6S_PHASES, "K2s": K2S_PHASES, "K5s": K5S_PHASES,
          "passes": PASS_PHASES, "K2s-layouts": K2S_LAYOUTS}
# the scan_bench.py kernels a scan body's copies are timed through
SCAN_BENCH = {"K2s": "K2s", "K5s": "K5s", "K2s-layouts": "K2s"}
# the figures of a timed kernel a line gives, from scan_bench.py's JSON
SCAN_FIGURES = (("MaIR-CDN@128", "{} MaIR-CDN@128"), ("enc-1", "{} MaIRUNet enc-1 [4]"),
                ("dec-1", "{} MaIRUNet dec-1 [8]"),
                ("a MaIRUNet@384 forward", "{} per MaIRUNet@384 forward"))


def scan_kernels(body: str, tree: str) -> str:
    """The scan_bench.py ``--kernels`` a scan body's copies of ``tree`` are
    timed through. ``passes``: K5 serving where the tree's runs the chunked
    passes (``StripeBf16Path`` in its ``chunk_scan.cuh``), else the parity
    bodies of K2 and K5."""
    if body != "passes":
        return SCAN_BENCH[body]
    src = Path(tree, "tpuir_torch", "csrc", SCAN).read_text()
    return "K5s" if "StripeBf16Path" in src else "K2,K5"


_BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
          "from tpuir_torch.ops import _kernels; _kernels.build()")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--body", choices=tuple(BODIES), default="K1s")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--tree", help="copy tpuir_torch from this checkout (default: this tree)")
    args = ap.parse_args(argv)
    phases = BODIES[args.body]
    tree = os.path.abspath(args.tree) if args.tree else str(_ROOT)
    sys.path.insert(0, str(_ROOT))
    from tpuir_torch.utils.serving_mutants import planted_copy

    # the tree's objects, which each copy starts from
    subprocess.run([sys.executable, "-c", _BUILD, tree], check=True)
    base = _ROOT / "build" / f"{args.body.lower()}_phases"
    builds = []
    dirs = {name: base / name.replace(" ", "_") for name in phases}
    for name, edits in phases.items():
        d = dirs[name]
        shutil.rmtree(d, ignore_errors=True)
        planted_copy(str(d), edits, os.path.join(tree, "tpuir_torch"))
        builds.append(subprocess.Popen([sys.executable, "-c", _BUILD, str(d)]))
    for p in builds:
        if p.wait():
            raise RuntimeError("a copy did not build")
    scan = args.body in ("passes", *SCAN_BENCH)
    kernels = scan_kernels(args.body, tree) if scan else args.body
    bench = str(_ROOT / "tpuir_torch" / "utils" / ("scan_bench.py" if scan else "gemm_bench.py"))
    for rnd in range(args.rounds):
        for name in (phases if rnd % 2 == 0 else list(phases)[::-1]):
            cmd = ([bench, "--tree", str(dirs[name]), "--kernels", kernels, "--no-breakdown",
                    "--iters", "3"] if scan else
                   [bench, "--tree", str(dirs[name]), "--kernels", args.body, "--no-forwards",
                    "--trace-dir", str(base / f"trace_{dirs[name].name}")])
            r = subprocess.run([sys.executable, *cmd], capture_output=True, text=True,
                               check=True)
            lines = [ln for ln in r.stdout.splitlines() if not ln.startswith("{")]
            if rnd == 0 and name == "unchanged":
                print(lines[0], flush=True)  # the card's name and power limit
            if scan:
                ms = json.loads(r.stdout.strip().splitlines()[-1])["ms"]
                print(f"{name:13s} round {rnd}: " + "; ".join(
                    f"{k} " + ", ".join(f"{ms[key.format(k)]:.3f} ms {where}"
                                        for where, key in SCAN_FIGURES)
                    for k in kernels.split(",")), flush=True)
                continue
            fwd = [ln.split()[-2] for ln in lines if ln.startswith(f"{args.body} per")]
            if args.body == "K1s":
                fused = [ln.split()[0] for ln in lines if "conv_product" in ln]
                print(f"{name:10s} round {rnd}: K1 serving {fwd[0]} ms a forward; fused "
                      f"kernels {' '.join(fused)} ms", flush=True)
            else:
                cdn = [ln.split()[-2] for ln in lines if ln.startswith("K6s MaIR-CDN@128")]
                print(f"{name:10s} round {rnd}: K6 serving {cdn[0]} ms at MaIR-CDN@128, "
                      f"{fwd[0]} ms a MaIRUNet@384 forward", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
