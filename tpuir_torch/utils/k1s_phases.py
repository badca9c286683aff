"""Where the fused product-and-conv kernels of K1's and K6's serving bodies
spend their time, on the card.

    python tpuir_torch/utils/k1s_phases.py [--body K1s|K6s] [--rounds 2]

Builds copies of ``tpuir_torch/`` under ``build/<body>_phases/``, each with
one phase of the body's fused kernel taken out, and times the body in each
with ``utils/gemm_bench.py --kernels <body>``, in turns with the unchanged
copy. A copy's output is wrong; only its time is read. What a phase's
removal saves is an upper bound on what making it free would save.

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
"""

from __future__ import annotations

import argparse
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
BODIES = {"K1s": PHASES, "K6s": K6S_PHASES}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--body", choices=tuple(BODIES), default="K1s")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    phases = BODIES[args.body]
    sys.path.insert(0, str(_ROOT))
    from tpuir_torch.ops import _kernels
    from tpuir_torch.utils.serving_mutants import planted_copy

    _kernels.build()  # this tree's objects, which each copy starts from
    base = _ROOT / "build" / f"{args.body.lower()}_phases"
    builds = []
    dirs = {name: base / name.replace(" ", "_") for name in phases}
    for name, edits in phases.items():
        d = dirs[name]
        shutil.rmtree(d, ignore_errors=True)
        planted_copy(str(d), edits)
        builds.append(subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
             "from tpuir_torch.ops import _kernels; _kernels.build()", str(d)]))
    for p in builds:
        if p.wait():
            raise RuntimeError("a copy did not build")
    bench = str(_ROOT / "tpuir_torch" / "utils" / "gemm_bench.py")
    for rnd in range(args.rounds):
        for name in (phases if rnd % 2 == 0 else list(phases)[::-1]):
            r = subprocess.run([sys.executable, bench, "--tree", str(dirs[name]), "--kernels",
                                args.body, "--no-forwards", "--trace-dir",
                                str(base / f"trace_{dirs[name].name}")],
                               capture_output=True, text=True, check=True)
            lines = [ln for ln in r.stdout.splitlines() if not ln.startswith("{")]
            if rnd == 0 and name == "unchanged":
                print(lines[0], flush=True)  # the card's name and power limit
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
