"""Where K1's fused product-and-conv kernels spend their time, on the card.

    python tpuir_torch/utils/k1s_phases.py [--rounds 2]

Builds copies of ``tpuir_torch/`` under ``build/k1s_phases/``, each with one
phase of ``conv_product_kernel`` (``csrc/fused_block.cu``) taken out, and
times K1's serving body in each with ``utils/gemm_bench.py --kernels K1s``
(Restormer@256's five block shapes, batch 8, a forward's sum), in turns with
the unchanged copy. A copy's output is wrong; only its time is read. The
phases: the depthwise 3x3 and its stores (``conv``), the tensor-core
product (``product``), the halo's LayerNorm into A' (``halo``). What a
phase's removal saves is an upper bound on what making it free would save.
Each line: the copy, the round, K1 serving's ms a forward, and the two
fused kernels' ms at each shape (the gate's, then qkv's).
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
FB = "fused_block.cu"
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(_ROOT))
    from tpuir_torch.ops import _kernels
    from tpuir_torch.utils.serving_mutants import planted_copy

    _kernels.build()  # this tree's objects, which each copy starts from
    base = _ROOT / "build" / "k1s_phases"
    builds = []
    for name, edits in PHASES.items():
        d = base / name
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
        for name in (PHASES if rnd % 2 == 0 else list(PHASES)[::-1]):
            r = subprocess.run([sys.executable, bench, "--tree", str(base / name), "--kernels",
                                "K1s", "--no-forwards", "--trace-dir",
                                str(base / f"trace_{name}")],
                               capture_output=True, text=True, check=True)
            if rnd == 0 and name == "unchanged":
                print(r.stdout.splitlines()[0], flush=True)  # the card's name and power limit
            fwd = [ln.split()[-2] for ln in r.stdout.splitlines() if ln.startswith("K1s per")]
            fused = [ln.split()[0] for ln in r.stdout.splitlines()
                     if "conv_product" in ln and not ln.startswith("{")]
            print(f"{name:10s} round {rnd}: K1 serving {fwd[0]} ms a forward; fused kernels "
                  f"{' '.join(fused)} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
