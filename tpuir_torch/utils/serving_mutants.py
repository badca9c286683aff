"""Mutation controls for K1's serving check, on the card.

    python -m tpuir_torch.utils.serving_mutants [--dir DIR] [--jobs 4]

Copies ``tpuir_torch/`` once per mutant into DIR (default: a temporary
directory, removed at the end), plants one fault in the copy's serving body (``csrc/``), builds
the copy's kernels there and runs ``utils/serving_check.check_serving_stages``
on its ``ops/fused_block.serving_stages`` at Restormer@256's level-3 and
level-1 block shapes (batch 8, BiasFree), as ``chip_smoke.py`` phase 12
builds them. The check must reject every mutant and accept the copy with
no fault ("none"). One line a mutant (the stages that rejected it, with
their numbers), then the verdict; exits 1 if a mutant is accepted or
"none" rejected. The source of the checked tree is never changed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FB, TC = "fused_block.cu", "tc_gemm.cuh"

# mutant -> [(source under csrc/, text, its replacement)]; each text occurs once
MUTANTS = {
    "none": [],
    "two-pass LN1": [(FB, "launch_ln_stats(xf, st2, rows, C, true, st)",
                      "launch_ln_stats(xf, st2, rows, C, false, st)")],
    "two-pass LN2": [(FB, "launch_ln_stats(x2, st2, rows, C, true, st)",
                      "launch_ln_stats(x2, st2, rows, C, false, st)")],
    "qkv product unrounded": [(FB, "launch_product<1, tc::Bf16>", "launch_product<1, tc::F32x3>")],
    "q unrounded": [(FB, "qr[i] = round_bf16(qr[i]);", "")],
    "k unrounded": [(FB, "kr[i] = round_bf16(kr[i]);", "")],
    "apply unrounded": [(FB, "launch_product<5, tc::Bf16>", "launch_product<5, tc::F32x3>")],
    "projection unrounded": [(FB, "launch_product<2, tc::Bf16, __nv_bfloat16>",
                              "launch_product<2, tc::F32x3, __nv_bfloat16>")],
    "project_in unrounded": [(FB, "launch_product<3, tc::Bf16>", "launch_product<3, tc::F32x3>")],
    "project_out unrounded": [(FB, "launch_product<4, tc::Bf16>", "launch_product<4, tc::F32x3>")],
    "exact GELU": [(FB, "hp, kGeluSigmoid,", "hp, kGeluExact,")],
    "attention folded into the projection": [
        (FB, "block_diag_kernel<<<dim3((C * C + kThreads - 1) / kThreads, B), kThreads, 0, st>>>(\n"
             "        attn, bd, C, heads);",
         "fold_proj_kernel<<<dim3((C * C + kThreads - 1) / kThreads, B), kThreads, 0, st>>>(\n"
         "        attn, w_proj, bd, C, heads);"),
        (FB, "launch_product<5, tc::Bf16>(v_bd, B, tc::NoPrologue{}, buf1, nullptr, C, st)",
         "launch_product<2, tc::Bf16, __nv_bfloat16>(v_bd, B, tc::NoPrologue{}, x2, x, C, st)"),
        (FB, "  if ((err = launch_product<2, tc::Bf16, __nv_bfloat16>(\n"
             "           tc::Args{buf1, 0, C, w_proj, 0, rows, C, C}, 1, tc::NoPrologue{}, "
             "x2, x, C, st)))\n    return err;\n", ""),
    ],
    "operands truncated": [(TC, 'asm("cvt.rn.bf16x2.f32 %0', 'asm("cvt.rz.bf16x2.f32 %0')],
    "output truncated": [
        (TC, "*p = __float2bfloat16_rn(v); }", "*p = __float2bfloat16_rz(v); }"),
        (TC, "__floats2bfloat162_rn(v.x, v.y)",
         "__halves2bfloat162(__float2bfloat16_rz(v.x), __float2bfloat16_rz(v.y))"),
    ],
}

# (label, H = W, C, heads): Restormer@256's level 3 and level 1, batch 8
SHAPES = [("level3", 64, 192, 4), ("level1", 256, 48, 1)]

_CHECK = r"""
import json, sys
import numpy as np, torch
from tpuir_torch.ops import _kernels
_kernels.build(); _kernels.library()
from tpuir_torch.core.engine import true_float32
from tpuir_torch.models.restormer import init_block_params
from tpuir_torch.ops.fused_block import serving_stages
from tpuir_torch.utils.serving_check import check_serving_stages
dev, missed = torch.device("cuda", 0), {}
for label, hw, C, heads in json.loads(sys.argv[1]):
    p = {k: v.to(dev) for k, v in init_block_params(C, heads, False, C).items()}
    x = torch.from_numpy(np.random.RandomState(hw).rand(8, hw, hw, C).astype(np.float32))
    x = x.to(dev).to(torch.bfloat16).permute(0, 3, 1, 2)
    with torch.inference_mode(), true_float32():
        v = check_serving_stages(x, p, heads, False, serving_stages(x, p, heads, False))
    missed[label] = {s.name: s.detail for s in v if not s.ok}
print(json.dumps(missed))
"""


def plant(src_dir: str, edits) -> None:
    """Apply a mutant's edits to the copy of tpuir_torch at src_dir."""
    for name, old, new in edits:
        path = os.path.join(src_dir, "csrc", name)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} occurs {text.count(old)} times")
        with open(path, "w") as f:
            f.write(text.replace(old, new))


def _run(root: str, name: str) -> tuple:
    d = os.path.join(root, "".join(c if c.isalnum() else "_" for c in name))
    shutil.copytree(_PKG, os.path.join(d, "tpuir_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    plant(os.path.join(d, "tpuir_torch"), MUTANTS[name])
    r = subprocess.run([sys.executable, "-c", _CHECK, json.dumps(SHAPES)], cwd=d,
                       capture_output=True, text=True)
    if r.returncode:
        return name, None, r.stderr[-2000:]
    return name, json.loads(r.stdout.strip().splitlines()[-1]), ""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=None, help="where the copies go (default: a temp dir)")
    ap.add_argument("--jobs", type=int, default=4, help="copies built and checked at once")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory(prefix="tpuir_serving_mutants_") as tmp:
        root = args.dir or tmp
        bad = []
        with ThreadPoolExecutor(args.jobs) as ex:
            for name, missed, err in ex.map(lambda n: _run(root, n), MUTANTS):
                if missed is None:
                    print(f"{name}: the copy did not build or run:\n{err}", flush=True)
                    bad.append(name)
                    continue
                print(f"{name}: {json.dumps(missed)}", flush=True)
                if any(missed.values()) == (name == "none"):
                    bad.append(name)
    print("serving mutants: " + (f"FAILED {bad}" if bad else
                                 f"the check rejects all {len(MUTANTS) - 1} mutants and "
                                 f"accepts the unmutated copy"))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
