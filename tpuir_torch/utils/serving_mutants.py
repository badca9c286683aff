"""Mutation controls for the serving checks, on the card.

    python -m tpuir_torch.utils.serving_mutants [--bodies K1|mixer|seq|recur] [--dir DIR] [--jobs 4]

Copies ``tpuir_torch/`` once per mutant into DIR (default: a temporary
directory, removed at the end), plants one fault in the copy's serving
body (``csrc/``, or for the recurrence body its subchunk table in
``ops/scan_ids.py``), builds the copy's kernels there and runs the stage check
of ``utils/serving_check.py`` on the copy's kernels. Each copy starts from
the checked tree's compiled objects (``ops/_kernels.py`` keys an object by
its source and the headers it includes), so it recompiles only the
sources its fault reaches:

* ``K1`` (the default): ``check_serving_stages`` on
  ``ops/fused_block.serving_stages`` at Restormer@256's level-3 and level-1
  block shapes (batch 8, BiasFree), as ``chip_smoke.py`` phase 12 builds
  them, and at level 2 with the LayerNorm bias;
* ``mixer``: the checks of K6's, K2's and K7's serving bodies
  (``check_prologue_serving``, ``check_scan_serving``,
  ``check_epilogue_serving``) on their ``*_serving_stages`` at MaIR-CDN's
  widths (seeded weights of block 0), 128x128 at batch 2 (K2 shift off and
  on) and the 96x72 tile at batch 1 (shift on), on inputs the plain
  serving versions make;
* ``seq``: the checks of the serving bodies off the stripe route,
  ``check_seq_scan_serving`` (K3) at MaIRUNet's two K3 levels of a 481x321
  request (96x82 and 48x41, batch 1, seeded weights of that level's block
  0, on xs gathered from the plain serving prologue's x) and
  ``check_fused_scan_serving`` (K5) at MaIR-CDN's widths, 128x128 at batch
  2 (shift on) and the 96x72 tile at batch 1 (shift off), which its walk
  takes in several chunks on an H100, and 64x64 at batch 8 (shift on), which
  it walks as one;
* ``recur``: ``check_nss_scan_recur_serving`` on ``nss_scan_recur_stages``
  (K2's bf16-recurrence body) at MaIR-CDN's widths, 128x128 at batch 2
  (shift off and on) and the 96x72 tile at batch 1 (shift on), on inputs
  the plain serving prologue makes.

The check must reject every mutant of ``MUTANTS`` (``MIXER_MUTANTS``,
``SEQ_MUTANTS``, ``RECUR_MUTANTS``) and accept the copy with no fault ("none"); a mutant named
for its kernels ("K3+K5 ...") is rejected when the check of each of those
kernels rejects it. ``MIXER_REPORTED`` and ``SEQ_REPORTED`` are faults whose
verdict is printed, not required: rounding differences the stage checks'
tolerances may not resolve. One line a mutant (the stages that rejected
it, with their numbers; for a mixer or seq mutant every stage's numbers),
then the verdict; exits 1 if a required mutant is accepted or "none"
rejected. The source of the checked tree is never changed.
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
PRO, SCAN, EPI = "nss_prologue.cu", "chunk_scan.cuh", "nss_epilogue.cu"
K3S, GEMM = "scan_fused_proj.cu", "simt_gemm.cuh"
K2S, IDS = "nss_scan.cu", "../ops/scan_ids.py"
WALK = "nss_walk.cuh"  # K2's and K5's serving walk

# mutant -> [(source under csrc/, text, its replacement)]; each text occurs once
_FOLD_BF16 = """// the attention folded into the projection, rounded to bf16
__global__ void fold_proj_bf16_kernel(const float* __restrict__ attn,
                                      const float* __restrict__ w_proj,
                                      __nv_bfloat16* __restrict__ mt, int C, int heads) {
  const int b = blockIdx.y;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= C * C) return;
  const int o = idx / C, d = idx - o * C;
  const int hc = C / heads;
  const int h = d / hc, h0 = h * hc, dl = d - h0;
  const float* A = attn + ((long long)b * heads + h) * hc * hc;
  const float* wr = w_proj + (long long)o * C + h0;
  float s = 0.f;
  for (int cl = 0; cl < hc; ++cl) s = fmaf(wr[cl], A[cl * hc + dl], s);
  mt[(long long)b * C * C + idx] = __float2bfloat16_rn(s);
}

int launch_gram_mma("""
MUTANTS = {
    "none": [],
    "two-pass LN1": [(FB, "launch_ln_stats(x, st2, rows, C, true, st)",
                      "launch_ln_stats(x, st2, rows, C, false, st)")],
    "two-pass LN2": [(FB, "launch_ln_stats(x2, st2, rows, C, true, st)",
                      "launch_ln_stats(x2, st2, rows, C, false, st)")],
    "qkv weight truncated": [(FB, "wq16[i] = __float2bfloat16_rn(w_qkv[i]);",
                              "wq16[i] = __float2bfloat16_rz(w_qkv[i]);")],
    "q and k stored truncated (the Gram's operands)": [
        (FB, "= __float2bfloat16_rn(o);  // q, k: the Gram's operands",
         "= __float2bfloat16_rz(o);  // q, k: the Gram's operands")],
    "v stored truncated": [(FB, "= __float2bfloat16_rn(o);  // v: the apply's A",
                            "= __float2bfloat16_rz(o);  // v: the apply's A")],
    "norms taken from the rounded q": [
        (FB, "nsq = fmaf(o, o, nsq);",
         "{ const float r = __bfloat162float(__float2bfloat16_rn(o)); nsq = fmaf(r, r, nsq); }")],
    "halo not zeroed outside the image": [
        (FB, "in ? make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]) : make_float2(0.f, 0.f);",
         "make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);")],
    "attention truncated": [(FB, "bd[(long long)b * C * C + idx] = __float2bfloat16_rn(a);",
                             "bd[(long long)b * C * C + idx] = __float2bfloat16_rz(a);")],
    "projection weight truncated": [(FB, "wp16[i] = __float2bfloat16_rn(w_proj[i]);",
                                     "wp16[i] = __float2bfloat16_rz(w_proj[i]);")],
    "project_in weight truncated": [(FB, "wi16[i] = __float2bfloat16_rn(w_in[i]);",
                                     "wi16[i] = __float2bfloat16_rz(w_in[i]);")],
    "project_out weight truncated": [(FB, "wo16[i] = __float2bfloat16_rn(c < hidden",
                                      "wo16[i] = __float2bfloat16_rz(c < hidden")],
    "exact GELU": [(FB, "const float o = gelu_sigmoid(s0) * s1;",
                    "const float o = gelu_exact(s0) * s1;")],
    "gate stored truncated": [(FB, "= __float2bfloat16_rn(o);  // the gate",
                               "= __float2bfloat16_rz(o);  // the gate")],
    "attention folded into the projection": [
        (FB, "int launch_gram_mma(", _FOLD_BF16),
        (FB, "block_diag_kernel<<<dim3((C * C + kThreads - 1) / kThreads, B), kThreads, 0, st>>>(\n"
             "        attn, bd16, C, heads);",
         "fold_proj_bf16_kernel<<<dim3((C * C + kThreads - 1) / kThreads, B), kThreads, 0, st>>>(\n"
         "        attn, w_proj, bd16, C, heads);"),
        (FB, "launch_product_bf16<5>(v_bd, B, act16, nullptr, C, st)",
         "launch_product_bf16<2, __nv_bfloat16>(v_bd, B, x2, x, C, st)"),
        (FB, "  if ((err = launch_product_bf16<2, __nv_bfloat16>(tc::ArgsBf16{act16, 0, C, wp16, 0, "
             "rows, C, C},\n                                                   1, x2, x, C, st)))\n"
             "    return err;\n", ""),
    ],
    "operands truncated": [(TC, 'asm("cvt.rn.bf16x2.f32 %0', 'asm("cvt.rz.bf16x2.f32 %0')],
    "output truncated": [
        (TC, "*p = __float2bfloat16_rn(v); }", "*p = __float2bfloat16_rz(v); }"),
        (TC, "__floats2bfloat162_rn(v.x, v.y)",
         "__halves2bfloat162(__float2bfloat16_rz(v.x), __float2bfloat16_rz(v.y))"),
    ],
}

# the mixer's serving bodies (K6, K2, K7): faults the check must reject
MIXER_MUTANTS = {
    "none": [],
    "K6 halo read across the left/right image edge": [
        (PRO, "const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;",
         "const bool in = yy >= 0 && yy < H && yy * W + xx >= 0 && yy * W + xx < H * W;")],
    "K6 z stored truncated": [(PRO, "return __float2bfloat16_rn(v);  // z's rounding",
                               "return __float2bfloat16_rz(v);  // z's rounding")],
    "K6 3x3 window off by one column at the tile edge": [
        (PRO, "column(xl + i + 2, r);", "column(min(xl + i + 2, kTW), r);")],
    "K2 x_proj W_xp unrounded": [(GEMM, "return kBf16 ? gemm_round_bf16(v) : v;", "return v;")],
    "K2 y truncated": [
        (WALK, "__floats2bfloat162_rn(y0, y1);  // y's rounding",
         "__halves2bfloat162(__float2bfloat16_rz(y0), __float2bfloat16_rz(y1));")],
    "K2 carry of the previous chunk dropped": [
        (WALK, "h[s] = FINAL && c > 0 && live ? a.hstate[state + n] : 0.f;  // the chained carry",
         "h[s] = 0.f;")],
    "K2 one state lane left out of the butterfly sum": [
        (WALK, "      sum_over_lanes<G>(p, lane);\n",
         "      if (g == G - 1)\n"
         "        for (int j = 0; j < T; ++j) p[j] = 0.f;\n"
         "      sum_over_lanes<G>(p, lane);\n")],
    "K7 gated rows stored truncated": [
        (EPI, "return __float2bfloat16_rn(v);  // the gated rows' rounding",
         "return __float2bfloat16_rz(v);  // the gated rows' rounding")],
    "K6+K7 weight copies truncated": [
        (TC, "w16[i] = __float2bfloat16_rn(c < cols", "w16[i] = __float2bfloat16_rz(c < cols")],
}
# faults whose verdict is printed, not required
MIXER_REPORTED = {
    "K2 dt operands unrounded": [
        (WALK, "wdt[e] = scan_round_bf16(w);  // dt_proj's operand", "wdt[e] = w;"),
        (WALK, "        x4.x = scan_round_bf16(x4.x), x4.y = scan_round_bf16(x4.y);\n"
              "        x4.z = scan_round_bf16(x4.z), x4.w = scan_round_bf16(x4.w);\n", "")],
    "K2 pooled from the rounded y": [
        (WALK, "pool0 += y0, pool1 += y1;",
         "pool0 += scan_round_bf16(y0), pool1 += scan_round_bf16(y1);")],
    "K7 two-pass LayerNorm": [(EPI, "epilogue<__nv_bfloat16, true>(",
                               "epilogue<__nv_bfloat16, false>(")],
}

# the serving bodies off the stripe route (K3, K5): faults the check must reject
SEQ_MUTANTS = {
    "none": [],
    "K3+K5 x_proj W_xp unrounded": MIXER_MUTANTS["K2 x_proj W_xp unrounded"],
    "K3 B and C rounded": [
        (K3S, "          load_vec<S>(bq + (j + jj) * CS + MAXN, cv);\n",
         "          load_vec<S>(bq + (j + jj) * CS + MAXN, cv);\n"
         "          if constexpr (kBf16)\n"
         "            for (int s = 0; s < S; ++s)\n"
         "              bv[s] = scan_round_bf16(bv[s]), cv[s] = scan_round_bf16(cv[s]);\n")],
    "K3 y through bf16": [
        (K3S, "fmaf(D_s, scan_widen(ud[row * UP + sc]), ytile[row * CBP + sc]);",
         "scan_round_bf16(fmaf(D_s, scan_widen(ud[row * UP + sc]), ytile[row * CBP + sc]));")],
    "K5 y truncated": MIXER_MUTANTS["K2 y truncated"],
    "K5 carry of the previous chunk dropped": MIXER_MUTANTS["K2 carry of the previous chunk dropped"],
    "K5 directions 2 and 3 stored untransposed": [
        (WALK, "*out_at = out;  // y's row: in the transposed image for directions 2 and 3",
         "*out_at = pixel;")],
    "K5 shifted lead stripe taken at full width": [
        (SCAN, "const int w = min(SL, (shift && col0 == 0) ? half : Wg - col0);",
         "const int w = min(SL, Wg - col0);")],
}
# faults whose verdict is printed, not required
SEQ_REPORTED = {
    "K3+K5 dt operands unrounded": [
        (K3S, "wdt[e] = kBf16 ? scan_round_bf16(w) : w;", "wdt[e] = w;"),
        (K3S, "x4.x = scan_round_bf16(x4.x), x4.y = scan_round_bf16(x4.y);", ""),
        (K3S, "x4.z = scan_round_bf16(x4.z), x4.w = scan_round_bf16(x4.w);", ""),
        *MIXER_REPORTED["K2 dt operands unrounded"]],
    "K5 pooled from the rounded y": MIXER_REPORTED["K2 pooled from the rounded y"],
}

# K2's bf16-recurrence body: faults the check must reject
RECUR_MUTANTS = {
    "none": [],
    "K2r level 1 in float32": [
        (K2S, "const float av = recur_bf16(exp2f(__fmul_rn(dt, a2[i])));",
         "const float av = exp2f(__fmul_rn(dt, a2[i]));"),
        (K2S, "const float bv = recur_bf16(__fmul_rn(row[R + n], du));",
         "const float bv = __fmul_rn(row[R + n], du);"),
        (K2S, "hA[i] = recur_bf16(av * hA[i]);", "hA[i] = av * hA[i];"),
        (K2S, "hB[i] = recur_bf16(__fadd_rn(recur_bf16(av * hB[i]), bv));",
         "hB[i] = __fadd_rn(av * hB[i], bv);")],
    "K2r final combine rounded": [
        (K2S, "const float h = __fadd_rn(recur_bf16(hA[i] * ce[i]), hB[i]);",
         "const float h = recur_bf16(__fadd_rn(recur_bf16(hA[i] * ce[i]), hB[i]));")],
    "K2r carry unrounded": [(K2S, "ce[i] = recur_bf16(cc);", "ce[i] = cc;")],
    "K2r rp 2 instead of 4": [(IDS, "rp = subchunk_rows(n, scan_len, vert_p)", "rp = 2")],
    "K2r no reset at a shifted lead or tail stripe": [
        (IDS, "starts[k, t:t + n * w:rp * w] = 1", "starts[k, t:t + n * w:rp * w] = w == scan_len")],
}

# (label, H = W, C, heads, LayerNorm bias): Restormer@256's level 3 and level 1,
# batch 8, BiasFree, and level 2 WithBias (where a halo left unzeroed carries
# the LayerNorm bias into the conv's padding)
SHAPES = [("level3", 64, 192, 4, False), ("level1", 256, 48, 1, False),
          ("level2 WithBias", 128, 96, 2, True)]
# (label, B, H, W, K2's shifts): MaIR-CDN's mixer shapes
MIXER_SHAPES = [("CDN@128 B=2", 2, 128, 128, (False, True)), ("96x72 B=1", 1, 96, 72, (True,))]
# (kernel, B, H, W, MaIRUNet's stage whose block 0 gives K3's weights, or K5's
# shift): K5's walk takes several chunks at the first two of its shapes on an
# H100 and one at B 8, 64x64
SEQ_SHAPES = [("K3", 1, 96, 82, "encoder_level3"), ("K3", 1, 48, 41, "latent"),
              ("K5", 2, 128, 128, True), ("K5", 1, 96, 72, False), ("K5", 8, 64, 64, True)]

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
for label, hw, C, heads, ln_bias in json.loads(sys.argv[1]):
    p = {k: v.to(dev) for k, v in init_block_params(C, heads, ln_bias, C).items()}
    x = torch.from_numpy(np.random.RandomState(hw).rand(8, hw, hw, C).astype(np.float32))
    x = x.to(dev).to(torch.bfloat16).permute(0, 3, 1, 2)
    with torch.inference_mode(), true_float32():
        v = check_serving_stages(x, p, heads, ln_bias, serving_stages(x, p, heads, ln_bias))
    missed[label] = {s.name: s.detail for s in v if not s.ok}
    del p, x
    torch.cuda.empty_cache()  # the copies check at once on one card
print(json.dumps(missed))
"""


_MIXER_CHECK = r"""
import json, sys
import numpy as np, torch
from tpuir_torch.ops import _kernels
_kernels.build(); _kernels.library()
from tpuir_torch import zoo
from tpuir_torch.core.engine import true_float32
from tpuir_torch.models.mair import init_state_dict
from tpuir_torch.ops import nss_epilogue as ep, nss_prologue as pr, nss_stripe as sc
from tpuir_torch.utils import serving_check as ck
dev, res = torch.device("cuda", 0), {}
cfg = zoo.MAIR_CDN_CONFIG
pre = "layers.0.residual_group.blocks.0.self_attention."
w = {k[len(pre):]: v.to(dev) for k, v in init_state_dict(cfg, seed=0).items() if k.startswith(pre)}
di, n = w["in_proj.weight"].shape[0] // 2, w["A_logs"].shape[1]
scan_w = dict(x_proj_w=w["x_proj_weight"], dt_w=w["dt_projs_weight"],
              A=-torch.exp(w["A_logs"]).reshape(4, di, n), D=w["Ds"].reshape(4, di),
              delta_bias=w["dt_projs_bias"])
epi_w = dict(ln_w=w["out_norm.weight"], ln_b=w["out_norm.bias"], w_out=w["out_proj.weight"])
def keep(label, verdicts):
    res[label] = {v.name: [v.ok, v.detail] for v in verdicts}
for label, b, hh, ww, shifts in json.loads(sys.argv[1]):
    h = torch.from_numpy(np.random.RandomState(hh).randn(b, hh, ww, cfg["embed_dim"]).astype(
        np.float32)).to(dev)
    pro = (h, w["in_proj.weight"], w["conv2d.weight"], w["conv2d.bias"])
    with torch.inference_mode(), true_float32():
        st = pr.mixer_prologue_serving_stages(*pro)
        keep(f"K6 {label}", ck.check_prologue_serving(*pro, st))
        x, z = pr.mixer_prologue_serving_plain(*pro)
        for shift in shifts:
            st = sc.nss_scan_serving_stages(x, **scan_w, shift=shift)
            keep(f"K2 {label} shift={int(shift)}",
                 ck.check_scan_serving(x, **scan_w, scan_len=4, shift=shift, st=st))
        y, pooled = sc.nss_scan_serving_plain(x, **scan_w, shift=shifts[-1])
        gates = torch.sigmoid(pooled / (hh * ww)).contiguous()
        keep(f"K7 {label}", ck.check_epilogue_serving(
            y, gates, z, **epi_w, st=ep.mixer_epilogue_serving_stages(y, gates, z, **epi_w)))
print(json.dumps(res))
"""


_SEQ_CHECK = r"""
import json, sys
import numpy as np, torch
from tpuir_torch.ops import _kernels
_kernels.build(); _kernels.library()
from tpuir_torch import zoo
from tpuir_torch.core.engine import true_float32
from tpuir_torch.models import mair, mair_unet
from tpuir_torch.ops import nss_fused as k5, nss_prologue as pr, scan_fused_proj as k3
from tpuir_torch.ops.scan_ids import scan_index_tensors
from tpuir_torch.utils import serving_check as ck
dev, res = torch.device("cuda", 0), {}
sds = {"K3": mair_unet.init_state_dict(zoo.MAIR_UNET_CONFIG, seed=0),
       "K5": mair.init_state_dict(zoo.MAIR_CDN_CONFIG, seed=0)}
for kern, b, hh, ww, arg in json.loads(sys.argv[1]):
    pre = (f"{arg}.0.self_attention." if kern == "K3"
           else "layers.0.residual_group.blocks.0.self_attention.")
    w = {k[len(pre):]: v.to(dev) for k, v in sds[kern].items() if k.startswith(pre)}
    (two_di, dm), n = w["in_proj.weight"].shape, w["A_logs"].shape[1]
    di = two_di // 2
    scan_w = dict(x_proj_w=w["x_proj_weight"], dt_w=w["dt_projs_weight"],
                  A=-torch.exp(w["A_logs"]).reshape(4, di, n), D=w["Ds"].reshape(4, di),
                  delta_bias=w["dt_projs_bias"])
    h = torch.from_numpy(np.random.RandomState(hh).randn(b, hh, ww, dm).astype(np.float32)).to(dev)
    with torch.inference_mode(), true_float32():
        x, _ = pr.mixer_prologue_serving_plain(h, w["in_proj.weight"], w["conv2d.weight"],
                                               w["conv2d.bias"])
        if kern == "K3":
            ids, _ = scan_index_tensors(hh, ww, 4, 0, dev)
            xs = x.reshape(b, hh * ww, di)[:, ids]
            v = ck.check_seq_scan_serving(
                xs, **scan_w, st=k3.selective_scan_fused_proj_serving_stages(xs, **scan_w))
        else:
            v = ck.check_fused_scan_serving(
                x, **scan_w, scan_len=4, shift=arg,
                st=k5.nss_scan_fused_serving_stages(x, **scan_w, shift=arg))
    res[f"{kern} B={b} {hh}x{ww}"] = {s.name: [s.ok, s.detail] for s in v}
print(json.dumps(res))
"""


_RECUR_CHECK = r"""
import json, sys
import numpy as np, torch
from tpuir_torch.ops import _kernels
_kernels.build(); _kernels.library()
from tpuir_torch import zoo
from tpuir_torch.core.engine import true_float32
from tpuir_torch.models.mair import init_state_dict
from tpuir_torch.ops import nss_prologue as pr, nss_stripe as sc
from tpuir_torch.utils import serving_check as ck
dev, res = torch.device("cuda", 0), {}
cfg = zoo.MAIR_CDN_CONFIG
pre = "layers.0.residual_group.blocks.0.self_attention."
w = {k[len(pre):]: v.to(dev) for k, v in init_state_dict(cfg, seed=0).items() if k.startswith(pre)}
di, n = w["in_proj.weight"].shape[0] // 2, w["A_logs"].shape[1]
scan_w = dict(x_proj_w=w["x_proj_weight"], dt_w=w["dt_projs_weight"],
              A=-torch.exp(w["A_logs"]).reshape(4, di, n), D=w["Ds"].reshape(4, di),
              delta_bias=w["dt_projs_bias"])
for label, b, hh, ww, shifts in json.loads(sys.argv[1]):
    h = torch.from_numpy(np.random.RandomState(hh).randn(b, hh, ww, cfg["embed_dim"]).astype(
        np.float32)).to(dev)
    with torch.inference_mode(), true_float32():
        x, _ = pr.mixer_prologue_serving_plain(h, w["in_proj.weight"], w["conv2d.weight"],
                                               w["conv2d.bias"])
        for shift in shifts:
            st = sc.nss_scan_recur_stages(x, **scan_w, shift=shift)
            v = ck.check_nss_scan_recur_serving(x, **scan_w, scan_len=4, shift=shift, st=st)
            res[f"K2r {label} shift={int(shift)}"] = {s.name: [s.ok, s.detail] for s in v}
print(json.dumps(res))
"""


def plant(src_dir: str, edits) -> None:
    """Apply a mutant's edits to the copy of tpuir_torch at src_dir (paths
    under its ``csrc/``)."""
    for name, old, new in edits:
        path = os.path.join(src_dir, "csrc", name)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} occurs {text.count(old)} times")
        with open(path, "w") as f:
            f.write(text.replace(old, new))


# bodies -> (required mutants, reported mutants, check script, its shapes)
BODIES = {"K1": (MUTANTS, {}, _CHECK, SHAPES),
          "mixer": (MIXER_MUTANTS, MIXER_REPORTED, _MIXER_CHECK, MIXER_SHAPES),
          "seq": (SEQ_MUTANTS, SEQ_REPORTED, _SEQ_CHECK, SEQ_SHAPES),
          "recur": (RECUR_MUTANTS, {}, _RECUR_CHECK, MIXER_SHAPES)}


def planted_copy(d: str, edits, pkg: str = _PKG) -> None:
    """Copy the package ``pkg`` (default: this tree's tpuir_torch) and the
    objects built beside it to ``d`` (so that the copy recompiles only the
    sources its edits reach) and plant ``edits`` there."""
    shutil.copytree(pkg, os.path.join(d, "tpuir_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    # the copy's build directory, as its ops/_kernels.py places it
    shutil.copytree(os.path.join(os.path.dirname(pkg), "build", "tpuir_torch", "obj"),
                    os.path.join(d, "build", "tpuir_torch", "obj"))
    plant(os.path.join(d, "tpuir_torch"), edits)


def _run(root: str, name: str, edits, script: str, shapes) -> tuple:
    d = os.path.join(root, "".join(c if c.isalnum() else "_" for c in name))
    planted_copy(d, edits)
    r = subprocess.run([sys.executable, "-c", script, json.dumps(shapes)], cwd=d,
                       capture_output=True, text=True)
    if r.returncode:
        return name, None, r.stderr[-2000:]
    return name, json.loads(r.stdout.strip().splitlines()[-1]), ""


def _rejected(res: dict, name: str = "none") -> bool:
    """Whether a check script's result rejects mutant ``name``: K1's lists
    the stages that missed a shape; the mixer's, seq's and recur's give every stage's
    [ok, detail] under labels that start with the kernel ("K2 ..."). A
    mutant named for its kernels ("K3+K5 ...") is rejected when each of
    their checks rejects it; any other, when any check does."""
    def rejects(stages):
        return any(not v[0] if isinstance(v, list) else True for v in stages.values())

    named = [[st for label, st in res.items() if label.split()[0] == k]
             for k in name.split()[0].split("+")]
    if not all(named):
        return any(rejects(st) for st in res.values())
    return all(any(map(rejects, sts)) for sts in named)


def run_mutants(bodies: str = "K1", root: str = None, jobs: int = 4) -> dict:
    """Build and check every mutant of ``bodies`` (each in its own copy under
    ``root``, default a temporary directory), printing one line each.
    Returns {mutant: rejected (bool), or None if its copy did not build or
    run}."""
    from tpuir_torch.ops import _kernels

    required, reported, script, shapes = BODIES[bodies]
    mutants = {**required, **reported}
    _kernels.build()  # the checked tree's objects, which each copy starts from
    with tempfile.TemporaryDirectory(prefix="tpuir_serving_mutants_") as tmp:
        with ThreadPoolExecutor(jobs) as ex:
            runs = ex.map(lambda n: _run(root or tmp, n, mutants[n], script, shapes), mutants)
            verdicts = {}
            for name, res, err in runs:
                if res is None:
                    print(f"{name}: the copy did not build or run:\n{err}", flush=True)
                    verdicts[name] = None
                    continue
                verdicts[name] = _rejected(res, name)
                tag = " (reported)" if name in reported else ""
                print(f"{name}{tag}: {'rejected' if verdicts[name] else 'accepted'} "
                      f"{json.dumps(res)}", flush=True)
    return verdicts


def failures(bodies: str, verdicts: dict) -> list:
    """The mutants whose verdict is wrong: a required mutant accepted, "none"
    rejected, or a copy that did not build or run."""
    reported = BODIES[bodies][1]
    return [n for n, rej in verdicts.items()
            if rej is None or (n not in reported and rej == (n == "none"))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bodies", choices=tuple(BODIES), default="K1",
                    help="K1's serving body, the MaIR mixer's (K6, K2, K7), MaIR's "
                         "scans off the stripe route (K3, K5), or K2's bf16-recurrence body")
    ap.add_argument("--dir", default=None, help="where the copies go (default: a temp dir)")
    ap.add_argument("--jobs", type=int, default=4, help="copies built and checked at once")
    args = ap.parse_args()
    verdicts = run_mutants(args.bodies, args.dir, args.jobs)
    bad = failures(args.bodies, verdicts)
    n = len(BODIES[args.bodies][0]) - 1
    print("serving mutants: " + (f"FAILED {bad}" if bad else
                                 f"the check rejects all {n} mutants and "
                                 f"accepts the unmutated copy"))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
