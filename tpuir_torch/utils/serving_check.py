"""The serving bodies held stage by stage, with no cascade: K1's, the MaIR
mixer's K6, K2 and K7, and its scans off the stripe route, K3 and K5.

At Restormer's widths the serving body cannot be held to its plain version
end to end: a float32 sum that differs in its last bit from another order's
flips a bf16 operand of the next product now and then, and the flips
compound through the block's rounding points. So ``check_serving_stages``
reads every stage's output from the kernel itself
(``ops/fused_block.serving_stages``) and computes each stage from the
kernel's own output of the stage before:

* where the kernel's float32 arithmetic decides a bf16 operand or a value
  that is compared bit for bit (the one-pass LayerNorm statistics, the
  LayerNorm applied to the fused products' A, q's and k's squared-norm
  partials an output tile and their sums, the bf16 roundings of the float32
  q, k, v and gate), that arithmetic is emulated bit for bit (``fma32``
  rounds a float32 FMA once), so each bf16 operand is the kernel's own and
  no rounding flips;
* every product stage is computed in float64 from those bf16 operands and
  held to the GEMM core's card tolerance, |got - ref| <= 5e-5 + 1e-4 |ref|:
  the fused stages (q | k | v from x, the gate from x2) through the float64
  product, the 3x3 and the GELU; the Gram, whose terms cancel, within 5e-5
  + 1e-4 sum |q| |k| of float64 sums of the stored bf16 q, k. An operand
  left unrounded, or rounded elsewhere (attention folded into the
  projection), moves a product by about 2^-9 of its terms, ten times that
  tolerance;
* a bf16 stage read as a product's operand (ao) and the bf16 output must
  be the rounding of a value within that tolerance of its float64
  reference.

``serving_stage_values`` runs the same stage functions in float32, each on
its own previous stage: the body in plain PyTorch with the kernel's sum
orders where they decide a bit, which the CPU tests hold against tpuir and
against the checks.

The mixer's three bodies (``check_prologue_serving``, ``check_scan_serving``,
``check_epilogue_serving``) are held the same way, on the stages their
wrappers' ``*_serving_stages`` entries return; none of their float32
arithmetic decides a bf16 operand that a later stage of the same body
reads back from the kernel, so nothing is emulated bit for bit:

* K6: the bf16 copy of W_in (rows padded to 8) bit for bit against
  ``utils/misc.bf16_padded_rows``; ``xpre`` (the x half of in_proj, which
  the kernel writes only for a check) and the z half against float64 sums
  of bf16(h) . bf16(W_in); x against silu(dw3x3(xpre) + b) in float64 from
  the kernel's own xpre; x and z (bf16) each the rounding of a value within
  the product tolerance of its float64 reference;
* K2: ``x_dbl`` against float64 sums of bf16(x) . bf16(W_xp); then the scan
  in float64 from the kernel's own x_dbl (``ops/nss_stripe.scan_from_xdbl``:
  dt from bf16(x_dbl[:R]) . bf16(W_dt), B and C unrounded), y (bf16) the
  rounding of a value within the scan tolerance (SCAN_ATOL + SCAN_RTOL |ref|,
  the JAX package's scan tolerance) of it, pooled within SCAN_ATOL +
  SCAN_RTOL sum|y| of its float64 sum;
* K7: the bf16 copy of W_out bit for bit as K6's of W_in; the gated rows
  (bf16) the rounding of a value within the product tolerance of their
  float64 value from the bf16 y and z (one-pass variance), their padding
  zero; the output against float64 sums of gated . bf16(W_out) from the
  kernel's own gated rows.

K2's bf16-recurrence body (``check_nss_scan_recur_serving``, on the stages
of ``ops/nss_stripe.nss_scan_recur_stages``) is the one whose float32
arithmetic decides bf16 values inside the body, at every step of its
level-1 recurrence, so its middle stage is emulated bit for bit:

* x_dbl against float64 sums of bf16(x) . bf16(W_xp), as K2's;
* the level-2 carries (cc at each subchunk's start) against
  ``ops/nss_stripe.recur_from_xdbl`` on the kernel's own x_dbl, bit for
  bit: dt, the decays, the level-1 roundings and the carry chain are the
  kernel's float32 operations, which PyTorch's float32 ops on the same
  card repeat (exp2f, expf, log1pf; each product of two bf16 values exact),
  with the subchunks of ``ops/scan_ids.mair_subchunk_layout``, not the
  kernel's table;
* y (bf16) the rounding of a value within RECUR_RTOL sum_n |h C_n| + |D x|
  of its float64 sum from those emulated h, and pooled within SCAN_ATOL +
  SCAN_RTOL sum|y| of its float64 sum.

The sequence route's K3 (``check_seq_scan_serving``) and the fused route's
K5 (``check_fused_scan_serving``) are held as K2: x_dbl against float64
sums of bf16(x) . bf16(W_xp), then the scan in float64 from the kernel's
own x_dbl (dt from bf16(x_dbl[:R]) . bf16(W_dt), B and C unrounded). K3's y
is float32 and must lie within the scan tolerance of it (a y rounded to
bf16 moves by up to 2^-9 of itself, about twice SCAN_RTOL); K5's y (bf16) must be
the rounding of a value within the scan tolerance, and its pooled within
SCAN_ATOL + SCAN_RTOL sum|y| of the float64 sum, as K2's.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple

import torch
import torch.nn.functional as F

ATOL, RTOL = 5e-5, 1e-4  # the GEMM core's card tolerance against float64
SCAN_ATOL, SCAN_RTOL = 5e-5, 1e-3  # the JAX package's scan tolerance (tests/test_mair.py)
# the recurrence body's y against its float64 sum from the emulated h, as a
# share of sum_n |h C_n| + |D x|: its float32 sum rounds about 11 times
RECUR_RTOL = 4e-6
TILE_H, TILE_W, RUN = 8, 16, 8  # csrc/fused_block.cu kTH, kTW, kRun: an output tile, a conv item
EPS = torch.tensor(1e-5, dtype=torch.float32).item()  # 1e-5f, as the kernel adds it


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf(a, b, c) elementwise on float32 tensors, rounded once: a * b is
    exact in float64, the sum is rounded to odd there (TwoSum's error sets
    the last bit where the float64 sum is inexact), and float64 to float32
    to nearest then rounds the exact value once (53 >= 24 + 2 bits)."""
    c64, p = c.double(), a.double() * b.double()
    s = c64 + p
    bb = s - c64
    e = (c64 - (s - bb)) + (p - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.full_like(s, float("inf")), torch.full_like(s, -float("inf")))
    return torch.where((e != 0) & even, torch.nextafter(s, toward), s).float()


def _f32(t64: torch.Tensor) -> torch.Tensor:
    """A float64 result of one IEEE operation on float32 values, rounded to
    float32: the correctly rounded float32 operation for +, -, *, / and sqrt
    (53 >= 2 * 24 + 2 bits)."""
    return t64.float()


def _bf16(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 t rounded to bf16 (nearest even), as the kernel rounds a
    product operand, in ``dtype``."""
    return t.to(torch.bfloat16).to(dtype)


def _warp_sum(v: torch.Tensor) -> torch.Tensor:
    """v (..., 32) summed as the kernel's butterfly (xor 16, 8, 4, 2, 1)."""
    lane = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o]
    return v[..., 0]


def ln_stats(x: torch.Tensor) -> torch.Tensor:
    """(mean, rstd) of each row of float32 x (n, C), bit for bit as the
    serving body's one-pass ``ln_stats_kernel<true>``: lane l of a warp sums
    x[l], x[l + 32], ... and fmaf(x, x, .) in that order, a butterfly joins
    the lanes, var = max(fmaf(-mu, mu, E[x^2]), 0), rstd = 1 / sqrtf(var +
    1e-5f). Returns (n, 2) float32."""
    n, C = x.shape
    xp = F.pad(x, (0, -C % 32)).view(n, -1, 32)
    s = torch.zeros(n, 32, dtype=torch.float32, device=x.device)
    s2 = torch.zeros_like(s)
    for j in range(xp.shape[1]):
        s = s + xp[:, j]
        s2 = fma32(xp[:, j], xp[:, j], s2)
    mu = _f32(_warp_sum(s).double() / C)
    e2 = _f32(_warp_sum(s2).double() / C)
    var = fma32(-mu, mu, e2).clamp_min(0.0)
    v = fma32(var, torch.ones_like(var), torch.full_like(var, EPS))  # var + 1e-5f
    rs = _f32(1.0 / _f32(v.double().sqrt()).double())
    return torch.stack([mu, rs], -1)


def ln_prologue(a: torch.Tensor, stats: torch.Tensor, w: torch.Tensor, b, ln_bias: bool
                ) -> torch.Tensor:
    """The GEMM core's LayerNorm prologue on float32 a (n, K), bit for bit:
    fmaf((a - mu) * rstd, w, b), with mu and b 0 where BiasFree."""
    mu = stats[:, :1] if ln_bias else torch.zeros_like(stats[:, :1])
    t = (a - mu) * stats[:, 1:]
    return fma32(t, w.expand_as(t), (b if ln_bias else torch.zeros_like(w)).expand_as(t))


def gram(qkv: torch.Tensor, heads: int, dtype: torch.dtype = torch.float32):
    """q^T k per head of the bf16 q, k of qkv (B, H, W, 3C), summed in
    ``dtype``, and the sum of |q| |k| (the scale its float32 sums round
    against). Returns (G, scale), each (B, heads, hc, hc)."""
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    q, k = (qkv[..., i * C:(i + 1) * C].reshape(B, H * W, heads, C // heads).to(dtype)
            for i in (0, 1))
    return (torch.einsum("bphc,bphd->bhcd", q, k),
            torch.einsum("bphc,bphd->bhcd", q.abs(), k.abs()))


def norm_partials(qkv32: torch.Tensor) -> torch.Tensor:
    """q's and k's squared norms an output tile, bit for bit as the fused
    qkv kernel sums them from the float32 values qkv32 (B, H, W, 3C): an
    FMA chain over each run of RUN pixels of a tile row (the kernel's conv
    items), the tile's 2 * TILE_H runs summed from 0 row by row, run by run.
    Returns (B, tiles, 2C), the tiles row by row."""
    B, H, W, C3 = qkv32.shape
    C2 = 2 * C3 // 3
    ty, tx = -(-H // TILE_H), -(-W // TILE_W)
    t = F.pad(qkv32[..., :C2], (0, 0, 0, tx * TILE_W - W, 0, ty * TILE_H - H))
    t = t.reshape(B, ty, TILE_H, tx, TILE_W // RUN, RUN, C2)
    runs = torch.zeros(B, ty, TILE_H, tx, TILE_W // RUN, C2, dtype=torch.float32,
                       device=qkv32.device)
    for i in range(RUN):  # pixels outside the image are zeros: fmaf(0, 0, s) = s
        runs = fma32(t[..., i, :], t[..., i, :], runs)
    tiles = torch.zeros(B, ty, tx, C2, dtype=torch.float32, device=qkv32.device)
    for r in range(TILE_H):
        for h in range(TILE_W // RUN):
            tiles = tiles + runs[:, :, r, :, h]
    return tiles.reshape(B, ty * tx, C2)


def norms_from_partials(parts: torch.Tensor, heads: int) -> torch.Tensor:
    """|q| and |k| from the tile partials (B, tiles, 2C), bit for bit: the
    tiles summed in order from 0, sqrtf, clamped at 1e-12. Returns (B,
    heads, 2, hc)."""
    B, tiles, C2 = parts.shape
    s = torch.zeros(B, C2, dtype=torch.float32, device=parts.device)
    for i in range(tiles):
        s = s + parts[:, i]
    n = _f32(s.double().sqrt()).clamp_min(1e-12)
    return n.view(B, 2, heads, C2 // 2 // heads).transpose(1, 2)


def _dwconv(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3, zero padding, on channels-last t (B, H, W, c)."""
    return F.conv2d(t.permute(0, 3, 1, 2), w.to(t.dtype), padding=1,
                    groups=t.shape[-1]).permute(0, 2, 3, 1)


def _product(a32: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """bf16(a32) . bf16(w)^T summed in ``dtype``; w (N, K) float32."""
    return _bf16(a32, dtype) @ _bf16(w.reshape(w.shape[0], -1), dtype).t()


def stage_qkv(xw, stats1, p, ln_bias, dtype):
    """qkv = dw3x3(bf16(LN1(x)) . bf16(Wqkv)^T), LN1 from the kernel's
    statistics."""
    B, H, W, C = xw.shape
    y = ln_prologue(xw.reshape(-1, C), stats1, p["norm1.body.weight"], p.get("norm1.body.bias"),
                    ln_bias)
    return _dwconv(_product(y, p["attn.qkv.weight"], dtype).view(B, H, W, 3 * C),
                   p["attn.qkv_dwconv.weight"])


def stage_attn(g, norms, temperature, dtype):
    """A = softmax(G / |q| / |k| * t), the logits as the kernel takes them in
    float32, the softmax in ``dtype``."""
    logits = g / norms[:, :, 0, :, None] / norms[:, :, 1, None, :]
    return (logits * temperature.reshape(1, -1, 1, 1)).to(dtype).softmax(-1)


def stage_ao(qkv, attn, heads, dtype):
    """ao = bf16(v) . bf16(A)^T per head."""
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    v = _bf16(qkv[..., 2 * C:].reshape(B, H * W, heads, C // heads).float(), dtype)
    ao = torch.einsum("bphd,bhcd->bphc", v, _bf16(attn, dtype))
    return ao.reshape(B, H, W, C)


def stage_x2(xw, ao, p, dtype):
    """x2 = x + bf16(ao) . bf16(Wproj)^T."""
    return xw.to(dtype) + _product(ao.float(), p["attn.project_out.weight"], dtype)


def stage_gate(x2, stats2, p, ln_bias, dtype):
    """gate = a1 * sigmoid(1.702 a1) * a2, (a1, a2) = dw3x3(h1), h1 =
    bf16(LN2(x2)) . bf16(Win)^T, LN2 from the kernel's statistics."""
    B, H, W, C = x2.shape
    y = ln_prologue(x2.reshape(-1, C), stats2, p["norm2.body.weight"], p.get("norm2.body.bias"),
                    ln_bias)
    h1 = _product(y, p["ffn.project_in.weight"], dtype).view(B, H, W, -1)
    a1, a2 = _dwconv(h1, p["ffn.dwconv.weight"]).chunk(2, dim=-1)
    return a1 * torch.sigmoid(1.702 * a1) * a2


def stage_out(x2, gate, p, dtype):
    """x2 + bf16(gate) . bf16(Wout)^T, before the output's bf16 rounding."""
    return x2.to(dtype) + _product(gate.float(), p["ffn.project_out.weight"], dtype)


def serving_stage_values(x: torch.Tensor, p: Mapping[str, torch.Tensor], heads: int,
                         ln_bias: bool) -> Dict[str, torch.Tensor]:
    """The serving body in plain float32 PyTorch with the kernel's sum orders
    where they decide a bit (LayerNorm statistics, q's and k's norms), stage
    by stage: the dict ``ops/fused_block.serving_stages`` returns. x: (B, C,
    H, W) bfloat16. On a card, turn TF32 off first."""
    f32, bf = torch.float32, torch.bfloat16
    B, C, H, W = x.shape
    xw = x.permute(0, 2, 3, 1).float().contiguous()
    st = {"stats1": ln_stats(xw.reshape(-1, C))}
    st["qkv32"] = stage_qkv(xw, st["stats1"], p, ln_bias, f32)
    st["qkv"] = st["qkv32"].to(bf)
    st["norm_parts"] = norm_partials(st["qkv32"])
    st["norms"] = norms_from_partials(st["norm_parts"], heads)
    st["gram"] = gram(st["qkv"], heads)[0]
    st["attn"] = stage_attn(st["gram"], st["norms"], p["attn.temperature"], f32)
    st["ao"] = stage_ao(st["qkv"], st["attn"], heads, f32).to(bf)
    st["x2"] = stage_x2(xw, st["ao"], p, f32)
    st["stats2"] = ln_stats(st["x2"].reshape(-1, C))
    gate = stage_gate(st["x2"], st["stats2"], p, ln_bias, f32)
    st["gate32"] = F.pad(gate, (0, -gate.shape[-1] % 8))  # rows of hp, as the kernel's
    st["gate"] = st["gate32"].to(bf)
    st["out"] = stage_out(st["x2"], st["gate"][..., :gate.shape[-1]], p, f32).to(bf)
    st["out"] = st["out"].permute(0, 3, 1, 2)
    return st


class Stage(NamedTuple):
    name: str
    ok: bool
    detail: str


def _within(got: torch.Tensor, ref: torch.Tensor, scale: torch.Tensor = None) -> float:
    """max |got - ref| as a share of ATOL + RTOL |ref| (float64 ref), or of
    ATOL + RTOL scale."""
    scale = ref.abs() if scale is None else scale
    return ((got.double() - ref).abs() / (ATOL + RTOL * scale)).max().item()


def _differ(got: torch.Tensor, want: torch.Tensor) -> int:
    """How many values of two tensors differ (a NaN always does)."""
    return int((got != want).sum().item())


def check_serving_stages(x: torch.Tensor, p: Mapping[str, torch.Tensor], heads: int,
                         ln_bias: bool, st: Mapping[str, torch.Tensor]) -> List[Stage]:
    """Each stage of ``st`` (from ``ops/fused_block.serving_stages``, or
    ``serving_stage_values``) against its function of st's own previous
    stage: bit for bit where the module's docstring says so, else within
    ATOL + RTOL |ref| of float64 (the Gram: ATOL + RTOL sum |q| |k|); a bf16
    stage as the rounding of a value within that of its float64 reference.
    x: the block's bf16 input."""
    f64, bf = torch.float64, torch.bfloat16
    B, C, H, W = x.shape
    hidden = p["ffn.project_out.weight"].shape[1]
    out: List[Stage] = []

    def exact(name, got, want):
        same = tuple(got.shape) == tuple(want.shape)
        n = _differ(got, want) if same else want.numel()
        out.append(Stage(name, same and n == 0, f"{n} of {want.numel()} values differ"
                         + ("" if same else f"; shape {tuple(got.shape)}")))

    def close(name, got, ref, scale=None):
        r = _within(got, ref, scale)
        finite = bool(torch.isfinite(got).all().item())
        out.append(Stage(name, r <= 1.0 and finite, f"max {r:.3f} of the tolerance"))

    xw = x.permute(0, 2, 3, 1).float()
    exact("LN1 statistics", st["stats1"], ln_stats(xw.reshape(-1, C)))
    close("qkv", st["qkv32"], stage_qkv(xw, st["stats1"], p, ln_bias, f64))
    exact("q, k, v rounded", st["qkv"], st["qkv32"].to(bf))
    parts = norm_partials(st["qkv32"])
    exact("norm partials", st["norm_parts"], parts)
    exact("norms of q, k", st["norms"], norms_from_partials(st["norm_parts"], heads))
    g, scale = gram(st["qkv"], heads, f64)
    close("Gram of bf16 q, k", st["gram"], g, scale)
    close("attention", st["attn"], stage_attn(st["gram"], st["norms"], p["attn.temperature"], f64))
    out.append(_rounded("ao", st["ao"], stage_ao(st["qkv"], st["attn"], heads, f64), ATOL, RTOL))
    close("x2", st["x2"], stage_x2(xw, st["ao"], p, f64))
    exact("LN2 statistics", st["stats2"], ln_stats(st["x2"].reshape(-1, C)))
    gate32 = st["gate32"]
    pads = int((gate32[..., hidden:] != 0).sum().item())
    r = _within(gate32[..., :hidden], stage_gate(st["x2"], st["stats2"], p, ln_bias, f64))
    finite = bool(torch.isfinite(gate32).all().item())
    out.append(Stage("gate", r <= 1.0 and finite and pads == 0,
                     f"max {r:.3f} of the tolerance, {pads} pad values not 0"))
    exact("gate rounded", st["gate"], gate32.to(bf))
    ref = stage_out(st["x2"], st["gate"][..., :hidden], p, f64)
    o = _rounded("out", st["out"].permute(0, 2, 3, 1), ref, ATOL, RTOL)
    out.append(o)
    return out


# --- the MaIR mixer's serving bodies: K6, K2, K7 ---------------------------


def _close(name: str, got: torch.Tensor, ref: torch.Tensor) -> Stage:
    """A float32 stage within ATOL + RTOL |ref| of its float64 reference."""
    r = _within(got, ref)
    finite = bool(torch.isfinite(got).all().item())
    return Stage(name, r <= 1.0 and finite, f"max {r:.3f} of the tolerance")


def _rounded(name: str, got: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float) -> Stage:
    """A bf16 stage that must be the nearest-even rounding of some value
    within atol + rtol |ref| of its float64 reference."""
    tol = atol + rtol * ref.abs()
    lo, hi = ((ref + s * tol).to(torch.bfloat16).double() for s in (-1, 1))
    g = got.double()
    outside = int(((g < lo) | (g > hi) | ~torch.isfinite(g)).sum().item())
    flips = int((g != ref.to(torch.bfloat16).double()).sum().item())
    return Stage(name, outside == 0, f"{outside} values not the rounding of one within the "
                 f"tolerance; {flips} of {g.numel()} not bf16(float64 reference)")


def _copy(name: str, got: torch.Tensor, want: torch.Tensor) -> Stage:
    """A stage that must equal ``want`` bit for bit, shape and dtype too."""
    same = tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype
    n = _differ(got, want) if same else want.numel()
    return Stage(name, same and n == 0, f"{n} of {want.numel()} values differ"
                 + ("" if same else f"; {got.dtype} {tuple(got.shape)}"))


def check_prologue_serving(h: torch.Tensor, w_in: torch.Tensor, conv_w: torch.Tensor,
                           conv_b: torch.Tensor, st: Mapping[str, torch.Tensor]) -> List[Stage]:
    """K6's serving stages ``st`` (``ops/nss_prologue.mixer_prologue_serving_stages``):
    W_in's bf16 copy bit for bit; against float64, in_proj's halves from
    bf16(h) . bf16(W_in), x from the kernel's own xpre. h: the block's
    float32 LayerNorm output."""
    from tpuir_torch.utils.misc import bf16_padded_rows

    f64 = torch.float64
    di = conv_w.shape[0]
    xz = _product(h, w_in, f64)
    conv = _dwconv(st["xpre"].double(), conv_w) + conv_b.double()
    return [_copy("W_in bf16 copy", st["w16"], bf16_padded_rows(w_in)),
            _close("in_proj x half", st["xpre"], xz[..., :di]),
            _rounded("x", st["x"], F.silu(conv), ATOL, RTOL),
            _rounded("z", st["z"], xz[..., di:], ATOL, RTOL)]


def check_scan_serving(x: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor,
                       A: torch.Tensor, D: torch.Tensor, delta_bias: torch.Tensor,
                       scan_len: int, shift: bool, st: Mapping[str, torch.Tensor]
                       ) -> List[Stage]:
    """K2's serving stages ``st`` (``ops/nss_stripe.nss_scan_serving_stages``)
    against float64: x_dbl from bf16(x) . bf16(W_xp), then y and pooled from
    the scan of the kernel's own x_dbl. x: the body's bf16 input."""
    from tpuir_torch.ops.nss_stripe import scan_from_xdbl

    B, H, W, d = x.shape
    xw = x.reshape(B, H * W, d).double()
    xdbl = torch.einsum("bld,kcd->blkc", xw, _bf16(x_proj_w, torch.float64))
    y, pooled = scan_from_xdbl(xw, st["x_dbl"].double(), dt_w, A, D, delta_bias, H, W,
                               scan_len, shift)
    bound = SCAN_ATOL + SCAN_RTOL * y.abs().sum((2, 3))
    err = (st["pooled"].double() - pooled).abs()
    r = (err / bound).max().item()
    finite = bool(torch.isfinite(st["pooled"]).all().item())
    return [_close("x_dbl", st["x_dbl"], xdbl),
            _rounded("y", st["y"], y, SCAN_ATOL, SCAN_RTOL),
            Stage("pooled", r <= 1.0 and finite,
                  f"max {r:.3f} of the tolerance (atol + rtol sum|y|)")]


def check_epilogue_serving(y: torch.Tensor, gates: torch.Tensor, z: torch.Tensor,
                           ln_w: torch.Tensor, ln_b: torch.Tensor, w_out: torch.Tensor,
                           st: Mapping[str, torch.Tensor]) -> List[Stage]:
    """K7's serving stages ``st`` (``ops/nss_epilogue.mixer_epilogue_serving_stages``):
    W_out's bf16 copy bit for bit; against float64, the bf16 gated rows
    from the bf16 y and z, the output from the kernel's own gated rows. y,
    z: the body's bf16 inputs."""
    from tpuir_torch.ops.nss_epilogue import gated_rows_serving
    from tpuir_torch.utils.misc import bf16_padded_rows

    di = y.shape[-1]
    gated = st["gated"]
    pads = int((gated[..., di:] != 0).sum().item())
    ref = gated_rows_serving(y, gates, z, ln_w, ln_b, torch.float64)
    g = _rounded("gated rows", gated[..., :di], ref, ATOL, RTOL)
    bf = gated.dtype == torch.bfloat16
    return [_copy("W_out bf16 copy", st["w16"], bf16_padded_rows(w_out)),
            Stage(g.name, g.ok and pads == 0 and bf, f"{g.detail}; {pads} pad values not 0; "
                  f"{gated.dtype}"),
            _close("out_proj", st["out"], _product(gated[..., :di].float(), w_out,
                                                   torch.float64))]


# --- the scans off the stripe route: K3 (sequence route), K5 (fused route) --


def check_seq_scan_serving(xs: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor,
                           A: torch.Tensor, D: torch.Tensor, delta_bias: torch.Tensor,
                           st: Mapping[str, torch.Tensor]) -> List[Stage]:
    """K3's serving stages ``st`` (``ops/scan_fused_proj.
    selective_scan_fused_proj_serving_stages``) against float64: x_dbl from
    bf16(xs) . bf16(W_xp), then the float32 y within the scan tolerance of
    the float64 scan of the kernel's own x_dbl. xs: the body's bf16 input
    (B, 4, L, d) in sequence order."""
    from tpuir_torch.ops.nss_stripe import seq_scan_from_xdbl

    xw = xs.double()
    xdbl = torch.einsum("bkld,kcd->bklc", xw, _bf16(x_proj_w, torch.float64))
    y = seq_scan_from_xdbl(xw, st["x_dbl"].double(), dt_w, A, D, delta_bias)
    got = st["y"]
    r = ((got.double() - y).abs() / (SCAN_ATOL + SCAN_RTOL * y.abs())).max().item()
    ok = r <= 1.0 and got.dtype == torch.float32 and bool(torch.isfinite(got).all().item())
    flips = int((got.double() != y.float().double()).sum().item())
    return [_close("x_dbl", st["x_dbl"], xdbl),
            Stage("y", ok, f"max {r:.3f} of the scan tolerance; {flips} of {got.numel()} "
                  f"not float32(float64 reference); {got.dtype}")]


def check_fused_scan_serving(x: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor,
                             A: torch.Tensor, D: torch.Tensor, delta_bias: torch.Tensor,
                             scan_len: int, shift: bool, st: Mapping[str, torch.Tensor]
                             ) -> List[Stage]:
    """K5's serving stages ``st`` (``ops/nss_fused.nss_scan_fused_serving_stages``)
    against float64, as ``check_scan_serving`` holds K2's (the same path and
    x_dbl layout): y01 and y23 together as y in image layout. x: the body's
    bf16 input."""
    y = torch.cat([st["y01"], st["y23"].transpose(2, 3)], 1)
    return check_scan_serving(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, shift,
                              {"x_dbl": st["x_dbl"], "y": y, "pooled": st["pooled"]})


# --- K2's bf16-recurrence body ---------------------------------------------


def check_nss_scan_recur_serving(x: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor,
                                 A: torch.Tensor, D: torch.Tensor, delta_bias: torch.Tensor,
                                 scan_len: int, shift: bool, st: Mapping[str, torch.Tensor]
                                 ) -> List[Stage]:
    """K2's bf16-recurrence stages ``st`` (``ops/nss_stripe.nss_scan_recur_stages``):
    x_dbl against float64, the level-2 carries bit for bit against their
    emulation from the kernel's own x_dbl, y and pooled against float64
    sums of the emulated h. x: the body's bf16 input. Run on the kernel's
    card: the emulation's exp2, exp and log1p are that card's."""
    from tpuir_torch.ops.nss_stripe import recur_from_xdbl

    B, H, W, d = x.shape
    xw = x.reshape(B, H * W, d).float()
    xdbl = torch.einsum("bld,kcd->blkc", xw.double(), _bf16(x_proj_w, torch.float64))
    y, pooled, carries, mag = recur_from_xdbl(xw, st["x_dbl"].float(), dt_w, A, D, delta_bias,
                                              H, W, scan_len, shift, torch.float64,
                                              magnitude=True)
    got = st["carries"]
    same_shape = tuple(got.shape) == tuple(carries.shape)
    n = _differ(got, carries) if same_shape else carries.numel()
    rel = ((got.double() - carries.double()).abs().max().item() if same_shape else float("nan"))
    lo, hi = ((y + s * RECUR_RTOL * mag).to(torch.bfloat16).double() for s in (-1, 1))
    g = st["y"].double()
    outside = int(((g < lo) | (g > hi) | ~torch.isfinite(g)).sum().item())
    flips = int((g != y.to(torch.bfloat16).double()).sum().item())
    bound = SCAN_ATOL + SCAN_RTOL * y.abs().sum((2, 3))
    r = ((st["pooled"].double() - pooled).abs() / bound).max().item()
    finite = bool(torch.isfinite(st["pooled"]).all().item())
    return [_close("x_dbl", st["x_dbl"], xdbl),
            Stage("level-2 carries", same_shape and n == 0,
                  f"{n} of {carries.numel()} values differ (max |diff| {rel:.3g}); "
                  f"shape {tuple(got.shape)}, want {tuple(carries.shape)}"),
            Stage("y", outside == 0, f"{outside} values not the rounding of one within "
                  f"RECUR_RTOL of the emulated h's sum; {flips} of {g.numel()} not "
                  f"bf16(float64 reference)"),
            Stage("pooled", r <= 1.0 and finite,
                  f"max {r:.3f} of the tolerance (atol + rtol sum|y|)")]
