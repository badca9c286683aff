"""K1's serving body in the port: the plain version against the JAX kernel
with ``mm_bf16=True, fast_gelu=True`` (interpret mode) on bf16 inputs, the
wrapper's checks, the stage-by-stage check of ``utils/serving_check.py``
(its emulations, and that it passes the body and catches each planted
fault), the GEMM core's bf16-operand kernel (``ops/tc_gemm.
gemm_bf16_operands``: the serving body's apply, projection and project_out,
and K7 serving's out_proj) against float64, and the CUDA kernels on a
card.

Block-level criteria against tpuir on the CPU (the bf16 flips that two sum
orders give): elementwise |got - want| <= 2^-6 * max(|want|, 1), two bf16
ulps; and the mean |got - want| at most 1/20 of the mean distance between
the serving and the parity body on the same inputs.

On the card, at widths of 48 and more, a float32 sum that differs in its
last bit from another order's flips a bf16 operand of the next product now
and then, and the flips cascade through the block's rounding points: the
plain version itself, its sums taken in float64 instead of float32, misses
those criteria at Restormer@256's shapes (``PERF.md`` §6). So the kernel is
held stage by stage, each stage to its function of the kernel's own
previous stage (``check_serving_stages``), where nothing cascades.

JAX is imported only on the reference side, so the card tests run where JAX
is absent: ``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from tpuir_torch.core.engine import true_float32
from tpuir_torch.models.restormer import init_block_params, state_dict_from_jax
from tpuir_torch.ops import _kernels
from tpuir_torch.ops.fused_block import (
    fused_transformer_block,
    fused_transformer_block_serving_plain,
    serving_stages,
)
from tpuir_torch.ops.tc_gemm import gemm_bf16_operands
from tpuir_torch.utils import k1s_phases, serving_mutants
from tpuir_torch.utils import serving_check as sc
from tests.torch_threads import one_torch_thread  # noqa: F401

KEY = "fused_transformer_block_serving"
# the bf16-operand core against float64 products of its operands (the
# parity core's card tolerance, tests/test_torch_gemm_core.py)
ATOL, RTOL = 5e-5, 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _nchw(x_nhwc) -> torch.Tensor:
    return torch.as_tensor(x_nhwc).permute(0, 3, 1, 2)  # channels_last, no copy


def _bf16_input(shape, seed) -> torch.Tensor:
    """Unit-scale NHWC values rounded to bf16, as an NCHW channels_last view."""
    x = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    return _nchw(torch.from_numpy(x).to(torch.bfloat16))


def assert_block_level(got, want, parity):
    """The block-level criteria above; all three tensors float32."""
    err = (got - want).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= 2.0 ** -6 * want.abs().clamp_min(1.0)).all()), err.max().item()
    assert err.mean().item() <= (want - parity).abs().mean().item() / 20


def _jax_serving_and_parity(x_bf16, C, heads, ln_bias, row_tile):
    """(serving output, parity output, params): tpuir's kernel in interpret
    mode on the same bf16 input, both bodies, Flax-initialised params."""
    import jax
    import jax.numpy as jnp
    from flax.core import unfreeze

    from tpuir.models.restormer import TransformerBlock
    from tpuir.ops.fused_block import fused_transformer_block as jax_kernel

    x32 = np.asarray(x_bf16.float())
    blk = TransformerBlock(C, heads, 2.66, False, ln_bias)
    params = unfreeze(blk.init(jax.random.PRNGKey(0), x32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(1)
    params["attn"]["temperature"] = (rng.rand(heads, 1, 1) + 0.5).astype(np.float32)
    for n in ("norm1", "norm2"):
        params[n]["weight"] = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
        if ln_bias:
            params[n]["bias"] = (0.1 * rng.standard_normal(C)).astype(np.float32)
    xj = jnp.asarray(x32)
    serving = jax_kernel(xj.astype(jnp.bfloat16), params, heads, ln_bias, row_tile=row_tile,
                         mm_bf16=True, fast_gelu=True, interpret=True)
    parity = jax_kernel(xj, params, heads, ln_bias, row_tile=row_tile, interpret=True)
    return (np.asarray(serving.astype(jnp.float32)), np.asarray(parity), params)


@pytest.mark.parametrize("ln_bias", [False, True])
@pytest.mark.parametrize(
    "H,W,C,heads,row_tile",
    [
        (16, 16, 8, 1, 8),
        (24, 16, 16, 2, 8),
        (20, 24, 16, 4, 8),  # H not a multiple of row_tile
        (16, 16, 8, 1, 4),
    ],
)
def test_plain_serving_matches_jax_kernel(H, W, C, heads, row_tile, ln_bias):
    x = np.random.RandomState(0).rand(2, H, W, C).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    serving, parity, params = _jax_serving_and_parity(xb, C, heads, ln_bias, row_tile)
    prefix = "encoder_level1.0."
    p = {k[len(prefix):]: v for k, v in state_dict_from_jax({"encoder_level1_0": params}).items()}
    before = _kernels.LAUNCHES[KEY]
    got = fused_transformer_block(_nchw(xb), p, heads, ln_bias, serving=True)
    assert _kernels.LAUNCHES[KEY] == before  # a CPU tensor takes the plain version
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert_block_level(got.float().permute(0, 2, 3, 1), torch.from_numpy(serving),
                       torch.from_numpy(parity))


def test_wrapper_serving_on_cpu_launches_nothing():
    p = init_block_params(48, 1, False, seed=0)
    x = _bf16_input((1, 9, 7, 48), seed=0)
    before = _kernels.LAUNCHES[KEY]
    got = fused_transformer_block(x, p, 1, False, serving=True)
    assert _kernels.LAUNCHES[KEY] == before
    torch.testing.assert_close(got, fused_transformer_block_serving_plain(x, p, 1, False),
                               atol=0, rtol=0)


@pytest.mark.parametrize("serving,dtype", [(True, torch.float32), (False, torch.bfloat16)])
def test_wrapper_rejects_the_other_body_dtype(serving, dtype):
    p = init_block_params(16, 2, True, seed=0)
    x = _nchw(torch.rand(1, 8, 8, 16).to(dtype))
    with pytest.raises(TypeError):
        fused_transformer_block(x, p, 2, True, serving=serving)


# --- the stage-by-stage check -----------------------------------------------

def _exact_float32(v) -> np.float32:
    """The float32 nearest the rational v, ties to even."""
    from fractions import Fraction

    f = np.float32(float(v))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))):
        d = abs(Fraction(float(c)) - v)
        even = (int(np.array(c).view(np.int32)) & 1) == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, c)
    return best[1]


def test_fma32_rounds_once():
    from fractions import Fraction

    rng = np.random.RandomState(0)
    a, b, c = (rng.randn(3000).astype(np.float32) * 10.0 ** rng.randint(-6, 6, 3000)
               for _ in range(3))
    # halfway cases of a double rounding: a * b = 1 + 2^-24 + 2^-60, c = 0
    a[0], b[0], c[0] = np.float32(1 + 2 ** -12), np.float32(1 + 2 ** -12), np.float32(-2 ** -24)
    a[1], b[1], c[1] = np.float32(1 + 2 ** -23), np.float32(1 + 2 ** -23), np.float32(0)
    got = sc.fma32(*(torch.from_numpy(t) for t in (a, b, c))).numpy()
    want = [_exact_float32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
            for x, y, z in zip(a, b, c)]
    assert np.array_equal(got, np.array(want, np.float32))


@pytest.mark.parametrize("C", [8, 48, 96, 100])
def test_ln_stats_are_the_one_pass_statistics(C):
    x = torch.from_numpy(np.random.RandomState(C).rand(300, C).astype(np.float32) * 4 - 1)
    st = sc.ln_stats(x)
    x64 = x.double()
    mu = x64.mean(-1)
    var = ((x64 * x64).mean(-1) - mu * mu).clamp_min(0)
    torch.testing.assert_close(st[:, 0].double(), mu, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(st[:, 1].double(), (var + 1e-5).rsqrt(), atol=0, rtol=1e-5)


@pytest.mark.parametrize("H,W,C,heads", [(8, 8, 16, 2), (20, 30, 8, 1)])  # 1 and 6 tiles
def test_gram_is_the_sum_of_bf16_products(H, W, C, heads):
    """The plain Gram sums the products of the bf16 q, k (exact in float32);
    the norms from the tile partials are q's and k's float32 norms."""
    qkv = torch.from_numpy(np.random.RandomState(H).randn(2, H, W, 3 * C).astype(np.float32))
    g, scale = sc.gram(qkv.to(torch.bfloat16), heads)
    q, k = (qkv[..., i * C:(i + 1) * C].reshape(2, H * W, heads, C // heads).double()
            for i in (0, 1))
    bq, bk = (t.to(torch.bfloat16).double() for t in (q, k))
    want = torch.einsum("bphc,bphd->bhcd", bq, bk)
    want_scale = torch.einsum("bphc,bphd->bhcd", bq.abs(), bk.abs())
    # float32 sums of exact products: within (pixels) ulps of the |terms|
    assert bool(((g.double() - want).abs() <= 2.0 ** -24 * H * W * want_scale).all())
    assert bool(((scale.double() - want_scale).abs() <= 2.0 ** -24 * H * W * want_scale).all())
    parts = sc.norm_partials(qkv)
    assert parts.shape == (2, -(-H // sc.TILE_H) * -(-W // sc.TILE_W), 2 * C)
    norms = sc.norms_from_partials(parts, heads)
    want_n = torch.stack([q.square().sum(1).sqrt(), k.square().sum(1).sqrt()], 2)
    torch.testing.assert_close(norms.double(), want_n, atol=0, rtol=2e-5)


STAGE_CASES = [(1, 24, 20, 48, 1, False), (2, 8, 8, 16, 2, True), (1, 8, 6, 384, 8, False)]


@pytest.mark.parametrize("B,H,W,C,heads,ln_bias", STAGE_CASES)
def test_stage_checks_pass_the_plain_stages(B, H, W, C, heads, ln_bias):
    p = init_block_params(C, heads, ln_bias, seed=C)
    x = _bf16_input((B, H, W, C), seed=H * W)
    st = serving_stages(x, p, heads, ln_bias)  # a CPU tensor: the plain version's stages
    verdicts = sc.check_serving_stages(x, p, heads, ln_bias, st)
    assert [v.name for v in verdicts if not v.ok] == [], verdicts


@pytest.mark.parametrize("ln_bias", [False, True])
@pytest.mark.parametrize("H,W,C,heads", [(16, 16, 8, 1), (20, 24, 16, 4)])
def test_plain_stages_match_jax_kernel(H, W, C, heads, ln_bias):
    x = np.random.RandomState(0).rand(2, H, W, C).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    serving, parity, params = _jax_serving_and_parity(xb, C, heads, ln_bias, 8)
    prefix = "encoder_level1.0."
    p = {k[len(prefix):]: v for k, v in state_dict_from_jax({"encoder_level1_0": params}).items()}
    got = sc.serving_stage_values(_nchw(xb), p, heads, ln_bias)["out"]
    assert_block_level(got.float().permute(0, 2, 3, 1), torch.from_numpy(serving),
                       torch.from_numpy(parity))


def _two_pass(x):
    mu = sc.ln_stats(x)[:, 0]
    return torch.stack([mu, torch.rsqrt(((x - mu[:, None]) ** 2).mean(-1) + 1e-5)], -1)


def _truncated(t):
    """float32 t rounded to bf16 toward zero."""
    return (t.float().contiguous().view(torch.int32) & ~0xFFFF).view(torch.float32).to(
        torch.bfloat16)


def _faulty_stages(x, p, heads, ln_bias, fault):
    """The plain stages with one planted fault, each later stage computed
    from the faulty one, as a kernel with that fault would."""
    f32, bf16, C = torch.float32, torch.bfloat16, x.shape[1]
    B, H, W, hc = x.shape[0], x.shape[2], x.shape[3], C // heads
    hidden = p["ffn.project_out.weight"].shape[1]
    bf = lambda t: t.to(bf16).float()  # noqa: E731
    def stats(name, t):
        return (_two_pass if fault == name else sc.ln_stats)(t.reshape(-1, C))
    xw = x.permute(0, 2, 3, 1).float().contiguous()
    st = {"stats1": stats("two-pass LN1", xw)}
    qkv32 = sc.stage_qkv(xw, st["stats1"], p, ln_bias, f32)
    wq = p["attn.qkv.weight"].reshape(3 * C, C)
    y = sc.ln_prologue(xw.reshape(-1, C), st["stats1"], p["norm1.body.weight"],
                       p.get("norm1.body.bias"), ln_bias)
    if fault == "LN1 output unrounded":
        qkv32 = sc._dwconv((y @ bf(wq).t()).view(B, H, W, 3 * C), p["attn.qkv_dwconv.weight"])
    if fault == "halo not zeroed outside the image":
        # a pixel outside the image reads as zeros with statistics (0, 0): its
        # LayerNorm is the bias, and the product of that fills the conv's padding
        prod = (bf(y) @ bf(wq).t()).view(B, H, W, 3 * C)
        pad = bf(p["norm1.body.bias"]) @ bf(wq).t()
        full = pad.expand(B, H + 2, W + 2, 3 * C).clone()
        full[:, 1:-1, 1:-1] = prod
        qkv32 = torch.nn.functional.conv2d(full.permute(0, 3, 1, 2), p["attn.qkv_dwconv.weight"],
                                           groups=3 * C).permute(0, 2, 3, 1)
    st["qkv32"] = qkv32
    st["qkv"] = qkv32.to(bf16)
    if fault == "q and k stored truncated":
        st["qkv"][..., :2 * C] = _truncated(qkv32[..., :2 * C])
    if fault == "v stored truncated":
        st["qkv"][..., 2 * C:] = _truncated(qkv32[..., 2 * C:])
    st["norm_parts"] = sc.norm_partials(
        torch.cat([bf(qkv32[..., :2 * C]), qkv32[..., 2 * C:]], -1)
        if fault == "norms from the rounded q" else qkv32)
    st["norms"] = sc.norms_from_partials(st["norm_parts"], heads)
    st["gram"] = sc.gram(st["qkv"], heads)[0]
    if fault == "Gram transposed":
        st["gram"] = st["gram"].transpose(-1, -2).contiguous()
    st["attn"] = sc.stage_attn(st["gram"], st["norms"], p["attn.temperature"], f32)
    ao = sc.stage_ao(st["qkv"], st["attn"], heads, f32)
    if fault == "v unrounded":
        v = qkv32[..., 2 * C:].reshape(B, H * W, heads, hc)
        ao = torch.einsum("bphd,bhcd->bphc", v, bf(st["attn"])).reshape(B, H, W, C)
    st["ao"] = _truncated(ao) if fault == "ao stored truncated" else ao.to(bf16)
    wp = p["attn.project_out.weight"].reshape(C, C)
    st["x2"] = sc.stage_x2(xw, st["ao"], p, f32)
    if fault == "ao unrounded":
        st["x2"] = xw + ao @ bf(wp).t()
    if fault == "attention folded into the projection":
        v = st["qkv"][..., 2 * C:].float().reshape(B, H * W, C)
        mt = torch.einsum("ohc,bhcd->bohd", wp.reshape(C, heads, hc), st["attn"]).reshape(B, C, C)
        st["x2"] = xw + torch.einsum("bpk,bok->bpo", v, bf(mt)).reshape(B, H, W, C)
    st["stats2"] = stats("two-pass LN2", st["x2"])
    gate = sc.stage_gate(st["x2"], st["stats2"], p, ln_bias, f32)
    if fault in ("LN2 output unrounded", "exact GELU"):
        y2 = sc.ln_prologue(st["x2"].reshape(-1, C), st["stats2"], p["norm2.body.weight"],
                            p.get("norm2.body.bias"), ln_bias)
        y2 = y2 if fault == "LN2 output unrounded" else bf(y2)
        h1 = (y2 @ bf(p["ffn.project_in.weight"].reshape(-1, C)).t()).view(B, H, W, -1)
        a1, a2 = sc._dwconv(h1, p["ffn.dwconv.weight"]).chunk(2, dim=-1)
        gelu = torch.nn.functional.gelu(a1) if fault == "exact GELU" else a1 * torch.sigmoid(
            1.702 * a1)
        gate = gelu * a2
    st["gate32"] = torch.nn.functional.pad(gate, (0, -gate.shape[-1] % 8))
    st["gate"] = (_truncated(st["gate32"]) if fault == "gate stored truncated"
                  else st["gate32"].to(bf16))
    wo = p["ffn.project_out.weight"].reshape(C, -1)
    g16 = st["gate"][..., :hidden].float()
    out = sc.stage_out(st["x2"], g16, p, f32)
    if fault == "gate unrounded":
        out = st["x2"] + gate @ bf(wo).t()
    if fault == "Wout unrounded":
        out = st["x2"] + g16 @ wo.t()
    if fault == "output truncated":
        out = (out.contiguous().view(torch.int32) & ~0xFFFF).view(torch.float32)
    st["out"] = out.to(bf16).permute(0, 3, 1, 2)
    return st


# (planted fault, the stage that must catch it, the LayerNorm variants it shows in)
FAULTS = [
    ("two-pass LN1", "LN1 statistics", (False, True)),
    ("LN1 output unrounded", "qkv", (False, True)),
    # BiasFree: a zero pixel's LayerNorm is 0, so the unzeroed halo is zero anyway
    ("halo not zeroed outside the image", "qkv", (True,)),
    ("q and k stored truncated", "q, k, v rounded", (False, True)),
    ("v stored truncated", "q, k, v rounded", (False, True)),
    ("norms from the rounded q", "norm partials", (False, True)),
    ("Gram transposed", "Gram of bf16 q, k", (False, True)),
    ("v unrounded", "ao", (False, True)),
    ("ao stored truncated", "ao", (False, True)),
    ("ao unrounded", "x2", (False, True)),
    ("attention folded into the projection", "x2", (False, True)),
    ("two-pass LN2", "LN2 statistics", (False, True)),
    ("LN2 output unrounded", "gate", (False, True)),
    ("exact GELU", "gate", (False, True)),
    ("gate stored truncated", "gate rounded", (False, True)),
    ("gate unrounded", "out", (False, True)),
    ("Wout unrounded", "out", (False, True)),
    ("output truncated", "out", (False, True)),
]


@pytest.mark.parametrize("fault,stage,ln_bias", [(f, s, b) for f, s, lbs in FAULTS for b in lbs])
def test_stage_checks_catch_a_fault(fault, stage, ln_bias):
    C, heads = 48, 1
    p = init_block_params(C, heads, ln_bias, seed=C)
    x = _bf16_input((1, 24, 20, C), seed=3)
    verdicts = sc.check_serving_stages(x, p, heads, ln_bias,
                                       _faulty_stages(x, p, heads, ln_bias, fault))
    assert [v.name for v in verdicts if not v.ok] == [stage], verdicts


@pytest.mark.parametrize("name", list(serving_mutants.MUTANTS))
def test_serving_mutants_apply_to_the_sources(name, tmp_path):
    """The card's mutation controls (``utils/serving_mutants.py``) still plant
    each fault in the current sources, on a copy."""
    shutil.copytree(os.path.join(os.path.dirname(_kernels.__file__), "..", "csrc"),
                    tmp_path / "csrc")
    serving_mutants.plant(str(tmp_path), serving_mutants.MUTANTS[name])


@pytest.mark.parametrize("name", list(k1s_phases.PHASES))
def test_k1s_phases_apply_to_the_sources(name, tmp_path):
    """The phase-removal timings (``utils/k1s_phases.py``) still take each
    phase out of the current fused kernel, on a copy."""
    shutil.copytree(os.path.join(os.path.dirname(_kernels.__file__), "..", "csrc"),
                    tmp_path / "csrc")
    serving_mutants.plant(str(tmp_path), k1s_phases.PHASES[name])


# --- the GEMM core's bf16-operand kernel ------------------------------------

def _bf16_float64_reference(a, w, resid):
    """(float64 product of a and w rounded to bf16, plus resid; the same of
    their absolute values)."""
    a = a.to(torch.bfloat16).double()
    w = w.to(torch.bfloat16).double().transpose(-1, -2)
    out, scale = a @ w, a.abs() @ w.abs()
    if resid is not None:
        out, scale = out + resid.double(), scale + resid.double().abs()
    return out, scale


def _gemm_operands(batch, M, N, K, per_image, resid, seed, device="cpu", lda=None):
    rng = np.random.RandomState(seed)
    t = lambda v: torch.from_numpy(np.asarray(v, np.float32)).to(device)  # noqa: E731
    a = t(rng.randn(batch, M, lda or K))[..., :K]
    w = t(rng.randn(*((batch,) if per_image else ()), N, K) / np.sqrt(K))
    r = t(rng.randn(batch, M, N)) if resid else None
    return a, w, r


# (batch, M, N, K, one weight an image, residual, row stride of A): the core's
# bf16-operand kernel at K1 serving's apply (v strided in q | k | v),
# projection and project_out (K the gate's padded row), K7 serving's
# out_proj (K d_inner rounded up to 8: MaIR-CDN's 234 and 33; MaIRUNet's
# widths) and ragged sizes
BF16_OPERAND_CASES = [
    (1, 37, 20, 16, False, False, None),
    (2, 19, 12, 24, True, True, 72),
    (1, 130, 48, 136, False, True, None),
    (1, 67, 180, 240, False, False, None),
    (1, 45, 20, 40, False, False, None),
    (1, 33, 48, 96, False, False, None),
    (1, 21, 384, 768, False, False, None),
]


@pytest.mark.parametrize("batch,M,N,K,per_image,resid,lda", BF16_OPERAND_CASES)
def test_gemm_bf16_operands_plain_is_the_product_of_its_operands(batch, M, N, K, per_image,
                                                               resid, lda):
    a, w, r = _gemm_operands(batch, M, N, K, per_image, resid, seed=M + K, lda=lda)
    a16, w16 = a.to(torch.bfloat16), w.to(torch.bfloat16)
    before = _kernels.LAUNCHES["tc_gemm_bf16_operands"]
    got = gemm_bf16_operands(a16, w16, r)
    assert _kernels.LAUNCHES["tc_gemm_bf16_operands"] == before  # the plain version on a CPU tensor
    want, scale = _bf16_float64_reference(a16.float(), w16.float(), r)
    assert bool(((got.double() - want).abs() <= 1e-6 * scale).all())


# --- the CUDA kernels, on a card --------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("batch,M,N,K,per_image,resid,lda", [
    (1, 1000, 37, 48, False, False, None),  # ragged M, N
    (3, 300, 96, 96, True, False, 288),     # the apply: one weight an image, v strided
    (1, 777, 48, 128, False, True, None),   # level 1's project_out, h = 127 padded to 128
    (1, 260, 384, 1024, False, True, None),  # the latent's project_out
    # K7 serving's out_proj, K = d_inner rounded up to 8
    (1, 4099, 180, 240, False, False, None),  # MaIR-CDN, d_inner 234
    (1, 3001, 48, 96, False, False, None),    # MaIRUNet's widths
    (1, 2999, 96, 192, False, False, None),
    (1, 1500, 192, 384, False, False, None),
    (1, 777, 384, 768, False, False, None),
    (1, 1001, 20, 40, False, False, None),    # d_inner 33
    (1, 513, 10, 16, False, False, None),     # d_inner 12
])
def test_gemm_bf16_operands_matches_float64_on_card(cuda_device, batch, M, N, K, per_image,
                                                    resid, lda):
    a, w, r = _gemm_operands(batch, M, N, K, per_image, resid, seed=N + K,
                                device=cuda_device, lda=lda)
    a16, w16 = a.to(torch.bfloat16), w.to(torch.bfloat16)
    if lda:  # a column slice of a wider bf16 tensor, as v is of q | k | v
        a16 = torch.zeros(batch, M, lda, device=cuda_device, dtype=torch.bfloat16)[..., :K]
        a16.copy_(a[..., :K].to(torch.bfloat16))
    before = _kernels.LAUNCHES["tc_gemm_bf16_operands"]
    with torch.inference_mode():
        got = gemm_bf16_operands(a16, w16, r)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["tc_gemm_bf16_operands"] == before + 1
        again = gemm_bf16_operands(a16, w16, r)
        want, _ = _bf16_float64_reference(a16.float(), w16.float(), r)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.double(), want, atol=ATOL, rtol=RTOL)


CARD_BLOCK_CASES = [
    (2, 8, 1, 16, 16, False),
    (2, 16, 4, 20, 24, True),
    (2, 48, 1, 33, 17, False),   # h = 127, odd sizes everywhere
    (2, 96, 2, 24, 20, True),    # h = 255
    (1, 192, 4, 16, 16, False),  # h = 510
    (1, 384, 8, 8, 12, True),    # h = 1021
    (1, 256, 2, 8, 8, False),    # head width 128, the kernel's limit
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,heads,H,W,ln_bias", CARD_BLOCK_CASES)
def test_serving_kernel_matches_plain_on_card(cuda_device, B, C, heads, H, W, ln_bias):
    """The kernel stage by stage (``check_serving_stages``), and its two parts
    giving the whole body's output."""
    p = {k: v.to(cuda_device) for k, v in init_block_params(C, heads, ln_bias, seed=C).items()}
    x = _bf16_input((B, H, W, C), seed=B * C).to(cuda_device)
    before = _kernels.LAUNCHES[KEY]
    with torch.inference_mode():
        got = fused_transformer_block(x, p, heads, ln_bias, serving=True)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES[KEY] == before + 1
        assert got.dtype == torch.bfloat16
        st = serving_stages(x, p, heads, ln_bias)
        assert _kernels.LAUNCHES[KEY] == before + 1  # a check's launches are not counted
        with true_float32():
            verdicts = sc.check_serving_stages(x, p, heads, ln_bias, st)
    assert torch.equal(st["out"], got)
    assert [v.name for v in verdicts if not v.ok] == [], verdicts


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,heads,H,W,ln_bias", [(2, 48, 1, 33, 17, False),
                                                   (1, 384, 8, 8, 12, True)])
def test_serving_kernel_repeats_bit_for_bit_on_card(cuda_device, B, C, heads, H, W, ln_bias):
    p = {k: v.to(cuda_device) for k, v in init_block_params(C, heads, ln_bias, seed=C).items()}
    x = _bf16_input((B, H, W, C), seed=C).to(cuda_device)
    with torch.inference_mode():
        first = fused_transformer_block(x, p, heads, ln_bias, serving=True)
        again = fused_transformer_block(x, p, heads, ln_bias, serving=True)
    assert torch.equal(first, again)
