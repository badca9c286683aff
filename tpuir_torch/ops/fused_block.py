"""K1: one Restormer TransformerBlock, hand-written for Hopper.

The counterpart of ``tpuir/ops/fused_block.py:fused_transformer_block``,
in its two bodies: float32 parity, and serving (``mm_bf16=True,
fast_gelu=True``: bf16 block IO and bf16 products with float32 sums, a
one-pass LayerNorm variance, the sigmoid GELU). The kernels are
``tpuir_torch/csrc/fused_block.cu`` (``tpuir_fused_block_f32``,
``tpuir_fused_block_bf16``); its source note gives the math, what bounds
them on the card and what the design does about that.

``fused_transformer_block`` is the wrapper. It checks its inputs and raises
on anything the kernel does not take. On a CUDA tensor it launches the
kernel on the current stream and counts the launch, under
``fused_transformer_block`` or, for the serving body,
``fused_transformer_block_serving``; on a CPU tensor, and only there, it
runs ``fused_transformer_block_plain`` or
``fused_transformer_block_serving_plain``, the same math in plain PyTorch.
The plain versions are also what the kernels are compared with on the card.
``serving_stages`` runs the serving kernel in its two parts and returns
every stage's output, for the stage-by-stage check of
``utils/serving_check.py``. The serving kernel takes C a multiple of 8, at
most 384 (its fused product-and-conv tile's shared memory).

Activations are NCHW tensors in ``torch.channels_last`` memory format, so
each pixel's C channels are contiguous (the NHWC order of the JAX kernel).
``p`` holds the block's parameters under the released checkpoints' names,
relative to the block (``norm1.body.weight``, ``attn.qkv.weight``, ...), in
PyTorch's own layouts.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from tpuir_torch.ops import _kernels
from tpuir_torch.utils.misc import bf16_rounded

_WEIGHTS = (
    "norm1.body.weight", "norm2.body.weight", "attn.temperature",
    "attn.qkv.weight", "attn.qkv_dwconv.weight", "attn.project_out.weight",
    "ffn.project_in.weight", "ffn.dwconv.weight", "ffn.project_out.weight",
)
_CONV_BIASES = (
    "attn.qkv.bias", "attn.qkv_dwconv.bias", "attn.project_out.bias",
    "ffn.project_in.bias", "ffn.dwconv.bias", "ffn.project_out.bias",
)
_MAX_HEAD_WIDTH = 128  # the Gram and softmax kernels' limit
_MAX_SERVING_C = 384  # csrc/fused_block.cu kMaxServingC
GRAM_CHUNK = 256  # pixels a Gram partial (csrc/fused_block.cu kGramChunk)


def _check(x: torch.Tensor, p: Mapping[str, torch.Tensor], heads: int,
           ln_bias: bool, serving: bool) -> int:
    """Validate the inputs; return the GDFN hidden width h."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_transformer_block: unsupported device {x.device}")
    want_dtype = torch.bfloat16 if serving else torch.float32
    if x.dtype != want_dtype:
        raise TypeError(f"fused_transformer_block: x must be {want_dtype} "
                        f"{'in serving' if serving else 'in parity'} mode, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"fused_transformer_block: x must be (B, C, H, W), got {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fused_transformer_block: x must be channels_last contiguous")
    biases = [k for k in _CONV_BIASES if k in p]
    if biases:
        raise ValueError(f"fused_transformer_block: conv biases are not supported: {biases}")
    names = _WEIGHTS + (("norm1.body.bias", "norm2.body.bias") if ln_bias else ())
    missing = [k for k in names if k not in p]
    if missing:
        raise KeyError(f"fused_transformer_block: missing parameters {missing}")
    B, C, H, W = x.shape
    if heads <= 0 or C % heads:
        raise ValueError(f"fused_transformer_block: C={C} not divisible by heads={heads}")
    hidden = p["ffn.project_out.weight"].shape[1]
    want = {
        "norm1.body.weight": (C,), "norm2.body.weight": (C,),
        "norm1.body.bias": (C,), "norm2.body.bias": (C,),
        "attn.temperature": (heads, 1, 1),
        "attn.qkv.weight": (3 * C, C, 1, 1),
        "attn.qkv_dwconv.weight": (3 * C, 1, 3, 3),
        "attn.project_out.weight": (C, C, 1, 1),
        "ffn.project_in.weight": (2 * hidden, C, 1, 1),
        "ffn.dwconv.weight": (2 * hidden, 1, 3, 3),
        "ffn.project_out.weight": (C, hidden, 1, 1),
    }
    for k in names:
        t = p[k]
        if tuple(t.shape) != want[k]:
            raise ValueError(f"fused_transformer_block: {k} has shape {tuple(t.shape)}, want {want[k]}")
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"fused_transformer_block: {k} must be contiguous float32 on {x.device}"
            )
    return hidden


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                ln_bias: bool, one_pass: bool = False) -> torch.Tensor:
    """Over the last axis; biased variance, eps 1e-5; BiasFree keeps x in the
    numerator. ``one_pass`` (the serving body) takes the variance as
    max(E[x^2] - mu^2, 0)."""
    mu = x.mean(-1, keepdim=True)
    if one_pass:
        var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    else:
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu if ln_bias else x) * torch.rsqrt(var + 1e-5) * w
    return y + b if ln_bias else y


def fused_transformer_block_plain(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                                  heads: int, ln_bias: bool) -> torch.Tensor:
    """The block in plain PyTorch, step for step as the kernel computes it.

    x: (B, C, H, W) float32; returns a channels_last tensor of the same
    shape. On a card, turn TF32 off first (cuBLAS and cuDNN) for a float32
    reference.
    """
    B, C, H, W = x.shape
    hc = C // heads
    hidden = p["ffn.project_out.weight"].shape[1]
    xh = x.permute(0, 2, 3, 1)  # (B, H, W, C)

    y = _layer_norm(xh, p["norm1.body.weight"], p.get("norm1.body.bias"), ln_bias)
    qkv = y @ p["attn.qkv.weight"].reshape(3 * C, C).t()
    qkv = F.conv2d(qkv.permute(0, 3, 1, 2), p["attn.qkv_dwconv.weight"],
                   padding=1, groups=3 * C)
    q, k, v = qkv.reshape(B, 3, heads, hc, H * W).unbind(1)  # (B, heads, hc, HW)
    qn = q.square().sum(-1).sqrt().clamp_min(1e-12)
    kn = k.square().sum(-1).sqrt().clamp_min(1e-12)
    g = q @ k.transpose(-1, -2)
    logits = g / qn[..., :, None] / kn[..., None, :] * p["attn.temperature"].reshape(1, heads, 1, 1)
    ao = (logits.softmax(-1) @ v).reshape(B, C, H, W).permute(0, 2, 3, 1)
    x2 = xh + ao @ p["attn.project_out.weight"].reshape(C, C).t()

    y2 = _layer_norm(x2, p["norm2.body.weight"], p.get("norm2.body.bias"), ln_bias)
    h1 = y2 @ p["ffn.project_in.weight"].reshape(2 * hidden, C).t()
    h1 = F.conv2d(h1.permute(0, 3, 1, 2), p["ffn.dwconv.weight"],
                  padding=1, groups=2 * hidden)
    a1, a2 = h1.chunk(2, dim=1)
    gate = (F.gelu(a1) * a2).permute(0, 2, 3, 1)
    out = x2 + gate @ p["ffn.project_out.weight"].reshape(C, hidden).t()
    return out.permute(0, 3, 1, 2)


def fused_transformer_block_serving_plain(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                                          heads: int, ln_bias: bool) -> torch.Tensor:
    """The serving body in plain PyTorch, step for step as the JAX kernel
    computes it with ``mm_bf16=True, fast_gelu=True``: every product's
    operands rounded to bf16 and summed in float32 (the 1x1 products, q . k^T,
    A . v); q's and k's norms, the depthwise convs, the softmax and both
    residuals in float32; the one-pass LayerNorm variance; the sigmoid GELU;
    attention applied to v before the projection.

    x: (B, C, H, W) bfloat16; returns a channels_last bfloat16 tensor of the
    same shape. The sums are taken in the weights' dtype: float32, or float64
    for a reference whose only roundings are the bf16 ones. On a card, turn
    TF32 off first (cuBLAS and cuDNN).
    """
    B, C, H, W = x.shape
    hc = C // heads
    hidden = p["ffn.project_out.weight"].shape[1]
    xh = x.permute(0, 2, 3, 1).to(p["attn.qkv.weight"].dtype)  # (B, H, W, C)

    y = _layer_norm(xh, p["norm1.body.weight"], p.get("norm1.body.bias"), ln_bias, True)
    qkv = bf16_rounded(y) @ bf16_rounded(p["attn.qkv.weight"].reshape(3 * C, C)).t()
    qkv = F.conv2d(qkv.permute(0, 3, 1, 2), p["attn.qkv_dwconv.weight"],
                   padding=1, groups=3 * C)
    q, k, v = qkv.reshape(B, 3, heads, hc, H * W).unbind(1)  # (B, heads, hc, HW)
    qn = q.square().sum(-1).sqrt().clamp_min(1e-12)
    kn = k.square().sum(-1).sqrt().clamp_min(1e-12)
    g = bf16_rounded(q) @ bf16_rounded(k).transpose(-1, -2)
    logits = g / qn[..., :, None] / kn[..., None, :] * p["attn.temperature"].reshape(1, heads, 1, 1)
    ao = bf16_rounded(logits.softmax(-1)) @ bf16_rounded(v)
    ao = ao.reshape(B, C, H, W).permute(0, 2, 3, 1)
    x2 = xh + bf16_rounded(ao) @ bf16_rounded(p["attn.project_out.weight"].reshape(C, C)).t()

    y2 = _layer_norm(x2, p["norm2.body.weight"], p.get("norm2.body.bias"), ln_bias, True)
    h1 = bf16_rounded(y2) @ bf16_rounded(p["ffn.project_in.weight"].reshape(2 * hidden, C)).t()
    h1 = F.conv2d(h1.permute(0, 3, 1, 2), p["ffn.dwconv.weight"],
                  padding=1, groups=2 * hidden)
    a1, a2 = h1.chunk(2, dim=1)
    gate = (a1 * torch.sigmoid(1.702 * a1) * a2).permute(0, 2, 3, 1)
    out = x2 + bf16_rounded(gate) @ bf16_rounded(p["ffn.project_out.weight"].reshape(C, hidden)).t()
    return out.to(torch.bfloat16).permute(0, 3, 1, 2)


def _scratch(x: torch.Tensor, heads: int, hidden: int, serving: bool,
             stages: bool = False) -> dict:
    """A body's scratch for x (B, C, H, W) on its card (csrc/fused_block.cu
    gives each buffer's use); ``stages``: with the serving body's float32
    stage buffer, for ``serving_stages``."""
    B, C, H, W = x.shape
    n = B * H * W
    lib = _kernels.library()

    def empty(numel, dt=torch.float32):
        return torch.empty(numel, device=x.device, dtype=dt)

    partials = empty(lib.tpuir_fused_block_partials_numel(B, H, W, C, heads))
    if not serving:
        hp = -(-hidden // 4) * 4  # the gate's row stride
        return {
            "buf1": empty(n * max(3 * C, 2 * hidden)), "buf2": empty(n * max(3 * C, hp)),
            "x2": empty(n * C), "w_out_p": empty(C * hp), "partials": partials,
            "attn": empty(B * C * (C // heads)),
            "mt": empty(B * C * C),  # the folded projection
            "stats": empty(2 * n),  # per-pixel LayerNorm (mean, rstd)
        }
    hp = -(-hidden // 8) * 8  # the gate's row stride
    bf = torch.bfloat16
    return {
        "w16": empty(4 * C * C + 2 * hidden * C + C * hp, bf),  # the weights rounded
        "qkv16": empty(n * 3 * C, bf), "act16": empty(n * max(C, hp), bf),  # ao, then the gate
        "x2": empty(n * C), "norms": empty(lib.tpuir_fused_block_bf16_norms_numel(B, H, W, C)),
        "partials": partials, "attn": empty(B * C * (C // heads)), "bd16": empty(B * C * C, bf),
        "stats": empty(2 * n),
        "f32": empty(n * max(3 * C, hp)) if stages else None,  # a stage's float32 values
    }


def _launch(x: torch.Tensor, out: torch.Tensor, p: Mapping[str, torch.Tensor], heads: int,
            ln_bias: bool, hidden: int, serving: bool, sc: dict, part: int = 0) -> None:
    """One launch of a body's kernels on x's card with scratch ``sc``;
    ``part`` as ``tpuir_fused_block_bf16`` takes it (serving only)."""
    B, C, H, W = x.shape
    lib = _kernels.library()
    ln1_b = p["norm1.body.bias"].data_ptr() if ln_bias else None
    ln2_b = p["norm2.body.bias"].data_ptr() if ln_bias else None
    weights = (
        p["norm1.body.weight"].data_ptr(), ln1_b,
        p["norm2.body.weight"].data_ptr(), ln2_b,
        p["attn.qkv.weight"].data_ptr(), p["attn.qkv_dwconv.weight"].data_ptr(),
        p["attn.temperature"].data_ptr(), p["attn.project_out.weight"].data_ptr(),
        p["ffn.project_in.weight"].data_ptr(), p["ffn.dwconv.weight"].data_ptr(),
        p["ffn.project_out.weight"].data_ptr(),
    )
    ptr = {k: (v.data_ptr() if v is not None else None) for k, v in sc.items()}
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        dims = (B, H, W, C, heads, hidden, int(ln_bias))
        if serving:
            err = lib.tpuir_fused_block_bf16(
                x.data_ptr(), out.data_ptr(), *weights, ptr["w16"], ptr["qkv16"], ptr["act16"],
                ptr["x2"], ptr["norms"], ptr["partials"], ptr["attn"], ptr["bd16"], ptr["stats"],
                ptr["f32"], *dims, part, stream)
        else:
            err = lib.tpuir_fused_block_f32(
                x.data_ptr(), out.data_ptr(), *weights, ptr["buf1"], ptr["buf2"], ptr["x2"],
                ptr["w_out_p"], ptr["partials"], ptr["attn"], ptr["mt"], ptr["stats"], *dims,
                stream)
    _kernels.check(err, "fused_transformer_block_serving" if serving else "fused_transformer_block")


def _check_cuda(x: torch.Tensor, p: Mapping[str, torch.Tensor], heads: int,
                serving: bool) -> None:
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in p.values())):
        raise RuntimeError("fused_transformer_block: the CUDA kernel has no backward")
    C = x.shape[1]
    if C // heads > _MAX_HEAD_WIDTH:
        raise ValueError(f"fused_transformer_block: head width {C // heads} > {_MAX_HEAD_WIDTH}")
    if serving and (C % 8 or C > _MAX_SERVING_C):
        raise ValueError(f"fused_transformer_block: the serving kernel takes C a multiple of 8, "
                         f"at most {_MAX_SERVING_C}, got {C}")


def fused_transformer_block(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                            heads: int, ln_bias: bool, serving: bool = False) -> torch.Tensor:
    """One TransformerBlock: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor. Forward only, bias-free convs, float32 weights;
    x float32 (parity) or, with ``serving``, bfloat16, and the output alike.

    The serving kernel rounds the float32 weights to bf16 copies in its
    scratch at each call (its first launch).
    """
    hidden = _check(x, p, heads, ln_bias, serving)
    if x.device.type == "cpu":
        plain = fused_transformer_block_serving_plain if serving else fused_transformer_block_plain
        return plain(x, p, heads, ln_bias)
    _check_cuda(x, p, heads, serving)
    out = torch.empty_like(x)
    _launch(x, out, p, heads, ln_bias, hidden, serving, _scratch(x, heads, hidden, serving))
    name = "fused_transformer_block_serving" if serving else "fused_transformer_block"
    _kernels.LAUNCHES[name] += 1
    return out


def serving_stages(x: torch.Tensor, p: Mapping[str, torch.Tensor], heads: int,
                   ln_bias: bool) -> dict:
    """The serving kernel's output and every stage's, from one run of its two
    parts on x's card, for a check (``utils/serving_check.py``); counts no
    launch. Returns tensors, channels last: ``stats1`` and ``stats2`` (LN1's
    and LN2's (mean, rstd) a pixel, (n, 2)), ``qkv32`` (B, H, W, 3C: q | k |
    v in float32, as the fused product-and-conv computes them) and ``qkv``
    (the same as stored, bf16), ``norm_parts`` (B, output tiles, 2C: q's and
    k's squared norms an 8 x 16 tile), ``gram`` (B, heads, hc, hc) and
    ``norms`` (B, heads, 2, hc), ``attn`` (B, heads, hc, hc), ``ao`` (bf16)
    and ``x2`` (B, H, W, C), ``gate32`` and ``gate`` (bf16) (B, H, W, hp: the
    gate's rows, zeros past h, hp = h rounded up to a multiple of 8), and
    ``out`` (bf16, as the wrapper returns it). On a CPU tensor, and only
    there, the same stages of the plain version with the kernel's sum orders
    where they decide a bit (``utils/serving_check.serving_stage_values``)."""
    hidden = _check(x, p, heads, ln_bias, True)
    if x.device.type == "cpu":
        from tpuir_torch.utils.serving_check import serving_stage_values

        return serving_stage_values(x, p, heads, ln_bias)
    _check_cuda(x, p, heads, True)
    B, C, H, W = x.shape
    hc, n, hp = C // heads, B * H * W, -(-hidden // 8) * 8
    sc = _scratch(x, heads, hidden, True, stages=True)
    out = torch.empty_like(x)
    rows = lambda t, w: t[: n * w].view(B, H, W, w).clone()  # noqa: E731
    _launch(x, out, p, heads, ln_bias, hidden, True, sc, part=1)
    nchunk = -(-H * W // GRAM_CHUNK)
    red = sc["partials"][B * heads * nchunk * hc * hc:][: B * heads * (hc * hc + 2 * hc)]
    red = red.view(B, heads, hc * hc + 2 * hc)
    got = {"stats1": sc["stats"].view(n, 2).clone(), "qkv32": rows(sc["f32"], 3 * C),
           "qkv": rows(sc["qkv16"], 3 * C), "norm_parts": sc["norms"].view(B, -1, 2 * C).clone(),
           "gram": red[..., : hc * hc].reshape(B, heads, hc, hc).clone(),
           "norms": red[..., hc * hc:].reshape(B, heads, 2, hc).clone(),
           "attn": sc["attn"].view(B, heads, hc, hc).clone(), "ao": rows(sc["act16"], C)}
    _launch(x, out, p, heads, ln_bias, hidden, True, sc, part=2)
    got.update(x2=rows(sc["x2"], C), stats2=sc["stats"].view(n, 2).clone(),
               gate32=rows(sc["f32"], hp), gate=rows(sc["act16"], hp), out=out)
    return got
