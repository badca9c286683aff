"""Tracing and profiling on the card: the counterpart of
``tpuir/utils/profiling.py``, on ``torch.profiler``.

Set ``TPUIR_TRACE_DIR`` to write a trace of any ``with maybe_trace("name"):``
region (the engine wraps its device pipeline) under ``<dir>/<name>``;
``trace_fn`` profiles one callable; ``kernel_times`` and ``op_device_ms``
read device time from its profile by kernel and by aten op. The helpers of
tpuir's module: ``check_nan_inf``, ``Timer`` and ``flop_count`` (PyTorch's
flop counter in place of XLA's cost analysis).

    python -m tpuir_torch.utils.profiling --engine <model>[,<model>...]
                                          [--precision parity[,serving]] [--out FILE]
    python tpuir_torch/utils/profiling.py [--tree DIR] --engine ... --wall [--requests 10]

serves one request a model through the zoo and the engine (seeded
checkpoints in the released formats, written to a temporary directory; the
requests of ``ENGINE_REQUESTS``) and splits it (``engine_split``): wall ms,
host ms of each step the engine takes (normalize, gather, AWGN, the
forward's host wall, window, blend, dtype restore; the window built cold
and from its cache), and from one profiled request the card's ms in
host-to-device and device-to-host copies and in the forward's kernels,
its busy ms and its idle share over the request. Each request is split
with ``max_in_flight`` 1 and 4. ``--wall`` instead times the request as a
user serves it (``request_times``: ``run_model_inference`` with its
defaults, the host wall of ``forward_patches`` read from outside it, and
the card's split of two profiled requests); it needs nothing newer than
the zoo and the engine's entry point, so ``--tree`` (another checkout's
``tpuir_torch``; run this file as a script) times an older tree the same
way, one tree a process.

    python -m tpuir_torch.utils.profiling [--model mair|mairunet|restormer|dncnn|rednet|
                                                   deblurgan-mobilenet|deblurgan-inception]
                                          [--batches 1,2,3,4,8] [--nss stripe|fused|0]
                                          [--precision parity|serving] [--layouts]

profiles one forward of MaIR-CDN@128 (``--model mair``, the default),
MaIRUNet@384 (``--model mairunet``), Restormer@256 (``--model
restormer``, the released color-denoising network, BiasFree), or one of
the plain-conv families at its released patch: DnCNN@256 (gray sigma=25,
17 layers), REDNet@128, DeblurGANv2 MobileNet@2048 and Inception@768
(each patch padded by the engine's always-pad to 2080 and 800), at each
batch size on the card: full released width and depth, weights drawn from
a seed, every mixer through its kernels as the zoo builds it on the
``--nss`` route (``stripe``, the default: K6, K2 and K7; ``fused``: K5;
``0``: K3 everywhere; K3 on levels the others do not take), every
Restormer block through K1, TF32 off as in the engine (under
``--precision serving``, TF32 left at PyTorch's defaults, as the engine
serves it: Restormer on K1's serving body and bf16 convs, MaIR-CDN and
MaIRUNet on their route's serving bodies, DnCNN and REDNet on a bf16
input chunk, DeblurGANv2 in float32). Per batch it prints
the forward's milliseconds (CUDA events), its device time by stage (for
Restormer, K1's launches by kernel: the LayerNorm statistics, its 1x1
products on the GEMM core, the depthwise convs (in serving fused with the
products that feed them), the Gram pass, its sum, the softmax and the
fold), its ten longest kernels, and the time of
each full conv of the model and of each depthwise conv shape it runs
(cuDNN; the mixers' dwconv off the stripe route) at the shape the forward
gives it, called once on the batch and once per image (for the plain-conv
families each distinct conv once: its first name and how many of the
forward's convs share its shape). The last line is the same as one JSON
object (REDNet's deconvs run as functional convs and are not among them).
``--layouts`` (the plain-conv families) times the forward instead over the
input's layout, cuDNN's choice of algorithms (its heuristic, its timed
search, none) and one image a call (``layout_times``).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

# Kernel-name fragments of the mixer kernels, by stage. K6's in_proj
# (SplitXZ) and K7's out_proj (tc::StoreOut, which kernel names spell
# tc::Store<float, float>; in serving on the bf16-operand kernel) run on the
# tensor-core core, told apart by their epilogue types; K6's serving body is
# one kernel (prologue_bf16_kernel) after its weight's bf16 copy
# (round_rows_bf16_kernel, K7 serving's too); the x_proj of K2, K3 and K5 on the SIMT
# GEMM (simt_gemm_nt_kernel); the scan passes' path type tells K2's
# (ImageIdsPath) from K5's (StripePath). K3 and the serving bodies of K2 and
# K5 pack their x_proj weight and walk each sequence (K2 and K5 serving: each
# chunk, their carries and sums named WalkChunks) with a channel's states
# across lanes.
MIXER_STAGES = (
    ("K6 in_proj GEMM", ("SplitXZ",)),
    ("K6 dwconv + SiLU", ("dwconv3x3_bias_silu",)),
    ("K6 serving: in_proj + dwconv + SiLU", ("prologue_bf16_kernel",)),
    ("K6, K7 serving: bf16 weight copies", ("round_rows_bf16_kernel",)),
    ("K2 scan passes", ("ImageIdsPath",)),
    ("K2 serving walk", ("nss_walk_kernel",)),
    ("K5 scan passes", ("StripePath",)),
    ("K5 serving walk", ("nss_stripe_walk_kernel",)),
    ("K2, K5 serving walks' carries and sums", ("WalkChunks",)),
    ("K3 one-pass scan", ("seq_scan_kernel",)),
    ("K3, K2, K5 serving x_proj weight packing", ("pack_xproj_kernel",)),
    ("x_proj GEMMs (K2, K3, K5)", ("simt_gemm_nt_kernel",)),
    ("K7 combine + norm + gate", ("combine_norm_gate",)),
    ("K7 out_proj GEMM", ("tc::Store<float, float>",)),
    ("K7 out_proj weight padding", ("pad_weight_kernel",)),
)
# K1's launches (csrc/fused_block.cu), by kernel-name fragment: the products
# on the GEMM core are told apart by their store type BlockOut<G, out, resid>
# (the parity body's on gemm_kernel, the serving body's apply, projection and
# project_out on gemm_bf16_kernel), the parity body's depthwise convs by their
# gate (0 none, 1 exact GELU), the serving body's fused products and convs by
# their A (bf16 x: qkv; float x2: project_in and the gate).
BLOCK_STAGES = (
    ("K1 LayerNorm statistics", ("ln_stats_kernel",)),
    ("K1 qkv product (LN1 prologue)", ("BlockOut<1,",)),
    ("K1 projection product (+ residual)", ("BlockOut<2,",)),
    ("K1 project_in product (LN2 prologue)", ("BlockOut<3,",)),
    ("K1 project_out product (+ residual)", ("BlockOut<4,",)),
    ("K1 serving: attention apply product", ("BlockOut<5,",)),
    ("K1 qkv depthwise conv", ("dwconv3x3_kernel<0>",)),
    ("K1 gated depthwise conv", ("dwconv3x3_kernel<1>",)),
    ("K1 serving: qkv product + depthwise conv", ("conv_product_kernel<__nv_bfloat16, false>",)),
    ("K1 serving: project_in product + gated conv", ("conv_product_kernel<float, true>",)),
    ("K1 Gram partials", ("gram_partial_kernel", "gram_mma_kernel")),
    ("K1 Gram sum", ("gram_reduce_kernel", "gram_norms_reduce_kernel")),
    ("K1 softmax", ("attn_softmax_kernel",)),
    ("K1 fold into the projection", ("fold_proj_kernel",)),
    ("K1 serving: weights rounded, blockdiag(A)", ("round_weights_kernel", "block_diag_kernel")),
)
# Library ops by the aten op that launched them (their self device time).
LIBRARY_STAGES = (
    ("convs (cuDNN)", "aten::cudnn_convolution"),
    ("Linear (MLP, cuBLAS)", "aten::addmm"),
    ("LayerNorm", "aten::native_layer_norm"),
)
# and the plain-conv families' own: convs off cuDNN (FPN-Inception in true
# float32), DeblurGANv2's norms
PLAIN_STAGES = (
    ("convs off cuDNN (im2col, cuBLAS)", "aten::_slow_conv2d_forward"),
    ("TrainNorm moments", "aten::var_mean"),
)
TILES = {"mair": 128, "mairunet": 384, "restormer": 256, "dncnn": 256, "rednet": 128,
         "deblurgan-mobilenet": 2048, "deblurgan-inception": 768}
# The plain-conv families: (input channels, the engine's always-pad block
# or 0, the serving chunk's dtype).
PLAIN_CONV = {"dncnn": (1, 0, torch.bfloat16), "rednet": (1, 0, torch.bfloat16),
              "deblurgan-mobilenet": (3, 32, torch.float32),
              "deblurgan-inception": (3, 32, torch.float32)}
RESTORMER_CONFIG = dict(layer_norm_bias=False)  # released color denoising (BiasFree)


def _leaves(tree, path=""):
    """(path, leaf) pairs of nested dicts (keys in sorted order, as JAX
    flattens them), lists and tuples; None is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def check_nan_inf(tree, name: str = "tensor") -> bool:
    """Debug guard (tpuir's ``check_nan_inf``): print one line for each leaf
    of ``tree`` (tensors or arrays in nested dicts, lists and tuples) that
    holds NaN or Inf, with the counts; return True if any does."""
    bad = False
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            leaf = (leaf.float() if leaf.is_floating_point() else leaf).cpu().numpy()
        arr = np.asarray(leaf)
        if not np.isfinite(arr).all():
            print(f"[check_nan_inf] {name}{path}: {int(np.isnan(arr).sum())} NaN, "
                  f"{int(np.isinf(arr).sum())} Inf")
            bad = True
    return bad


class Timer:
    """Host-clock timer with the engine's ms convention: ``.ms`` on exit."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = (time.perf_counter() - self.t0) * 1000.0


def flop_count(fn: Callable, *args) -> dict:
    """{"flops": the floating-point operations of fn(*args)}, from
    ``torch.utils.flop_counter.FlopCounterMode``: the products and
    convolutions that PyTorch's own ops run (2 a multiply-add), the
    counterpart of ``xla_cost``'s ``flops``. Kernels called through ctypes
    are invisible to it: count a model on CPU tensors, where every kernel
    wrapper runs its plain version, or with plain blocks on meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": int(counter.get_total_flops())}


def _profile(on_trace_ready=None):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, on_trace_ready=on_trace_ready)


@contextlib.contextmanager
def maybe_trace(name: str, trace_dir: Optional[str] = None):
    """Profile the region into a TensorBoard trace under ``<trace_dir>/<name>``
    (``trace_dir`` defaults to ``$TPUIR_TRACE_DIR``); do nothing when neither
    is set."""
    trace_dir = trace_dir or os.environ.get("TPUIR_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import tensorboard_trace_handler

    with _profile(tensorboard_trace_handler(os.path.join(trace_dir, name))):
        yield


def trace_fn(fn: Callable, *args, **kw):
    """Run fn twice (warm-up, then profiled); return (result, profile)."""
    fn(*args, **kw)
    with _profile() as prof:
        out = fn(*args, **kw)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return out, prof


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def kernel_times(prof) -> Dict[str, Tuple[float, int]]:
    """{kernel name: (device ms in all, launches)} over a profile's kernels."""
    out = {}
    for evt in prof.key_averages():
        if str(evt.device_type).endswith("CUDA") and _device_us(evt) > 0:
            out[evt.key] = (_device_us(evt) / 1e3, evt.count)
    return out


def op_device_ms(prof, op: str) -> float:
    """Device ms that the kernels launched by aten op ``op`` took."""
    return sum(_device_us(e) for e in prof.key_averages() if e.key == op) / 1e3


def cuda_ms(fn: Callable, iters: int = 3) -> float:
    """Mean milliseconds of fn() on the card, from CUDA events, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _seeded_net(model: str, seed: int, dev: torch.device, nss: str = "stripe",
                serving: bool = False) -> torch.nn.Module:
    from tpuir_torch import zoo
    from tpuir_torch.models import dncnn, mair, mair_unet, rednet, restormer
    from tpuir_torch.models.deblurgan import fpn_inception, fpn_mobilenet

    if model == "dncnn":
        net = dncnn.DnCNN(1, 1, 64, 17)
        net.load_state_dict(dncnn.init_state_dict(1, 17, seed=seed))
    elif model == "rednet":
        net = rednet.REDNet()
        net.load_state_dict(rednet.init_state_dict(seed=seed))
    elif model.startswith("deblurgan"):
        mod = fpn_mobilenet if model.endswith("mobilenet") else fpn_inception
        net = mod.FPNMobileNet() if model.endswith("mobilenet") else mod.FPNInception()
        net.load_state_dict(mod.init_state_dict(seed=seed))
    elif model == "restormer":
        net = restormer.Restormer(**RESTORMER_CONFIG, fused=True, serving=serving)
        net.load_state_dict(restormer.init_state_dict(RESTORMER_CONFIG, seed=seed))
    elif model == "mair":
        net = mair.MaIR(**zoo.MAIR_CDN_CONFIG, fused=True, nss=nss, serving=serving)
        net.load_state_dict(mair.init_state_dict(zoo.MAIR_CDN_CONFIG, seed=seed))
    else:
        net = mair_unet.MaIRUNet(**zoo.MAIR_UNET_CONFIG, fused=True, nss=nss, serving=serving)
        net.load_state_dict(mair_unet.init_state_dict(zoo.MAIR_UNET_CONFIG, seed=seed))
    return net.to(dev).eval().requires_grad_(False)


def conv_times(net: torch.nn.Module, x: torch.Tensor, gen: torch.Generator,
               dtype: torch.dtype = torch.float32, distinct: bool = False) -> dict:
    """{conv name: (C, H, W, ms on the batch, ms once per image)} for each
    full conv of net that a forward of x runs and for the first depthwise
    conv of each (C, H, W) it runs, at that (C, H, W), on random
    channels_last inputs of x's batch, in ``dtype`` (bf16: with a bf16 copy
    of the weight, as Restormer's serving forward runs them). net's forward
    must call its convs as modules (a parity net). With ``distinct`` each
    conv of a new input shape and geometry only, under its first name with
    ``" xN"`` appended, N the forward's convs of that shape and geometry."""
    shapes, hooks, depthwise, seen = {}, [], set(), {}

    def record(name, mod, args):
        shape = tuple(args[0].shape[1:])
        if distinct:
            key = (shape, tuple(mod.weight.shape), mod.stride, mod.padding, mod.groups)
            if key in seen:
                seen[key][1] += 1
                return
            seen[key] = [name, 1]
        elif mod.groups > 1:
            if shape in depthwise:
                return
            depthwise.add(shape)
        shapes.setdefault(name, (mod, shape))  # returns None: args unchanged

    for name, mod in net.named_modules():
        if isinstance(mod, torch.nn.Conv2d):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, a, _n=name: record(_n, m, a)))
    net(x)
    for h in hooks:
        h.remove()
    out = {}
    for name, (conv, (c, hh, ww)) in shapes.items():
        inp = torch.rand(x.shape[0], hh, ww, c, device=x.device, generator=gen).permute(0, 3, 1, 2)
        if dtype == torch.float32:
            run = conv
        else:
            inp, weight = inp.to(dtype), conv.weight.to(dtype)
            run = lambda t, _c=conv, _w=weight: torch.nn.functional.conv2d(  # noqa: E731
                t, _w, None, _c.stride, _c.padding, _c.dilation, _c.groups)
        n = next((v[1] for v in seen.values() if v[0] == name), 0)
        out[f"{name} x{n}" if distinct else name] = (
            c, hh, ww, cuda_ms(lambda: run(inp)),
            cuda_ms(lambda: [run(inp[i:i + 1]) for i in range(inp.shape[0])]))
        del inp
    return out


def profile_model(model: str = "mair", batches=(1, 2, 3, 4, 8), seed: int = 0,
                  nss: str = "stripe", precision: str = "parity") -> dict:
    """The forward breakdown described in the module docstring."""
    from tpuir_torch.core.engine import true_float32

    dev = torch.device("cuda")
    tile = TILES[model]
    net = _seeded_net(model, seed, dev, nss, serving=precision == "serving")
    # the convs' shapes come from a parity net's forward (Restormer's serving
    # forward calls them as functions, in bf16; MaIR's runs them as they are)
    bf16_convs = precision == "serving" and model == "restormer"
    parity_net = _seeded_net(model, seed, dev, nss) if bf16_convs else net
    gen = torch.Generator(device=dev).manual_seed(seed)
    res = {"card": torch.cuda.get_device_name(0), "model": model, "nss": nss, "tile": tile,
           "precision": precision, "batches": {}}
    pin = true_float32() if precision == "parity" else contextlib.nullcontext()
    chans, block, serving_dtype = PLAIN_CONV.get(model, (3, 0, torch.float32))
    side = tile + block  # the always-pad adds a block
    with torch.inference_mode(), pin:
        for b in batches:
            x = torch.rand(b, chans, side, side, device=dev, generator=gen)
            if block:
                x = 2 * x - 1  # DeblurGANv2's [-1, 1] input
            if model in PLAIN_CONV:  # channels_last, as the engine hands them over
                x = x.to(memory_format=torch.channels_last,
                         dtype=serving_dtype if precision == "serving" else torch.float32)
            fwd_ms = cuda_ms(lambda: net(x), iters=2)
            _, prof = trace_fn(net, x)
            kernels = kernel_times(prof)
            stages = {}
            for name, frags in {"restormer": BLOCK_STAGES, "mair": MIXER_STAGES,
                                "mairunet": MIXER_STAGES}.get(model, ()):
                stages[name] = sum(ms for k, (ms, _) in kernels.items()
                                   if any(f in k for f in frags))
            for name, op in LIBRARY_STAGES + (PLAIN_STAGES if model in PLAIN_CONV else ()):
                stages[name] = op_device_ms(prof, op)
            total = sum(ms for ms, _ in kernels.values())
            stages["other"] = total - sum(stages.values())
            top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
            res["batches"][b] = {
                "forward_ms": fwd_ms, "device_ms": total, "stages_ms": stages,
                "top_kernels": [[k[:100], ms, n] for k, (ms, n) in top],
                "convs": conv_times(parity_net, x.float(), gen,
                                    torch.bfloat16 if bf16_convs else torch.float32,
                                    distinct=model in PLAIN_CONV),
            }
            del x, prof
    return res


@contextlib.contextmanager
def _cudnn(**settings):
    """Set attributes of ``torch.backends.cudnn``; restore them on exit."""
    saved = {k: getattr(torch.backends.cudnn, k) for k in settings}
    for k, v in settings.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(torch.backends.cudnn, k, v)


# layout_times' variants: (name, input layout, cuDNN settings, one image a call)
LAYOUT_VARIANTS = (
    ("channels_last, heuristic", torch.channels_last, {}, False),
    ("channels_last, benchmark", torch.channels_last, dict(benchmark=True), False),
    ("nchw, heuristic", torch.contiguous_format, {}, False),
    ("nchw, benchmark", torch.contiguous_format, dict(benchmark=True), False),
    ("channels_last, benchmark of every algorithm", torch.channels_last,
     dict(benchmark=True, benchmark_limit=0), False),
    ("channels_last, cuDNN off (PyTorch's own convs)", torch.channels_last,
     dict(enabled=False), False),
    ("channels_last, heuristic, one image a call", torch.channels_last, {}, True),
)


def layout_times(model: str, batches=(1, 2, 8), seed: int = 0,
                 precision: str = "parity") -> dict:
    """For a plain-conv family: {variant: {batch: (forward ms, max|out -
    the first variant's out|)}} of its layers (``_forward``: without the
    model's own choice of how to run them) over ``LAYOUT_VARIANTS`` (the
    input ``channels_last``, as the engine hands a chunk over, or
    contiguous NCHW; cuDNN's heuristic choice of algorithms, its timed
    search (made in the warm-up) of the first 10 or of every algorithm, or
    no cuDNN; the batch whole or one image a call), and of the model's own
    forward, in the engine's precision."""
    from tpuir_torch.core.engine import true_float32

    dev = torch.device("cuda")
    net = _seeded_net(model, seed, dev)
    layers = getattr(net, "_forward", net)
    chans, block, serving_dtype = PLAIN_CONV[model]
    side = TILES[model] + block
    dtype = serving_dtype if precision == "serving" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(seed)
    pin = true_float32() if precision == "parity" else contextlib.nullcontext()
    res = {}
    with torch.inference_mode(), pin:
        for b in batches:
            x = torch.rand(b, chans, side, side, device=dev, generator=gen)
            x = (2 * x - 1 if block else x).to(dtype)
            first = None
            variants = LAYOUT_VARIANTS + (
                ("the model's forward (its own choice)", torch.channels_last, {}, None),)
            for name, fmt, settings, per_image in variants:
                xin = x.to(memory_format=fmt)
                if per_image is None:
                    run = lambda: net(xin)  # noqa: E731
                elif per_image:
                    run = lambda: torch.cat([layers(xin[i:i + 1]) for i in range(b)])  # noqa: E731
                else:
                    run = lambda: layers(xin)  # noqa: E731
                with _cudnn(**settings):
                    ms = cuda_ms(run)
                    out = run().float()
                first = out if first is None else first
                res.setdefault(name, {})[b] = (ms, float((out - first).abs().max()))
                del out
            del x, first
    return res

# --engine: a request a model, served through the zoo and the engine, as
# chip_smoke.py serves them: (zoo route (task, subtask, model, gray, sigma),
# request (H, W), host AWGN sigma or None: the input served as it is).
ENGINE_REQUESTS = {
    "restormer": (("denoising", "gaussian", "Restormer", False, 25), (512, 512), 25),
    "mair": (("denoising", "gaussian", "MaIR", False, 25), (256, 256), 25),
    "mairunet": (("denoising", "real", "MaIR", False, None), (720, 1280), None),
    "dncnn": (("denoising", "gaussian", "DnCNN", True, 25), (481, 321), 25),
    "rednet": (("denoising", "gaussian", "REDNet", True, 50), (481, 321), 50),
    "deblurgan-mobilenet": (("deblurring", "motion", "DeblurGANv2 (MobileNet)", False, None),
                            (720, 1280), None),
    "deblurgan-inception": (("deblurring", "motion", "DeblurGANv2 (Inception)", False, None),
                            (720, 1280), None),
}
HOST_STEPS = ("normalize", "gather", "awgn", "forward_patches", "window", "blend", "restore")


# each model's output head (its state-dict prefix), which ``head_scale`` scales
HEADS = {"restormer": "output.", "mair": "conv_last.", "mairunet": "output.",
         "dncnn": "model.32.", "rednet": "deconv15.", "deblurgan-mobilenet": "final.",
         "deblurgan-inception": "final."}


def write_seeded_checkpoint(model: str, wdir: str, seed: int = 0,
                            head_scale: Optional[float] = None) -> None:
    """``model``'s checkpoint of ``ENGINE_REQUESTS`` under ``wdir`` in its
    released format, with seeded weights at full width and depth; with
    ``head_scale`` the output head (``HEADS``) scaled by it, which makes a
    seeded net near-identity as trained restoration nets are (tpuir's
    ``scripts/validate_serving.py:_scale_head``)."""
    from tpuir_torch.models import dncnn, mair, mair_unet, rednet, restormer
    from tpuir_torch.models.deblurgan import fpn_inception, fpn_mobilenet

    if model == "restormer":
        sd, rel, key = (restormer.init_state_dict(RESTORMER_CONFIG, seed=seed),
                        "Restormer/denoising/gaussian_color_denoising_sigma25.pth", "params")
    elif model == "mair":
        sd, rel, key = mair.init_state_dict(seed=seed), "MaIR/denoising/MaIR_CDN_s25.pth", "params"
    elif model == "mairunet":
        sd, rel, key = (mair_unet.init_state_dict(seed=seed), "MaIR/denoising/MaIR_RealDN.pth",
                        "params")
    elif model == "dncnn":
        sd, rel, key = dncnn.init_state_dict(1, 17, seed=seed), "DnCNN/dncnn_25.pth", None
    elif model == "rednet":
        sd, rel, key = rednet.init_state_dict(seed=seed), "REDNet/50.pt", None
    else:
        variant = model.split("-")[1]
        mod = fpn_mobilenet if variant == "mobilenet" else fpn_inception
        sd, rel, key = mod.init_state_dict(seed=seed), f"DeblurGANv2/fpn_{variant}.h5", "model"
        sd = {f"module.{k}": v for k, v in sd.items()}
    if head_scale is not None:
        head = ("module." if key == "model" else "") + HEADS[model]
        sd = {k: v * head_scale if k.startswith(head) else v for k, v in sd.items()}
    path = os.path.join(wdir, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({key: sd} if key else sd, path)


def seeded_request(model: str, seed: int = 0) -> np.ndarray:
    """``model``'s request of ``ENGINE_REQUESTS``: a seeded uint8 image (one
    channel where the route is gray)."""
    (_, _, _, gray, _), (h, w), _ = ENGINE_REQUESTS[model]
    return (np.random.RandomState(seed).rand(h, w, 1 if gray else 3) * 255).astype(np.uint8)


def engine_split(model, img: np.ndarray, sigma=None, max_in_flight: int = 4,
                 cold_window: bool = False) -> Tuple[np.ndarray, dict]:
    """Serve ``img`` as ``core.engine.run_model_inference`` serves it, by
    the same calls, each timed with ``Timer``: returns (the output, {step:
    host ms} over ``HOST_STEPS`` and "wall"). ``cold_window`` empties the
    window's cache first."""
    from tpuir_torch.core import engine, native, tiling
    from tpuir_torch.core.degrade import add_noise_batched
    from tpuir_torch.core.image_io import restore_dtype

    if cold_window:
        engine.window_crop.cache_clear()
    ms = {}
    with Timer() as wall:
        with Timer() as t:
            x = np.ascontiguousarray(model.normalize(img))
        ms["normalize"] = t.ms
        h, w = x.shape[:2]
        out_ch = min(3, x.shape[2])
        ps, hs, ws = tiling.tile_indices(h, w, model.patch_size, model.patch_overlap)
        ph, pw = min(ps, h), min(ps, w)
        coords = [(hi, wi) for hi in hs for wi in ws]
        with Timer() as t:
            patches = native.extract_patches(x, coords, ph, pw)
        ms["gather"] = t.ms
        with Timer() as t:
            if sigma is not None:
                patches = add_noise_batched(patches, sigma)
        ms["awgn"] = t.ms
        with Timer() as t:
            preds = model.forward_patches(patches, None, max_in_flight)
        ms["forward_patches"] = t.ms
        with Timer() as t:
            window = engine.window_crop(ps, ph, pw, out_ch)
        ms["window"] = t.ms
        with Timer() as t:
            out = native.blend_stitch(preds[:, :, :, :out_ch], coords, window, h, w)
        ms["blend"] = t.ms
        with Timer() as t:
            out = restore_dtype(out, img)
        ms["restore"] = t.ms
    ms["wall"] = wall.ms
    return out, ms


def device_split(trace_events, window=None) -> dict:
    """From a chrome trace's events (``torch.profiler``'s export): the
    card's ms in host-to-device and device-to-host copies and in kernels
    (memsets among them), its busy ms (the union of those intervals) and
    its idle share over ``window`` (start, end) in the trace's us, by
    default the span of the "engine request" annotations."""
    gpu = [e for e in trace_events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if window is None:
        req = [e for e in trace_events if e.get("ph") == "X" and e.get("name") == "engine request"
               and e.get("cat") == "user_annotation"] or [
            e for e in trace_events if e.get("ph") == "X" and "dur" in e]
        if not req:
            return {}
        window = (min(e["ts"] for e in req), max(e["ts"] + e["dur"] for e in req))
    lo, hi = window
    res = {"h2d_ms": 0.0, "d2h_ms": 0.0, "kernels_ms": 0.0}
    spans = []
    for e in gpu:
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b <= a:
            continue
        name = e["name"]
        key = ("h2d_ms" if "HtoD" in name else "d2h_ms" if "DtoH" in name
               else "kernels_ms" if e["cat"] != "gpu_memcpy" else None)
        if key:
            res[key] += (b - a) / 1e3
        spans.append((a, b))
    busy, end = 0.0, lo
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    res["busy_ms"] = busy / 1e3
    res["window_ms"] = (hi - lo) / 1e3
    res["idle_share"] = 1.0 - busy / (hi - lo) if hi > lo else None
    return res


def profiled_requests(serve: Callable[[], None], requests: int = 2) -> dict:
    """``device_split`` over ``requests`` calls of ``serve`` back to back,
    each in an "engine request" annotation, under ``torch.profiler``."""
    from torch.profiler import record_function

    torch.cuda.synchronize()
    with _profile() as prof:
        for _ in range(requests):
            with record_function("engine request"):
                serve()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="tpuir_torch_trace_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    res = device_split(events)
    for k in ("h2d_ms", "d2h_ms", "kernels_ms", "busy_ms", "window_ms"):
        if k in res:
            res[k] /= requests
    return res


def seeded_model(model_name: str, precision: str, seed: int = 0, device="cuda"):
    """``model_name``'s zoo model of ``ENGINE_REQUESTS`` on ``device``, from
    a seeded checkpoint in its released format (``write_seeded_checkpoint``)."""
    from tpuir_torch import zoo

    (task, subtask, name, gray, sigma), _, _ = ENGINE_REQUESTS[model_name]
    with tempfile.TemporaryDirectory(prefix="tpuir_torch_engine_") as wdir:
        write_seeded_checkpoint(model_name, wdir, seed)
        return zoo.get_model_instance(task, subtask, name, gray=gray, sigma=sigma,
                                      weights_dir=wdir, precision=precision, device=device)


def _package_tree() -> str:
    """The checkout whose ``tpuir_torch`` this process imported."""
    from tpuir_torch.core import engine

    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(engine.__file__))))


def engine_report(model_name: str, precision: str, rounds: int = 3, seed: int = 0,
                  device="cuda") -> dict:
    """The split of ``model_name``'s request (see the module docstring):
    {variant: {"host_ms": {step: median ms}, "window_cold_ms", "device":
    device_split of two profiled requests, "mpix_s"}} with variants
    "max_in_flight=1" and "max_in_flight=4", and the outputs' agreement."""
    from tpuir_torch.core.tiling import tile_indices

    _, (h, w), noise = ENGINE_REQUESTS[model_name]
    model = seeded_model(model_name, precision, seed, device)
    img = seeded_request(model_name, seed)
    engine_split(model, img, noise, 1)  # warm-up: cuDNN, allocators
    torch.cuda.synchronize()
    _, hs, ws = tile_indices(h, w, model.patch_size, model.patch_overlap)
    res = {"model": model_name, "request": [h, w], "precision": precision, "tree": _package_tree(),
           "tiles": len(hs) * len(ws), "variants": {}}
    outs = {}
    for mif in (1, 4):
        label = f"max_in_flight={mif}"
        splits = []
        for r in range(rounds):
            out, ms = engine_split(model, img, noise, mif, cold_window=r == 0)
            splits.append(ms)
            outs.setdefault(label, out)
            if not np.array_equal(out, outs[label]):
                raise RuntimeError(f"{model_name} {precision} {label}: not repeatable")
        host = {k: float(np.median([s[k] for s in splits])) for k in HOST_STEPS + ("wall",)}
        dev = profiled_requests(lambda: engine_split(model, img, noise, mif))
        res["variants"][label] = {"host_ms": host, "window_cold_ms": splits[0]["window"],
                                  "device": dev, "mpix_s": h * w / 1e3 / host["wall"]}
    first = next(iter(outs.values()))
    res["bit_equal_across_variants"] = all(np.array_equal(o, first) for o in outs.values())
    del model
    torch.cuda.empty_cache()
    return res


def request_times(model_name: str, precision: str, requests: int = 10, seed: int = 0,
                  device="cuda") -> dict:
    """``model_name``'s request served ``requests`` times, after two
    warm-ups, as a user serves it: ``core.engine.run_model_inference`` with
    its defaults. {"wall_ms": [...], "forward_patches_ms": [...] (its host
    wall, timed by wrapping the model's ``forward_patches``), "mpix_s" (of
    the median wall), "device": device_split of two profiled requests}.
    Uses only the zoo and the entry point, so any tree of the port can be
    timed by it."""
    from tpuir_torch.core.engine import run_model_inference

    _, (h, w), noise = ENGINE_REQUESTS[model_name]
    model = seeded_model(model_name, precision, seed, device)
    img = seeded_request(model_name, seed)
    inner, fp_ms = model.forward_patches, []

    @functools.wraps(inner)
    def timed(*args, **kw):
        with Timer() as t:
            out = inner(*args, **kw)
        fp_ms.append(t.ms)
        return out

    model.forward_patches = timed
    serve = lambda: run_model_inference(model, img, need_degradation=noise is not None,  # noqa: E731
                                        noise_level=noise)
    for _ in range(2):
        serve()
    torch.cuda.synchronize()
    del fp_ms[:]
    wall = []
    for _ in range(requests):
        with Timer() as t:
            serve()
        wall.append(t.ms)
    res = {"model": model_name, "request": [h, w], "precision": precision, "tree": _package_tree(),
           "wall_ms": wall, "forward_patches_ms": list(fp_ms),
           "mpix_s": h * w / 1e3 / float(np.median(wall)), "device": profiled_requests(serve)}
    del model
    torch.cuda.empty_cache()
    return res


def card_line(d: dict) -> str:
    """``device_split``'s figures on one line."""
    if not d:
        return "card: not measured"
    return (f"card: h2d {d['h2d_ms']:.3f} d2h {d['d2h_ms']:.3f} kernels {d['kernels_ms']:.3f} "
            f"busy {d['busy_ms']:.3f} of {d['window_ms']:.3f} ms, idle "
            f"{100 * d['idle_share']:.1f}%")


def print_engine_report(res: dict) -> None:
    head = (f"engine {res['model']} {res['request'][0]}x{res['request'][1]} "
            f"{res['precision']} ({res['tiles']} tiles)")
    for label, v in res["variants"].items():
        print(f"{head} {label}: wall {v['host_ms']['wall']:.2f} ms {v['mpix_s']:.3f} Mpix/s; "
              "host " + " ".join(f"{k} {v['host_ms'][k]:.2f}" for k in HOST_STEPS)
              + f" (window cold {v['window_cold_ms']:.2f}); {card_line(v['device'])}",
              flush=True)
    print(f"{head}: outputs bit-equal across variants: {res['bit_equal_across_variants']}",
          flush=True)


def print_request_times(res: dict) -> None:
    wall, fp = res["wall_ms"], res["forward_patches_ms"]
    print(f"request {res['model']} {res['request'][0]}x{res['request'][1]} {res['precision']} "
          f"({res['tree']}): wall median {np.median(wall):.2f} ms {res['mpix_s']:.3f} Mpix/s "
          f"(min {min(wall):.2f}, max {max(wall):.2f} of {len(wall)}); forward_patches median "
          f"{np.median(fp):.2f} ms; host outside it {np.median(np.subtract(wall, fp)):.2f} ms; "
          f"{card_line(res['device'])}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(TILES), default="mair")
    ap.add_argument("--batches", default="1,2,3,4,8")
    ap.add_argument("--nss", choices=("stripe", "fused", "0"), default="stripe")
    ap.add_argument("--precision", default="parity",
                    help="parity or serving (--engine: a comma-separated list of them)")
    ap.add_argument("--layouts", action="store_true",
                    help="a plain-conv family's forward ms by input layout and cuDNN's "
                         "algorithm choice (layout_times) instead of the breakdown")
    ap.add_argument("--engine", help="comma-separated models of ENGINE_REQUESTS: split "
                                     "each one's request through the zoo and the engine")
    ap.add_argument("--tree", help="import tpuir_torch from this checkout (run as a script)")
    ap.add_argument("--out", help="--engine: also write the reports to this JSON file")
    ap.add_argument("--wall", action="store_true",
                    help="--engine: time each request as served (request_times), no split")
    ap.add_argument("--requests", type=int, default=10, help="--wall: timed requests")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiling: no CUDA device")
        return 1
    if args.engine:
        precisions = args.precision.split(",")
        models = args.engine.split(",")
        bad = [p for p in precisions if p not in ("parity", "serving")] + [
            m for m in models if m not in ENGINE_REQUESTS]
        if bad:
            ap.error(f"unknown --precision or --engine values: {bad}")
        print(torch.cuda.get_device_name(0), flush=True)
        reports = []
        for m in models:
            for p in precisions:
                if args.wall:
                    reports.append(request_times(m, p, args.requests))
                    print_request_times(reports[-1])
                else:
                    reports.append(engine_report(m, p))
                    print_engine_report(reports[-1])
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(reports, f)
        print(json.dumps(reports))
        return 0
    if args.precision not in ("parity", "serving"):
        ap.error(f"unknown --precision {args.precision!r}")
    if args.layouts:
        batches = tuple(int(b) for b in args.batches.split(","))
        res = layout_times(args.model, batches, precision=args.precision)
        print(torch.cuda.get_device_name(0))
        for name, by_batch in res.items():
            print(f"{args.model}@{TILES[args.model]} {args.precision} {name}: " + ", ".join(
                f"batch {b} {ms:.3f} ms (max|d| {d:.2e})" for b, (ms, d) in by_batch.items()))
        print(json.dumps({k: {str(b): v for b, v in r.items()} for k, r in res.items()}))
        return 0
    res = profile_model(args.model, tuple(int(b) for b in args.batches.split(",")),
                        nss=args.nss, precision=args.precision)
    print(res["card"])
    for b, r in res["batches"].items():
        print(f"{args.model}@{res['tile']} nss={args.nss} {args.precision} batch {b}: "
              f"forward {r['forward_ms']:.3f} ms "
              f"(CUDA events), device {r['device_ms']:.3f} ms (profiler)")
        for name, ms in r["stages_ms"].items():
            print(f"  {name:40s} {ms:9.3f} ms")
        for name, ms, n in r["top_kernels"]:
            print(f"    {ms:9.3f} ms {n:4d}x  {name}")
        for name, (c, h, w, ms, per_ms) in r["convs"].items():
            print(f"  conv {name:34s} in {c:4d}x{h}x{w}: {ms:8.3f} ms on the batch, "
                  f"{per_ms:8.3f} ms per image")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    _tree = sys.argv[sys.argv.index("--tree") + 1] if "--tree" in sys.argv else None
    if _tree and __package__:
        raise SystemExit("--tree: run this file as a script, not with -m")
    sys.path.insert(0, os.path.abspath(_tree) if _tree
                    else os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
                        __file__)))))
    raise SystemExit(main())
