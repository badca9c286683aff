"""Tracing and profiling on the card: the counterpart of
``tpuir/utils/profiling.py``, on ``torch.profiler``.

Set ``TPUIR_TRACE_DIR`` to write a trace of any ``with maybe_trace("name"):``
region (the engine wraps its device pipeline) under ``<dir>/<name>``;
``trace_fn`` profiles one callable; ``kernel_times`` and ``op_device_ms``
read device time from its profile by kernel and by aten op.

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
import contextlib
import json
import os
from typing import Callable, Dict, Optional, Tuple

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(TILES), default="mair")
    ap.add_argument("--batches", default="1,2,3,4,8")
    ap.add_argument("--nss", choices=("stripe", "fused", "0"), default="stripe")
    ap.add_argument("--precision", choices=("parity", "serving"), default="parity")
    ap.add_argument("--layouts", action="store_true",
                    help="a plain-conv family's forward ms by input layout and cuDNN's "
                         "algorithm choice (layout_times) instead of the breakdown")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiling: no CUDA device")
        return 1
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
    raise SystemExit(main())
