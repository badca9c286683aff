"""Largest patch size each model serves on the card: a binary search on
CUDA out-of-memory.

    python -m tpuir_torch.scripts.test_patch_size [--models NAME ...] [--max-side 2048]

The original's protocol (a forward at each candidate side, step 16, upper
bound 2048): each trial runs the engine's step (cast, pad, forward, crop)
on one (1, C, side, side) patch of the model of ``compute_flops``' table,
seeded weights, in parity, on the card. Only ``torch.cuda.OutOfMemoryError`` counts
as "does not fit" (the allocator's cache is emptied after it); any other
error propagates, so a serving kernel's refusal of a shape or a failed
build never reads as "too big". tpuir's script asks XLA's memory analysis
instead (a TPU has no run-time out-of-memory to catch).
"""

import argparse
from typing import Callable

import torch


def find_max_patch_size(fits: Callable[[int], bool], max_side: int = 2048,
                        step: int = 16) -> int:
    """The binary search of ``scripts/test_patch_size.py``: the largest
    multiple of ``step`` up to ``max_side`` for which ``fits(side)`` held
    on the path it took (``step`` if none did)."""
    lo, hi = step, int(max_side)
    best = step
    while lo <= hi:
        mid = max(((lo + hi) // (2 * step)) * step, step)
        if fits(mid):
            best = mid
            lo = mid + step
        else:
            hi = mid - step
    return best


def card_fits(model, in_ch: int) -> Callable[[int], bool]:
    """``fits(side)`` for an engine bundle: one (1, in_ch, side, side) patch
    through ``model.step`` on its device; False on CUDA out-of-memory only."""

    def fits(side: int) -> bool:
        torch.cuda.reset_peak_memory_stats(model.device)
        x = torch.rand(1, in_ch, side, side, device=model.device)
        if model.pad_block:  # DeblurGANv2's [-1, 1] input
            x = 2 * x - 1
        oom = False
        try:
            model.step(x)
            torch.cuda.synchronize(model.device)
        except torch.cuda.OutOfMemoryError:
            oom = True  # the traceback's frames are freed once the handler is left
        del x
        if oom:
            torch.cuda.empty_cache()
            print(f"  size {side}: out of memory", flush=True)
            return False
        peak = torch.cuda.max_memory_allocated(model.device)
        print(f"  size {side}: fits, peak {peak / 1e9:.2f} GB", flush=True)
        return True

    return fits


def bundle(name: str, build, in_ch: int, device="cuda"):
    """A parity engine bundle of ``compute_flops``' model ``name`` with the
    hooks the zoo gives its family."""
    from tpuir_torch.core.engine import InferenceModel
    from tpuir_torch.core.image_io import normalize_signed

    torch.manual_seed(0)
    kw = dict(name=name, device=torch.device(device))
    if name.startswith(("Restormer", "MaIR")):  # every block through its kernels
        net = build(fused=True)
        kw.update(pad_factor=8)
    elif name.startswith("DeblurGANv2"):
        net = build()
        kw.update(pad_block=32, normalize=normalize_signed)
    else:  # DnCNN, REDNet
        net = build()
    return InferenceModel(net=net.to(device).eval().requires_grad_(False), **kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", nargs="*", default=None)
    ap.add_argument("--max-side", type=int, default=2048)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("test_patch_size: no CUDA device")
        return 1
    from tpuir_torch.scripts.compute_flops import model_table

    print(f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    for name, build, in_ch in model_table():
        if args.models and not any(m.lower() in name.lower() for m in args.models):
            continue
        model = bundle(name, build, in_ch, "cuda")
        best = find_max_patch_size(card_fits(model, in_ch), max_side=args.max_side)
        print(f"{name}: max patch size {best}", flush=True)
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
