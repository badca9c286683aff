"""Per-model FLOPs of the port at 256x256 through PyTorch's flop counter.

    python -m tpuir_torch.scripts.compute_flops [--size 256] [--models NAME ...]

The counterpart of ``scripts/compute_flops.py``: the same model table and
names, each model at (1, C, size, size), counted by
``utils.profiling.flop_count`` (``torch.utils.flop_counter``: products and
convolutions, 2 a multiply-add; XLA's cost analysis also counts elementwise
work, so the figures are not tpuir's). The count runs on the meta device:
the modules and the input have shapes and no data, so no forward runs, as
tpuir's script only lowers its models and never runs them. The port's
kernel wrappers take CPU or CUDA tensors only, so Restormer and MaIR are
built with their plain blocks (``fused=False``), which compute the same
function. MaIR-CDN's plain scans still make minutes of Python calls.
"""

import argparse
import functools

import torch

from tpuir_torch.utils.profiling import flop_count


def model_table():
    """(name, constructor of the module, input channels), ``scripts/compute_flops.py``'s
    table. Restormer's and MaIR's constructors take ``fused``."""
    from tpuir_torch.models.deblurgan import FPNInception, FPNMobileNet
    from tpuir_torch.models.dncnn import DnCNN
    from tpuir_torch.models.mair import MaIR
    from tpuir_torch.models.mair_unet import MaIRUNet
    from tpuir_torch.models.rednet import REDNet
    from tpuir_torch.models.restormer import Restormer

    return [
        ("REDNet", REDNet, 1),
        ("DnCNN (nonblind, gray)", lambda: DnCNN(1, 1, 64, 17), 1),
        ("DnCNN (blind, color)", lambda: DnCNN(3, 3, 64, 20), 3),
        ("Restormer", Restormer, 3),
        ("Restormer (Dual-pixel)",
         lambda **kw: Restormer(inp_channels=6, dual_pixel_task=True, **kw), 6),
        ("DeblurGANv2 (Inception)", FPNInception, 3),
        ("DeblurGANv2 (MobileNet)", FPNMobileNet, 3),
        ("MaIR (CDN)", MaIR, 3),
        ("MaIR (UNet)", MaIRUNet, 3),
    ]


def compute_flops(build, in_ch: int, size: int = 256):
    """(flops, parameters) of the module ``build()`` makes, at (1, in_ch,
    size, size), on the meta device."""
    with torch.device("meta"):
        net = build().eval()
        x = torch.empty(1, in_ch, size, size)
    n_params = sum(p.numel() for p in net.parameters())
    return flop_count(net, x)["flops"], n_params


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--models", nargs="*", default=None)
    args = ap.parse_args(argv)

    print(f"{'Model':34s} {'Params':>12s} {'GFLOPs@%d' % args.size:>12s}")
    for name, build, in_ch in model_table():
        if args.models and not any(m.lower() in name.lower() for m in args.models):
            continue
        if name.startswith(("Restormer", "MaIR")):
            build = functools.partial(build, fused=False)
        flops, n_params = compute_flops(build, in_ch, args.size)
        print(f"{name:34s} {n_params:12,d} {flops / 1e9:12.2f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
