#!/usr/bin/env python3
"""How far a mesh's float32 train step is from one process's and from
float64 on the card, and why; how accurate the card's float32 convs are;
and what a rank's sharded serving holds in memory: the measurements behind
``chip_smoke.py`` phase 22's design.

    python3 mesh_precision.py

Run from the root of a checkout on one CUDA card (it reads phase 22's
network, crops and requests from ``chip_smoke.py`` beside it). Three parts,
printed in this order:

* convs: a conv's float32 output, input and weight gradients against
  float64 at phase 22's Restormer shapes (depthwise 3x3 at 144, 72 and 288
  channels, a 1x1 and a dense 3x3), channels_last and NCHW, cuDNN on and
  off.
* serve: the card's peak memory of ``forward_patches`` on five patches (a
  ``dp`` rank's share) of phase 18's Restormer 512x512 and MaIR-CDN
  256x256 parity requests, by engine batch.
* grads: one step of phase 22's Restormer (the sigma=25 file's network,
  seeded, crop 64, batch 4, ``shard_params_tp(..., min_dim=64)``) on meshes
  ``{sp: 2}``, ``{tp: 2}`` and ``{dp: 2, sp: 2, tp: 2}`` of gloo ranks on
  the card, and on one spawned rank with cuDNN off, each against this
  process's float32 step and against float64: the averaged, clipped
  gradient's relative L2 over every parameter and its three worst tensors.
  Then the L1 loss's residuals: how many lie within the largest difference
  between the run's output and this process's (so within the float32
  rounding of zero that can flip their sign), how many flipped, and this
  process's step taken again with the run's residual signs in place of its
  own (the L1 gradient is sign(residual)/N), against the run's gradient.
  If the gap closes there, the difference is the L1's discontinuity at
  zero, not the mesh's arithmetic.
"""

from __future__ import annotations

import sys
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

MESHES = ({"sp": 2}, {"tp": 2}, {"dp": 2, "sp": 2, "tp": 2})
CONVS = [  # (label, batch, channels, side, kernel, groups): phase 22's Restormer convs
    ("depthwise", 4, 144, 64, 3, 144), ("depthwise", 4, 72, 64, 3, 72),
    ("depthwise", 4, 288, 32, 3, 288), ("1x1", 4, 144, 64, 1, 1), ("3x3", 4, 48, 64, 3, 1),
]
SERVE_BATCHES = (1, 2, 8)


def _rel(a, b) -> float:
    return float(np.linalg.norm((a - b).ravel()) / max(np.linalg.norm(b.ravel()), 1e-30))


def _whole(got, want) -> float:
    err = np.sqrt(sum(np.sum((got[k] - w) ** 2) for k, w in want.items()))
    return float(err / np.sqrt(sum(np.sum(w ** 2) for w in want.values())))


def signed_step(axes, trains, signs=None, cudnn=True):
    """``dryrun.dryrun_multichip(axes, trains)`` (cuDNN as ``cudnn`` says)
    with each L1 loss's prediction kept, in order, under "preds" (this
    rank's share, NCHW). Given ``signs`` (whole NCHW arrays, one a loss,
    on a mesh of one), a loss is sum(pred * signs) / N instead, whose
    gradient is the L1's with those residual signs."""
    from tpuir_torch.parallel import dryrun
    from tpuir_torch.train import losses

    torch.backends.cudnn.enabled = cudnn
    l1, preds = losses.l1_loss, []

    def kept(pred, target, **kw):
        preds.append(pred.detach().cpu().numpy())
        if signs is None:
            return l1(pred, target, **kw)
        return (pred * torch.from_numpy(signs[len(preds) - 1]).to(pred)).sum() / pred.numel()

    losses.l1_loss = kept  # dryrun.train_part imports it at each call
    try:
        out = dryrun.dryrun_multichip(axes, trains)
    finally:
        losses.l1_loss = l1
        torch.backends.cudnn.enabled = True
    out["preds"] = preds
    return out


def whole_pred(axes, ranks, shape):
    """Step 1's prediction of the whole batch (NCHW ``shape``), from the
    shares of the ranks with ``tp`` coordinate 0."""
    from tpuir_torch.parallel.mesh import Mesh, batch_sharding, coords_of, volume

    out = np.empty(shape, np.float32)
    for r in range(volume(axes)):
        if coords_of(axes, r).get("tp", 0) == 0:
            rows, hs = batch_sharding(Mesh(axes, r), shape[0], shape[2])
            out[rows, :, hs] = ranks[r]["preds"][0]
    return out


def float64_grads(train) -> dict:
    """One float64 step's gradient of ``train`` (``dryrun.train_part``'s
    arguments) on the card, clipped as the step clips it."""
    from tpuir_torch.parallel import dryrun
    from tpuir_torch.train.archs import build_network, init_state_dict

    net = build_network(train["network_g"])
    net.load_state_dict(init_state_dict(train["network_g"], train["seed"]))
    net = net.double().cuda()
    x, y = (torch.from_numpy(a[0].transpose(0, 3, 1, 2).copy()).double().cuda()
            for a in (train["lq"], train["gt"]))
    (net(x) - y).abs().mean().backward()
    grads = {k: p.grad for k, p in net.named_parameters()}
    norm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
    scale = min(1.0, dryrun.GRAD_CLIP / (norm + 1e-6))
    return {k: (g * scale).cpu().numpy() for k, g in grads.items()}


def _worst(got, want) -> str:
    worst = sorted(((_rel(got[k], w), k) for k, w in want.items()), reverse=True)[:3]
    return ", ".join(f"{k} {r:.2e}" for r, k in worst)


def part_grads(cs) -> None:
    from tpuir_torch.parallel.dist import init_dist
    from tpuir_torch.parallel.launch import launch
    from tpuir_torch.parallel.mesh import volume

    lq, gt = cs.ddp_batches()
    trains = cs.sptp_trains(lq[:1], gt[:1])[:1]  # Restormer, one step
    target = trains[0]["gt"][0].transpose(0, 3, 1, 2)
    init_dist(device="cuda:0")
    ref = signed_step({"dp": 1}, trains)
    want, pred = ref["train"][0]["grads"][0], ref["preds"][0]
    again = signed_step({"dp": 1}, trains, [np.sign(pred - target)])["train"][0]["grads"][0]
    f64 = float64_grads(trains[0])
    torch.cuda.empty_cache()
    print(f"one process, float32 against float64: {_whole(want, f64):.2e} over every "
          f"parameter; again with its own residual signs: {_whole(again, want):.2e}",
          flush=True)
    runs = [(axes, True, "") for axes in MESHES] + [({"dp": 1}, False, ", cuDNN off")]
    for axes, cudnn, note in runs:
        ranks = launch(signed_step, volume(axes), args=(axes, trains, None, cudnn),
                       backend="gloo", device="cuda:0", timeout=600, threads=1)
        got = ranks[0]["train"][0]["grads"][0]
        print(f"{axes}{note}: against one process {_whole(got, want):.2e}, against float64 "
              f"{_whole(got, f64):.2e} over every parameter; worst tensors "
              + _worst(got, want), flush=True)
        theirs = whole_pred(axes, ranks, pred.shape)
        near = np.abs(theirs - pred).max()
        flips = np.sign(theirs - target) != np.sign(pred - target)
        flipped = signed_step({"dp": 1}, trains, [np.sign(theirs - target)])
        torch.cuda.empty_cache()
        moved = flipped["train"][0]["grads"][0]
        print(f"  residuals: {pred.size}; output max |difference| {near:.2e}; within it of "
              f"zero {int((np.abs(pred - target) <= near).sum())}; signs flipped "
              f"{int(flips.sum())}; one process with this run's signs: against this run "
              f"{_whole(moved, got):.2e}, worst tensors " + _worst(moved, got)
              + f"; against one process {_whole(moved, want):.2e}", flush=True)


def part_convs() -> None:
    gen = torch.Generator().manual_seed(0)
    for cudnn in (True, False):
        torch.backends.cudnn.enabled = cudnn
        for fmt in (torch.channels_last, torch.contiguous_format):
            for label, b, c, side, k, groups in CONVS:
                x = torch.randn(b, c, side, side, generator=gen)
                w = torch.randn(c, c // groups, k, k, generator=gen) / 3
                dy = torch.randn(b, c, side, side, generator=gen)
                outs = {}
                for dt in (torch.float64, torch.float32):
                    xx = x.to("cuda", dt).contiguous(memory_format=fmt).requires_grad_(True)
                    ww = w.to("cuda", dt).requires_grad_(True)
                    with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
                        y = F.conv2d(xx, ww, None, 1, k // 2, 1, groups)
                        y.backward(dy.to("cuda", dt).contiguous(memory_format=fmt))
                    outs[dt] = [t.detach().double().cpu().numpy() for t in (y, xx.grad, ww.grad)]
                errs = [_rel(a, b) for a, b in zip(outs[torch.float32], outs[torch.float64])]
                print(f"{label} batch {b}, {c} channels, {side}x{side}, "
                      f"{'channels_last' if fmt == torch.channels_last else 'NCHW'}, cuDNN "
                      f"{'on' if cudnn else 'off'}: float32 against float64: output "
                      f"{errs[0]:.1e}, input gradient {errs[1]:.1e}, weight gradient "
                      f"{errs[2]:.1e}", flush=True)
    torch.backends.cudnn.enabled = True


def part_serve(cs) -> None:
    from tpuir_torch.core import native
    from tpuir_torch.core.tiling import tile_indices
    from tpuir_torch.utils.profiling import write_seeded_checkpoint

    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="tpuir_mesh_precision_") as wdir:
        for key in ("restormer", "mair"):
            write_seeded_checkpoint(key, wdir, seed=cs.SEED)
            model = cs.seeded_zoo_model(key, "parity", wdir, device)
            img = np.ascontiguousarray(model.normalize(cs.window_request(key)[0]))
            ps, hs, ws = tile_indices(*img.shape[:2], model.patch_size, model.patch_overlap)
            patches = native.extract_patches(img, [(a, b) for a in hs for b in ws],
                                             min(ps, img.shape[0]), min(ps, img.shape[1]))[:5]
            for batch in SERVE_BATCHES:
                model.batch_size = batch
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                model.forward_patches(np.ascontiguousarray(patches))
                torch.cuda.synchronize()
                print(f"{key}: five patches of {ps}x{ps} at engine batch {batch}: peak "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
            del model


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_precision: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tpuir_torch.ops import _kernels

    print(cs.card_line(), flush=True)
    _kernels.library()
    part_convs()
    part_serve(cs)
    part_grads(cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
