"""How far float32 gradients of DeblurGANv2's training steps are from
float64, on the card and on the CPU.

    python -m tpuir_torch.utils.gan_precision

On one CUDA card (``chip_smoke.py`` beside the package, whose phase 20
builds the steps): the released recipe's step 1 (``chip_smoke.gan_pair``,
``GanRun``: FPN-Inception, double_gan, WGAN-GP, perceptual, 256x256, batch
1) and one L1 step of each extra generator (``chip_smoke.GENERATORS``), in
float32 on the card, in float32 on the CPU and in float64 on the CPU. Per
network, one line: how many gradient tensors (those zero by construction
left out) each float32 run has past 1e-3 relative L2 from float64, the
worst of each, and the whole gradient's relative L2; then the four worst
tensors. Phase 20 bounds the gradients in float64 only: these lines are
why.
"""

from __future__ import annotations

import importlib
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def summary(label, card, c32, f64, zero_share, rtol=1e-3):
    import chip_smoke as cs

    total = float(torch.sqrt(sum((w.double() ** 2).sum() for w in f64.values())))
    rows = [(cs.rel_l2(card[k], w), cs.rel_l2(c32[k], w), cs.rel_l2(card[k], c32[k]), k)
            for k, w in f64.items() if float(w.double().norm()) > zero_share * total]
    a = np.array([r[:3] for r in rows])

    def whole(got):
        return float(torch.sqrt(sum(((got[k] - f64[k]).double() ** 2).sum() for k in f64))) / total

    print(f"{label}: {len(rows)} tensors; past {rtol} from float64: card {(a[:, 0] > rtol).sum()}, "
          f"CPU float32 {(a[:, 1] > rtol).sum()} (card from CPU float32: {(a[:, 2] > rtol).sum()}); "
          f"worst card {a[:, 0].max():.2e}, CPU float32 {a[:, 1].max():.2e}; whole gradient card "
          f"{whole(card):.2e}, CPU float32 {whole(c32):.2e}", flush=True)
    for r in sorted(rows, reverse=True)[:4]:
        print(f"    {r[3]}: card {r[0]:.2e}, CPU float32 {r[1]:.2e}, card from CPU float32 {r[2]:.2e}")


def main() -> int:
    sys.path.insert(0, REPO)  # chip_smoke.py, beside the package
    import chip_smoke as cs
    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.models.deblurgan import fpn_inception
    from tpuir_torch.models.deblurgan.discriminators import get_discriminator
    from tpuir_torch.train import deblurgan_losses, vgg_features
    from tpuir_torch.utils.misc import seeded_state_dict

    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    g_sd = fpn_inception.init_state_dict(seed=cs.GAN_SEED)
    d_sds = {k: seeded_state_dict(d, cs.GAN_SEED + 1 + i)
             for i, (k, d) in enumerate(get_discriminator(cs.RELEASED, device="cpu").items())}
    vgg_sd = vgg_features.init_state_dict(seed=cs.GAN_SEED + 5)
    blurred, sharp = cs.gan_pair(dev)
    alpha = deblurgan_losses.DiscLossWGANGP.draw_alpha(torch.Generator().manual_seed(cs.GAN_SEED))
    with true_float32():
        card = cs.GanRun(cs.RELEASED, dev, fpn_inception.FPNInception, g_sd, d_sds, vgg_sd)
        rec = card.step(blurred, sharp, alpha)

    def recipe_on_cpu(dtype):
        run = cs.GanRun(cs.RELEASED, cpu, fpn_inception.FPNInception, g_sd, d_sds, vgg_sd, dtype)
        fake = run.g(blurred.cpu().to(dtype))
        run.d_loss(fake.detach(), sharp.cpu().to(dtype), alpha).backward()
        out = {"d": {k: cs.grads_of(d) for k, d in run.ds.items()}}
        for k, d in run.ds.items():
            d.load_state_dict(rec["d_after"][k])
            d.zero_grad(set_to_none=True)
        run.g_loss(fake, sharp.cpu().to(dtype)).backward()
        out["g"] = cs.grads_of(run.g)
        return out

    c32, f64 = recipe_on_cpu(torch.float32), recipe_on_cpu(torch.float64)
    for k in ("patch", "full"):
        summary(f"released recipe step 1, D {k}", rec["d_grads"][k], c32["d"][k], f64["d"][k],
                cs.GAN_ZERO_SHARE)
    summary("released recipe step 1, G", rec["g_grads"], c32["g"], f64["g"], cs.GAN_ZERO_SHARE)

    x, y = cs.gan_pair(dev, cs.GAN_SEED + 50)
    for label, name in cs.GENERATORS:
        mod = importlib.import_module(f"tpuir_torch.models.deblurgan.{name}")
        sd = mod.init_state_dict(seed=cs.GAN_SEED + 20)
        grads = []
        for d, dtype in ((dev, torch.float32), (cpu, torch.float32), (cpu, torch.float64)):
            net = mod.build(sd, device=d).train().to(dtype)
            with true_float32():
                torch.mean(torch.abs(net(x.to(d, dtype)) - y.to(d, dtype))).backward()
            grads.append(cs.grads_of(net))
        summary(f"{label}, L1 step", *grads, cs.GAN_ZERO_SHARE)
    return 0


if __name__ == "__main__":
    sys.exit(main())
