"""Model zoo of the PyTorch port: (task, subtask, model, gray, sigma) -> InferenceModel.

The counterpart of ``tpuir/zoo.py``, for all five families: Restormer (all
12 released configs), MaIR-CDN (Gaussian color denoising, sigma 15, 25 and
50), MaIRUNet (MaIR's real denoising and motion deblurring), each in parity
and serving precision, MaIR on every NSS route and with K2's
bf16-recurrence serving body under ``recur_bf16``; and the plain-conv
families DnCNN (gray sigma 15/25/50, gray blind, color blind), REDNet
(sigma 15/25/50) and DeblurGANv2 (MobileNet, Inception), which carry no
hand kernel: their layers are cuDNN convolutions and plain PyTorch.
Checkpoints are the released files, read with ``torch.load(...,
weights_only=True)`` (REDNet's ``.caffemodel`` with ``weights/caffe.py``);
a missing file raises ``FileNotFoundError``, which the harness treats as
"skip this cell". Models are built on the card unless the caller asks for
another device.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

from tpuir_torch.config import ROOT_WEIGHTS_DIR, get_patch_config
from tpuir_torch.core.engine import InferenceModel
from tpuir_torch.utils.misc import param_count


def resolve_precision(precision: Optional[str] = None) -> str:
    """'parity' (default: true float32) or 'serving' (bf16 products and
    activations where the JAX zoo takes them: Restormer, MaIR-CDN, MaIRUNet).
    Defaults to the TPUIR_PRECISION environment variable."""
    p = precision or os.environ.get("TPUIR_PRECISION", "parity")
    if p not in ("parity", "serving"):
        raise ValueError(f"unknown precision mode {p!r} (parity|serving)")
    return p


def resolve_nss(nss: Optional[str] = None) -> str:
    """MaIR's NSS route: 'stripe' (default: K6 -> K2 -> K7), 'fused' (K5)
    or '0' (K3 on every level), as the JAX module's TPUIR_NSS knob
    (``tpuir/models/mair.py:196-213``). Defaults to the TPUIR_NSS environment
    variable; '1' is its legacy alias of 'fused'."""
    n = nss or os.environ.get("TPUIR_NSS", "stripe")
    if n == "1":
        n = "fused"
    if n not in ("stripe", "fused", "0"):
        raise ValueError(f"unknown NSS route {n!r} (stripe|fused|0)")
    return n


def resolve_recur_bf16(recur: Optional[bool] = None) -> bool:
    """Whether MaIR's serving mixers take K2's bf16-recurrence body, as the
    JAX module's TPUIR_RECUR_BF16 knob (``tpuir/models/mair.py:248-254``):
    ``recur`` when given, else the TPUIR_RECUR_BF16 environment variable
    ("1" turns it on). It acts only in serving precision and on the stripe
    route."""
    if recur is not None:
        return bool(recur)
    return os.environ.get("TPUIR_RECUR_BF16") == "1"


def _load_sd(path: str, key: Optional[str] = None):
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if key is not None and isinstance(ckpt, dict) and key in ckpt:
        ckpt = ckpt[key]
    return ckpt


# Restormer released configs: (relative weights path, in_ch, out_ch,
# layer_norm_bias [WithBias=True], dual_pixel), from the 12 option YAMLs of
# the released models (the same table as tpuir/zoo.py).
RESTORMER_CONFIGS = {
    ("denoising", "gaussian", True, 15): ("denoising/gaussian_gray_denoising_sigma15.pth", 1, 1, False, False),
    ("denoising", "gaussian", True, 25): ("denoising/gaussian_gray_denoising_sigma25.pth", 1, 1, False, False),
    ("denoising", "gaussian", True, 50): ("denoising/gaussian_gray_denoising_sigma50.pth", 1, 1, False, False),
    ("denoising", "gaussian", True, None): ("denoising/gaussian_gray_denoising_blind.pth", 1, 1, False, False),
    ("denoising", "gaussian", False, 15): ("denoising/gaussian_color_denoising_sigma15.pth", 3, 3, False, False),
    ("denoising", "gaussian", False, 25): ("denoising/gaussian_color_denoising_sigma25.pth", 3, 3, False, False),
    ("denoising", "gaussian", False, 50): ("denoising/gaussian_color_denoising_sigma50.pth", 3, 3, False, False),
    ("denoising", "gaussian", False, None): ("denoising/gaussian_color_denoising_blind.pth", 3, 3, False, False),
    ("denoising", "real", False, None): ("denoising/real_denoising.pth", 3, 3, False, False),
    ("deblurring", "motion", False, None): ("deblurring/motion_deblurring.pth", 3, 3, True, False),
    ("deblurring", "defocus", False, None): ("deblurring/single_image_defocus_deblurring.pth", 3, 3, True, False),
    ("deblurring", "defocus-dual", False, None): ("deblurring/dual_pixel_defocus_deblurring.pth", 6, 3, True, True),
}


def build_restormer(weights_dir: str, task: str, subtask: str, gray: bool, sigma,
                    precision: str = "parity",
                    device: Union[str, torch.device] = "cuda") -> InferenceModel:
    """The released Restormer for this config, every block through K1: its
    float32 body (parity), or under ``precision="serving"`` its serving body
    with bf16 activations between the blocks, as ``tpuir/zoo.py`` builds
    ``restormer_fused.make_apply_fn(mm_bf16=True, io_bf16=True,
    fast_gelu=True)`` with ``compute_dtype="float32"``."""
    from tpuir_torch.models import restormer as m

    key = (task, subtask, gray, sigma)
    if key not in RESTORMER_CONFIGS:
        raise ValueError(f"no Restormer config for {key}")
    serving = resolve_precision(precision) == "serving"
    rel, in_ch, out_ch, ln_bias, dual = RESTORMER_CONFIGS[key]
    sd = _load_sd(os.path.join(weights_dir, "Restormer", rel), key="params")
    device = torch.device(device)
    net = m.Restormer(inp_channels=in_ch, out_channels=out_ch, layer_norm_bias=ln_bias,
                      dual_pixel_task=dual, fused=True, serving=serving)
    net.load_state_dict(sd)
    net = net.to(device).eval().requires_grad_(False)
    pc = get_patch_config(task, subtask.split("-")[0], "Restormer")
    return InferenceModel(
        name="Restormer", net=net, device=device,
        patch_size=pc["patch_size"], patch_overlap=pc["patch_overlap"],
        pad_factor=8, param_count=param_count(net),
        # float32 at the engine boundary, no TF32 pin; bf16 lives inside the model
        compute_dtype="float32" if serving else None,
    )


# MaIR-CDN's released config (the JAX zoo's, from upstream's
# test_MaIR_CDN_s{15,25,50}.yml).
MAIR_CDN_CONFIG = dict(embed_dim=180, depths=(6,) * 6, d_state=16, ssm_ratio=1.3,
                       mlp_ratio=2.0, scan_len=4)
MAIR_CDN_SIGMAS = (15, 25, 50)
# MaIRUNet's released config (the JAX zoo's, from upstream's
# test_MaIR_RealDN.yml) and its checkpoints under MaIR/.
MAIR_UNET_CONFIG = dict(dim=48, num_blocks=(4, 6, 6, 8), num_refinement_blocks=4,
                        ssm_ratio=2.0, flp_ratio=4.0, mlp_ratio=1.5, scan_len=4)
MAIR_UNET_WEIGHTS = {
    ("denoising", "real"): os.path.join("denoising", "MaIR_RealDN.pth"),
    ("deblurring", "motion"): os.path.join("deblurring", "MaIR_MotionDeblur.pth"),
}


def build_mair(weights_dir: str, task: str, subtask: str, sigma,
               precision: str = "parity",
               device: Union[str, torch.device] = "cuda",
               nss: Optional[str] = None, recur_bf16: Optional[bool] = None) -> InferenceModel:
    """The released MaIR-CDN for this sigma (Gaussian denoising) or MaIRUNet
    (real denoising, motion deblurring); every mixer through K6, K2 and K7
    (``nss`` "stripe", the default) or K5 ("fused"), or K3 on levels those
    do not take (every level under "0"); see ``resolve_nss``.

    ``precision="serving"`` builds either model with its mixers' serving
    bodies on the ``nss`` route (``MaIR(serving=True)``,
    ``MaIRUNet(serving=True)``: K6, K2 and K7's, K5's or K3's, with bf16
    activations inside the mixers) and ``compute_dtype="float32"``, as
    ``tpuir/zoo.py`` builds ``MaIR(scan_io_dtype="bfloat16")`` and
    ``MaIRUNet(scan_io_dtype="bfloat16")``. ``recur_bf16`` (see
    ``resolve_recur_bf16``) takes K2's bf16-recurrence serving body on the
    stripe route; in parity it has no effect, as in the JAX package."""
    from tpuir_torch.models import mair as m
    from tpuir_torch.models import mair_unet as mu

    gaussian = (task, subtask) == ("denoising", "gaussian")
    if gaussian and sigma not in MAIR_CDN_SIGMAS:
        raise ValueError(f"no MaIR-CDN config for sigma={sigma}")
    if not gaussian and (task, subtask) not in MAIR_UNET_WEIGHTS:
        raise ValueError(f"no MaIR config for {task}/{subtask}")
    serving = resolve_precision(precision) == "serving"
    nss = resolve_nss(nss)
    recur = serving and resolve_recur_bf16(recur_bf16)
    rel = (os.path.join("denoising", f"MaIR_CDN_s{sigma}.pth") if gaussian
           else MAIR_UNET_WEIGHTS[(task, subtask)])
    sd = _load_sd(os.path.join(weights_dir, "MaIR", rel), key="params")
    device = torch.device(device)
    net = (m.MaIR(**MAIR_CDN_CONFIG, fused=True, nss=nss, serving=serving, recur_bf16=recur)
           if gaussian else mu.MaIRUNet(**MAIR_UNET_CONFIG, fused=True, nss=nss,
                                        serving=serving, recur_bf16=recur))
    net = _load_own_keys(net, sd).to(device).eval().requires_grad_(False)
    pc = get_patch_config(task, subtask, "MaIR")
    return InferenceModel(
        name="MaIR", net=net, device=device,
        patch_size=pc["patch_size"], patch_overlap=pc["patch_overlap"],
        pad_factor=8, param_count=param_count(net),
        # float32 at the engine boundary, no TF32 pin; bf16 lives inside the mixers
        compute_dtype="float32" if serving else None,
    )


def _load_own_keys(net: torch.nn.Module, sd) -> torch.nn.Module:
    """Load the keys ``net`` holds from ``sd`` (others ignored, as tpuir's
    converters ignore them; a missing or misshapen one raises)."""
    keys = net.state_dict().keys()
    net.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items() if k in keys})
    return net


def _plain_conv_model(name: str, net: torch.nn.Module, device, precision: str,
                      serving_dtype: str, patch: dict, **hooks) -> InferenceModel:
    """A plain-conv family's bundle: float32 parity (TF32 off), or in serving
    the engine's ``serving_dtype`` as the JAX zoo sets it."""
    device = torch.device(device)
    net = net.to(device).eval().requires_grad_(False)
    return InferenceModel(
        name=name, net=net, device=device,
        patch_size=patch["patch_size"], patch_overlap=patch["patch_overlap"],
        param_count=param_count(net),
        compute_dtype=serving_dtype if resolve_precision(precision) == "serving" else None,
        **hooks,
    )


def build_rednet(weights_dir: str, sigma, precision: str = "parity",
                 device: Union[str, torch.device] = "cuda") -> InferenceModel:
    """The released REDNet for this sigma, from ``REDNet/{sigma}.pt`` or else
    ``REDNet/{sigma}.caffemodel`` (read by the port's copy of tpuir's caffe
    reader). Serving: ``compute_dtype="bfloat16"``, as ``tpuir/zoo.py``."""
    from tpuir_torch.models.rednet import REDNet
    from tpuir_torch.weights.caffe import caffemodel_to_state_dict

    pt = os.path.join(weights_dir, "REDNet", f"{sigma}.pt")
    cm = os.path.join(weights_dir, "REDNet", f"{sigma}.caffemodel")
    if os.path.exists(pt):
        sd = _load_sd(pt)
    elif os.path.exists(cm):
        sd = caffemodel_to_state_dict(cm)
    else:
        raise FileNotFoundError(pt)
    return _plain_conv_model("REDNet", _load_own_keys(REDNet(), sd), device, precision,
                             "bfloat16", get_patch_config("denoising", "gaussian", "REDNet"))


def build_dncnn(weights_dir: str, gray: bool, sigma, precision: str = "parity",
                device: Union[str, torch.device] = "cuda") -> InferenceModel:
    """The released DnCNN for this config, as ``tpuir/zoo.py:86-107`` picks
    it: gray ``dncnn_{sigma}.pth`` (17 layers) or ``dncnn_gray_blind.pth``
    (20), color ``dncnn_color_blind.pth`` (20; color is blind-only), 64
    wide. Serving: ``compute_dtype="bfloat16"``, as ``tpuir/zoo.py``."""
    from tpuir_torch.models.dncnn import DnCNN

    if gray:
        fname, nc, nb = ((f"dncnn_{sigma}.pth", 1, 17) if sigma is not None
                         else ("dncnn_gray_blind.pth", 1, 20))
    elif sigma is not None:
        raise ValueError("DnCNN color is blind-only")
    else:
        fname, nc, nb = "dncnn_color_blind.pth", 3, 20
    sd = _load_sd(os.path.join(weights_dir, "DnCNN", fname))
    net = _load_own_keys(DnCNN(in_nc=nc, out_nc=nc, nc=64, nb=nb), sd)
    return _plain_conv_model("DnCNN", net, device, precision, "bfloat16",
                             get_patch_config("denoising", "gaussian", "DnCNN"))


def build_deblurgan(weights_dir: str, variant: str, precision: str = "parity",
                    device: Union[str, torch.device] = "cuda") -> InferenceModel:
    """The released DeblurGANv2 generator (``variant`` "MobileNet" or
    "Inception") from ``DeblurGANv2/fpn_{mobilenet,inception}.h5`` (a torch
    pickle: ``model``, DataParallel ``module.`` keys), in its plain layout,
    with the engine hooks of ``tpuir/zoo.py``: the always-pad to 32, the
    [-1, 1] normalize and ``(x + 1) / 2``. Serving: ``compute_dtype=
    "float32"`` (float32 activations, cuDNN at TF32)."""
    from tpuir_torch.core.image_io import normalize_signed
    from tpuir_torch.models.deblurgan import FPNInception, FPNMobileNet, load_checkpoint

    if variant not in ("MobileNet", "Inception"):
        raise ValueError(f"no DeblurGANv2 variant {variant!r}")
    sd = _load_sd(os.path.join(weights_dir, "DeblurGANv2", f"fpn_{variant.lower()}.h5"),
                  key="model")
    net = load_checkpoint(FPNInception() if variant == "Inception" else FPNMobileNet(), sd)
    name = f"DeblurGANv2 ({variant})"
    return _plain_conv_model(name, net, device, precision, "float32",
                             get_patch_config("deblurring", "motion", name),
                             pad_block=32, normalize=normalize_signed,
                             postprocess=_signed_to_unit)


def _signed_to_unit(y: torch.Tensor) -> torch.Tensor:
    return (y + 1) / 2.0


def get_model_instance(
    task: str,
    subtask: str,
    model_name: str,
    gray: bool = False,
    sigma=None,
    weights_dir: Optional[str] = None,
    precision: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
    nss: Optional[str] = None,
    recur_bf16: Optional[bool] = None,
) -> InferenceModel:
    """Route a harness configuration to a loaded model bundle on ``device``
    (MaIR's mixers on the ``nss`` route, see ``resolve_nss``; K2's
    bf16-recurrence serving body under ``recur_bf16``, see
    ``resolve_recur_bf16``).

    Raises ValueError for unsupported combinations and FileNotFoundError
    when the weights are absent, with the routing of ``tpuir/zoo.py:294-306``.
    """
    weights_dir = weights_dir or ROOT_WEIGHTS_DIR
    precision = resolve_precision(precision)
    key = model_name.split(" ")[0]
    if key == "REDNet":
        if task == "denoising" and subtask == "gaussian" and sigma is not None:
            return build_rednet(weights_dir, sigma, precision, device)
    elif key == "DnCNN":
        if task == "denoising" and subtask == "gaussian" and (gray or sigma is None):
            return build_dncnn(weights_dir, gray, sigma, precision, device)
    elif key == "DeblurGANv2":
        if task == "deblurring" and subtask == "motion":
            for variant in ("Inception", "MobileNet"):
                if variant in model_name:
                    return build_deblurgan(weights_dir, variant, precision, device)
    elif key == "Restormer":
        sub = "defocus-dual" if ("Dual-pixel" in model_name and subtask == "defocus") else subtask
        if (task, sub, gray, sigma) in RESTORMER_CONFIGS:
            return build_restormer(weights_dir, task, sub, gray, sigma, precision, device)
    elif key == "MaIR":
        if task == "denoising" and subtask == "gaussian" and not gray and sigma is not None:
            return build_mair(weights_dir, task, subtask, sigma, precision, device, nss,
                              recur_bf16)
        if (task, subtask) in (("denoising", "real"), ("deblurring", "motion")):
            return build_mair(weights_dir, task, subtask, None, precision, device, nss,
                              recur_bf16)
    raise ValueError("No model instance found for current configuration.")
