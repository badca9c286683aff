"""InceptionV3 FID feature extractor (NCHW, eval-mode BatchNorm).

The PyTorch counterpart of ``tpuir/train/fid_inception.py``: pytorch-fid's
trunk, torchvision's Inception v3 up to the global average pool (2048-d),
with the FID changes: the pool branch of InceptionA, InceptionC and the
first InceptionE (Mixed_7b) is a 3x3 average that leaves the padding out
of its count (``count_include_pad=False``, ``:73-78``), Mixed_7c's is a
3x3/1 max pool, and there is no aux classifier. Every BatchNorm is
``EvalBN`` (eps 1e-3): the running statistics, in any mode (``:36-50``).
Module names are torchvision's, so a ``pt_inception-2015-12-05``
checkpoint loads by key (``fc.*`` and ``AuxLogits.*`` ignored), read with
``torch.load(weights_only=True)``.

With ``resize_input`` the input goes to 299x299 first, bilinear with
half-pixel centers and, when shrinking, a triangle filter widened by the
scale: ``jax.image.resize(..., "bilinear")`` as tpuir calls it, which is
``F.interpolate(..., mode="bilinear", antialias=True)``; an input already
299x299 passes unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpuir_torch.utils.misc import resolve_device, seeded_state_dict

FID_DIMS = 2048


class EvalBN(nn.Module):
    """BatchNorm in inference mode: the running statistics, always."""

    def __init__(self, num_features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = EvalBN(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool3_exclusive(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool3_exclusive(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool3_exclusive(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool == "max":
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg_pool3_exclusive(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """tpuir's ``jax.image.resize(x, (.., 299, 299, ..), "bilinear")`` on NCHW."""
    if tuple(x.shape[2:]) == (299, 299):
        return x
    return F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                         antialias=True)


class InceptionV3FID(nn.Module):
    """2048-d pool3 features of NCHW RGB in [0, 1]."""

    def __init__(self, resize_input: bool = True, normalize_input: bool = False):
        super().__init__()
        self.resize_input, self.normalize_input = resize_input, normalize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, pool="max")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.resize_input:
            x = resize_299(x)
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return torch.mean(x, dim=(2, 3))


_BN_MAP = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """tpuir's ``InceptionV3FID`` params as this module's state dict: the
    inverse of ``convert_fid_inception_state_dict`` (``num_batches_tracked``
    0, as nothing reads it)."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for name, child in node.items():
            key = f"{prefix}.{name}" if prefix else name
            if name == "conv":
                sd[f"{key}.weight"] = torch.from_numpy(np.ascontiguousarray(
                    np.asarray(child["kernel"], np.float32).transpose(3, 2, 0, 1)))
            elif name == "bn":
                for leaf, torch_leaf in _BN_MAP.items():
                    sd[f"{key}.{torch_leaf}"] = torch.from_numpy(np.array(child[leaf], np.float32))
                sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
            else:
                walk(child, key)

    walk(p, "")
    return sd


def init_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A seeded state dict for ``InceptionV3FID()`` in torchvision's keys."""
    with torch.device("meta"):
        net = InceptionV3FID()
    return seeded_state_dict(net, seed)


def load_patched_inception_v3(weights_path: str | None = None, resize_input: bool = True,
                              normalize_input: bool = False, device="cuda") -> InceptionV3FID:
    """The FID Inception on ``device`` (default card 0; raises without
    one), in eval mode: weights from a pt_inception checkpoint at
    ``weights_path`` (``torch.load(weights_only=True)``; ``fc.*`` and
    ``AuxLogits.*`` ignored), else seeded (for pipeline tests: FID numbers
    then carry no meaning)."""
    dev = resolve_device(device)
    net = InceptionV3FID(resize_input=resize_input, normalize_input=normalize_input)
    if weights_path is not None:
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
        sd = {k: v for k, v in sd.items() if k.split(".")[0] not in ("fc", "AuxLogits")}
    else:
        sd = init_state_dict()
    res = net.load_state_dict(sd, strict=False)
    missing = [k for k in res.missing_keys if not k.endswith("num_batches_tracked")]
    if missing or res.unexpected_keys:
        raise KeyError(f"FID Inception checkpoint: missing {missing[:5]}, "
                       f"unexpected {res.unexpected_keys[:5]}")
    return net.to(dev).eval()


@torch.no_grad()
def extract_inception_features(data_generator, net: InceptionV3FID,
                               batch_size: int = 64) -> np.ndarray:
    """pool3 features, (N, 2048) float32, of a generator of NHWC [0, 1]
    arrays (a 3-D array is one image), on ``net``'s device."""
    dev = next(net.parameters()).device
    feats = []
    for batch in data_generator:
        arr = np.asarray(batch, np.float32)
        if arr.ndim == 3:
            arr = arr[None]
        x = torch.from_numpy(np.ascontiguousarray(arr)).permute(0, 3, 1, 2).to(dev)
        feats.append(net(x).float().cpu().numpy())
    return np.concatenate(feats, axis=0)
