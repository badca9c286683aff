"""P1: the card's elementwise-rate probe, and the scan floor it gives.

The counterpart of ``benchmarks/micro_vpu.py`` (its Pallas probe
``vpu_rate``, its ``matmul_peak`` and its scan floor). ``probe`` is P1's
wrapper: on a CUDA tensor it launches ``tpuir_torch/csrc/rate_probe.cu``
on the current stream and counts the launch; on a CPU tensor, and only
there, it runs ``probe_plain``, the same chain in torch:

    out = sum over the 8 streams s, in order, of op^rounds(x[s] * (1 + 1e-6 s))

for op in ``mul`` (v * 0.99), ``fma`` (0.5 v + 0.3) and ``exp2`` (2^-v).
With ``rounds = 32`` and x (8, 512, 128) it computes what the JAX
``_probe_kernel`` computes.

    python -m tpuir_torch.utils.micro_rate

prints, on the card: the three elementwise rates in Gelem/s (one launch a
rate, each thread holding its 8 chains in registers for ``TIMED_ROUNDS``
rounds, 4 blocks of 128 threads an SM); the float32 (TF32 off), TF32 and
bf16 ``torch.matmul`` rates at 8192^3; and the scan floor at MaIR-CDN@128,
batch 8 (d_inner 234 unpadded): per state update 3 mul, 3 fma and 1 exp at
the measured rates, as ``benchmarks/micro_vpu.py`` counts it, and the
three-pass MUFU floor (two exp2 a state update at the measured exp2 rate),
beside the measured times of K2 (``nss_scan``) and K5 (``nss_scan_fused``)
at that shape. Its last line is the same as one JSON object. It writes no
file.
"""

from __future__ import annotations

import json
import math
from typing import Callable, Dict

import numpy as np
import torch

from tpuir_torch.ops import _kernels
from tpuir_torch.utils.profiling import cuda_ms

STREAMS = 8
ROUNDS = 32            # the JAX probe's unrolled rounds
BLOCK = (512, 128)     # the JAX probe's block a stream
TIMED_ROUNDS = 65536   # rounds of a timed launch
OPS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "mul": lambda v: v * 0.99,
    "fma": lambda v: 0.5 * v + 0.3,
    "exp2": lambda v: torch.exp2(-v),
}
_OP_CODES = {"mul": 0, "fma": 1, "exp2": 2}
# MaIR-CDN@128, batch 8: the scan floor's shape (tpuir_torch/zoo.py MAIR_CDN_CONFIG)
CDN_BATCH, CDN_TILE, CDN_DIM, CDN_STATE, CDN_RATIO = 8, 128, 180, 16, 1.3


def _check(x: torch.Tensor, op: str, rounds: int) -> None:
    if op not in OPS:
        raise ValueError(f"probe: op must be one of {sorted(OPS)}, got {op!r}")
    if rounds < 0:
        raise ValueError(f"probe: rounds must be >= 0, got {rounds}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"probe: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"probe: float32 only, got {x.dtype}")
    if x.dim() < 2 or x.shape[0] != STREAMS or not x.is_contiguous() or x[0].numel() == 0:
        raise ValueError(f"probe: x must be contiguous ({STREAMS}, ...), got {tuple(x.shape)}")


def probe_plain(x: torch.Tensor, op: str, rounds: int = ROUNDS) -> torch.Tensor:
    """The probe's function in plain PyTorch: x (8, ...) -> out (...)."""
    f = OPS[op]
    acc = None
    for s in range(STREAMS):
        v = x[s] * (1.0 + 1e-6 * s)
        for _ in range(rounds):
            v = f(v)
        acc = v if acc is None else acc + v
    return acc


def probe(x: torch.Tensor, op: str, rounds: int = ROUNDS) -> torch.Tensor:
    """P1: the CUDA kernel on a CUDA tensor, ``probe_plain`` on a CPU tensor."""
    _check(x, op, rounds)
    if x.device.type == "cpu":
        return probe_plain(x, op, rounds)
    lib = _kernels.library()
    with torch.cuda.device(x.device):
        out = torch.empty(x.shape[1:], device=x.device, dtype=torch.float32)
        err = lib.tpuir_rate_probe_f32(x.data_ptr(), out.data_ptr(), out.numel(), _OP_CODES[op],
                                       rounds, torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check(err, "rate_probe")
    _kernels.LAUNCHES["rate_probe"] += 1
    return out


def elementwise_rates(device, rounds: int = TIMED_ROUNDS, iters: int = 5) -> Dict[str, float]:
    """{op: Gelem/s}: one probe launch a timing, 4 blocks of 128 threads an SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n = sms * 4 * 128
    x = torch.from_numpy(np.random.RandomState(0).rand(STREAMS, n).astype(np.float32)).to(device)
    rates = {}
    for op in OPS:
        ms = cuda_ms(lambda: probe(x, op, rounds), iters)
        rates[op] = STREAMS * n * rounds / (ms * 1e-3) / 1e9
    return rates


def gemm_rates(device, n: int = 8192, iters: int = 5) -> Dict[str, float]:
    """{dtype: TFLOP/s} of torch.matmul at n^3: float32 with TF32 off,
    float32 with TF32 on (inside this probe only), bf16."""
    from tpuir_torch.core.engine import true_float32

    gen = torch.Generator(device=device).manual_seed(0)
    out = {}
    for name, dtype, tf32 in (("float32", torch.float32, False), ("tf32", torch.float32, True),
                              ("bfloat16", torch.bfloat16, False)):
        a = torch.rand(n, n, device=device, generator=gen).to(dtype)
        b = torch.rand(n, n, device=device, generator=gen).to(dtype)
        with true_float32():  # restores the caller's TF32 settings on exit
            torch.backends.cuda.matmul.allow_tf32 = tf32
            ms = cuda_ms(lambda: torch.matmul(a, b), iters)
        out[name] = 2 * n ** 3 / (ms * 1e-3) / 1e12
        del a, b
    return out


def cdn_scan_shape():
    """(B, H, W, d_inner, d_state, dt rank) of MaIR-CDN@128 at batch 8."""
    di = int(CDN_RATIO * CDN_DIM)
    return CDN_BATCH, CDN_TILE, CDN_TILE, di, CDN_STATE, math.ceil(CDN_DIM / 16)


def cdn_scan_updates() -> int:
    """State updates of one scan at MaIR-CDN@128, batch 8: B * 4 * L * N *
    d_inner, d_inner unpadded."""
    B, H, W, di, n, _ = cdn_scan_shape()
    return B * 4 * H * W * n * di


def scan_floor_ms(rates: Dict[str, float], updates: int = 0) -> float:
    """The scan's arithmetic floor from measured rates: per state update
    3 mul + 3 fma + 1 exp (benchmarks/micro_vpu.py's count), over
    ``updates`` (by default MaIR-CDN@128's, batch 8)."""
    updates = updates or cdn_scan_updates()
    return updates * (3 / rates["mul"] + 3 / rates["fma"] + 1 / rates["exp2"]) / 1e6


def mufu_floor_ms(rates: Dict[str, float], updates: int = 0) -> float:
    """The floor of the three-pass chunked scan (``csrc/chunk_scan.cuh``):
    passes 1 and 3 each take one exp2 on the MUFU pipe a state update, so
    2 * ``updates`` at the measured exp2 rate."""
    updates = updates or cdn_scan_updates()
    return 2 * updates / rates["exp2"] / 1e6


def scan_times(device, iters: int = 3) -> Dict[str, float]:
    """{kernel: ms a call} of K2 and K5 at MaIR-CDN@128, batch 8, on seeded
    operands (TF32 off)."""
    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.ops.nss_fused import nss_scan_fused
    from tpuir_torch.ops.nss_stripe import nss_scan

    B, H, W, di, n, r = cdn_scan_shape()
    rng = np.random.RandomState(0)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    args = (f(rng.rand(B, H, W, di)), f(rng.randn(4, r + 2 * n, di) * 0.05),
            f(rng.randn(4, di, r) * 0.05), f(-np.exp(rng.randn(4, di, n) * 0.1)),
            f(rng.rand(4, di)), f(rng.randn(4, di) * 0.1))
    with torch.inference_mode(), true_float32():
        return {"nss_scan": cuda_ms(lambda: nss_scan(*args), iters),
                "nss_scan_fused": cuda_ms(lambda: nss_scan_fused(*args), iters)}


def main() -> int:
    if not torch.cuda.is_available():
        print("micro_rate: no CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(dev)
    print(card)
    rates = elementwise_rates(dev)
    for op, rate in rates.items():
        print(f"{'probe ' + op:12s} {rate:12.1f} Gelem/s")
    gemm = gemm_rates(dev)
    for name, tf in gemm.items():
        print(f"{name + ' matmul 8192^3':24s} {tf:9.1f} TFLOP/s")
    floor, mufu = scan_floor_ms(rates), mufu_floor_ms(rates)
    times = scan_times(dev)
    print(f"scan floor at MaIR-CDN@128, batch 8, d_inner 234: {floor:.4f} ms; three-pass MUFU "
          f"floor {mufu:.4f} ms; measured "
          + ", ".join(f"{k} {ms:.3f} ms ({ms / floor:.2f}x, {ms / mufu:.2f}x MUFU)"
                      for k, ms in times.items()))
    print(json.dumps({"card": card, "gelem_s": rates, "matmul_tflop_s": gemm,
                      "scan_floor_ms": floor, "mufu_floor_ms": mufu, "scan_ms": times}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
