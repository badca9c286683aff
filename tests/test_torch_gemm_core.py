"""The port's tensor-core GEMM core (``tpuir_torch/ops/tc_gemm.py``, the
core of ``csrc/tc_gemm.cuh`` that K1 and K6 run their products on): its
plain version against float64 and against the JAX package's LayerNorm and a
HIGHEST-precision ``jnp.dot`` on the CPU, the wrapper's checks, and the
CUDA kernel against float64 on a card (3xTF32 ``mma.sync``): ragged M, N
and K, rows that are not 16-byte aligned (K 127 and 1021), one weight an
image, the LayerNorm prologue with and without its bias, the residual
store, and bit-for-bit repeats.

Inputs come from NumPy seeds: unit-scale A, fan-in-scaled W. JAX is imported
only on the reference side, so the card tests run where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
"""

import numpy as np
import pytest
import torch

from tpuir_torch.ops import _kernels
from tpuir_torch.ops.tc_gemm import gemm_f32x3, gemm_plain
from tests.torch_threads import one_torch_thread  # noqa: F401

KEY = "tc_gemm"
# the card tests' tolerance for K1 against its plain version
# (tests/test_torch_fused_block.py), here against float64
ATOL, RTOL = 5e-5, 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _operands(batch, M, N, K, per_image, ln, resid, seed, lda=None):
    """numpy a (batch, M, lda) (the product reads its first K columns), w
    ((batch,) N, K), ln (weight, bias or None) or None, resid or None."""
    rng = np.random.RandomState(seed)
    a = rng.randn(batch, M, lda or K).astype(np.float32)
    w = (rng.randn(*((batch,) if per_image else ()), N, K) / np.sqrt(K)).astype(np.float32)
    lnp = None
    if ln:
        lnp = ((1 + 0.1 * rng.randn(K)).astype(np.float32),
               (0.1 * rng.randn(K)).astype(np.float32) if ln == "bias" else None)
    r = rng.randn(batch, M, N).astype(np.float32) if resid else None
    return a, w, lnp, r


def _float64_reference(a, w, ln, resid):
    a = a.astype(np.float64)
    if ln is not None:
        weight, bias = ln
        mu = a.mean(-1, keepdims=True)
        rstd = 1 / np.sqrt(((a - mu) ** 2).mean(-1, keepdims=True) + 1e-5)
        a = (a - mu if bias is not None else a) * rstd * weight + (bias if bias is not None else 0)
    out = a @ np.swapaxes(w.astype(np.float64), -1, -2)
    return out + resid if resid is not None else out


def _torch_args(a, w, ln, resid, K, device="cpu"):
    t = lambda v: None if v is None else torch.from_numpy(v).to(device)  # noqa: E731
    return (t(a)[..., :K], t(w), t(resid),
            None if ln is None else (t(ln[0]), t(ln[1])))


# (batch, M, N, K, one weight an image, LayerNorm, residual)
CPU_CASES = [
    (1, 37, 20, 16, False, None, False),
    (2, 19, 12, 24, True, None, True),
    (2, 23, 30, 16, False, "bias", False),
    (1, 17, 9, 40, False, "no bias", True),
]


@pytest.mark.parametrize("batch,M,N,K,per_image,ln,resid", CPU_CASES)
def test_plain_matches_float64(batch, M, N, K, per_image, ln, resid):
    a, w, lnp, r = _operands(batch, M, N, K, per_image, ln, resid, seed=M + N)
    before = _kernels.LAUNCHES[KEY]
    args = _torch_args(a, w, lnp, r, K)
    got = gemm_f32x3(*args)
    assert _kernels.LAUNCHES[KEY] == before  # a CPU tensor takes the plain version
    assert torch.equal(got, gemm_plain(*args))
    np.testing.assert_allclose(got.numpy(), _float64_reference(a, w, lnp, r), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ln_bias", [False, True])
def test_plain_matches_jax_layer_norm_product(ln_bias):
    """The LayerNorm prologue and product against the JAX kernel's own
    LayerNorm (``tpuir/ops/fused_block.py:_ln``) and a HIGHEST ``jnp.dot``."""
    import jax
    import jax.numpy as jnp

    from tpuir.ops.fused_block import _ln

    a, w, (weight, bias), _ = _operands(1, 33, 24, 48, False, "bias", False, seed=7)
    bias = bias if ln_bias else np.zeros_like(bias)
    want = jnp.dot(_ln(jnp.asarray(a[0]), weight, bias, ln_bias), jnp.asarray(w).T,
                   precision=jax.lax.Precision.HIGHEST)
    got = gemm_f32x3(torch.from_numpy(a[0]), torch.from_numpy(w),
                     ln=(torch.from_numpy(weight), torch.from_numpy(bias) if ln_bias else None))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("fault", ["float64", "k_mismatch", "w_not_contiguous",
                                   "per_image_w_unbatched_a", "ln_shape", "strided_k"])
def test_wrapper_rejects(fault):
    a = torch.randn(16, 8)
    w = torch.randn(4, 8)
    ln, err = None, ValueError
    if fault == "float64":
        a, err = a.double(), TypeError
    elif fault == "k_mismatch":
        w = torch.randn(4, 9)
    elif fault == "w_not_contiguous":
        w = torch.randn(8, 4).t()
    elif fault == "per_image_w_unbatched_a":
        w = torch.randn(2, 4, 8)
    elif fault == "ln_shape":
        ln = (torch.ones(7), None)
    else:
        a = torch.randn(16, 16)[:, ::2]
    with pytest.raises(err):
        gemm_f32x3(a, w, ln=ln)


# --- the CUDA kernel against float64, on a card ----------------------------

# (batch, M, N, K, one weight an image, LayerNorm, residual, row stride of A)
CARD_CASES = [
    (1, 1000, 37, 50, False, None, False, None),       # ragged M, N; K % 4 != 0: 4-byte copies
    (1, 777, 254, 48, False, None, False, None),       # K1 level 1's project_in shape, ragged M
    (1, 515, 48, 127, False, None, True, None),        # K = h = 127: unaligned rows, residual
    (1, 260, 384, 1021, False, None, True, None),      # K = h = 1021: the latent's project_out
    (3, 300, 96, 96, True, None, True, 288),           # one weight an image, strided rows (v)
    (2, 333, 144, 48, False, "no bias", False, None),  # LayerNorm prologue, BiasFree
    (1, 333, 510, 96, False, "bias", False, None),     # LayerNorm prologue, WithBias
    (1, 211, 468, 180, False, None, False, None),      # K6's in_proj at MaIR-CDN's widths
    (1, 129, 2042, 384, False, "bias", False, None),   # the latent's project_in, N tiles of 128
]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,M,N,K,per_image,ln,resid,lda", CARD_CASES)
def test_core_matches_float64_on_card(cuda_device, batch, M, N, K, per_image, ln, resid, lda):
    a, w, lnp, r = _operands(batch, M, N, K, per_image, ln, resid, seed=N + K, lda=lda)
    args = _torch_args(a, w, lnp, r, K, cuda_device)
    before = _kernels.LAUNCHES[KEY]
    with torch.inference_mode():
        got = gemm_f32x3(*args)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES[KEY] == before + 1
        again = gemm_f32x3(*args)
    assert torch.equal(got, again)  # no atomics, one sum order
    want = _float64_reference(a[..., :K], w, lnp, r)
    np.testing.assert_allclose(got.cpu().numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 4])
def test_core_unaligned_operand_start_on_card(cuda_device, offset):
    """A starting 4, 8 or 16 bytes into a row (a column slice), so that the
    core takes its 4-byte copies or its 16-byte ones."""
    a, w, _, _ = _operands(1, 300, 96, 64, False, None, False, seed=offset, lda=64 + 8)
    at = torch.from_numpy(a[0]).to(cuda_device)[:, offset:offset + 64]
    with torch.inference_mode():
        got = gemm_f32x3(at, torch.from_numpy(w).to(cuda_device))
    want = _float64_reference(a[0][:, offset:offset + 64], w, None, None)
    np.testing.assert_allclose(got.cpu().numpy(), want, atol=ATOL, rtol=RTOL)
