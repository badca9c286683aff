"""K3 in the port (the selective scan with fused projections on gathered
sequences): its plain version against the JAX Pallas kernel in interpret
mode and against the JAX composition it replaces, the wrapper's checks, and
the CUDA kernel against the plain version on a card.

Inputs come from NumPy seeds. JAX is imported only on the reference side,
so the card tests run where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
"""

import numpy as np
import pytest
import torch

from tpuir_torch.core.engine import true_float32
from tpuir_torch.ops import _kernels
from tpuir_torch.ops.scan_fused_proj import (selective_scan_fused_proj,
                                             selective_scan_fused_proj_plain)

# the JAX package's tolerance for K3 against its composition
# (tests/test_scan_pallas.py:61)
ATOL, RTOL = 2e-4, 2e-4
# the scan's own, kernel against plain on the card (tests/test_torch_nss.py)
SCAN_ATOL, SCAN_RTOL = 5e-5, 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _operands(B, L, d, n, r, seed):
    """xs and the scan weights as the port takes them (A already -exp), the
    projections scaled by their fan-in so that x_dbl and dt stay unit-scale
    at any width."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(
        xs=f(B, 4, L, d), x_proj_w=f(4, r + 2 * n, d) / np.float32(np.sqrt(d)),
        dt_w=f(4, d, r) / np.float32(np.sqrt(r)),
        A=-np.exp(f(4, d, n) * np.float32(0.3)).astype(np.float32),
        D=f(4, d) * np.float32(0.3), delta_bias=f(4, d) * np.float32(0.3),
    )


def _torch(d, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in d.items()}


@pytest.mark.parametrize("B,L,d,n,r", [
    (1, 64, 24, 4, 2),
    (2, 100, 12, 5, 2),   # ragged L (not a multiple of the chunk) and d
    (1, 70, 40, 32, 3),   # MaIRUNet's latent d_state 32, ragged L
    (1, 48, 20, 16, 2),
])
def test_plain_matches_jax_kernel_and_composition(B, L, d, n, r):
    import jax.numpy as jnp

    from tpuir.ops import scan_pallas as sp

    ops = _operands(B, L, d, n, r, seed=L + n)
    j = [jnp.asarray(ops[k]) for k in ("xs", "x_proj_w", "dt_w", "A", "D", "delta_bias")]
    kern = np.asarray(sp.selective_scan_fused_proj(*j, chunk=16, interpret=True))
    comp = np.asarray(sp._reference_composition(*j, chunk=16))
    before = dict(_kernels.LAUNCHES)
    got = selective_scan_fused_proj(**_torch(ops))
    assert _kernels.LAUNCHES == before  # a CPU tensor takes the plain version
    assert got.shape == (B, 4, L, d)
    np.testing.assert_allclose(got.numpy(), kern, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), comp, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("fault", ["float64", "not_contiguous", "three_directions",
                                   "wide_state", "bad_weight", "other_device"])
def test_wrapper_rejects(fault):
    ops = _torch(_operands(1, 16, 6, 3, 2, seed=0))
    err = ValueError
    if fault == "float64":
        ops["xs"], err = ops["xs"].double(), TypeError
    elif fault == "not_contiguous":
        ops["xs"] = ops["xs"].transpose(2, 3)
    elif fault == "three_directions":
        ops["xs"] = ops["xs"][:, :3].contiguous()
    elif fault == "wide_state":
        ops = _torch(_operands(1, 16, 6, 33, 2, seed=0))
    elif fault == "bad_weight":
        ops["dt_w"] = ops["dt_w"][:, :-1].contiguous()
    else:
        ops["A"] = ops["A"].to("meta")
    with pytest.raises(err):
        selective_scan_fused_proj(**ops)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,d,n,r", [
    (1, 64, 24, 4, 2), (2, 100, 12, 5, 2), (2, 600, 40, 16, 3),
    (2, 7872, 384, 16, 12),   # MaIRUNet level 3 of a 481x321 request (96x82 tiles)
    (2, 1968, 768, 32, 24),   # its latent level (48x41 tiles)
    (1, 257, 300, 32, 64),    # ragged chunk, three channel blocks, over 48 KB of shared memory
])
def test_kernel_matches_plain_on_card(cuda_device, B, L, d, n, r):
    ops = _torch(_operands(B, L, d, n, r, seed=L + d), cuda_device)
    before = _kernels.LAUNCHES["selective_scan_fused_proj"]
    with torch.inference_mode(), true_float32():
        y = selective_scan_fused_proj(**ops)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["selective_scan_fused_proj"] == before + 1
        again = selective_scan_fused_proj(**ops)
        want = selective_scan_fused_proj_plain(**ops)
    assert torch.equal(y, again)  # no atomics
    torch.testing.assert_close(y, want, atol=SCAN_ATOL, rtol=SCAN_RTOL)
