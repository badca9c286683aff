"""K4 in the port (the plain selective scan, mamba_ssm's selective_scan_fn):
its CPU path against the JAX Pallas kernel in interpret mode, the wrapper's
checks, and the CUDA kernel against the plain version on a card.

Inputs come from NumPy seeds. JAX is imported only on the reference side,
so the card tests run where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
"""

import numpy as np
import pytest
import torch

from tpuir_torch.core.engine import true_float32
from tpuir_torch.ops import _kernels
from tpuir_torch.ops.selective_scan import selective_scan, selective_scan_kernel
from tests.torch_threads import one_torch_thread  # noqa: F401

# the JAX package's tolerance for its kernel against its scan (tests/test_scan_pallas.py:27)
TOL = 2e-4
# the scan's own, kernel against plain on the card (tests/test_torch_nss.py)
SCAN_ATOL, SCAN_RTOL = 5e-5, 1e-3
NAMES = ("u", "delta", "A", "Bmat", "Cmat", "D", "delta_bias")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(b, k, L, d, n, seed):
    """The operands of one scan, unit-scale, with A = -exp(.) negative."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(u=f(b, k, L, d), delta=f(b, k, L, d) * np.float32(0.5),
                A=-np.exp(f(k, d, n) * np.float32(0.5)).astype(np.float32),
                Bmat=f(b, k, L, n), Cmat=f(b, k, L, n), D=f(k, d),
                delta_bias=f(k, d) * np.float32(0.3))


def _torch(case, device="cpu"):
    return {k: None if v is None else torch.from_numpy(v).to(device) for k, v in case.items()}


# tests/test_scan_pallas.py:14-16's three cases: (b, k, L, d, n, chunk, d_tile)
CASES = [(1, 2, 64, 8, 4, 16, 8), (2, 4, 100, 12, 5, 32, 8), (1, 4, 256, 24, 16, 64, 16)]


@pytest.mark.parametrize("absent", [False, True], ids=["D+bias", "no_D_no_bias"])
@pytest.mark.parametrize("b,k,L,d,n,chunk,d_tile", CASES)
def test_matches_jax_kernel(b, k, L, d, n, chunk, d_tile, absent):
    import jax.numpy as jnp

    from tpuir.ops.scan_pallas import selective_scan_pallas

    case = _case(b, k, L, d, n, seed=L + d)
    if absent:
        case["D"] = case["delta_bias"] = None
    j = {name: None if v is None else jnp.asarray(v) for name, v in case.items()}
    want = np.asarray(selective_scan_pallas(*[j[name] for name in NAMES], chunk=chunk,
                                            d_tile=d_tile, interpret=True))
    before = dict(_kernels.LAUNCHES)
    got = selective_scan_kernel(**_torch(case))
    assert _kernels.LAUNCHES == before  # a CPU tensor takes the plain version
    assert got.shape == (b, k, L, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_raw_delta_refused():
    """The kernel fuses softplus, as the JAX function asserts."""
    with pytest.raises(ValueError):
        selective_scan_kernel(**_torch(_case(1, 2, 16, 4, 2, seed=0)), delta_softplus=False)


@pytest.mark.parametrize("fault", ["float64", "not_contiguous", "wide_state", "bad_B",
                                   "bad_D", "other_device"])
def test_wrapper_rejects(fault):
    ops = _torch(_case(1, 2, 16, 4, 2, seed=0))
    err = ValueError
    if fault == "float64":
        ops["u"], err = ops["u"].double(), TypeError
    elif fault == "not_contiguous":
        ops["delta"] = ops["delta"].transpose(2, 3).contiguous().transpose(2, 3)
    elif fault == "wide_state":
        ops = _torch(_case(1, 2, 16, 4, 33, seed=0))
    elif fault == "bad_B":
        ops["Bmat"] = ops["Bmat"][:, :, :-1].contiguous()
    elif fault == "bad_D":
        ops["D"] = ops["D"][:1].contiguous()
    else:
        ops["A"] = ops["A"].to("meta")
    with pytest.raises(err):
        selective_scan_kernel(**ops)


@pytest.mark.cuda
@pytest.mark.parametrize("absent", [False, True], ids=["D+bias", "no_D_no_bias"])
@pytest.mark.parametrize("b,k,L,d,n", [
    (1, 2, 64, 8, 4), (2, 4, 100, 12, 5), (1, 4, 256, 24, 16),
    (2, 3, 700, 130, 32),    # odd K, ragged chunk, two channel blocks, d_state 32
    (1, 1, 300, 8, 9),       # K 1, ceiling 16
])
def test_kernel_matches_plain_on_card(cuda_device, b, k, L, d, n, absent):
    case = _case(b, k, L, d, n, seed=L + d)
    if absent:
        case["D"] = case["delta_bias"] = None
    ops = _torch(case, cuda_device)
    before = _kernels.LAUNCHES["selective_scan"]
    with torch.inference_mode(), true_float32():
        y = selective_scan_kernel(**ops)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["selective_scan"] == before + 1
        again = selective_scan_kernel(**ops)
        want = selective_scan(**ops)
    assert torch.equal(y, again)  # no atomics
    torch.testing.assert_close(y, want, atol=SCAN_ATOL, rtol=SCAN_RTOL)
