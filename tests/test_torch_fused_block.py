"""K1 in the port: the plain version against the JAX kernel (interpret mode)
and the Flax TransformerBlock on the CPU, the wrapper's checks, and the CUDA
kernel against the plain version on a card.

JAX is imported only on the reference side, so the card tests run where
JAX is absent: ``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
"""

import numpy as np
import pytest
import torch

from tpuir_torch.core.engine import true_float32
from tpuir_torch.models.restormer import init_block_params, state_dict_from_jax
from tpuir_torch.ops import _kernels
from tpuir_torch.ops.fused_block import fused_transformer_block, fused_transformer_block_plain

KEY = "fused_transformer_block"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)  # channels_last, no copy


def _jax_references(x, H, W, C, heads, ln_bias, row_tile):
    """(Flax module output, JAX kernel output in interpret mode, Flax params)."""
    import jax
    import jax.numpy as jnp
    from flax.core import unfreeze

    from tpuir.models.restormer import TransformerBlock
    from tpuir.ops.fused_block import fused_transformer_block as jax_kernel

    blk = TransformerBlock(C, heads, 2.66, False, ln_bias)
    params = unfreeze(blk.init(jax.random.PRNGKey(0), x))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(1)
    params["attn"]["temperature"] = (rng.rand(heads, 1, 1) + 0.5).astype(np.float32)
    for n in ("norm1", "norm2"):
        params[n]["weight"] = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
        if ln_bias:
            params[n]["bias"] = (0.1 * rng.standard_normal(C)).astype(np.float32)
    flax_out = np.asarray(blk.apply({"params": params}, jnp.asarray(x)))
    kernel_out = np.asarray(
        jax_kernel(jnp.asarray(x), params, heads, ln_bias, row_tile=row_tile, interpret=True)
    )
    return flax_out, kernel_out, params


@pytest.mark.parametrize(
    "H,W,C,heads,ln_bias,row_tile",
    [
        (16, 16, 8, 1, False, 8),
        (24, 16, 16, 2, True, 8),
        (20, 24, 16, 4, False, 8),  # H not a multiple of row_tile
        (16, 16, 8, 1, True, 4),
    ],
)
def test_plain_matches_jax_kernel_and_flax(H, W, C, heads, ln_bias, row_tile):
    x = np.random.RandomState(0).rand(2, H, W, C).astype(np.float32)
    flax_out, kernel_out, params = _jax_references(x, H, W, C, heads, ln_bias, row_tile)
    prefix = "encoder_level1.0."
    p = {k[len(prefix):]: v for k, v in state_dict_from_jax({"encoder_level1_0": params}).items()}
    before = _kernels.LAUNCHES[KEY]
    got = fused_transformer_block(_nchw(x), p, heads, ln_bias)
    assert _kernels.LAUNCHES[KEY] == before  # a CPU tensor takes the plain version
    assert got.is_contiguous(memory_format=torch.channels_last)
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, kernel_out, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, flax_out, atol=2e-5, rtol=1e-4)


def test_wrapper_on_cpu_launches_nothing():
    p = init_block_params(48, 1, False, seed=0)
    x = _nchw(np.random.RandomState(0).rand(1, 9, 7, 48).astype(np.float32))
    before = _kernels.LAUNCHES[KEY]
    got = fused_transformer_block(x, p, 1, False)
    assert _kernels.LAUNCHES[KEY] == before
    torch.testing.assert_close(got, fused_transformer_block_plain(x, p, 1, False), atol=0, rtol=0)


@pytest.mark.parametrize("fault", ["conv_bias", "not_channels_last", "float64"])
def test_wrapper_rejects(fault):
    p = init_block_params(16, 2, True, seed=0)
    x = _nchw(np.random.RandomState(0).rand(1, 8, 8, 16).astype(np.float32))
    err = ValueError
    if fault == "conv_bias":
        p["attn.qkv.bias"] = torch.zeros(48)
    elif fault == "not_channels_last":
        x = x.contiguous()
    else:
        x, err = x.double(), TypeError
    with pytest.raises(err):
        fused_transformer_block(x, p, 2, True)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,C,heads,H,W,ln_bias",
    [
        (2, 8, 1, 16, 16, False),
        (2, 16, 4, 20, 24, True),
        (2, 48, 1, 33, 17, False),   # h = 127, odd sizes everywhere
        (2, 96, 2, 24, 20, True),    # h = 255
        (1, 192, 4, 16, 16, False),  # h = 510
        (1, 384, 8, 8, 12, True),    # h = 1021
        (1, 256, 2, 8, 8, False),    # head width 128, the kernel's limit
    ],
)
def test_kernel_matches_plain_on_card(cuda_device, B, C, heads, H, W, ln_bias):
    p = {k: v.to(cuda_device) for k, v in init_block_params(C, heads, ln_bias, seed=C).items()}
    x = _nchw(np.random.RandomState(B * C).rand(B, H, W, C).astype(np.float32)).to(cuda_device)
    before = _kernels.LAUNCHES[KEY]
    with torch.inference_mode():
        got = fused_transformer_block(x, p, heads, ln_bias)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES[KEY] == before + 1
        with true_float32():
            want = fused_transformer_block_plain(x, p, heads, ln_bias)
    # float32 sums in another order than cuBLAS/cuDNN: unit-scale inputs
    torch.testing.assert_close(got, want, atol=5e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,heads,H,W,ln_bias", [(2, 48, 1, 33, 17, False),
                                                   (1, 384, 8, 8, 12, True)])
def test_kernel_repeats_bit_for_bit_on_card(cuda_device, B, C, heads, H, W, ln_bias):
    """The products (3xTF32 on the tensor cores), the Gram partials and
    their chunk-order sum take one order every run."""
    p = {k: v.to(cuda_device) for k, v in init_block_params(C, heads, ln_bias, seed=C).items()}
    x = _nchw(np.random.RandomState(C).rand(B, H, W, C).astype(np.float32)).to(cuda_device)
    with torch.inference_mode():
        first = fused_transformer_block(x, p, heads, ln_bias)
        again = fused_transformer_block(x, p, heads, ln_bias)
    assert torch.equal(first, again)
