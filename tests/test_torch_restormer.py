"""The port's Restormer against the Flax Restormer on the CPU, in both block
modes, and the weight carriers (state_dict_from_jax, init_state_dict).

Weights come from ``init_state_dict`` (numpy RandomState) in the released
checkpoints' layout and reach the JAX package through its own
``convert_state_dict``. JAX is imported only on the reference side.
"""

import functools

import numpy as np
import pytest
import torch

from tpuir_torch.models.restormer import Restormer, init_state_dict, state_dict_from_jax
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1, heads=(1, 2, 4, 8))
FULL = dict(dim=48, num_blocks=(4, 6, 6, 8), num_refinement_blocks=4, heads=(1, 2, 4, 8))


def _config(base, ln_bias, dual):
    return dict(base, inp_channels=6 if dual else 3, out_channels=3,
                layer_norm_bias=ln_bias, dual_pixel_task=dual)


def _numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _convert(config, sd):
    from tpuir.models import restormer as jres

    return jres.convert_state_dict(
        _numpy_sd(sd), config["num_blocks"], config["num_refinement_blocks"], False,
        config["layer_norm_bias"], config["dual_pixel_task"],
    )


@functools.lru_cache(maxsize=None)
def _flax_case(base_name, ln_bias, dual, h, w):
    """(input NHWC, Flax output NHWC, torch state dict) for one config."""
    import jax

    from tpuir.models import restormer as jres

    config = _config(TINY if base_name == "tiny" else FULL, ln_bias, dual)
    sd = init_state_dict(config, seed=0)
    model = jres.Restormer(
        inp_channels=config["inp_channels"], out_channels=3, dim=config["dim"],
        num_blocks=config["num_blocks"], num_refinement_blocks=config["num_refinement_blocks"],
        heads=config["heads"], layer_norm_bias=ln_bias, dual_pixel_task=dual,
    )
    x = np.random.RandomState(1).rand(1, h, w, config["inp_channels"]).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)(_convert(config, sd), x))
    return x, want, sd, config


def _port_forward(config, sd, x, fused):
    net = Restormer(**config, fused=fused)
    net.load_state_dict(sd)
    with torch.inference_mode():
        y = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("ln_bias,dual", [(False, False), (True, True)])
def test_tiny_restormer_matches_flax(ln_bias, dual, fused):
    x, want, sd, config = _flax_case("tiny", ln_bias, dual, 32, 24)
    got = _port_forward(config, sd, x, fused)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-3)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "kernel"])
def test_full_width_restormer_matches_flax(fused):
    x, want, sd, config = _flax_case("full", False, False, 40, 48)
    got = _port_forward(config, sd, x, fused)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("ln_bias,dual", [(False, False), (True, True)])
def test_state_dict_round_trip_exact(ln_bias, dual):
    config = _config(TINY, ln_bias, dual)
    sd = init_state_dict(config, seed=3)
    back = state_dict_from_jax(_convert(config, sd))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert back[k].shape == v.shape and torch.equal(back[k], v), k


def test_init_state_dict_full_config():
    """Seeded, loadable as it is, and the released width: 26,111,668 params."""
    config = dict(layer_norm_bias=False)
    sd = init_state_dict(config, seed=0)
    assert sum(v.numel() for v in sd.values()) == 26_111_668
    assert all(v.dtype == torch.float32 for v in sd.values())
    again = init_state_dict(config, seed=0)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    Restormer(**config).load_state_dict(sd)  # strict: every key, every shape
