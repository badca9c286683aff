"""The dependency-free torch checkpoint reader vs torch.save round-trips."""

import numpy as np
import pytest
from tests.torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")

from tpuir.weights.torch_pickle import load_torch_checkpoint


def _make_state_dict():
    torch.manual_seed(0)
    return {
        "conv.weight": torch.randn(4, 3, 3, 3),
        "conv.bias": torch.randn(4),
        "scale": torch.randn(()),
        "half": torch.randn(5).half(),
        "ints": torch.arange(6, dtype=torch.int64),
    }


def test_zip_format(tmp_path):
    sd = _make_state_dict()
    p = tmp_path / "ckpt.pth"
    torch.save(sd, p)
    loaded = load_torch_checkpoint(str(p))
    for k, v in sd.items():
        np.testing.assert_array_equal(loaded[k], v.float().numpy() if v.dtype == torch.float16 else v.numpy())


def test_zip_format_nested_and_noncontiguous(tmp_path):
    t = torch.randn(6, 8)
    obj = {"params": {"w": t.t()}, "iter": 7, "lst": [torch.randn(2)]}
    p = tmp_path / "nested.pth"
    torch.save(obj, p)
    loaded = load_torch_checkpoint(str(p))
    np.testing.assert_array_equal(loaded["params"]["w"], t.t().contiguous().numpy())
    assert loaded["iter"] == 7
    np.testing.assert_array_equal(loaded["lst"][0], obj["lst"][0].numpy())


def test_legacy_format(tmp_path):
    sd = _make_state_dict()
    p = tmp_path / "legacy.pt"
    torch.save(sd, p, _use_new_zipfile_serialization=False)
    loaded = load_torch_checkpoint(str(p))
    for k, v in sd.items():
        np.testing.assert_array_equal(
            loaded[k], v.float().numpy() if v.dtype == torch.float16 else v.numpy()
        )


def test_bfloat16_storage(tmp_path):
    t = torch.randn(16).bfloat16()
    p = tmp_path / "bf16.pth"
    torch.save({"t": t}, p)
    loaded = load_torch_checkpoint(str(p))
    np.testing.assert_array_equal(loaded["t"], t.float().numpy())
