"""The port's ``maybe_trace`` (counterpart of ``tpuir.utils.profiling.maybe_trace``):
``TPUIR_TRACE_DIR`` makes the engine write a trace of its device pipeline
under ``engine_<model name>``; unset, the engine writes nothing. Runs on the
CPU with a tiny seeded Restormer.
"""

import os

import numpy as np
import pytest
import torch

from tpuir_torch.core.engine import InferenceModel, run_model_inference
from tpuir_torch.models.restormer import Restormer, init_state_dict
from tpuir_torch.utils.profiling import maybe_trace
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1, heads=(1, 2, 4, 8),
            layer_norm_bias=False)


def _model(name):
    net = Restormer(**TINY, fused=True)
    net.load_state_dict(init_state_dict(TINY, seed=0))
    return InferenceModel(name=name, net=net.eval(), device=torch.device("cpu"), patch_size=32,
                          patch_overlap=8, pad_factor=8, batch_size=4)


def _files(root):
    return [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs]


@pytest.mark.parametrize("env", [True, False], ids=["TPUIR_TRACE_DIR", "unset"])
def test_engine_traces_only_under_trace_dir(monkeypatch, tmp_path, env):
    if env:
        monkeypatch.setenv("TPUIR_TRACE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("TPUIR_TRACE_DIR", raising=False)
    img = (np.random.RandomState(0).rand(40, 36, 3) * 255).astype(np.uint8)
    out, _ = run_model_inference(_model("Tiny Restormer"), img)
    assert out.shape == img.shape and out.dtype == np.uint8
    if env:
        assert os.listdir(tmp_path) == ["engine_Tiny_Restormer"]
        traces = _files(tmp_path / "engine_Tiny_Restormer")
        assert traces and all(f.endswith(".pt.trace.json") for f in traces)
    else:
        assert _files(tmp_path) == []


def test_maybe_trace_argument_overrides_env(monkeypatch, tmp_path):
    monkeypatch.setenv("TPUIR_TRACE_DIR", str(tmp_path / "env"))
    with maybe_trace("region", trace_dir=str(tmp_path / "arg")):
        torch.ones(4).sum()
    assert _files(tmp_path / "arg" / "region") and not (tmp_path / "env").exists()
