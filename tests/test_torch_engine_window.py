"""The engine's in-flight window, its window crop and the engine split on the CPU.

``InferenceModel.forward_patches(..., max_in_flight)`` keeps up to that
many chunks un-fetched, as tpuir's engine does; on the CPU nothing is
pinned and each step has finished when it returns, so the output must be
the old loop's bit for bit at every window, and within 1 uint8 LSB of
tpuir's engine. ``engine.window_crop`` must be tpuir's full window cropped,
bit for bit. JAX is imported only on the reference side; the card test
skips here.
"""

import numpy as np
import pytest
import torch

from tpuir_torch.core import engine
from tpuir_torch.core.engine import InferenceModel, run_model_inference
from tpuir_torch.models.restormer import Restormer, init_state_dict
from tpuir_torch.utils import profiling
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1, heads=(1, 2, 4, 8),
            layer_norm_bias=False)
HOOKS = dict(patch_size=32, patch_overlap=8, pad_factor=8)
SHAPE_20_TILES = (96, 120)  # 4 x 5 tiles of 32 at stride 24
WINDOWS = (1, 2, 4, 8)


@pytest.fixture(scope="module")
def tiny_sd():
    return init_state_dict(TINY, seed=0)


def _model(sd, batch_size, device="cpu", fused=True):
    net = Restormer(**TINY, fused=fused)
    net.load_state_dict(sd)
    return InferenceModel(name="Restormer", net=net.to(device).eval(), device=torch.device(device),
                          batch_size=batch_size, **HOOKS)


def _image(h, w, seed):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


@pytest.mark.parametrize("batch_size", (8, 3))
def test_windows_agree_and_match_tpuir(tiny_sd, batch_size):
    """A 20-tile request at every window: bit-equal with each other, 1 LSB
    from tpuir's engine (as tests/test_torch_engine.py holds it)."""
    from tpuir.core.engine import InferenceModel as JaxInferenceModel
    from tpuir.core.engine import run_model_inference as jax_run
    from tpuir.core.tiling import tile_indices
    from tpuir.models import restormer as jres

    h, w = SHAPE_20_TILES
    _, hs, ws = tile_indices(h, w, HOOKS["patch_size"], HOOKS["patch_overlap"])
    assert len(hs) * len(ws) == 20
    model = _model(tiny_sd, batch_size)
    img = _image(h, w, seed=batch_size)
    outs = {m: run_model_inference(model, img, need_degradation=True, noise_level=25,
                                   max_in_flight=m)[0] for m in WINDOWS}
    for m in WINDOWS:
        assert np.array_equal(outs[m], outs[1]), m
    jmodel = JaxInferenceModel(
        name="Restormer",
        apply_fn=jres.Restormer(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                                layer_norm_bias=False).apply,
        params=jres.convert_state_dict({k: v.numpy() for k, v in tiny_sd.items()},
                                       (1, 1, 1, 1), 1, False, False),
        batch_size=batch_size, **HOOKS,
    )
    want, _ = jax_run(jmodel, img, need_degradation=True, noise_level=25)
    assert outs[4].shape == want.shape and outs[4].dtype == want.dtype == np.uint8
    assert np.abs(outs[4].astype(int) - want.astype(int)).max() <= 1


def test_cpu_window_is_the_old_loop_bit_for_bit(tiny_sd):
    """On the CPU the window degenerates to the loop the engine had: each
    chunk through ``step`` and straight back to the host."""
    model = _model(tiny_sd, 3)
    patches = np.random.RandomState(1).rand(10, 32, 40, 3).astype(np.float32)
    old = np.concatenate([
        model.step(torch.from_numpy(patches[off:off + 3]).permute(0, 3, 1, 2))
        .permute(0, 2, 3, 1).cpu().numpy() for off in range(0, 10, 3)])
    for m in WINDOWS:
        got = model.forward_patches(patches, max_in_flight=m)
        assert got.dtype == np.float32 and got.shape == old.shape
        assert np.array_equal(got, old), m


class _CountingNet(torch.nn.Module):
    """x -> x / 2, counting its calls and recording TF32's flags in each."""

    def __init__(self):
        super().__init__()
        self.calls, self.tf32 = 0, []

    def forward(self, x):
        self.calls += 1
        self.tf32.append((torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32))
        return x * 0.5


def _stub(batch_size=4, compute_dtype=None):
    net = _CountingNet()
    return net, InferenceModel(name="stub", net=net, device=torch.device("cpu"),
                               batch_size=batch_size, compute_dtype=compute_dtype)


@pytest.mark.parametrize("max_in_flight", WINDOWS)
@pytest.mark.parametrize("n", (17, 4, 1))
def test_window_bounds_unfetched_chunks_and_progress(max_in_flight, n):
    """At most ``max_in_flight`` chunks dispatched and not yet fetched at any
    time, the window filled where there are enough chunks; ``progress_cb``
    once a chunk, monotone, ending at n."""
    net, model = _stub()
    seen, unfetched = [], []

    def forward(x):
        unfetched.append(net.calls + 1 - len(seen))  # this chunk included
        return _CountingNet.forward(net, x)

    net.forward = forward
    patches = np.random.RandomState(n).rand(n, 6, 5, 3).astype(np.float32)
    out = model.forward_patches(patches, lambda done, total: seen.append((done, total)),
                                max_in_flight=max_in_flight)
    chunks = -(-n // 4)
    assert net.calls == chunks
    assert max(unfetched) == min(max_in_flight, chunks)
    assert [d for d, _ in seen] == [min(4 * (i + 1), n) for i in range(chunks)]
    assert all(t == n for _, t in seen)
    assert np.array_equal(out, patches * 0.5)


@pytest.mark.parametrize("bad", (0, -1))
def test_window_below_one_raises(bad):
    _, model = _stub()
    with pytest.raises(ValueError, match="max_in_flight"):
        model.forward_patches(np.zeros((3, 4, 4, 3), np.float32), max_in_flight=bad)
    with pytest.raises(ValueError, match="max_in_flight"):
        run_model_inference(model, _image(8, 8, 0), max_in_flight=bad)


@pytest.mark.parametrize("compute_dtype,pinned", [(None, True), ("float32", False)])
def test_true_float32_holds_while_each_chunk_is_enqueued(compute_dtype, pinned):
    """Parity pins TF32 off around every chunk's forward, whichever chunks
    are in flight, and restores the flags after; serving leaves them."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        net, model = _stub(batch_size=2, compute_dtype=compute_dtype)
        model.forward_patches(np.zeros((9, 4, 4, 3), np.float32), max_in_flight=4)
        assert net.tf32 == [(not pinned, not pinned)] * 5
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (
            True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("ps,ph,pw,c", [(2048, 720, 1280, 3), (768, 720, 768, 3),
                                        (256, 256, 256, 1), (128, 96, 72, 3)])
def test_window_crop_is_the_full_window_cropped(ps, ph, pw, c):
    from tpuir.core.tiling import gaussian_window

    got = engine.window_crop(ps, ph, pw, c)
    want = gaussian_window(ps, ps, c)[:ph, :pw]
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert not got.flags.writeable and engine.window_crop(ps, ph, pw, c) is got


def test_engine_split_serves_the_engines_output(tiny_sd):
    """``utils.profiling.engine_split`` makes the engine's calls: its output
    is ``run_model_inference``'s bit for bit, with every host step timed, at
    each window, the window's cache cold and warm."""
    model = _model(tiny_sd, 4)
    img = _image(*SHAPE_20_TILES, seed=3)
    want, _ = run_model_inference(model, img, need_degradation=True, noise_level=15)
    for mif, cold in ((1, True), (4, False), (2, False)):
        got, ms = profiling.engine_split(model, img, 15, mif, cold_window=cold)
        assert np.array_equal(got, want), mif
        assert set(ms) == set(profiling.HOST_STEPS) | {"wall"}
        assert all(v >= 0 for v in ms.values())
        assert ms["wall"] >= ms["forward_patches"]


def test_request_times_serves_through_the_entry_point(monkeypatch):
    """``utils.profiling.request_times`` serves the zoo model's request by
    ``run_model_inference`` and reads forward_patches' host wall from
    outside it, on the CPU at a small request (DnCNN, seeded checkpoint)."""
    route, _, sigma = profiling.ENGINE_REQUESTS["dncnn"]
    monkeypatch.setitem(profiling.ENGINE_REQUESTS, "dncnn", (route, (24, 20), sigma))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    res = profiling.request_times("dncnn", "parity", requests=3, device="cpu")
    assert len(res["wall_ms"]) == len(res["forward_patches_ms"]) == 3
    assert all(0 < f <= w for f, w in zip(res["forward_patches_ms"], res["wall_ms"]))
    assert res["request"] == [24, 20] and res["mpix_s"] > 0
    assert res["device"]["busy_ms"] == 0 and res["device"]["idle_share"] == 1.0


def test_device_split_reads_a_trace():
    """Copies, kernels, the union of the card's intervals and the idle share
    over the requests' annotations, from chrome-trace events (us)."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "engine request", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "engine request", "ts": 100, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": 10,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 15, "dur": 40},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 120, "dur": 30},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 140, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "ts": 190,
         "dur": 20},  # half outside the window
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 0, "dur": 200},
    ]
    res = profiling.device_split(events)
    assert res["h2d_ms"] == pytest.approx(0.010) and res["d2h_ms"] == pytest.approx(0.010)
    assert res["kernels_ms"] == pytest.approx(0.090)
    assert res["busy_ms"] == pytest.approx(0.095)  # 10-55, 120-160, 190-200
    assert res["window_ms"] == pytest.approx(0.200)
    assert res["idle_share"] == pytest.approx(1 - 95 / 200)


def test_profiled_requests_on_the_cpu_sees_no_card(monkeypatch):
    """Under the profiler on the CPU the requests' window is seen and the
    card does nothing: idle share 1, no figure under a device's name."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    res = profiling.profiled_requests(lambda: torch.ones(64, 64) @ torch.ones(64, 64))
    assert res["window_ms"] > 0 and res["busy_ms"] == 0 and res["idle_share"] == 1.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the window's pinned ring and events run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_windows_agree(cuda_device, tiny_sd):
    """On the card every window gives the same output bit for bit, over 7
    chunks (the pinned ring) and one (no ring), and agrees with the CPU
    within 1 LSB (plain blocks: the window is under test, not K1)."""
    img = _image(*SHAPE_20_TILES, seed=4)
    cpu, _ = run_model_inference(_model(tiny_sd, 3, fused=False), img, need_degradation=True, noise_level=25)
    for batch in (3, 20):
        model = _model(tiny_sd, batch, cuda_device, fused=False)
        outs = [run_model_inference(model, img, need_degradation=True, noise_level=25,
                                    max_in_flight=m)[0] for m in WINDOWS]
        assert all(np.array_equal(o, outs[0]) for o in outs), batch
        assert np.abs(cpu.astype(int) - outs[0].astype(int)).max() <= 1, batch
