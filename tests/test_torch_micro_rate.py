"""P1 in the port (the card's elementwise-rate probe): its plain version
against the JAX probe kernel (``benchmarks/micro_vpu.py:_probe_kernel``)
through ``pl.pallas_call`` in interpret mode, the wrapper's checks, the
scan floor's arithmetic, and the CUDA kernel against the plain version on a
card.

Importing ``benchmarks/micro_vpu.py`` sets JAX's compilation-cache
directory, so the JAX side rebuilds the call from the module's source: its
``_probe_kernel`` and the constants it reads, taken with ``ast`` and run in
a namespace of their own.
"""

import ast
import functools
import os

import numpy as np
import pytest
import torch

from tpuir_torch.ops import _kernels
from tpuir_torch.utils import micro_rate
from tpuir_torch.utils.micro_rate import probe, probe_plain
from tests.torch_threads import one_torch_thread  # noqa: F401

MICRO_VPU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "benchmarks", "micro_vpu.py")
RTOL = 1e-5  # float32 chains the two sides round alike; exp2's last bit may differ


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _jax_probe_kernel():
    """(_probe_kernel, its namespace) from micro_vpu.py's source, without
    running the module's top level."""
    import jax.numpy as jnp

    tree = ast.parse(open(MICRO_VPU).read())
    keep = [node for node in tree.body
            if (isinstance(node, ast.FunctionDef) and node.name == "_probe_kernel")
            or (isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Tuple) and {e.id for e in t.elts} & {"ROUNDS", "STREAMS"}
                for t in node.targets))]
    ns = {"jnp": jnp}
    exec(compile(ast.Module(body=keep, type_ignores=[]), MICRO_VPU, "exec"), ns)
    return ns["_probe_kernel"], ns


def _jax_ops():
    import jax.numpy as jnp

    # micro_vpu.py:main's three ops
    return {"mul": lambda v: v * 0.99, "fma": lambda v: 0.5 * v + 0.3,
            "exp2": lambda v: jnp.exp2(-v)}


@pytest.mark.parametrize("op", ["mul", "fma", "exp2"])
def test_plain_matches_jax_probe(op):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    kernel, ns = _jax_probe_kernel()
    assert (ns["ROUNDS"], ns["STREAMS"]) == (micro_rate.ROUNDS, micro_rate.STREAMS)
    blk = (16, 128)  # a small block of the JAX probe's (512, 128)
    x = np.random.RandomState(0).rand(micro_rate.STREAMS, *blk).astype(np.float32)
    call = pl.pallas_call(
        functools.partial(kernel, _jax_ops()[op]), grid=(1,),
        in_specs=[pl.BlockSpec((micro_rate.STREAMS,) + blk, lambda g: (0, 0, 0))],
        out_specs=pl.BlockSpec(blk, lambda g: (0, 0)),
        out_shape=jax.ShapeDtypeStruct(blk, jnp.float32), interpret=True)
    want = np.asarray(call(jnp.asarray(x)))
    before = dict(_kernels.LAUNCHES)
    got = probe(torch.from_numpy(x), op)
    assert _kernels.LAUNCHES == before  # a CPU tensor takes the plain version
    assert got.shape == blk
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("fault,err", [("op", ValueError), ("rounds", ValueError),
                                       ("streams", ValueError), ("float64", TypeError),
                                       ("other_device", ValueError)])
def test_wrapper_rejects(fault, err):
    x = torch.rand(micro_rate.STREAMS, 4, 8)
    op, rounds = "mul", 32
    if fault == "op":
        op = "div"
    elif fault == "rounds":
        rounds = -1
    elif fault == "streams":
        x = x[:4]
    elif fault == "float64":
        x = x.double()
    else:
        x = x.to("meta")
    with pytest.raises(err):
        probe(x, op, rounds)


def test_scan_floor_counts_cdn_updates():
    """The floor counts B * 4 * L * N * d_inner state updates of MaIR-CDN@128
    at batch 8, d_inner 234 unpadded, each 3 mul + 3 fma + 1 exp."""
    assert micro_rate.cdn_scan_shape() == (8, 128, 128, 234, 16, 12)
    updates = 8 * 4 * 128 * 128 * 16 * 234
    rates = {"mul": 1000.0, "fma": 500.0, "exp2": 250.0}  # Gelem/s
    want = updates * (3 / 1000 + 3 / 500 + 1 / 250) / 1e6
    assert micro_rate.scan_floor_ms(rates) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("updates", [0, 1_000_000])
def test_mufu_floor_counts_two_exp2_a_update(updates):
    """The three-pass scan's floor: passes 1 and 3 each take one exp2 a state
    update (MaIR-CDN@128's updates by default), at the exp2 rate alone."""
    rates = {"mul": 1000.0, "fma": 500.0, "exp2": 250.0}  # Gelem/s
    n = updates or 8 * 4 * 128 * 128 * 16 * 234
    assert micro_rate.cdn_scan_updates() == 8 * 4 * 128 * 128 * 16 * 234
    assert micro_rate.mufu_floor_ms(rates, updates) == pytest.approx(2 * n / 250 / 1e6,
                                                                     rel=1e-12)
    assert micro_rate.scan_floor_ms(rates, updates) == pytest.approx(
        n * (3 / 1000 + 3 / 500 + 1 / 250) / 1e6, rel=1e-12)


def test_mufu_floor_of_a_one_pass_scan_is_half():
    """K3's one-pass scan takes one exp2 a state update: half the three-pass floor."""
    rates = {"mul": 1000.0, "fma": 500.0, "exp2": 250.0}  # Gelem/s
    n = 8 * 7872 * 384 * 16  # K3 at MaIRUNet's level 3 of a 481x321 request
    assert micro_rate.mufu_floor_ms(rates, n, exps=1) == pytest.approx(n / 250 / 1e6, rel=1e-12)
    assert micro_rate.mufu_floor_ms(rates, n, exps=1) * 2 == pytest.approx(
        micro_rate.mufu_floor_ms(rates, n), rel=1e-12)


def test_scan_bench_needs_a_card(monkeypatch, capsys):
    from tpuir_torch.utils import scan_bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert scan_bench.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("regs,threads,smem,want", [
    (64, 512, 49152, 2),   # 16 warps at the 64-register cap: registers allow two
    (40, 128, 23424, 9),   # 4 warps: shared memory allows nine
    (32, 256, 0, 8),       # threads allow eight
    (16, 32, 0, 32),       # the ceiling of 32 blocks
])
def test_scan_bench_resident_blocks(regs, threads, smem, want):
    from tpuir_torch.utils import scan_bench

    assert scan_bench.resident_blocks(regs, threads, smem) == want


def test_scan_bench_reads_ptxas_registers(monkeypatch):
    """Registers by kernel from nvcc's -Xptxas=-v lines, the mangled names
    demangled and shortened as the profiler's names are."""
    from tpuir_torch.utils import scan_bench

    log = ("ptxas info    : Compiling entry function '_Z1fv' for 'sm_90a'\n"
           "ptxas info    : Used 40 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_Z1gv' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1gv\n"
           "ptxas info    : Used 64 registers\n")
    plain = {"_Z1fv": "void (anonymous namespace)::seq_scan_kernel<32>((anonymous "
                      "namespace)::SeqScanArgs)", "_Z1gv": "void tc::gemm_kernel<96, 4>(tc::Args)"}

    class Done:
        def __init__(self, names):
            self.stdout = "\n".join(plain[n] for n in names.split("\n"))

    monkeypatch.setattr(scan_bench.shutil, "which", lambda tool: "/bin/true")
    monkeypatch.setattr(scan_bench.subprocess, "run", lambda cmd, input, **kw: Done(input))
    assert scan_bench.ptxas_registers(log) == {"seq_scan_kernel<32>": 40,
                                               "tc::gemm_kernel<96, 4>": 64}
    assert scan_bench.ptxas_registers("") == {}


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["mul", "fma", "exp2"])
@pytest.mark.parametrize("rounds", [0, 1, 32, 37])
def test_kernel_matches_plain_on_card(cuda_device, op, rounds):
    x = torch.from_numpy(np.random.RandomState(1).rand(
        micro_rate.STREAMS, 512, 128).astype(np.float32)).to(cuda_device)
    before = _kernels.LAUNCHES["rate_probe"]
    got = probe(x, op, rounds)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["rate_probe"] == before + 1
    assert torch.equal(got, probe(x, op, rounds))
    torch.testing.assert_close(got, probe_plain(x, op, rounds), rtol=RTOL, atol=0)
