"""The numerical design of the port's tensor-core GEMM core
(``tpuir_torch/csrc/tc_gemm.cuh``), on the CPU in NumPy.

The core takes each float32 product as three TF32 products (3xTF32):
x = hi + lo with hi = rna_tf32(x) and lo = rna_tf32(x - hi), and
a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, a_lo.b_lo dropped, accumulated in
float32. ``rna_tf32`` emulates ``cvt.rna.tf32.f32`` (10 mantissa bits kept,
round to nearest with ties away from zero), checked bit for bit on ties,
denormals and the infinities; for every input but NaN it is also what the
kernel's two integer ops for hi give (add 0x1000, clear the 13 low bits).
The split product is then held, at the K of K1's, K6's and K7's products,
to the card tests' tolerance against float64: summed exactly, and
accumulated in float32 in the core's order (eight k a step, the two small
products before the large one) with each step rounded to nearest or, as
tensor cores are reported to do, toward zero.
"""

import numpy as np
import pytest

# the card tests' tolerance for K1 against its plain version
# (tests/test_torch_fused_block.py): float32 sums in another order
ATOL, RTOL = 5e-5, 1e-4


def rna_tf32(x) -> np.ndarray:
    """cvt.rna.tf32.f32 on float32 bits: drop the 13 low mantissa bits,
    rounding to nearest with ties away from zero (a carry may raise the
    exponent, and out of the largest binade gives inf); NaN stays NaN."""
    x = np.asarray(x, np.float32)
    u = x.view(np.uint32)
    mag = ((u & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)) & np.uint32(0x7FFFE000)
    r = (mag | (u & np.uint32(0x80000000))).view(np.float32)
    return np.where(np.isnan(x), x, r)


def split_tf32(x):
    """(hi, lo), both TF32 values in float32: x = hi + lo + O(2^-22 |x|)."""
    x = np.asarray(x, np.float32)
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def _bits(u):
    return np.array(u, np.uint32).view(np.float32)


# (input bits, cvt.rna.tf32.f32's output bits)
CASES = [
    (0x3F800000, 0x3F800000),  # 1.0: already TF32
    (0x3F801000, 0x3F802000),  # 1 + 2^-11, a tie: away from zero (to even would give 1.0)
    (0xBF801000, 0xBF802000),  # its negative: away from zero
    (0x3F800FFF, 0x3F800000),  # just under the tie
    (0x3F801001, 0x3F802000),  # just over it
    (0x3F803000, 0x3F804000),  # a tie between odd and even TF32 values
    (0x3FFFF000, 0x40000000),  # a tie that carries into the exponent: 2.0
    (0x00001000, 0x00002000),  # a denormal tie
    (0x00000FFF, 0x00000000),  # a denormal rounding to zero
    (0x80001000, 0x80002000),  # a negative denormal tie
    (0x007FF000, 0x00800000),  # the largest denormals round up to the smallest normal
    (0x00000000, 0x00000000),  # +0
    (0x80000000, 0x80000000),  # -0
    (0x7F800000, 0x7F800000),  # +inf
    (0xFF800000, 0xFF800000),  # -inf
    (0x7F7FE000, 0x7F7FE000),  # the largest finite TF32 value
    (0x7F7FFFFF, 0x7F800000),  # the largest float32 rounds out of range: inf
]


@pytest.mark.parametrize("bits,want", CASES, ids=[f"{b:08x}" for b, _ in CASES])
def test_rna_tf32_bit_exact(bits, want):
    got = rna_tf32(_bits([bits])).view(np.uint32)[0]
    assert got == want, f"{bits:08x} -> {got:08x}, want {want:08x}"


def test_kernel_integer_rounding_is_rna_tf32():
    """The kernel rounds hi as (bits + 0x1000) & 0xffffe000 on all 32 bits:
    the same as cvt.rna.tf32.f32 for every input but NaN."""
    rng = np.random.RandomState(2)
    u = np.concatenate([rng.randint(0, 2 ** 32, 1_000_000, dtype=np.uint64).astype(np.uint32),
                        np.array([b for b, _ in CASES], np.uint32)])
    x = u.view(np.float32)
    keep = ~np.isnan(x)
    kernel = ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    assert np.array_equal(kernel[keep].view(np.uint32), rna_tf32(x[keep]).view(np.uint32))


def test_rna_tf32_keeps_nan():
    assert np.isnan(rna_tf32(np.float32(np.nan)))


def test_split_is_exact_where_it_must_be():
    """hi keeps 10 mantissa bits within half a TF32 ulp of x; x - hi is exact
    in float32, and x - (hi + lo) is below 2^-22 |x|."""
    rng = np.random.RandomState(0)
    x = (rng.randn(100_000) * np.exp(rng.uniform(-30, 30, 100_000))).astype(np.float32)
    hi, lo = split_tf32(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    x64 = x.astype(np.float64)
    assert (np.abs(x64 - hi) <= np.abs(x64) * 2.0 ** -11).all()
    assert np.array_equal((x - hi).astype(np.float64), x64 - hi.astype(np.float64))
    assert (np.abs(x64 - hi - lo) <= np.abs(x64) * 2.0 ** -22).all()


def _round_toward_zero(v: np.ndarray) -> np.ndarray:
    """float64 -> float32, truncated toward zero."""
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    return np.where(over, np.nextafter(r, np.float32(0)), r)


def split_product(a, w, accumulate=None):
    """a (M, K) . w (N, K)^T as the core takes it: 3xTF32, with the sum
    exact in float64 (accumulate None), or in float32 eight k a step in
    the core's order, each step rounded by ``accumulate`` (float64 ->
    float32); a step's products and their sum are exact, as the tensor
    cores take them."""
    ah, al = (t.astype(np.float64) for t in split_tf32(a))
    wh, wl = (t.astype(np.float64) for t in split_tf32(w))
    if accumulate is None:
        return al @ wh.T + ah @ wl.T + ah @ wh.T
    acc = np.zeros((a.shape[0], w.shape[0]), np.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        for x, y in ((al, wh), (ah, wl), (ah, wh)):
            acc = accumulate(acc.astype(np.float64) + x[:, s] @ y[:, s].T)
    return acc.astype(np.float64)


ACCUMULATE = {"exact": None, "float32 to nearest": lambda v: v.astype(np.float32),
              "float32 toward zero": _round_toward_zero}


@pytest.mark.parametrize("accumulate", list(ACCUMULATE))
# K1's and K6's product depths, then K7's out_proj depths (MaIRUNet's 192 and
# 768, MaIR-CDN's 234)
@pytest.mark.parametrize("K", [48, 96, 127, 180, 384, 1021, 192, 234, 768])
def test_split_product_within_card_tolerance(K, accumulate):
    """Unit-scale A, fan-in-scaled W (the card tests' operands): the 3xTF32
    product stays well inside atol 5e-5 + rtol 1e-4 of float64."""
    rng = np.random.RandomState(K)
    a = rng.randn(96, K).astype(np.float32)
    w = (rng.randn(64, K) / np.sqrt(K)).astype(np.float32)
    ref = a.astype(np.float64) @ w.astype(np.float64).T
    got = split_product(a, w, ACCUMULATE[accumulate])
    err = np.abs(got - ref)
    margin = float((err / (ATOL + RTOL * np.abs(ref))).max())  # 1.0 = at the tolerance
    print(f"K={K} {accumulate}: max|err| {err.max():.3e}, {margin:.4f} of the tolerance")
    assert margin < 0.5


def test_single_tf32_would_miss_the_tolerance():
    """Plain TF32 (hi.hi alone) misses the tolerance at these shapes: the
    reason the core takes three products."""
    rng = np.random.RandomState(1)
    a = rng.randn(96, 384).astype(np.float32)
    w = (rng.randn(64, 384) / np.sqrt(384)).astype(np.float32)
    ref = a.astype(np.float64) @ w.astype(np.float64).T
    hi = rna_tf32(a).astype(np.float64) @ rna_tf32(w).astype(np.float64).T
    assert (np.abs(hi - ref) > ATOL + RTOL * np.abs(ref)).any()
