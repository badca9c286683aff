// One Restormer TransformerBlock in float32 on Hopper (sm_90a), hand-written.
//
// Replaces: tpuir/ops/fused_block.py:fused_transformer_block (the Pallas TPU
// kernel, body _make_kernel). Same math, in this order, on a channels-last
// (NHWC in memory) float32 activation x of B images, H*W pixels, C channels:
//   y  = LN1(x)                          over channels, biased variance, eps 1e-5
//                                        (BiasFree: x*rstd*w, no mean in the numerator)
//   qkv = dw3x3(y . Wqkv^T)              1x1 C->3C, then zero-padded depthwise 3x3
//   per head: G = q^T k over all pixels, logits = G / (|q| (x) |k|) * temperature,
//             A = softmax(logits, last axis), |.| clamped at 1e-12
//   x2 = x + (v . A^T) . Wproj^T         computed as x + v . Mt_b^T with
//                                        Mt_b = Wproj . blockdiag(A_b): one C x C
//                                        weight per image, the same math in
//                                        another sum order
//   h1 = dw3x3(LN2(x2) . Win^T)          1x1 C->2h, depthwise 3x3
//   out = x2 + (gelu(h1[:h]) * h1[h:]) . Wout^T
//
// What bounds it on this card. Parity mode is float32 parity. The 1x1
// products take 24 C^2 of the block's flops a pixel (2 TFLOP a batch-8
// Restormer@256 forward); they run on the tensor cores in 3xTF32 (three TF32
// products a float32 product, tc_gemm.cuh), whose line is 494.7 / 3 TFLOP/s
// over 3.35 TB/s, about 49 flop/byte. A 1x1 product reads C and writes N
// floats a pixel for 2*C*N flops, about 0.4*C flop/byte here: under that
// line at C = 48 and 96, above it at C = 192 and 384. The depthwise convs,
// the LayerNorm statistics and the Gram pass are bytes-bound everywhere.
//
// What the design does about it, kept simple:
//   * The four 1x1 products (qkv, the folded projection, project_in,
//     project_out) run on the tensor-core GEMM core of tc_gemm.cuh (3xTF32
//     mma.sync, a cp.async ring). LayerNorm is applied to A on its way from
//     shared memory to the fragments, with each row's statistics computed
//     once by a small launch before it, and the residual add is in the
//     epilogue, so neither LN output nor the projection output makes a
//     separate trip to HBM. The gate's rows (h = 127 ... 1021 floats) are
//     stored padded to a multiple of 4 floats with zeros, and project_out's
//     weight is copied so padded, so that the core copies its operands 16
//     bytes at a time.
//   * The depthwise convs slide a 3x3 window along x (3 loads an output per
//     input channel), and the GELU gate is fused into the second one (2h in,
//     h out).
//   * Attention is folded into the projection (Mt above), so v . A^T is never
//     written out.
//   * The Gram sum over all pixels is split over pixel chunks into partials
//     and summed by a second pass in a fixed order: no float atomics, so the
//     result is the same on every run.
//   * The TPU kernel's halo ring, one-tile lag, row masks, lane packing and
//     row tiles exist for the TPU's sequential grid and are not carried over:
//     each launch here covers the whole batch and the convs read their zero
//     padding by bounds checks.
// Intermediates (qkv, x2, h1, the gate) still go through device memory; a
// later change that fuses the launches would remove those trips.
//
// The serving body (tpuir_fused_block_bf16) replaces the same TPU kernel
// built with mm_bf16=True, fast_gelu=True (_make_kernel's serving branches):
//   * x and out are bf16; x2 = x + ... stays float32; out = x2 + ... is
//     rounded to bf16 on its store;
//   * every product takes bf16 operands with float32 sums: the four 1x1
//     products, the Gram q . k^T (q's and k's squared norms taken from the
//     unrounded values) and the attention apply;
//   * attention is not folded into the projection, since at bf16 resolution
//     that rounds Mt instead of v, A and then v . A^T: ao = v . blockdiag(A_b)^T
//     with one C x C weight an image (the off-diagonal zeros are exact), then
//     x2 = x + ao . Wproj^T;
//   * LayerNorm takes the one-pass variance max(E[x^2] - mu^2, 0), and the
//     gate GELU's sigmoid form x * sigmoid(1.702 x) (expf, not __expf);
//   * the depthwise convs, the softmax and the residual sums stay float32.
// What bounds it: with its products at the tensor cores' bf16 rate (989
// TFLOP/s dense), the body's least time is its float32 rest (the depthwise
// convs, at 67 TFLOP/s), about 4 ms a batch-8 Restormer@256 forward. Its
// traffic is the other floor: this design moves about 51C bytes a pixel
// of a block (C channels; 154C with float32 intermediates and separate
// product and conv launches), 38 GB a forward, 11.4 ms at 3.35 TB/s.
// What the design does about it:
//   * bf16 wherever the JAX kernel rounds anyway: a value read only as a
//     product's operand is stored rounded (v, ao, the gate, q and k), and
//     the four weights are rounded to bf16 copies (round_weights_kernel);
//     x is read as bf16 (widening is exact);
//   * each 1x1 product that feeds a depthwise 3x3 (qkv, project_in) runs
//     fused with it in shared memory (conv_product_kernel): a block takes an
//     8 x 16 tile of output pixels, its LayerNorm'd, bf16 halo of 10 x 18
//     input pixels as A (kept for every channel slice it takes), each slice
//     of bf16 weight rows by cp.async, ldmatrix fragments and bf16 mma.sync,
//     and takes the float32 3x3 from the product tile in shared memory, its
//     rows outside the image zeroed as the JAX kernel's row_ok does (else
//     the LayerNorm bias would leak into the zero padding). No float32 qkv
//     product or h1 goes to device memory; q, k, v and the gate are stored
//     bf16, and q's and k's squared-norm partials an output tile from the
//     float32 values;
//   * the Gram on the tensor cores (gram_mma_kernel): bf16 q and k of a
//     pixel chunk staged in shared memory, fragments by ldmatrix.trans,
//     mma.sync m16n8k16, the chunk partials and the norm partials each
//     summed in a fixed order by a second pass (no float atomics, the same
//     result on every run);
//   * the three products whose A is stored bf16 (the apply, the projection,
//     project_out) on the core's bf16-operand kernel (tc_gemm.cuh).

// C interface (bound with ctypes, no PyTorch headers): every launch goes on
// the caller's stream, nothing is allocated or synchronised here, and the
// entry point returns the first cudaError_t it meets (0 = success).

#include <cuda_runtime.h>
#include <math.h>

#include "tc_gemm.cuh"

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// The products run on tc_gemm.cuh. BlockOut<G> is product G's store (1 qkv,
// 2 projection, 3 project_in, 4 project_out, 5 the serving body's attention
// apply), a type of its own so that a profile tells the products apart by
// kernel name: out[row * ldo + n] = v (+ resid[row * ldo + n]), each float or
// bf16.
// ---------------------------------------------------------------------------

template <int G, class TOut = float, class TRes = float>
struct BlockOut : tc::Store<TOut, TRes> {};

template <class T>
struct Id {  // keeps a parameter out of deduction, so that it may be nullptr
  using type = T;
};

template <int G, class Prec = tc::F32x3, class TRes = float, class TOut, class Pro>
int launch_product(const tc::Args& p, int batch, const Pro& pro, TOut* out,
                   const typename Id<TRes>::type* resid, int ldo, cudaStream_t st) {
  BlockOut<G, TOut, TRes> epi;
  epi.out = out;
  epi.resid = resid;
  epi.ldo = ldo;
  epi.vec2 = tc::pairs_aligned<TOut, TRes>(out, resid, ldo);
  return tc::launch_tc_gemm<Prec>(p, batch, pro, epi, st);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Per-row LayerNorm statistics over C channels, one warp a row: the mean,
// then 1/sqrt(biased variance + 1e-5), the variance by a second pass, as the
// parity reference, or (ONE_PASS, the serving body) as max(E[x^2] - mu^2, 0).
// Written once here instead of by every GEMM tile that reads the row.
template <bool ONE_PASS, class T>  // T: float, or bf16 (the serving body's x, widened exactly)
__global__ void __launch_bounds__(kThreads) ln_stats_kernel(
    const T* __restrict__ x, float2* __restrict__ stats, long long rows, int C) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const T* r = x + row * C;
  float s = 0.f, s2 = 0.f;
  for (int k = lane; k < C; k += 32) {
    const float v = tc::load_f32(r + k);
    s += v;
    if (ONE_PASS) s2 = fmaf(v, v, s2);
  }
  const float mu = warp_sum(s) / (float)C;
  float var;
  if (ONE_PASS) {
    var = fmaxf(fmaf(-mu, mu, warp_sum(s2) / (float)C), 0.f);  // one rounding, spelt out
  } else {
    float v = 0.f;
    for (int k = lane; k < C; k += 32) {
      const float d = tc::load_f32(r + k) - mu;
      v = fmaf(d, d, v);
    }
    var = warp_sum(v) / (float)C;
  }
  const float rs = 1.0f / sqrtf(var + 1e-5f);
  if (lane == 0) stats[row] = make_float2(mu, rs);
}

// ---------------------------------------------------------------------------
// Depthwise 3x3, zero padding, channels-last. w is (Cin, 1, 3, 3) as PyTorch
// keeps it. With a gate: Cin = 2*Cout and out = gelu(dw[c]) * dw[Cout + c],
// the exact GELU (the parity body; the serving body's gate is in
// conv_product_kernel). Output rows are ldo >= Cout floats; columns
// [Cout, ldo) are written as 0.
// ---------------------------------------------------------------------------

enum Gate { kNoGate = 0, kGeluExact = 1 };  // dwconv3x3_kernel<0|1>

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// x * sigmoid(1.702 x), with expf (the serving gate; the card checks hold it
// to the plain version's torch.sigmoid)
__device__ __forceinline__ float gelu_sigmoid(float v) {
  return v * (1.0f / (1.0f + expf(-1.702f * v)));
}

// Block (32 channels) x (8 runs of kDwRun pixels along x) of one image row;
// grid (B*H rows, x runs, channel tiles). Each thread slides a 3x3 window
// along its run: 3 loads a new column, and a warp's loads are 32
// consecutive channels of one pixel.
constexpr int kDwRun = 8;

template <int G>  // a Gate
__global__ void __launch_bounds__(kThreads) dwconv3x3_kernel(
    const float* __restrict__ in, const float* __restrict__ w, float* __restrict__ out,
    int H, int W, int Cin, int Cout, int ldo) {
  constexpr bool GATE = G != kNoGate;
  const int c = blockIdx.z * 32 + threadIdx.x;
  const int x0 = (blockIdx.y * blockDim.y + threadIdx.y) * kDwRun;
  const int row = blockIdx.x;  // b*H + y
  const int y = row % H;
  if (c >= ldo || x0 >= W) return;
  const long long img = (long long)(row - y) * W;  // first pixel of image b
  const int x_end = min(W, x0 + kDwRun);
  if (c >= Cout) {  // a pad column
    for (int x = x0; x < x_end; ++x) out[(img + (long long)y * W + x) * ldo + c] = 0.f;
    return;
  }

  float w0[9], w1[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    w0[t] = w[c * 9 + t];
    w1[t] = GATE ? w[(Cout + c) * 9 + t] : 0.f;
  }
  // window columns left / mid / right, rows y-1, y, y+1; *1: the gate's half
  float l0[3], m0[3], r0[3], l1[3], m1[3], r1[3];
  auto column = [&](int xx, float* v0, float* v1) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int yy = y + d - 1;
      const bool ok = xx >= 0 && xx < W && yy >= 0 && yy < H;
      const float* src = in + (img + (long long)yy * W + xx) * Cin + c;
      v0[d] = ok ? src[0] : 0.f;
      v1[d] = (GATE && ok) ? src[Cout] : 0.f;
    }
  };
  column(x0 - 1, l0, l1);
  column(x0, m0, m1);
  for (int x = x0; x < x_end; ++x) {
    column(x + 1, r0, r1);
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      s0 = fmaf(l0[d], w0[d * 3], s0);
      s0 = fmaf(m0[d], w0[d * 3 + 1], s0);
      s0 = fmaf(r0[d], w0[d * 3 + 2], s0);
      if (GATE) {
        s1 = fmaf(l1[d], w1[d * 3], s1);
        s1 = fmaf(m1[d], w1[d * 3 + 1], s1);
        s1 = fmaf(r1[d], w1[d * 3 + 2], s1);
      }
    }
    float o = s0;
    if (G == kGeluExact) o = gelu_exact(s0) * s1;
    out[(img + (long long)y * W + x) * ldo + c] = o;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      l0[d] = m0[d];
      m0[d] = r0[d];
      l1[d] = m1[d];
      m1[d] = r1[d];
    }
  }
}

// ---------------------------------------------------------------------------
// Channel attention statistics. qkv is (B, HW, 3C) channels-last, q | k | v,
// head-major inside each (the parity body; the serving body's Gram is
// gram_mma_kernel below). Pass 1: one block per (pixel chunk, head, image)
// writes its partial G (hc x hc), sum q^2 (hc) and sum k^2 (hc). Pass 2 sums
// the partials in chunk order, one thread an entry. Pass 3: one block per
// (head, image) normalises, applies the temperature and takes the row
// softmax.
// ---------------------------------------------------------------------------

constexpr int kGramChunk = 256;  // pixels per partial
constexpr int kGramTile = 32;    // pixels staged in shared memory at a time

template <int R>  // R = ceil(hc / 16); hc <= 128
__global__ void __launch_bounds__(kThreads) gram_partial_kernel(
    const float* __restrict__ qkv, float* __restrict__ part, int HW, int C, int heads,
    int nchunk) {
  extern __shared__ float sm[];
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hc = C / heads;
  float* qs = sm;
  float* ks = sm + kGramTile * hc;
  const int tid = threadIdx.x;
  const int tc = tid & 15, td = tid >> 4;
  float acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;
  float sq = 0.f;

  const float* base = qkv + (long long)b * HW * 3 * C + h * hc;
  const int p_begin = chunk * kGramChunk;
  const int p_end = min(HW, p_begin + kGramChunk);
  for (int p0 = p_begin; p0 < p_end; p0 += kGramTile) {
    for (int e = tid; e < kGramTile * hc; e += kThreads) {
      const int pp = e / hc, c = e - pp * hc;
      const int pix = p0 + pp;
      float qv = 0.f, kv = 0.f;
      if (pix < p_end) {
        const float* row = base + (long long)pix * 3 * C + c;
        qv = row[0];
        kv = row[C];
      }
      qs[e] = qv;
      ks[e] = kv;
    }
    __syncthreads();
    for (int pp = 0; pp < kGramTile; ++pp) {
      float qr[R], kr[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int c = tc + 16 * i;
        qr[i] = c < hc ? qs[pp * hc + c] : 0.f;
        const int d = td + 16 * i;
        kr[i] = d < hc ? ks[pp * hc + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] = fmaf(qr[i], kr[j], acc[i][j]);
    }
    if (tid < 2 * hc) {
      const float* src = tid < hc ? qs + tid : ks + (tid - hc);
      for (int pp = 0; pp < kGramTile; ++pp) sq = fmaf(src[pp * hc], src[pp * hc], sq);
    }
    __syncthreads();
  }

  float* out = part + (((long long)b * heads + h) * nchunk + chunk) * (hc * hc + 2 * hc);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = tc + 16 * i, d = td + 16 * j;
      if (c < hc && d < hc) out[c * hc + d] = acc[i][j];
    }
  if (tid < 2 * hc) out[hc * hc + tid] = sq;
}

// Sum the chunk partials in chunk order, one thread an entry of one
// (head, image): G, then |q| and |k| clamped at 1e-12.
__global__ void __launch_bounds__(kThreads) gram_reduce_kernel(
    const float* __restrict__ part, float* __restrict__ red, int C, int heads, int nchunk) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int hc = C / heads;
  const int stride = hc * hc + 2 * hc;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= stride) return;
  const long long bh = (long long)b * heads + h;
  const float* src = part + bh * nchunk * stride + e;
  float s = 0.f;
  for (int ch = 0; ch < nchunk; ++ch) s += src[(long long)ch * stride];
  red[bh * stride + e] = e < hc * hc ? s : fmaxf(sqrtf(s), 1e-12f);
}

__global__ void __launch_bounds__(kThreads) attn_softmax_kernel(
    const float* __restrict__ red, const float* __restrict__ temperature,
    float* __restrict__ attn, int C, int heads) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int hc = C / heads;
  const float* G = red + ((long long)b * heads + h) * (hc * hc + 2 * hc);
  const float* qn = G + hc * hc;
  const float* kn = qn + hc;
  const float t = temperature[h];
  float* A = attn + ((long long)b * heads + h) * hc * hc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = warp; c < hc; c += blockDim.x / 32) {
    float v[4];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = lane + 32 * i;
      v[i] = d < hc ? G[c * hc + d] / qn[c] / kn[d] * t : -INFINITY;
      mx = fmaxf(mx, v[i]);
    }
    mx = warp_max(mx);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = lane + 32 * i;
      v[i] = d < hc ? expf(v[i] - mx) : 0.f;
      s += v[i];
    }
    s = warp_sum(s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = lane + 32 * i;
      if (d < hc) A[c * hc + d] = v[i] / s;
    }
  }
}

// mt[b][o][d] = sum over c in head(d) of w_proj[o][c] * A_b[head(d)][c][d]:
// the projection with the image's attention folded in.
__global__ void __launch_bounds__(kThreads) fold_proj_kernel(
    const float* __restrict__ attn, const float* __restrict__ w_proj, float* __restrict__ mt,
    int C, int heads) {
  const int b = blockIdx.y;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= C * C) return;
  const int o = idx / C, d = idx - o * C;
  const int hc = C / heads;
  const int h = d / hc, h0 = h * hc, dl = d - h0;
  const float* A = attn + ((long long)b * heads + h) * hc * hc;
  const float* wr = w_proj + (long long)o * C + h0;
  float s = 0.f;
  for (int cl = 0; cl < hc; ++cl) s = fmaf(wr[cl], A[cl * hc + dl], s);
  mt[(long long)b * C * C + idx] = s;
}

template <class T>
int launch_ln_stats(const T* x, float2* stats, long long rows, int C, bool one_pass,
                    cudaStream_t st) {
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (one_pass)
    ln_stats_kernel<true, T><<<(unsigned)blocks, kThreads, 0, st>>>(x, stats, rows, C);
  else
    ln_stats_kernel<false, T><<<(unsigned)blocks, kThreads, 0, st>>>(x, stats, rows, C);
  return (int)cudaGetLastError();
}

// dst (rows, ldd) = src (rows, cols) with columns [cols, ldd) set to 0
__global__ void __launch_bounds__(kThreads) pad_rows_kernel(const float* __restrict__ src,
                                                            float* __restrict__ dst, int rows,
                                                            int cols, int ldd) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)rows * ldd) return;
  const int r = (int)(i / ldd), c = (int)(i - (long long)r * ldd);
  dst[i] = c < cols ? src[(long long)r * cols + c] : 0.f;
}

int launch_dwconv(const float* in, const float* w, float* out, int B, int H, int W, int Cin,
                  int Cout, int ldo, Gate gate, cudaStream_t st) {
  const dim3 block(32, kThreads / 32);
  const dim3 grid(B * H, (W + block.y * kDwRun - 1) / (block.y * kDwRun), (ldo + 31) / 32);
  if (gate == kGeluExact)
    dwconv3x3_kernel<kGeluExact><<<grid, block, 0, st>>>(in, w, out, H, W, Cin, Cout, ldo);
  else
    dwconv3x3_kernel<kNoGate><<<grid, block, 0, st>>>(in, w, out, H, W, Cin, Cout, ldo);
  return (int)cudaGetLastError();
}

int launch_gram(const float* qkv, float* part, int B, int HW, int C, int heads, int nchunk,
                cudaStream_t st) {
  const int hc = C / heads;
  dim3 grid(nchunk, heads, B);
  const size_t smem = 2 * kGramTile * hc * sizeof(float);
  switch ((hc + 15) / 16) {
#define TPUIR_GRAM_CASE(R)                                                    \
  case R:                                                                     \
    gram_partial_kernel<R>                                                    \
        <<<grid, kThreads, smem, st>>>(qkv, part, HW, C, heads, nchunk);      \
    break;
    TPUIR_GRAM_CASE(1)
    TPUIR_GRAM_CASE(2)
    TPUIR_GRAM_CASE(3)
    TPUIR_GRAM_CASE(4)
    TPUIR_GRAM_CASE(5)
    TPUIR_GRAM_CASE(6)
    TPUIR_GRAM_CASE(7)
    TPUIR_GRAM_CASE(8)
#undef TPUIR_GRAM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The per-head attention A (B, heads, hc, hc) from qkv (B, HW, 3C): Gram
// partials, their chunk-order sum, the normalised, tempered softmax.
int launch_attention(const float* qkv, float* partials, const float* temperature, float* attn,
                     int B, int HW, int C, int heads, cudaStream_t st) {
  const int hc = C / heads;
  const int nchunk = (HW + kGramChunk - 1) / kGramChunk;
  int err;
  if ((err = launch_gram(qkv, partials, B, HW, C, heads, nchunk, st))) return err;
  const int stride = hc * hc + 2 * hc;
  float* red = partials + (long long)B * heads * nchunk * stride;
  gram_reduce_kernel<<<dim3((stride + kThreads - 1) / kThreads, heads, B), kThreads, 0, st>>>(
      partials, red, C, heads, nchunk);
  if ((err = (int)cudaGetLastError())) return err;
  attn_softmax_kernel<<<dim3(heads, B), kThreads, 0, st>>>(red, temperature, attn, C, heads);
  return (int)cudaGetLastError();
}

// ===========================================================================
// The serving body's kernels.
// ===========================================================================

// The four weights rounded to bf16 copies: w_qkv (3C, C), w_proj (C, C),
// w_in (2h, C), and w_out (C, h) in rows of hp with zeros past h.
__global__ void __launch_bounds__(kThreads) round_weights_kernel(
    const float* __restrict__ w_qkv, const float* __restrict__ w_proj,
    const float* __restrict__ w_in, const float* __restrict__ w_out, __nv_bfloat16* __restrict__ wq16,
    __nv_bfloat16* __restrict__ wp16, __nv_bfloat16* __restrict__ wi16,
    __nv_bfloat16* __restrict__ wo16, int C, int hidden, int hp) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < 3LL * C * C) wq16[i] = __float2bfloat16_rn(w_qkv[i]);
  if (i < (long long)C * C) wp16[i] = __float2bfloat16_rn(w_proj[i]);
  if (i < 2LL * hidden * C) wi16[i] = __float2bfloat16_rn(w_in[i]);
  if (i < (long long)C * hp) {
    const int r = (int)(i / hp), c = (int)(i - (long long)r * hp);
    wo16[i] = __float2bfloat16_rn(c < hidden ? w_out[(long long)r * hidden + c] : 0.f);
  }
}

// ---------------------------------------------------------------------------
// conv_product_kernel: a 1x1 product under a LayerNorm, fused with the
// depthwise 3x3 that reads it (see the note at the top). qkv: 3C outputs, q,
// k and v stored bf16 and q's and k's squared norms summed an output tile;
// GATE (project_in): the 2h product columns in pairs (c, h + c), the
// sigmoid-GELU gate stored bf16 in rows of ldo = hp, zeros past h. out32,
// when not null (a check's run), gets the same values before their rounding.
// ---------------------------------------------------------------------------

constexpr int kTH = 8, kTW = 16;                    // output tile
constexpr int kHaloW = kTW + 2;                     // halo columns
constexpr int kHaloRows = (kTH + 2) * kHaloW;       // 180 halo pixels; the product takes 192
                                                    // rows (4 warps x 3 m16 tiles), the last
                                                    // 12 read from past A' and dropped
constexpr int kNP = 48;                             // product columns a slice: 2 warps x 3 n8
constexpr int kPS = kNP + 6;                        // row stride of the product tile, floats:
                                                    // a conv item's next run starts 16 or 24
                                                    // banks on, so a warp's two items do not
                                                    // share banks
constexpr int kRun = 8;                             // pixels a qkv conv item slides over
constexpr int kItems = kTH * (kTW / kRun);          // qkv conv items a channel (norm partials)
constexpr int kMaxServingC = 384;                   // the shared memory's limit (see below)

struct ConvProduct {
  const void* a;           // (rows, C): bf16 x (qkv) or float32 x2 (GATE)
  const float2* stats;     // the LayerNorm's (mean, rstd) a row
  const float* ln_w;
  const float* ln_b;       // null: BiasFree (no mean subtracted, no bias)
  const __nv_bfloat16* w;  // bf16 weight, (3C or 2h, C)
  const float* dw;         // depthwise weight, (3C or 2h, 9)
  __nv_bfloat16* out;      // qkv (rows, 3C) or gate (rows, ldo)
  float* out32;            // null, or the float32 values of out
  float* nrm;              // qkv: (B, tiles, 2C) squared-norm partials of q and k
  int H, W, C, hidden, ldo, slices, spb;
};

// shared bytes of a conv_product_kernel block: A' and W rows of C + 8 bf16,
// the float32 product tile, the LayerNorm vectors, the norm partials and two
// slices' depthwise weights
inline int conv_product_smem(int C) {
  return 2 * (kHaloRows + kNP) * (C + 8) +
         4 * (kHaloRows * kPS + 2 * C + kNP * kItems + 2 * kNP * 9);
}

template <class TA>
__device__ __forceinline__ void load8(const TA* src, float (&v)[8]);
template <>
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// Grid: (output tiles of an image, slice groups, images); block b's group
// takes slices [y * spb, min(slices, (y + 1) * spb)) of kNP product columns.
template <class TA, bool GATE>
__global__ void __launch_bounds__(kThreads, 2) conv_product_kernel(ConvProduct p) {
  constexpr int NS = GATE ? kNP / 2 : kNP;  // output channels a slice
  constexpr int RUN = GATE ? kRun / 2 : kRun;  // the gate: NS * kTH * kTW / RUN = 768 items too
  extern __shared__ __align__(16) unsigned char cp_smem[];
  const int C = p.C, CP = C + 8, CG = CP / 8;  // A' and W row stride; 8-value groups a row
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(cp_smem);  // [kHaloRows][CP]
  __nv_bfloat16* Ws = As + kHaloRows * CP;                         // [kNP][CP]
  float* Ps = reinterpret_cast<float*>(Ws + kNP * CP);             // [kHaloRows][kPS]
  float* lnv = Ps + kHaloRows * kPS;                               // weight [C], bias [C]
  float* nps = lnv + 2 * C;                                        // [kNP][kItems]
  float* dws = nps + kNP * kItems;                                 // [2][kNP][9], by slice

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int H = p.H, W = p.W;
  const int tiles_x = (W + kTW - 1) / kTW;
  const int y0 = (int)(blockIdx.x / tiles_x) * kTH, x0 = (int)(blockIdx.x % tiles_x) * kTW;
  const int b = blockIdx.z;
  const long long img = (long long)b * H * W;
  const int s_begin = blockIdx.y * p.spb, s_end = min(p.slices, s_begin + p.spb);
  const int n_out = GATE ? p.hidden : 3 * C;  // output channels

  // slice s's weight rows into Ws, zeros past C and past the weight's rows
  auto load_w = [&](int s) {
    for (int e = tid; e < kNP * CG; e += kThreads) {
      const int j = e / CG, k = (e - j * CG) * 8;
      int row;
      bool ok;
      if (GATE) {
        const int c = s * NS + (j % NS);
        ok = c < p.hidden;
        row = (j < NS ? 0 : p.hidden) + c;
      } else {
        row = s * NS + j;
        ok = row < n_out;
      }
      ok = ok && k < C;
      tc::cp_async16b(Ws + j * CP + k, ok ? p.w + (long long)row * C + k : p.w, ok);
    }
    for (int e = tid; e < kNP * 9; e += kThreads) {  // the rows' depthwise weights
      const int j = e / 9;
      const int row = GATE ? (j < NS ? 0 : p.hidden) + s * NS + (j % NS) : s * NS + j;
      const bool ok = GATE ? s * NS + (j % NS) < p.hidden : row < n_out;
      tc::cp_async4(dws + (s & 1) * kNP * 9 + e, ok ? p.dw + (long long)row * 9 + e % 9 : p.dw,
                    ok);
    }
    tc::cp_async_commit();
  };
  load_w(s_begin);

  for (int k = tid; k < C; k += kThreads) {
    lnv[k] = p.ln_w[k];
    lnv[C + k] = p.ln_b ? p.ln_b[k] : 0.f;
  }
  __syncthreads();

  // A' = bf16(LN(a)) on the halo, as the GEMM core's prologue computes it;
  // a pixel outside the image reads as zeros with statistics (0, 0). Four
  // groups of 8 values a thread are loaded before any is used.
  const TA* A = static_cast<const TA*>(p.a);
  constexpr int kBatch = 4;
  for (int e0 = tid; e0 < kHaloRows * CG; e0 += kBatch * kThreads) {
    float v[kBatch][8];
    float2 q[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      const int r = e / CG, k = (e - r * CG) * 8;
      const int yy = y0 - 1 + r / kHaloW, xx = x0 - 1 + r % kHaloW;
#pragma unroll
      for (int i = 0; i < 8; ++i) v[u][i] = 0.f;
      q[u] = make_float2(0.f, 0.f);
      if (e < kHaloRows * CG && k < C && yy >= 0 && yy < H && xx >= 0 && xx < W) {
        const long long row = img + (long long)yy * W + xx;
        load8(A + row * C + k, v[u]);
        q[u] = p.stats[row];
        if (!p.ln_b) q[u].x = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= kHaloRows * CG) break;
      const int r = e / CG, k = (e - r * CG) * 8;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (k < C) {
        uint32_t* pk = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pk[i] = tc::pack_bf16(
              fmaf((v[u][2 * i] - q[u].x) * q[u].y, lnv[k + 2 * i], lnv[C + k + 2 * i]),
              fmaf((v[u][2 * i + 1] - q[u].x) * q[u].y, lnv[k + 2 * i + 1],
                   lnv[C + k + 2 * i + 1]));
      }
      *reinterpret_cast<uint4*>(As + r * CP + k) = packed;
    }
  }

  const int tile = blockIdx.x;
  const int tiles = gridDim.x;
  for (int s = s_begin; s < s_end; ++s) {
    tc::cp_async_wait<0>();
    __syncthreads();  // W(s) and A' are in; every thread is done with the last slice's Ps, nps
                      // (so the product tile may be written as soon as the product is done)

    // the product: 192 x 48 x C, warps 4 along M (48 rows) x 2 along N (24 columns)
    float acc[3][3][4];
#pragma unroll
    for (int mi = 0; mi < 3; ++mi)
#pragma unroll
      for (int ni = 0; ni < 3; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
    const __nv_bfloat16* as = As + wm * 48 * CP;
    const __nv_bfloat16* ws = Ws + wn * 24 * CP;
    for (int k0 = 0; k0 < C; k0 += 16) {  // C + 8 >= C rounded up to 16; the pad is zero
      uint32_t af[3][4];
#pragma unroll
      for (int mi = 0; mi < 3; ++mi)
        tc::ldsm_x4(af[mi], as + (mi * 16 + (lane & 15)) * CP + k0 + 8 * (lane >> 4));
#pragma unroll
      for (int ni = 0; ni < 3; ++ni) {
        uint32_t b0, b1;
        tc::ldsm_x2(b0, b1, ws + (ni * 8 + (lane & 7)) * CP + k0 + 8 * ((lane >> 3) & 1));
#pragma unroll
        for (int mi = 0; mi < 3; ++mi) tc::mma_bf16(acc[mi][ni], af[mi], b0, b1);
      }
    }
    // the product tile, rows outside the image zeroed (the conv's zero padding)
#pragma unroll
    for (int mi = 0; mi < 3; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 48 + mi * 16 + h * 8 + g;
        if (r >= kHaloRows) continue;
        const int yy = y0 - 1 + r / kHaloW, xx = x0 - 1 + r % kHaloW;
        const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
#pragma unroll
        for (int ni = 0; ni < 3; ++ni) {
          const int n = wn * 24 + ni * 8 + 2 * t;
          *reinterpret_cast<float2*>(Ps + r * kPS + n) =
              in ? make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]) : make_float2(0.f, 0.f);
        }
      }
    __syncthreads();  // the product tile is in; every warp is done with W(s)
    if (s + 1 < s_end) load_w(s + 1);  // lands while this slice's conv runs

    // the 3x3 in today's fmaf order: item (channel c, tile row ty, run hx) slides
    // a window along RUN pixels of the row
    const float* dw = dws + (s & 1) * kNP * 9;
    for (int it = tid; it < NS * kTH * (kTW / RUN); it += kThreads) {
      const int c = it % NS, item = it / NS;
      const int ty = item / (kTW / RUN), hx = item - ty * (kTW / RUN);
      const int y = y0 + ty, xl = hx * RUN;  // xl: the run's first column in the tile
      const int ch = s * NS + c;             // output channel
      const bool part_qk = !GATE && ch < 2 * C;
      float nsq = 0.f;
      if (ch < n_out) {
        float w0[9], w1[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          w0[i] = dw[c * 9 + i];
          w1[i] = GATE ? dw[(NS + c) * 9 + i] : 0.f;
        }
        // window columns left / mid / right, rows y-1, y, y+1; *1: the gate's partner
        float l0[3], m0[3], r0[3], l1[3], m1[3], r1[3];
        auto column = [&](int hc, float* v0, float* v1) {  // hc: halo column
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const float* src = Ps + ((ty + d) * kHaloW + hc) * kPS + c;
            v0[d] = src[0];
            v1[d] = GATE ? src[NS] : 0.f;
          }
        };
        column(xl, l0, l1);
        column(xl + 1, m0, m1);
#pragma unroll
        for (int i = 0; i < RUN; ++i) {
          column(xl + i + 2, r0, r1);
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            s0 = fmaf(l0[d], w0[d * 3], s0);
            s0 = fmaf(m0[d], w0[d * 3 + 1], s0);
            s0 = fmaf(r0[d], w0[d * 3 + 2], s0);
            if (GATE) {
              s1 = fmaf(l1[d], w1[d * 3], s1);
              s1 = fmaf(m1[d], w1[d * 3 + 1], s1);
              s1 = fmaf(r1[d], w1[d * 3 + 2], s1);
            }
          }
          const int x = x0 + xl + i;
          if (y < H && x < W) {
            const long long px = img + (long long)y * W + x;
            if (GATE) {
              const float o = gelu_sigmoid(s0) * s1;
              p.out[px * p.ldo + ch] = __float2bfloat16_rn(o);  // the gate
              if (p.out32) p.out32[px * p.ldo + ch] = o;
            } else {
              const float o = s0;
              if (part_qk) {
                nsq = fmaf(o, o, nsq);  // the norm from the float32 value
                p.out[px * 3 * C + ch] = __float2bfloat16_rn(o);  // q, k: the Gram's operands
              } else {
                p.out[px * 3 * C + ch] = __float2bfloat16_rn(o);  // v: the apply's A
              }
              if (p.out32) p.out32[px * 3 * C + ch] = o;
            }
          }
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            l0[d] = m0[d];
            m0[d] = r0[d];
            l1[d] = m1[d];
            m1[d] = r1[d];
          }
        }
      } else if (GATE && ch < p.ldo) {  // a pad column of the gate's rows
        for (int i = 0; i < RUN; ++i) {
          const int x = x0 + xl + i;
          if (y < H && x < W) {
            const long long px = img + (long long)y * W + x;
            p.out[px * p.ldo + ch] = __float2bfloat16_rn(0.f);
            if (p.out32) p.out32[px * p.ldo + ch] = 0.f;
          }
        }
      }
      if (part_qk) nps[c * kItems + item] = nsq;
    }
    if (!GATE) {  // this tile's squared norms of q and k, the items summed in order
      __syncthreads();
      const int ch = s * NS + tid;
      if (tid < NS && ch < 2 * C) {
        float sum = 0.f;
        for (int i = 0; i < kItems; ++i) sum += nps[tid * kItems + i];
        p.nrm[((long long)b * tiles + tile) * 2 * C + ch] = sum;
      }
    }
  }
}

template <class TA, bool GATE>
int launch_conv_product(const ConvProduct& p0, int B, cudaStream_t st) {
  ConvProduct p = p0;
  const int ns = GATE ? kNP / 2 : kNP;
  const int n_out = GATE ? p.hidden : 3 * p.C;
  p.slices = (n_out + ns - 1) / ns;
  const long long tiles = (long long)((p.H + kTH - 1) / kTH) * ((p.W + kTW - 1) / kTW);
  // slice groups: enough blocks for 2 a card's SM, each group as many slices as that leaves
  // (more groups recompute the halo's A' more often; 4 a SM measured slower)
  const long long want = (2 * 132 + tiles * B - 1) / (tiles * B);
  const int groups = want < p.slices ? (int)want : p.slices;
  p.spb = (p.slices + groups - 1) / groups;
  const int gy = (p.slices + p.spb - 1) / p.spb;
  const int smem = conv_product_smem(p.C);
  auto kern = conv_product_kernel<TA, GATE>;
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  if (tiles > 0x7fffffffLL || gy > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  kern<<<dim3((unsigned)tiles, gy, B), kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The Gram on the tensor cores: one block per (pixel chunk, head, image)
// writes G's partial over the chunk's kGramChunk pixels, from bf16 q and k
// (rows of 3C, q | k | v) staged kGramSub pixels at a time with rows of HP + 8
// (HP = hc rounded up to 16, zeros past hc): G = q^T k, A = q^T as ldmatrix.trans
// fragments of the staged q, B = k likewise, mma.sync m16n8k16 with float32
// sums. Each warp takes 16 x 16 blocks warp, warp + 8, ... of G.
// ---------------------------------------------------------------------------

constexpr int kGramSub = 64;

template <int R>  // R = ceil(hc / 16)
__global__ void __launch_bounds__(kThreads) gram_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                                                            float* __restrict__ part, int HW,
                                                            int C, int heads, int nchunk) {
  constexpr int HP = 16 * R, QS = HP + 8;
  constexpr int NB = (R * R + 7) / 8;  // G's 16 x 16 blocks a warp, at most
  __shared__ __align__(16) __nv_bfloat16 qs[kGramSub * QS];
  __shared__ __align__(16) __nv_bfloat16 ks[kGramSub * QS];
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hc = C / heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool vec = hc % 8 == 0;  // rows of q and k start 16-byte aligned (C % 8 == 0)
  const __nv_bfloat16* base = qkv + (long long)b * HW * 3 * C + h * hc;
  const int p_begin = chunk * kGramChunk;
  const int p_end = min(HW, p_begin + kGramChunk);

  float acc[NB][2][4];
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int p0 = p_begin; p0 < p_end; p0 += kGramSub) {
    for (int e = tid; e < kGramSub * (HP / 8); e += kThreads) {
      const int pp = e / (HP / 8), c8 = (e - pp * (HP / 8)) * 8;
      const int pix = p0 + pp;
      uint4 qv = make_uint4(0u, 0u, 0u, 0u), kv = qv;
      if (pix < p_end && c8 < hc) {
        const __nv_bfloat16* row = base + (long long)pix * 3 * C + c8;
        if (vec) {
          qv = *reinterpret_cast<const uint4*>(row);
          kv = *reinterpret_cast<const uint4*>(row + C);
        } else {
          __nv_bfloat16* qh = reinterpret_cast<__nv_bfloat16*>(&qv);
          __nv_bfloat16* kh = reinterpret_cast<__nv_bfloat16*>(&kv);
          for (int i = 0; i < 8 && c8 + i < hc; ++i) {
            qh[i] = row[i];
            kh[i] = row[C + i];
          }
        }
      }
      *reinterpret_cast<uint4*>(qs + pp * QS + c8) = qv;
      *reinterpret_cast<uint4*>(ks + pp * QS + c8) = kv;
    }
    __syncthreads();
#pragma unroll
    for (int kp = 0; kp < kGramSub; kp += 16) {
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int blk = warp + 8 * i;
        if (blk < R * R) {  // warp-uniform
          const int bm = blk / R, bn = blk - bm * R;
          uint32_t a[4], bb[4];
          // a: (channels 0-7 | 8-15 of bm) x (pixels 0-7 | 8-15), registers a0..a3
          tc::ldsm_x4_trans(a, qs + (kp + (lane & 7) + 8 * (lane >> 4)) * QS + bm * 16 +
                                   8 * ((lane >> 3) & 1));
          // b: (pixels 0-7 | 8-15) x channels 0-7, then 8-15, of bn: b0, b1 of two n8 tiles
          tc::ldsm_x4_trans(bb, ks + (kp + (lane & 7) + 8 * ((lane >> 3) & 1)) * QS + bn * 16 +
                                    8 * (lane >> 4));
          tc::mma_bf16(acc[i][0], a, bb[0], bb[1]);
          tc::mma_bf16(acc[i][1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();
  }

  float* out = part + (((long long)b * heads + h) * nchunk + chunk) * hc * hc;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int blk = warp + 8 * i;
    if (blk >= R * R) continue;
    const int bm = blk / R, bn = blk - bm * R;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = bm * 16 + g + 8 * hh, d = bn * 16 + nt * 8 + 2 * t;
        if (c >= hc) continue;
        if (d < hc) out[c * hc + d] = acc[i][nt][2 * hh];
        if (d + 1 < hc) out[c * hc + d + 1] = acc[i][nt][2 * hh + 1];
      }
  }
}

// Sum the Gram's chunk partials in chunk order and the squared-norm partials
// in tile order, one thread an entry of one (head, image): G, then |q| and |k|
// clamped at 1e-12, in rows of hc * hc + 2 hc as the softmax reads them.
__global__ void __launch_bounds__(kThreads) gram_norms_reduce_kernel(
    const float* __restrict__ part, const float* __restrict__ nrm, float* __restrict__ red,
    int C, int heads, int nchunk, int tiles) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int hc = C / heads;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= hc * hc + 2 * hc) return;
  const long long bh = (long long)b * heads + h;
  float s = 0.f;
  if (e < hc * hc) {
    const float* src = part + bh * nchunk * hc * hc + e;
    for (int ch = 0; ch < nchunk; ++ch) s += src[(long long)ch * hc * hc];
    red[bh * (hc * hc + 2 * hc) + e] = s;
  } else {
    const int q = e - hc * hc;  // q's channels, then k's
    const int n = (q < hc ? 0 : C) + h * hc + q % hc;
    const float* src = nrm + (long long)b * tiles * 2 * C + n;
    for (int tl = 0; tl < tiles; ++tl) s += src[(long long)tl * 2 * C];
    red[bh * (hc * hc + 2 * hc) + e] = fmaxf(sqrtf(s), 1e-12f);
  }
}

// bd[b][n][k] = bf16(A_b[head][n - h0][k - h0]) where n and k lie in one head
// (h0 its first channel), else 0: the attention as one C x C bf16 weight an
// image, so that the core computes ao = v . blockdiag(A_b)^T.
__global__ void __launch_bounds__(kThreads) block_diag_kernel(const float* __restrict__ attn,
                                                              __nv_bfloat16* __restrict__ bd,
                                                              int C, int heads) {
  const int b = blockIdx.y;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= C * C) return;
  const int n = idx / C, k = idx - n * C;
  const int hc = C / heads;
  const int h = n / hc, h0 = h * hc;
  const float a =
      k / hc == h ? attn[((long long)b * heads + h) * hc * hc + (n - h0) * hc + (k - h0)] : 0.f;
  bd[(long long)b * C * C + idx] = __float2bfloat16_rn(a);
}

int launch_gram_mma(const __nv_bfloat16* qkv, float* part, int B, int HW, int C, int heads,
                    int nchunk, cudaStream_t st) {
  const int hc = C / heads;
  const dim3 grid(nchunk, heads, B);
  switch ((hc + 15) / 16) {
#define TPUIR_GRAM_MMA_CASE(R)                                                      \
  case R:                                                                           \
    gram_mma_kernel<R><<<grid, kThreads, 0, st>>>(qkv, part, HW, C, heads, nchunk); \
    break;
    TPUIR_GRAM_MMA_CASE(1)
    TPUIR_GRAM_MMA_CASE(2)
    TPUIR_GRAM_MMA_CASE(3)
    TPUIR_GRAM_MMA_CASE(4)
    TPUIR_GRAM_MMA_CASE(5)
    TPUIR_GRAM_MMA_CASE(6)
    TPUIR_GRAM_MMA_CASE(7)
    TPUIR_GRAM_MMA_CASE(8)
#undef TPUIR_GRAM_MMA_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// product G of the serving body on the core's bf16-operand kernel:
// out[row * ldo + n] = v (+ resid[row * ldo + n])
template <int G, class TRes = float, class TOut>
int launch_product_bf16(const tc::ArgsBf16& p, int batch, TOut* out,
                        const typename Id<TRes>::type* resid, int ldo, cudaStream_t st) {
  BlockOut<G, TOut, TRes> epi;
  epi.out = out;
  epi.resid = resid;
  epi.ldo = ldo;
  epi.vec2 = tc::pairs_aligned<TOut, TRes>(out, resid, ldo);
  return tc::launch_tc_gemm_bf16(p, batch, epi, st);
}

}  // namespace

extern "C" {

// Floats of the Gram scratch the entry point needs: the chunk partials,
// then their sums.
long long tpuir_fused_block_partials_numel(int B, int H, int W, int C, int heads) {
  const int hc = C / heads;
  const long long nchunk = ((long long)H * W + kGramChunk - 1) / kGramChunk;
  return (long long)B * heads * (nchunk + 1) * (hc * hc + 2 * hc);
}

const char* tpuir_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x, out: (B, H, W, C) channels-last float32. Weights as PyTorch keeps them:
// w_qkv (3C, C), dw_qkv (3C, 9), temperature (heads), w_proj (C, C),
// w_in (2h, C), dw_in (2h, 9), w_out (C, h); ln*_b may be null (BiasFree).
// Scratch: buf1 >= B*H*W*max(3C, 2h), buf2 >= B*H*W*max(3C, hp), x2 >= B*H*W*C,
// w_out_p >= C*hp, hp = h rounded up to a multiple of 4,
// partials >= tpuir_fused_block_partials_numel, attn >= B*C*C/heads, mt >= B*C*C,
// stats >= 2*B*H*W (16-byte aligned).
int tpuir_fused_block_f32(const float* x, float* out, const float* ln1_w, const float* ln1_b,
                          const float* ln2_w, const float* ln2_b, const float* w_qkv,
                          const float* dw_qkv, const float* temperature, const float* w_proj,
                          const float* w_in, const float* dw_in, const float* w_out,
                          float* buf1, float* buf2, float* x2, float* w_out_p,
                          float* partials, float* attn,
                          float* mt, float* stats, int B, int H, int W, int C, int heads,
                          int hidden,
                          int ln_bias, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int HW = H * W;
  const int hc = C / heads;
  if (B <= 0 || HW <= 0 || heads <= 0 || C % heads != 0 || hc > 128 || hidden <= 0 ||
      (long long)B * HW > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long hwl = HW;
  int err;

  float2* st2 = reinterpret_cast<float2*>(stats);

  // 1-3. qkv = dw3x3(LN1(x) . Wqkv^T) -> buf2
  if ((err = launch_ln_stats(x, st2, B * hwl, C, false, st))) return err;
  const int rows = B * HW;  // the products without per-image weights take the batch as rows
  const tc::LnPrologue ln1{st2, ln1_w, ln_bias ? ln1_b : nullptr, ln_bias};
  if ((err = launch_product<1>(tc::Args{x, 0, C, w_qkv, 0, rows, 3 * C, C}, 1, ln1, buf1,
                               nullptr, 3 * C, st)))
    return err;
  if ((err = launch_dwconv(buf1, dw_qkv, buf2, B, H, W, 3 * C, 3 * C, 3 * C, kNoGate, st)))
    return err;

  // 4-5. per-head Gram -> softmax -> A; fold A into the projection -> mt
  if ((err = launch_attention(buf2, partials, temperature, attn, B, HW, C, heads, st)))
    return err;
  fold_proj_kernel<<<dim3((C * C + kThreads - 1) / kThreads, B), kThreads, 0, st>>>(
      attn, w_proj, mt, C, heads);
  if ((err = (int)cudaGetLastError())) return err;

  // 6-7. x2 = x + v . mt_b^T
  if ((err = launch_product<2>(
           tc::Args{buf2 + 2 * C, hwl * 3 * C, 3 * C, mt, (long long)C * C, HW, C, C}, B,
           tc::NoPrologue{}, x2, x, C, st)))
    return err;

  // 8-11. gate = gelu(dw(h1)[:h]) * dw(h1)[h:], h1 = LN2(x2) . Win^T -> buf2, in rows of
  // hp floats with zeros past h, so that project_out's operands are 16-byte aligned
  if ((err = launch_ln_stats(x2, st2, B * hwl, C, false, st))) return err;
  const tc::LnPrologue ln2{st2, ln2_w, ln_bias ? ln2_b : nullptr, ln_bias};
  if ((err = launch_product<3>(tc::Args{x2, 0, C, w_in, 0, rows, 2 * hidden, C}, 1, ln2, buf1,
                               nullptr, 2 * hidden, st)))
    return err;
  const int hp = (hidden + 3) / 4 * 4;
  if ((err = launch_dwconv(buf1, dw_in, buf2, B, H, W, 2 * hidden, hidden, hp, kGeluExact, st)))
    return err;

  // 12. out = x2 + gate . Wout^T, over hp columns (w_out padded with zeros alike)
  pad_rows_kernel<<<(unsigned)(((long long)C * hp + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      w_out, w_out_p, C, hidden, hp);
  if ((err = (int)cudaGetLastError())) return err;
  return launch_product<4>(tc::Args{buf2, 0, hp, w_out_p, 0, rows, C, hp}, 1, tc::NoPrologue{},
                           out, x2, C, st);
}

// Floats of the serving body's squared-norm partials: (B, output tiles, 2C).
long long tpuir_fused_block_bf16_norms_numel(int B, int H, int W, int C) {
  return (long long)B * ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW) * 2 * C;
}

// The serving body (mm_bf16, fast_gelu): x, out (B, H, W, C) channels-last
// bf16, weights float32 as for tpuir_fused_block_f32; C a multiple of 8, at
// most kMaxServingC. Scratch: w16 (bf16) >= 3C*C + C*C + 2h*C + C*hp, hp = h
// rounded up to a multiple of 8; qkv16 (bf16) >= B*H*W*3C; act16 (bf16) >=
// B*H*W*max(C, hp) (ao, then the gate); x2 >= B*H*W*C; norms >=
// tpuir_fused_block_bf16_norms_numel; partials >= tpuir_fused_block_partials_numel
// (the Gram's chunk partials (B, heads, nchunk, hc*hc), then their sums and
// the norms (B, heads, hc*hc + 2hc)); attn >= B*C*C/heads; bd16 (bf16) >=
// B*C*C; stats >= 2*B*H*W (16-byte aligned); f32 >= B*H*W*max(3C, hp), or
// null. Every bf16 buffer 16-byte aligned.
// part 0 runs the whole body. Part 1 runs steps 1-5 and leaves LN1's (mean,
// rstd) in stats, q | k | v in qkv16 and their float32 values in f32, the
// norm partials, G's sums and the norms after the chunk partials, A in attn
// and ao in act16; part 2 then runs steps 6-9 on that scratch and leaves x2,
// LN2's statistics in stats, the gate in act16 and its float32 values in f32.
// The two parts let a check read every stage's output; part 0 writes no f32.
int tpuir_fused_block_bf16(const __nv_bfloat16* x, __nv_bfloat16* out, const float* ln1_w,
                           const float* ln1_b, const float* ln2_w, const float* ln2_b,
                           const float* w_qkv, const float* dw_qkv, const float* temperature,
                           const float* w_proj, const float* w_in, const float* dw_in,
                           const float* w_out, __nv_bfloat16* w16, __nv_bfloat16* qkv16,
                           __nv_bfloat16* act16, float* x2, float* norms, float* partials,
                           float* attn, __nv_bfloat16* bd16, float* stats, float* f32, int B,
                           int H, int W, int C, int heads, int hidden, int ln_bias, int part,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int HW = H * W;
  if (B <= 0 || HW <= 0 || heads <= 0 || C % heads != 0 || C / heads > 128 || C % 8 != 0 ||
      C > kMaxServingC || hidden <= 0 || (long long)B * HW > 0x7fffffffLL || part < 0 ||
      part > 2)
    return (int)cudaErrorInvalidValue;
  const int rows = B * HW, hc = C / heads;
  const int hp = (hidden + 7) / 8 * 8;
  float2* st2 = reinterpret_cast<float2*>(stats);
  if (part == 0) f32 = nullptr;
  int err;

  // 0. the weights rounded to bf16
  __nv_bfloat16 *wq16 = w16, *wp16 = wq16 + 3LL * C * C, *wi16 = wp16 + (long long)C * C,
                *wo16 = wi16 + 2LL * hidden * C;
  const long long nw = 3LL * C * C > 2LL * hidden * C ? 3LL * C * C : 2LL * hidden * C;
  round_weights_kernel<<<(unsigned)((nw + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      w_qkv, w_proj, w_in, w_out, wq16, wp16, wi16, wo16, C, hidden, hp);
  if ((err = (int)cudaGetLastError())) return err;

  if (part != 2) {
    // 1-2. q | k | v = bf16(dw3x3(bf16(LN1(x)) . bf16(Wqkv)^T)), and q's and k's squared-norm
    // partials, fused; LN1's statistics from the bf16 x
    if ((err = launch_ln_stats(x, st2, rows, C, true, st))) return err;
    const ConvProduct qkv{x, st2, ln1_w, ln_bias ? ln1_b : nullptr, wq16, dw_qkv, qkv16, f32,
                          norms, H, W, C, hidden, 3 * C, 0, 0};
    if ((err = launch_conv_product<__nv_bfloat16, false>(qkv, B, st))) return err;

    // 3-4. per head: G of bf16 q, k on the tensor cores -> sums, norms -> softmax -> A ->
    // bf16 blockdiag(A_b) -> bd16
    const int nchunk = (HW + kGramChunk - 1) / kGramChunk;
    const int tiles = ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
    if ((err = launch_gram_mma(qkv16, partials, B, HW, C, heads, nchunk, st))) return err;
    float* red = partials + (long long)B * heads * nchunk * hc * hc;
    gram_norms_reduce_kernel<<<dim3((hc * hc + 2 * hc + kThreads - 1) / kThreads, heads, B),
                               kThreads, 0, st>>>(partials, norms, red, C, heads, nchunk, tiles);
    if ((err = (int)cudaGetLastError())) return err;
    attn_softmax_kernel<<<dim3(heads, B), kThreads, 0, st>>>(red, temperature, attn, C, heads);
    if ((err = (int)cudaGetLastError())) return err;
    block_diag_kernel<<<dim3((C * C + kThreads - 1) / kThreads, B), kThreads, 0, st>>>(
        attn, bd16, C, heads);
    if ((err = (int)cudaGetLastError())) return err;

    // 5. ao = bf16(v . bd_b^T) -> act16
    const tc::ArgsBf16 v_bd{qkv16 + 2 * C, (long long)HW * 3 * C, 3 * C, bd16, (long long)C * C,
                            HW, C, C};
    if ((err = launch_product_bf16<5>(v_bd, B, act16, nullptr, C, st))) return err;
    if (part == 1) return 0;
  }

  // 6. x2 = x + ao . bf16(Wproj)^T
  if ((err = launch_product_bf16<2, __nv_bfloat16>(tc::ArgsBf16{act16, 0, C, wp16, 0, rows, C, C},
                                                   1, x2, x, C, st)))
    return err;

  // 7-8. gate = bf16(gelu_sigmoid(dw(h1)[:h]) * dw(h1)[h:]), h1 = bf16(LN2(x2)) . bf16(Win)^T,
  // fused -> act16, rows of hp
  if ((err = launch_ln_stats(x2, st2, rows, C, true, st))) return err;
  const ConvProduct ffn{x2, st2, ln2_w, ln_bias ? ln2_b : nullptr, wi16, dw_in, act16, f32,
                        nullptr, H, W, C, hidden, hp, 0, 0};
  if ((err = launch_conv_product<float, true>(ffn, B, st))) return err;

  // 9. out = bf16(x2 + gate . bf16(Wout)^T), over hp columns (Wout padded with zeros alike)
  return launch_product_bf16<4>(tc::ArgsBf16{act16, 0, hp, wo16, 0, rows, C, hp}, 1, out, x2, C,
                                st);
}

}  // extern "C"
