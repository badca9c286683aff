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
//   * x and out are bf16; x is widened to a float32 scratch once, for LN1's
//     statistics and the qkv product, and the projection's residual reads
//     the bf16 x as it is; out = x2 + ... is rounded to bf16 on its store,
//     x2 stays float32;
//   * every product takes bf16 operands with float32 sums (the core's Bf16
//     mode, which rounds A' and W on their way to the fragments): the four
//     1x1 products, the Gram q . k^T (q and k rounded in the Gram pass, their
//     squared norms taken from the unrounded values) and the attention apply;
//   * attention is not folded into the projection, since at bf16 resolution
//     that rounds Mt instead of v, A and then v . A^T: the core computes
//     ao = v . blockdiag(A_b)^T with one C x C weight an image (the off-diagonal
//     zeros are exact), then x2 = x + ao . Wproj^T;
//   * LayerNorm takes the one-pass variance max(E[x^2] - mu^2, 0), and the
//     gate GELU's sigmoid form x * sigmoid(1.702 x) (expf, not __expf);
//   * the depthwise convs, the softmax and the residual sums stay float32.
// What bounds it: with its products at the tensor cores' bf16 rate (989
// TFLOP/s dense), the body's least time is its float32 rest (the depthwise
// convs, at 67 TFLOP/s), about 4 ms a batch-8 Restormer@256 forward against
// 0.3 ms for its bf16 block IO. The kernel is far from that (PERF.md): its
// intermediates go through device memory, as the parity body's do, and the
// core stages float32 tiles.
//
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
template <bool ONE_PASS>
__global__ void __launch_bounds__(kThreads) ln_stats_kernel(
    const float* __restrict__ x, float2* __restrict__ stats, long long rows, int C) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const float* r = x + row * C;
  float s = 0.f, s2 = 0.f;
  for (int k = lane; k < C; k += 32) {
    s += r[k];
    if (ONE_PASS) s2 = fmaf(r[k], r[k], s2);
  }
  const float mu = warp_sum(s) / (float)C;
  float var;
  if (ONE_PASS) {
    var = fmaxf(fmaf(-mu, mu, warp_sum(s2) / (float)C), 0.f);  // one rounding, spelt out
  } else {
    float v = 0.f;
    for (int k = lane; k < C; k += 32) {
      const float d = r[k] - mu;
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
// the exact GELU (parity) or its sigmoid form (serving).
// Output rows are ldo >= Cout floats; columns [Cout, ldo) are written as 0.
// ---------------------------------------------------------------------------

enum Gate { kNoGate = 0, kGeluExact = 1, kGeluSigmoid = 2 };  // dwconv3x3_kernel<0|1|2>

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// x * sigmoid(1.702 x), with expf (the card checks hold it to the plain
// version's torch.sigmoid)
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
    if (G == kGeluSigmoid) o = gelu_sigmoid(s0) * s1;
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
// head-major inside each. Pass 1: one block per (pixel chunk, head, image)
// writes its partial G (hc x hc), sum q^2 (hc) and sum k^2 (hc); with BF16
// (the serving body) G sums the products of q and k rounded to bf16, the
// squared norms those of the unrounded values. Pass 2 sums
// the partials in chunk order, one thread an entry. Pass 3: one block per
// (head, image) normalises, applies the temperature and takes the row
// softmax.
// ---------------------------------------------------------------------------

constexpr int kGramChunk = 256;  // pixels per partial
constexpr int kGramTile = 32;    // pixels staged in shared memory at a time

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int R, bool BF16>  // R = ceil(hc / 16); hc <= 128
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
        if (BF16) {
          qr[i] = round_bf16(qr[i]);
          kr[i] = round_bf16(kr[i]);
        }
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

// bd[b][n][k] = A_b[head][n - h0][k - h0] where n and k lie in one head
// (h0 its first channel), else 0: the attention as one C x C weight an image,
// so that the core computes ao = v . blockdiag(A_b)^T (the serving body).
__global__ void __launch_bounds__(kThreads) block_diag_kernel(const float* __restrict__ attn,
                                                              float* __restrict__ bd, int C,
                                                              int heads) {
  const int b = blockIdx.y;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= C * C) return;
  const int n = idx / C, k = idx - n * C;
  const int hc = C / heads;
  const int h = n / hc, h0 = h * hc;
  bd[(long long)b * C * C + idx] =
      k / hc == h ? attn[((long long)b * heads + h) * hc * hc + (n - h0) * hc + (k - h0)] : 0.f;
}

// dst = src widened to float32, n values
__global__ void __launch_bounds__(kThreads) widen_kernel(const __nv_bfloat16* __restrict__ src,
                                                         float* __restrict__ dst, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) dst[i] = __bfloat162float(src[i]);
}

int launch_ln_stats(const float* x, float2* stats, long long rows, int C, bool one_pass,
                    cudaStream_t st) {
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (one_pass)
    ln_stats_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(x, stats, rows, C);
  else
    ln_stats_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(x, stats, rows, C);
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
  switch (gate) {
    case kGeluExact:
      dwconv3x3_kernel<kGeluExact><<<grid, block, 0, st>>>(in, w, out, H, W, Cin, Cout, ldo);
      break;
    case kGeluSigmoid:
      dwconv3x3_kernel<kGeluSigmoid><<<grid, block, 0, st>>>(in, w, out, H, W, Cin, Cout, ldo);
      break;
    default:
      dwconv3x3_kernel<kNoGate><<<grid, block, 0, st>>>(in, w, out, H, W, Cin, Cout, ldo);
  }
  return (int)cudaGetLastError();
}

template <bool BF16>
int launch_gram(const float* qkv, float* part, int B, int HW, int C, int heads, int nchunk,
                cudaStream_t st) {
  const int hc = C / heads;
  dim3 grid(nchunk, heads, B);
  const size_t smem = 2 * kGramTile * hc * sizeof(float);
  switch ((hc + 15) / 16) {
#define TPUIR_GRAM_CASE(R)                                                    \
  case R:                                                                     \
    gram_partial_kernel<R, BF16>                                              \
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
template <bool BF16>
int launch_attention(const float* qkv, float* partials, const float* temperature, float* attn,
                     int B, int HW, int C, int heads, cudaStream_t st) {
  const int hc = C / heads;
  const int nchunk = (HW + kGramChunk - 1) / kGramChunk;
  int err;
  if ((err = launch_gram<BF16>(qkv, partials, B, HW, C, heads, nchunk, st))) return err;
  const int stride = hc * hc + 2 * hc;
  float* red = partials + (long long)B * heads * nchunk * stride;
  gram_reduce_kernel<<<dim3((stride + kThreads - 1) / kThreads, heads, B), kThreads, 0, st>>>(
      partials, red, C, heads, nchunk);
  if ((err = (int)cudaGetLastError())) return err;
  attn_softmax_kernel<<<dim3(heads, B), kThreads, 0, st>>>(red, temperature, attn, C, heads);
  return (int)cudaGetLastError();
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
  if ((err = launch_attention<false>(buf2, partials, temperature, attn, B, HW, C, heads, st)))
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

// The serving body (mm_bf16, fast_gelu): x, out (B, H, W, C) channels-last
// bf16, weights float32 as for tpuir_fused_block_f32. Scratch: xf >= B*H*W*C
// (x widened, then x2), buf1 >= B*H*W*max(3C, 2h), buf2 >= B*H*W*max(3C, hp),
// w_out_p >= C*hp, partials >= tpuir_fused_block_partials_numel,
// attn >= B*C*C/heads, bd >= B*C*C, stats >= 2*B*H*W (16-byte aligned).
// part 0 runs the whole body. Part 1 runs steps 1-6 and leaves x widened in
// xf, LN1's (mean, rstd) in stats, qkv in buf2, the Gram sums and norms
// after the partials, A in attn and ao in buf1; part 2 then runs steps 7-12
// on that scratch and leaves x2 in xf, LN2's statistics in stats, h1 in buf1
// and the gate in buf2. The two parts let a check read every stage's output.
int tpuir_fused_block_bf16(const __nv_bfloat16* x, __nv_bfloat16* out, const float* ln1_w,
                           const float* ln1_b, const float* ln2_w, const float* ln2_b,
                           const float* w_qkv, const float* dw_qkv, const float* temperature,
                           const float* w_proj, const float* w_in, const float* dw_in,
                           const float* w_out, float* xf, float* buf1, float* buf2,
                           float* w_out_p, float* partials, float* attn, float* bd, float* stats,
                           int B, int H, int W, int C, int heads, int hidden, int ln_bias,
                           int part, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int HW = H * W;
  if (B <= 0 || HW <= 0 || heads <= 0 || C % heads != 0 || C / heads > 128 || hidden <= 0 ||
      (long long)B * HW > 0x7fffffffLL || part < 0 || part > 2)
    return (int)cudaErrorInvalidValue;
  const int rows = B * HW;
  const long long n = (long long)rows * C;
  float2* st2 = reinterpret_cast<float2*>(stats);
  int err;
  float* x2 = xf;

  if (part != 2) {
    // 1-3. qkv = dw3x3(LN1(x) . Wqkv^T) -> buf2, LN1 on x widened to xf
    widen_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(x, xf, n);
    if ((err = (int)cudaGetLastError())) return err;
    if ((err = launch_ln_stats(xf, st2, rows, C, true, st))) return err;
    const tc::LnPrologue ln1{st2, ln1_w, ln_bias ? ln1_b : nullptr, ln_bias};
    if ((err = launch_product<1, tc::Bf16>(tc::Args{xf, 0, C, w_qkv, 0, rows, 3 * C, C}, 1, ln1,
                                           buf1, nullptr, 3 * C, st)))
      return err;
    if ((err = launch_dwconv(buf1, dw_qkv, buf2, B, H, W, 3 * C, 3 * C, 3 * C, kNoGate, st)))
      return err;

    // 4-5. per-head Gram of bf16 q, k -> softmax -> A -> blockdiag(A_b) -> bd
    if ((err = launch_attention<true>(buf2, partials, temperature, attn, B, HW, C, heads, st)))
      return err;
    block_diag_kernel<<<dim3((C * C + kThreads - 1) / kThreads, B), kThreads, 0, st>>>(
        attn, bd, C, heads);
    if ((err = (int)cudaGetLastError())) return err;

    // 6. ao = v . bd_b^T -> buf1
    const tc::Args v_bd{buf2 + 2 * C, (long long)HW * 3 * C, 3 * C, bd, (long long)C * C, HW, C, C};
    if ((err = launch_product<5, tc::Bf16>(v_bd, B, tc::NoPrologue{}, buf1, nullptr, C, st)))
      return err;
    if (part == 1) return 0;
  }

  // 7. x2 = x + ao . Wproj^T -> xf (x's widened copy is dead)
  if ((err = launch_product<2, tc::Bf16, __nv_bfloat16>(
           tc::Args{buf1, 0, C, w_proj, 0, rows, C, C}, 1, tc::NoPrologue{}, x2, x, C, st)))
    return err;

  // 8-11. gate = gelu_sigmoid(dw(h1)[:h]) * dw(h1)[h:], h1 = LN2(x2) . Win^T -> buf2, rows
  // of hp floats
  if ((err = launch_ln_stats(x2, st2, rows, C, true, st))) return err;
  const tc::LnPrologue ln2{st2, ln2_w, ln_bias ? ln2_b : nullptr, ln_bias};
  if ((err = launch_product<3, tc::Bf16>(tc::Args{x2, 0, C, w_in, 0, rows, 2 * hidden, C}, 1,
                                         ln2, buf1, nullptr, 2 * hidden, st)))
    return err;
  const int hp = (hidden + 3) / 4 * 4;
  if ((err = launch_dwconv(buf1, dw_in, buf2, B, H, W, 2 * hidden, hidden, hp, kGeluSigmoid,
                           st)))
    return err;

  // 12. out = bf16(x2 + gate . Wout^T), over hp columns (w_out padded with zeros alike)
  pad_rows_kernel<<<(unsigned)(((long long)C * hp + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      w_out, w_out_p, C, hidden, hp);
  if ((err = (int)cudaGetLastError())) return err;
  return launch_product<4, tc::Bf16>(tc::Args{buf2, 0, hp, w_out_p, 0, rows, C, hp}, 1,
                                     tc::NoPrologue{}, out, x2, C, st);
}

}  // extern "C"
