// A GEMM on Hopper's tensor cores (sm_90a), hand-written, shared by K1
// (fused_block.cu), K6 (nss_prologue.cu) and K7 (nss_epilogue.cu), and behind
// the measurement entry points of tc_gemm.cu:
//
//   out[z*M + m, n] = epi( sum_k A'[z, m, k] * Wt[z, n, k] )
//
// A is (M, K) row-major with row stride lda, image z at A + z*a_batch; Wt is
// (N, K) row-major, a torch Linear or 1x1-conv weight as it is, one per image
// when w_batch != 0 (K1's folded projection). A' is A, or A under a per-row
// LayerNorm (LnPrologue). epi stores two neighbouring outputs of a row.
//
// Products, chosen by the precision tag Prec:
//
// F32x3 (float32 parity, the default). Each float32 operand x is split as
// hi = rna_tf32(x) and lo = rna_tf32(x - hi) (x - hi is exact; rna:
// cvt.rna.tf32.f32's round to nearest, ties away from zero), and a.b is taken as
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the two small products first, on
// mma.sync.m16n8k8 TF32 with float32 accumulators; a_lo.b_lo (2^-22 of a.b)
// is dropped. The result keeps float32 parity (tests/test_torch_gemm_split.py
// bounds the split's error; the card tests hold it to float64). No product is
// taken in plain TF32.
//
// Bf16 (the serving bodies of K6 and K7). Each operand is rounded to bf16 with
// cvt.rn.bf16x2.f32 (round to nearest even, as the JAX kernels'
// astype(bfloat16)) on its way from shared memory to the fragments, and each
// k16 step is one mma.sync.m16n8k16 bf16 product with float32 accumulators.
// A bf16 x bf16 product is exact in float32, so the result is the float32 sum
// of the rounded operands' products. The staged tiles stay float32.
//
// Bf16 operands (launch_tc_gemm_bf16, K1's serving body): A and W are bf16 in
// device memory (a product's operands stored already rounded), staged as
// bf16 tiles by 16-byte cp.async (8 values), fragments read by ldmatrix, one
// m16n8k16 bf16 mma.sync a k16 step with float32 accumulators. No operand is
// rounded here. Its own kernel, gemm_bf16_kernel: the F32x3 and Bf16
// instances above are not touched by it.
//
// What bounds it on this card: 3xTF32 costs three tensor-core products and
// the two splits, so its ceiling is the TF32 rate over 3 (494.7 / 3 TFLOP/s)
// and, with the splits on the ALU, below that; at K1's level 1 and K6's
// widths (K 48-384) a product moves 4 (K + N) bytes a row for 2 K N flops,
// so the short-K products sit near the 3.35 TB/s line and the rest on the
// tensor-core line. Bf16 issues a sixth of the mma instructions and no
// splits, but stages the same float32 tiles: at K 48-96 it is no faster
// than 3xTF32 (PERF.md); bf16 tiles, ldmatrix and wgmma are untried.
//
// Design:
//   * Block tile 128 x BN x 32, BN in {48, 96, 128} picked per call for the
//     fewest padded columns (N is 48-2042 here); 8 warps, 4 along M x 2 along
//     N, each 32 x BN/2 of m16n8 tiles.
//   * A 3-stage cp.async ring of A and W tiles in dynamic shared memory
//     (above 48 KB, cudaFuncSetAttribute), 16-byte copies where rows and
//     pointers allow it, else 4-byte ones (a row width that is not a
//     multiple of 4 floats), zero-filled past M, N and K. Row stride 36
//     floats, so the fragment reads (row g = lane / 4, column t = lane % 4)
//     hit 32 distinct banks.
//   * Fragment columns: m16n8k8 TF32 reads columns (t, t + 4) of a k8 step.
//     m16n8k16 bf16 packs k-slots (2t, 2t + 1) and (2t + 8, 2t + 9) into a
//     register; the core gives those slots the staged columns (t, t + 4) and
//     (t + 8, t + 12) of the k16 step, in A and W alike. The product's sum
//     over k is the same; the reads stay on 32 distinct banks.
//   * The LayerNorm is applied to A on its way from shared memory to the
//     fragments, with each row's (mean, rstd) read once into registers and
//     the LayerNorm weight and bias staged in shared memory.
//   * Blocks walk N tiles fastest, so the blocks that share an A tile run
//     together and read it from L2. They are not persistent: blocks that
//     walk many tiles with the ring running across tile boundaries measured
//     5-10% slower on K1 and K6 (PERF.md).
//
// Everything is in namespace tc; the caller defines its epilogue and launches
// through launch_tc_gemm.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tc {

// The precision tags: the k depth of one tensor-core step.
struct F32x3 {
  static constexpr int kStep = 8;
};
struct Bf16 {
  static constexpr int kStep = 16;
};

constexpr int kThreads = 256;
constexpr int kBM = 128, kBK = 32;
constexpr int kBKP = kBK + 4;  // row stride of a staged tile, in floats
constexpr int kStages = 3;

struct Args {
  const float* a;
  long long a_batch;
  int lda;
  const float* w;  // row stride K
  long long w_batch;
  int M, N, K;
};

// No prologue: A' = A. (The kernel reads a prologue's members only when
// kActive.)
struct NoPrologue {
  static constexpr bool kActive = false;
  static constexpr int smem_floats(int) { return 0; }
};

// LayerNorm over the K axis: A' = (A - mu) * rstd * w[k] + b[k], or, with
// sub_mean 0 (BiasFree), A * rstd * w[k]; row r's (mu, rstd) at stats[r],
// r = z*M + m. b may be null.
struct LnPrologue {
  static constexpr bool kActive = true;
  const float2* stats;
  const float* w;
  const float* b;
  int sub_mean;
  static constexpr int smem_floats(int kp) { return 2 * kp; }
  __device__ void stage(float* s, int kp, int K) const {
    for (int k = threadIdx.x; k < kp; k += blockDim.x) {
      s[k] = k < K ? w[k] : 0.f;
      s[kp + k] = (b != nullptr && k < K) ? b[k] : 0.f;
    }
  }
  __device__ float2 row(long long r) const {
    const float2 v = stats[r];
    return make_float2(sub_mean ? v.x : 0.f, v.y);
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo, both TF32, each rounded to nearest with ties away from zero.
// hi takes cvt.rna.tf32.f32's rounding in two integer ops (add half of the
// dropped 13 bits, clear them), the same bits for every x but NaN and
// cheaper than the conversion; lo = cvt.rna(x - hi) is NaN whenever x is, so
// a NaN still reaches the product.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// d += a . b on one m16n8k8 tile; a: rows (g, g+8) x columns (t, t+4), b:
// column g, rows (t, t+4)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16(lo) in the low half, bf16(hi) in the high half, each rounded to
// nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d += a . b on one m16n8k16 bf16 tile; a: register j holds row g + 8 (j & 1),
// k-slots 2t + 8 (j >> 1) + (0, 1); b: column g, k-slots 2t + (0, 1) and
// 2t + 8 + (0, 1)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One block: a 128 x BN output tile of image blockIdx.y; blockIdx.x walks the
// N tiles fastest, then the M tiles. VEC: floats a cp.async copies (4 or 1).
template <int BN, int VEC, class Prec, class Pro, class Epi>
__global__ void __launch_bounds__(kThreads, 2) gemm_kernel(Args p, Pro pro, Epi epi) {
  constexpr int NT = BN / 16;  // n8 tiles of a warp's BN / 2 columns
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                          // [kStages][kBM][kBKP]
  float* Ws = As + kStages * kBM * kBKP;     // [kStages][BN][kBKP]
  float* ext = Ws + kStages * BN * kBKP;     // the prologue's vectors

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int n_tiles = (p.N + BN - 1) / BN;
  const int n0 = (int)(blockIdx.x % n_tiles) * BN;
  const int m0 = (int)(blockIdx.x / n_tiles) * kBM;
  const int z = blockIdx.y;
  const float* A = p.a + z * p.a_batch;
  const float* W = p.w + z * p.w_batch;
  const int KT = (p.K + kBK - 1) / kBK;
  const int kp = KT * kBK;

  auto load_tile = [&](int kt, int slot) {
    const int k0 = kt * kBK;
    float* as = As + slot * kBM * kBKP;
    float* ws = Ws + slot * BN * kBKP;
    if constexpr (VEC == 4) {
#pragma unroll
      for (int i = 0; i < kBM * kBK / 4 / kThreads; ++i) {
        const int c = tid + i * kThreads, r = c >> 3, kc = (c & 7) * 4;
        const int m = m0 + r, k = k0 + kc;
        const bool ok = m < p.M && k < p.K;
        cp_async16(as + r * kBKP + kc, ok ? A + (long long)m * p.lda + k : A, ok);
      }
#pragma unroll
      for (int i = 0; i < (BN * kBK / 4 + kThreads - 1) / kThreads; ++i) {
        const int c = tid + i * kThreads;
        if (c < BN * kBK / 4) {
          const int r = c >> 3, kc = (c & 7) * 4;
          const int n = n0 + r, k = k0 + kc;
          const bool ok = n < p.N && k < p.K;
          cp_async16(ws + r * kBKP + kc, ok ? W + (long long)n * p.K + k : W, ok);
        }
      }
    } else {  // rolled: unrolled, the 4-byte copies' row pointers take ~64 registers
#pragma unroll 1
      for (int i = 0; i < kBM * kBK / kThreads; ++i) {
        const int c = tid + i * kThreads, r = c >> 5, kc = c & 31;
        const int m = m0 + r, k = k0 + kc;
        const bool ok = m < p.M && k < p.K;
        cp_async4(as + r * kBKP + kc, ok ? A + (long long)m * p.lda + k : A, ok);
      }
#pragma unroll 1
      for (int i = 0; i < BN * kBK / kThreads; ++i) {
        const int c = tid + i * kThreads, r = c >> 5, kc = c & 31;
        const int n = n0 + r, k = k0 + kc;
        const bool ok = n < p.N && k < p.K;
        cp_async4(ws + r * kBKP + kc, ok ? W + (long long)n * p.K + k : W, ok);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_tile(s, s);
    cp_async_commit();
  }

  // the prologue's per-row (mean or 0, rstd) of rows wm*32 + mi*16 + h*8 + g
  float2 rp[2][2];
  if constexpr (Pro::kActive) {
    pro.stage(ext, kp, p.K);  // read after the first barrier below
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + mi * 16 + h * 8 + g;
        rp[mi][h] = m < p.M ? pro.row((long long)z * p.M + m) : make_float2(0.f, 0.f);
      }
  }

  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
    {
      const int nk = kt + kStages - 1;
      if (nk < KT) load_tile(nk, nk % kStages);  // into tile kt - 1's slot
      cp_async_commit();
    }
    const int slot = kt % kStages;
    const float* as = As + slot * kBM * kBKP + wm * 32 * kBKP;
    const float* ws = Ws + slot * BN * kBKP + wn * (BN / 2) * kBKP;
    constexpr int kStep = Prec::kStep;
    constexpr int NC = kStep / 4;  // staged columns a thread reads a row: t + 4c
#pragma unroll
    for (int kk = 0; kk < kBK; kk += kStep) {
      float lw[NC], lb[NC];
      if constexpr (Pro::kActive) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          lw[c] = ext[kt * kBK + kk + t + 4 * c];
          lb[c] = ext[kp + kt * kBK + kk + t + 4 * c];
        }
      }
      // A' at row r of the warp's tile, staged column t + 4c of this step
      auto a_at = [&](int mi, int r, int c) {
        float v = as[(mi * 16 + r) * kBKP + kk + t + 4 * c];
        if constexpr (Pro::kActive) {
          const float2 q = rp[mi][r >> 3];
          v = fmaf((v - q.x) * q.y, lw[c], lb[c]);
        }
        return v;
      };
      if constexpr (std::is_same_v<Prec, Bf16>) {
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j) {  // row g + 8 (j & 1), columns t + 8 (j >> 1) + (0, 4)
            const int r = (j & 1) * 8 + g, c = 2 * (j >> 1);
            af[mi][j] = pack_bf16(a_at(mi, r, c), a_at(mi, r, c + 1));
          }
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const float* wr = ws + (ni * 8 + g) * kBKP + kk + t;
          const uint32_t b0 = pack_bf16(wr[0], wr[4]), b1 = pack_bf16(wr[8], wr[12]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], af[mi], b0, b1);
        }
      } else {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j)  // a_j: row g + 8 (j & 1), column t + 4 (j >> 1)
            split_tf32(a_at(mi, (j & 1) * 8 + g, j >> 1), ah[mi][j], al[mi][j]);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const float* wr = ws + (ni * 8 + g) * kBKP + kk + t;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(wr[0], bh0, bl0);
          split_tf32(wr[4], bh1, bl1);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_tf32(acc[mi][ni], al[mi], bh0, bh1);
            mma_tf32(acc[mi][ni], ah[mi], bl0, bl1);
            mma_tf32(acc[mi][ni], ah[mi], bh0, bh1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // c0, c1: row g, columns 2t, 2t + 1; c2, c3: row g + 8
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const int n = n0 + wn * (BN / 2) + ni * 8 + 2 * t;
      if (n >= p.N) continue;
      const bool two = n + 1 < p.N;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + mi * 16 + h * 8 + g;
        if (m < p.M)
          epi((long long)z * p.M + m, n, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1], two);
      }
    }
}

// The N tile with the fewest padded columns, the wider on a tie.
inline int pick_bn(int N) {
  int best = 128, waste = (N + 127) / 128 * 128 - N;
  const int narrower[2] = {96, 48};
  for (int bn : narrower) {
    const int w = (N + bn - 1) / bn * bn - N;
    if (w < waste) best = bn, waste = w;
  }
  return best;
}

template <int BN, int VEC, class Prec, class Pro, class Epi>
int launch_bn(const Args& p, int batch, const Pro& pro, const Epi& epi, cudaStream_t st) {
  const int kp = (p.K + kBK - 1) / kBK * kBK;
  const int smem = (int)sizeof(float) * (kStages * (kBM + BN) * kBKP + Pro::smem_floats(kp));
  auto kern = gemm_kernel<BN, VEC, Prec, Pro, Epi>;
  static int smem_set = 48 * 1024;  // the largest size asked for so far
  if (smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const long long tiles = (long long)((p.N + BN - 1) / BN) * ((p.M + kBM - 1) / kBM);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<dim3((unsigned)tiles, batch), kThreads, smem, st>>>(p, pro, epi);
  return (int)cudaGetLastError();
}

// Launch the product of p over `batch` images (gridDim.y) on st, in precision
// Prec (F32x3 or Bf16); returns the first CUDA error (0 = success).
// epi(row, n, v0, v1, two) stores output (row, n) and, when two, (row, n + 1);
// n is even.
template <class Prec = F32x3, class Pro, class Epi>
int launch_tc_gemm(const Args& p, int batch, const Pro& pro, const Epi& epi, cudaStream_t st) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || batch <= 0 || batch > 65535 || p.lda < p.K)
    return (int)cudaErrorInvalidValue;
  const bool v4 = p.K % 4 == 0 && p.lda % 4 == 0 && p.a_batch % 4 == 0 && p.w_batch % 4 == 0 &&
                  ((uintptr_t)p.a & 15) == 0 && ((uintptr_t)p.w & 15) == 0;
  switch (pick_bn(p.N)) {
    case 48:
      return v4 ? launch_bn<48, 4, Prec>(p, batch, pro, epi, st)
                : launch_bn<48, 1, Prec>(p, batch, pro, epi, st);
    case 96:
      return v4 ? launch_bn<96, 4, Prec>(p, batch, pro, epi, st)
                : launch_bn<96, 1, Prec>(p, batch, pro, epi, st);
    default:
      return v4 ? launch_bn<128, 4, Prec>(p, batch, pro, epi, st)
                : launch_bn<128, 1, Prec>(p, batch, pro, epi, st);
  }
}

// ---------------------------------------------------------------------------
// Bf16 operands: gemm_bf16_kernel (see the header note).
// ---------------------------------------------------------------------------

struct ArgsBf16 {
  const __nv_bfloat16* a;
  long long a_batch;
  int lda;
  const __nv_bfloat16* w;  // row stride K
  long long w_batch;
  int M, N, K;
};

constexpr int kBKH = kBK + 8;  // row stride of a staged bf16 tile: 80 bytes, ldmatrix rows on
                               // 8 distinct 16-byte bank groups

__device__ __forceinline__ void cp_async16b(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

// ldmatrix: lane l gives the address of row l % 8 of matrix l / 8; register j
// receives matrix j, each lane (row lane / 4, columns 2 (lane % 4) + (0, 1)),
// or with .trans (rows 2 (lane % 4) + (0, 1), column lane / 4)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(s));
}

// One block: a 128 x BN output tile of image blockIdx.y, N tiles fastest, as
// gemm_kernel; 8 warps, 4 along M x 2 along N, each 32 x BN/2.
template <int BN, class Epi>
__global__ void __launch_bounds__(kThreads, 2) gemm_bf16_kernel(ArgsBf16 p, Epi epi) {
  constexpr int NT = BN / 16;  // n8 tiles of a warp's BN / 2 columns
  extern __shared__ __align__(16) __nv_bfloat16 smem_h[];
  __nv_bfloat16* As = smem_h;                  // [kStages][kBM][kBKH]
  __nv_bfloat16* Ws = As + kStages * kBM * kBKH;  // [kStages][BN][kBKH]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int n_tiles = (p.N + BN - 1) / BN;
  const int n0 = (int)(blockIdx.x % n_tiles) * BN;
  const int m0 = (int)(blockIdx.x / n_tiles) * kBM;
  const int z = blockIdx.y;
  const __nv_bfloat16* A = p.a + z * p.a_batch;
  const __nv_bfloat16* W = p.w + z * p.w_batch;
  const int KT = (p.K + kBK - 1) / kBK;

  auto load_tile = [&](int kt, int slot) {  // 8 values a copy; K is a multiple of 8
    const int k0 = kt * kBK;
    __nv_bfloat16* as = As + slot * kBM * kBKH;
    __nv_bfloat16* ws = Ws + slot * BN * kBKH;
#pragma unroll
    for (int i = 0; i < kBM * kBK / 8 / kThreads; ++i) {
      const int c = tid + i * kThreads, r = c >> 2, kc = (c & 3) * 8;
      const int m = m0 + r, k = k0 + kc;
      const bool ok = m < p.M && k < p.K;
      cp_async16b(as + r * kBKH + kc, ok ? A + (long long)m * p.lda + k : A, ok);
    }
#pragma unroll
    for (int i = 0; i < (BN * kBK / 8 + kThreads - 1) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      if (c < BN * kBK / 8) {
        const int r = c >> 2, kc = (c & 3) * 8;
        const int n = n0 + r, k = k0 + kc;
        const bool ok = n < p.N && k < p.K;
        cp_async16b(ws + r * kBKH + kc, ok ? W + (long long)n * p.K + k : W, ok);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_tile(s, s);
    cp_async_commit();
  }

  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
    {
      const int nk = kt + kStages - 1;
      if (nk < KT) load_tile(nk, nk % kStages);
      cp_async_commit();
    }
    const int slot = kt % kStages;
    const __nv_bfloat16* as = As + slot * kBM * kBKH + wm * 32 * kBKH;
    const __nv_bfloat16* ws = Ws + slot * BN * kBKH + wn * (BN / 2) * kBKH;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // a: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15), registers a0..a3 of m16n8k16
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(af[mi], as + (mi * 16 + (lane & 15)) * kBKH + kk + 8 * (lane >> 4));
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        uint32_t b0, b1;  // columns n 0-7 of the tile, k 0-7 and 8-15
        ldsm_x2(b0, b1, ws + (ni * 8 + (lane & 7)) * kBKH + kk + 8 * ((lane >> 3) & 1));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], af[mi], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const int n = n0 + wn * (BN / 2) + ni * 8 + 2 * t;
      if (n >= p.N) continue;
      const bool two = n + 1 < p.N;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + mi * 16 + h * 8 + g;
        if (m < p.M)
          epi((long long)z * p.M + m, n, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1], two);
      }
    }
}

template <int BN, class Epi>
int launch_bf16_bn(const ArgsBf16& p, int batch, const Epi& epi, cudaStream_t st) {
  const int smem = (int)sizeof(__nv_bfloat16) * kStages * (kBM + BN) * kBKH;
  auto kern = gemm_bf16_kernel<BN, Epi>;
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const long long tiles = (long long)((p.N + BN - 1) / BN) * ((p.M + kBM - 1) / kBM);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<dim3((unsigned)tiles, batch), kThreads, smem, st>>>(p, epi);
  return (int)cudaGetLastError();
}

// The product of bf16 operands p over `batch` images on st; epi as for
// launch_tc_gemm. K, lda and the batch strides must be multiples of 8 and
// a, w 16-byte aligned.
template <class Epi>
int launch_tc_gemm_bf16(const ArgsBf16& p, int batch, const Epi& epi, cudaStream_t st) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || batch <= 0 || batch > 65535 || p.lda < p.K ||
      p.K % 8 || p.lda % 8 || p.a_batch % 8 || p.w_batch % 8 || ((uintptr_t)p.a & 15) ||
      ((uintptr_t)p.w & 15))
    return (int)cudaErrorInvalidValue;
  switch (pick_bn(p.N)) {
    case 48:
      return launch_bf16_bn<48>(p, batch, epi, st);
    case 96:
      return launch_bf16_bn<96>(p, batch, epi, st);
    default:
      return launch_bf16_bn<128>(p, batch, epi, st);
  }
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float2 load_f32x2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_f32x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_f32x2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store_f32x2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

// out[row * ldo + n] = v (+ resid[row * ldo + n]), out and resid float or
// bf16 (a bf16 residual is widened exactly, a bf16 output rounded to nearest
// even); pairs in one access when vec2 (ldo even, out and resid aligned to a
// pair).
template <class TOut, class TRes = TOut>
struct Store {
  TOut* out;
  const TRes* resid;  // may be null
  int ldo;
  int vec2;
  __device__ __forceinline__ void operator()(long long row, int n, float v0, float v1,
                                             bool two) const {
    const long long off = row * ldo + n;
    if (two && vec2) {
      float2 v = make_float2(v0, v1);
      if (resid) {
        const float2 r = load_f32x2(resid + off);
        v.x = r.x + v.x;
        v.y = r.y + v.y;
      }
      store_f32x2(out + off, v);
    } else {
      store_f32(out + off, resid ? load_f32(resid + off) + v0 : v0);
      if (two) store_f32(out + off + 1, resid ? load_f32(resid + off + 1) + v1 : v1);
    }
  }
};
using StoreOut = Store<float>;

template <class TOut, class TRes>
inline int pairs_aligned(const TOut* out, const TRes* resid, int ldo) {
  return (ldo % 2 == 0 && ((uintptr_t)out % (2 * sizeof(TOut))) == 0 &&
          ((uintptr_t)resid % (2 * sizeof(TRes))) == 0) ? 1 : 0;
}

inline int pairs_aligned(const float* out, const float* resid, int ldo) {
  return pairs_aligned<float, float>(out, resid, ldo);
}

}  // namespace tc
