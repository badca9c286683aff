// K6: the MaIR mixer's prologue on Hopper (sm_90a), hand-written, in float32
// parity and in serving precision.
//
// Replaces: tpuir/ops/nss_prologue.py:_forward (the Pallas TPU kernel, via
// mixer_prologue). Same math, on a channels-last (NHWC) float32 activation
// h of B images, H*W pixels, Dm channels (the block's LayerNorm output):
//   xz = h . W_in^T                   in_proj, Dm -> 2*Di, no bias, [x | z]
//   x  = silu(dw3x3(xz[:, :Di]) + b)  depthwise 3x3, zero padding, then bias
//   z  = xz[:, Di:]                   the gate half, untouched
// and returns x and z as two (B, H, W, Di) tensors. The TPU kernel's lane
// padding of Di to 256, its transposed copy x^T (the stripe kernel's
// column-direction operand), its halo rows and row blocks are TPU layouts:
// none of them has a counterpart here.
//
// What bounds it on this card. At MaIR-CDN@128, batch 8 (M = 131,072
// pixels, Dm = 180, Di = 234) in_proj is 22.1 GFLOP and the whole function
// must move 340 MB (h in; x, z out). On the tensor cores in 3xTF32 (three
// TF32 products a float32 product, 494.7 / 3 TFLOP/s) in_proj needs 0.13 ms
// and the bytes 0.10 ms, so the function sits near both lines; on the
// float32 FMA line (67 TFLOP/s) it would need 0.33 ms. The depthwise conv
// (0.5 GFLOP) is bound by bytes.
//
// What the design does about it:
//   * in_proj runs on the tensor-core GEMM core of tc_gemm.cuh (3xTF32
//     mma.sync, cp.async ring), whose epilogue writes the x half to a
//     scratch image and the z half to its own output as float2 pairs, so no
//     split copy follows.
//   * The depthwise conv slides a 3x3 window along x (3 loads an output, a
//     warp's loads are 32 consecutive channels of one pixel), with the bias
//     and SiLU in its store; it reads the x half right behind the GEMM,
//     mostly from L2.
// The x half still makes one round trip between the two launches; fusing the
// conv into the GEMM's epilogue would need a halo of rows a tile.
//
// The serving body (tpuir_mixer_prologue_bf16; the TPU kernel with
// serving=True) rounds h and W_in to bf16 (nearest even) and sums in_proj's
// products in float32; the conv, its bias and the SiLU run in float32 on the
// float32 product, and x and z are stored rounded to bf16. What bounds it: at
// MaIR-CDN@128, batch 8, it must move 216 MB (h in float32, x and z out in
// bf16, the weights), 0.065 ms at 3.35 TB/s; in_proj at the bf16 tensor-core
// rate takes 0.022 ms and the conv's float32 operations less. Bytes, then.
// What the design does about it: one kernel, prologue_bf16_kernel, after a
// small launch that rounds W_in to a bf16 copy (tc::round_rows_bf16):
//   * a block takes an 8 x 16 tile of output pixels and keeps bf16(h) of its
//     10 x 18 halo in shared memory as A (pixels outside the image zeros, so
//     their products are the conv's zero padding), read from device memory
//     once a block;
//   * it walks slices of 32 in_proj columns, each slice's bf16 weight rows
//     brought in by cp.async while the slice before finishes, fragments by
//     ldmatrix and bf16 mma.sync with float32 sums;
//   * an x-half slice takes the product over all 180 halo pixels into a
//     float32 tile in shared memory and runs the 3x3 there in the parity
//     body's fmaf order, then the bias and SiLU, storing x as bf16;
//   * a z-half slice takes the product over the tile's own 128 pixels only
//     (ldmatrix gathers their rows out of the halo's) and stores z as bf16
//     from the accumulators.
// No float32 x half goes to device memory: xpre is written only where the
// caller passes it (a check's run).
//
// C interface (ctypes, no PyTorch headers): launches go on the caller's
// stream, nothing is allocated or synchronised, the first cudaError_t met
// is returned (0 = success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_gemm.cuh"

namespace {

// Columns [0, di) of the in_proj output to x, [di, 2*di) to z, float32 (TZ;
// this and the conv's TO are template parameters so that the parity body's
// kernels keep the names utils/sass_diff.py pairs across trees); a pair
// (n, n + 1), n even, in one access when di is even (the pair then lies in
// one half, aligned).
template <class TZ>
struct SplitXZ {
  float* x;
  TZ* z;
  int di;
  __device__ __forceinline__ void one(long long m, int n, float v) const {
    if (n < di)
      x[m * di + n] = v;
    else
      tc::store_f32(z + m * di + (n - di), v);
  }
  __device__ __forceinline__ void operator()(long long m, int n, float v0, float v1,
                                             bool two) const {
    if (two && (di & 1) == 0) {
      if (n < di)
        tc::store_f32x2(x + m * di + n, make_float2(v0, v1));
      else
        tc::store_f32x2(z + m * di + (n - di), make_float2(v0, v1));
    } else {
      one(m, n, v0);
      if (two) one(m, n + 1, v1);
    }
  }
};

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

constexpr int kDwThreads = 256;
constexpr int kDwRun = 8;  // outputs a thread slides its window over

// out = silu(dw3x3(in) + b), channels-last (B, H, W, C), w (C, 1, 3, 3);
// out float32 (TO).
// Block: 32 channels x 8 runs of kDwRun pixels along x of one image row;
// grid (B*H rows, x runs, channel tiles).
template <class TO>
__global__ void __launch_bounds__(kDwThreads) dwconv3x3_bias_silu_kernel(
    const float* __restrict__ in, const float* __restrict__ w, const float* __restrict__ bias,
    TO* __restrict__ out, int H, int W, int C) {
  const int c = blockIdx.z * 32 + threadIdx.x;
  const int x0 = (blockIdx.y * blockDim.y + threadIdx.y) * kDwRun;
  const int row = blockIdx.x;  // b*H + y
  const int y = row % H;
  if (c >= C || x0 >= W) return;
  const long long img = (long long)(row - y) * W;  // first pixel of image b

  float wk[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) wk[t] = w[c * 9 + t];
  const float bc = bias[c];
  float l[3], m[3], r[3];  // window columns left / mid / right, rows y-1, y, y+1
  auto column = [&](int xx, float* v) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int yy = y + d - 1;
      const bool ok = xx >= 0 && xx < W && yy >= 0 && yy < H;
      v[d] = ok ? in[(img + (long long)yy * W + xx) * C + c] : 0.f;
    }
  };
  column(x0 - 1, l);
  column(x0, m);
  const int x_end = min(W, x0 + kDwRun);
  for (int x = x0; x < x_end; ++x) {
    column(x + 1, r);
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      s = fmaf(l[d], wk[d * 3], s);
      s = fmaf(m[d], wk[d * 3 + 1], s);
      s = fmaf(r[d], wk[d * 3 + 2], s);
    }
    tc::store_f32(out + (img + (long long)y * W + x) * C + c, silu(s + bc));
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      l[d] = m[d];
      m[d] = r[d];
    }
  }
}

// The parity body: in_proj on the core, then the conv; x and z float32.
int prologue_f32(const float* h, const float* w_in, const float* conv_w, const float* conv_b,
                 float* xpre, float* x, float* z, int B, int H, int W, int Dm, int Di,
                 cudaStream_t st) {
  if (B <= 0 || H <= 0 || W <= 0 || Dm <= 0 || Di <= 0) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  if (M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const tc::Args p{h, 0, Dm, w_in, 0, (int)M, 2 * Di, Dm};
  int err = tc::launch_tc_gemm(p, 1, tc::NoPrologue{}, SplitXZ<float>{xpre, z, Di}, st);
  if (err) return err;
  const dim3 block(32, kDwThreads / 32);
  const dim3 grid(B * H, (W + block.y * kDwRun - 1) / (block.y * kDwRun), (Di + 31) / 32);
  dwconv3x3_bias_silu_kernel<float><<<grid, block, 0, st>>>(xpre, conv_w, conv_b, x, H, W, Di);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The serving body: prologue_bf16_kernel (see the note at the top).
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTH = 8, kTW = 16;               // output tile
constexpr int kHaloW = kTW + 2;                // halo columns
constexpr int kHaloRows = (kTH + 2) * kHaloW;  // 180 halo pixels; the x product takes 192
                                               // rows (4 warps x 3 m16 tiles), the last 12
                                               // read from past A and dropped
constexpr int kNP = 32;                        // in_proj columns a slice: 2 warps x 2 n8
constexpr int kPS = kNP + 8;                   // row stride of the product tile, floats: a
                                               // half-warp's float2 stores (4 rows) fall on
                                               // 4 distinct 8-bank groups
constexpr int kRun = 8;                        // pixels a conv item slides over
constexpr int kMaxDm = 464;                    // Dm rounded up to 16: the shared memory's limit

struct Prologue {
  const float* h;            // (B, H, W, Dm)
  const __nv_bfloat16* w16;  // (2 Di, ldw): bf16(W_in), zeros past Dm
  const float* dw;           // (Di, 9)
  const float* db;           // (Di)
  float* xpre;               // null, or (B, H, W, Di): the float32 x half (a check's run)
  __nv_bfloat16* x;          // (B, H, W, Di)
  __nv_bfloat16* z;          // (B, H, W, Di)
  int H, W, Dm, Di, ldw;
  int kp, xs, slices, spb;   // Dm rounded up to 16; x-half slices; all slices; slices a block
};

// shared bytes of a block: A and a slice's W rows of kp + 8 bf16 (rows 16 bytes
// apart modulo 128, so ldmatrix's eight rows hit distinct banks), the float32
// product tile
inline int prologue_smem(int kp) {
  return 2 * (kHaloRows + kNP) * (kp + 8) + 4 * kHaloRows * kPS;
}

__device__ __forceinline__ __nv_bfloat16 z_bf16(float v) {
  return __float2bfloat16_rn(v);  // z's rounding
}

// Grid: (output tiles of an image, slice groups, images); block (., y, .)
// takes slices [y spb, min(slices, (y + 1) spb)): slice s < xs holds the x
// half's columns [32 s, 32 s + 32), slice s >= xs the z half's columns
// [32 (s - xs), 32 (s - xs) + 32). VEC4: h's rows load as float4 (Dm a
// multiple of 4, h 16-byte aligned).
template <bool VEC4>
__global__ void __launch_bounds__(kThreads, 2) prologue_bf16_kernel(Prologue p) {
  extern __shared__ __align__(16) unsigned char pro_smem[];
  const int AS = p.kp + 8, G = p.kp / 8;  // A and W row stride; 8-value groups a row
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(pro_smem);  // [kHaloRows][AS]
  __nv_bfloat16* Ws = As + kHaloRows * AS;                          // [kNP][AS]
  float* Ps = reinterpret_cast<float*>(Ws + kNP * AS);              // [kHaloRows][kPS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int H = p.H, W = p.W, Dm = p.Dm, Di = p.Di;
  const int tiles_x = (W + kTW - 1) / kTW;
  const int y0 = (int)(blockIdx.x / tiles_x) * kTH, x0 = (int)(blockIdx.x % tiles_x) * kTW;
  const long long img = (long long)blockIdx.z * H * W;
  const int s_begin = blockIdx.y * p.spb, s_end = min(p.slices, s_begin + p.spb);

  // slice s's weight rows into Ws, zeros past Di's rows and past ldw
  auto load_w = [&](int s) {
    const bool zh = s >= p.xs;
    const int c0 = (zh ? s - p.xs : s) * kNP;  // the slice's first column of its half
    for (int e = tid; e < kNP * G; e += kThreads) {
      const int j = e / G, k = (e - j * G) * 8;
      const bool ok = c0 + j < Di && k < p.ldw;
      tc::cp_async16b(Ws + j * AS + k,
                      ok ? p.w16 + (long long)((zh ? Di : 0) + c0 + j) * p.ldw + k : p.w16, ok);
    }
    tc::cp_async_commit();
  };
  load_w(s_begin);

  // A = bf16(h) on the halo, rounded to nearest even; a pixel outside the
  // image reads as zeros. Four groups of 8 values a thread are loaded before
  // any is used.
  constexpr int kBatch = 4;
  for (int e0 = tid; e0 < kHaloRows * G; e0 += kBatch * kThreads) {
    float v[kBatch][8];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      const int r = e / G, k = (e - r * G) * 8;
      const int yy = y0 - 1 + r / kHaloW, xx = x0 - 1 + r % kHaloW;
#pragma unroll
      for (int i = 0; i < 8; ++i) v[u][i] = 0.f;
      const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;  // the halo pixel is in the image
      if (e < kHaloRows * G && k < Dm && in) {
        const float* src = p.h + (img + (long long)yy * W + xx) * Dm + k;
        if (VEC4) {
          const float4 a = reinterpret_cast<const float4*>(src)[0];
          v[u][0] = a.x, v[u][1] = a.y, v[u][2] = a.z, v[u][3] = a.w;
          if (k + 4 < Dm) {
            const float4 b = reinterpret_cast<const float4*>(src)[1];
            v[u][4] = b.x, v[u][5] = b.y, v[u][6] = b.z, v[u][7] = b.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (k + i < Dm) v[u][i] = src[i];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= kHaloRows * G) break;
      const int r = e / G, k = (e - r * G) * 8;
      uint4 packed;
      uint32_t* pk = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int i = 0; i < 4; ++i) pk[i] = tc::pack_bf16(v[u][2 * i], v[u][2 * i + 1]);
      *reinterpret_cast<uint4*>(As + r * AS + k) = packed;
    }
  }

  const bool z_pairs = (Di & 1) == 0;  // a pair (n, n + 1), n even, in one 4-byte store
  for (int s = s_begin; s < s_end; ++s) {
    tc::cp_async_wait<0>();
    __syncthreads();  // W(s) and A are in; every thread is done with the last slice's Ps

    if (s < p.xs) {
      // the x half: 192 x 32 x kp over the halo, warps 4 along M (48 rows) x 2 along N
      float acc[3][2][4];
#pragma unroll
      for (int mi = 0; mi < 3; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
      const __nv_bfloat16* as = As + wm * 48 * AS;
      const __nv_bfloat16* ws = Ws + wn * 16 * AS;
      for (int k0 = 0; k0 < p.kp; k0 += 16) {  // the x product's k steps
        uint32_t af[3][4];
#pragma unroll
        for (int mi = 0; mi < 3; ++mi)
          tc::ldsm_x4(af[mi], as + (mi * 16 + (lane & 15)) * AS + k0 + 8 * (lane >> 4));
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          uint32_t b0, b1;
          tc::ldsm_x2(b0, b1, ws + (ni * 8 + (lane & 7)) * AS + k0 + 8 * ((lane >> 3) & 1));
#pragma unroll
          for (int mi = 0; mi < 3; ++mi) tc::mma_bf16(acc[mi][ni], af[mi], b0, b1);
        }
      }
      // the product tile; the rows of halo pixels outside the image are zero
#pragma unroll
      for (int mi = 0; mi < 3; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 48 + mi * 16 + h * 8 + g;
          if (r >= kHaloRows) continue;
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
            *reinterpret_cast<float2*>(Ps + r * kPS + wn * 16 + ni * 8 + 2 * t) =
                make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        }
      __syncthreads();  // the product tile is in; every warp is done with W(s)
      if (s + 1 < s_end) load_w(s + 1);  // lands while the conv runs

      // the 3x3 in the parity body's fmaf order, its bias and the SiLU, x
      // stored bf16: item (channel c, tile row ty, run) slides a window along
      // kRun pixels of the row
      for (int it = tid; it < kNP * kTH * (kTW / kRun); it += kThreads) {
        const int c = it % kNP, item = it / kNP;
        const int ty = item / (kTW / kRun), xl = (item - ty * (kTW / kRun)) * kRun;
        const int ch = s * kNP + c, y = y0 + ty;
        if (ch >= Di || y >= H) continue;
        float wk[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) wk[i] = __ldg(p.dw + ch * 9 + i);
        const float bc = __ldg(p.db + ch);
        float l[3], m[3], r[3];  // window columns left / mid / right, rows y-1, y, y+1
        auto column = [&](int hc, float* v) {  // hc: halo column
#pragma unroll
          for (int d = 0; d < 3; ++d) v[d] = Ps[((ty + d) * kHaloW + hc) * kPS + c];
        };
        column(xl, l);
        column(xl + 1, m);
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          column(xl + i + 2, r);
          float sum = 0.f;
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            sum = fmaf(l[d], wk[d * 3], sum);
            sum = fmaf(m[d], wk[d * 3 + 1], sum);
            sum = fmaf(r[d], wk[d * 3 + 2], sum);
          }
          const int xx = x0 + xl + i;
          if (xx < W) {
            const long long px = img + (long long)y * W + xx;
            p.x[px * Di + ch] = __float2bfloat16_rn(silu(sum + bc));
            if (p.xpre) p.xpre[px * Di + ch] = m[1];
          }
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            l[d] = m[d];
            m[d] = r[d];
          }
        }
      }
    } else {
      // the z half: 128 x 32 x kp over the tile's own pixels, warps 4 along M
      // (two tile rows) x 2 along N; lane l's ldmatrix row is pixel l % 16 of
      // a tile row, read from its place among the halo's rows
      float acc[2][2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
      const __nv_bfloat16* ws = Ws + wn * 16 * AS;
      for (int k0 = 0; k0 < p.kp; k0 += 16) {  // the z product's k steps
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          tc::ldsm_x4(af[mi], As + ((wm * 2 + mi + 1) * kHaloW + 1 + (lane & 15)) * AS + k0 +
                                  8 * (lane >> 4));
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          uint32_t b0, b1;
          tc::ldsm_x2(b0, b1, ws + (ni * 8 + (lane & 7)) * AS + k0 + 8 * ((lane >> 3) & 1));
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) tc::mma_bf16(acc[mi][ni], af[mi], b0, b1);
        }
      }
      __syncthreads();  // every warp is done with W(s)
      if (s + 1 < s_end) load_w(s + 1);
      const int zc = (s - p.xs) * kNP + wn * 16 + 2 * t;  // + ni * 8: the pair's first column
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int y = y0 + wm * 2 + mi, xx = x0 + h * 8 + g;
          if (y >= H || xx >= W) continue;
          __nv_bfloat16* zp = p.z + (img + (long long)y * W + xx) * Di;
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) {
            const int n = zc + ni * 8;
            const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
            if (n + 1 < Di && z_pairs) {
              *reinterpret_cast<__nv_bfloat162*>(zp + n) =
                  __halves2bfloat162(z_bf16(v0), z_bf16(v1));
            } else if (n < Di) {
              zp[n] = z_bf16(v0);
              if (n + 1 < Di) zp[n + 1] = z_bf16(v1);
            }
          }
        }
    }
  }
}

template <bool VEC4>
int launch_prologue_bf16(Prologue p, int B, cudaStream_t st) {
  p.kp = (p.Dm + 15) / 16 * 16;
  p.xs = (p.Di + kNP - 1) / kNP;
  p.slices = 2 * p.xs;
  const long long tiles = (long long)((p.H + kTH - 1) / kTH) * ((p.W + kTW - 1) / kTW);
  // slice groups: enough blocks for 2 a card's SM (132), each group as many
  // slices as that leaves (more groups re-read the halo more often)
  const long long want = (2 * 132 + tiles * B - 1) / (tiles * B);
  const int groups = want < p.slices ? (int)want : p.slices;
  p.spb = (p.slices + groups - 1) / groups;
  const int gy = (p.slices + p.spb - 1) / p.spb;
  const int smem = prologue_smem(p.kp);
  auto kern = prologue_bf16_kernel<VEC4>;
  static int smem_set = 48 * 1024;  // the largest size asked for so far
  if (smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  if (tiles > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidValue;
  kern<<<dim3((unsigned)tiles, gy, B), kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// h (B, H, W, Dm) channels-last float32; w_in (2*Di, Dm) (torch Linear
// layout); conv_w (Di, 1, 3, 3); conv_b (Di). Outputs x, z: (B, H, W, Di).
// Scratch xpre >= B*H*W*Di floats.
int tpuir_mixer_prologue_f32(const float* h, const float* w_in, const float* conv_w,
                             const float* conv_b, float* xpre, float* x, float* z, int B, int H,
                             int W, int Dm, int Di, void* stream) {
  return prologue_f32(h, w_in, conv_w, conv_b, xpre, x, z, B, H, W, Dm, Di,
                      (cudaStream_t)stream);
}

// The serving body: h (B, H, W, Dm) float32; w_in (2*Di, Dm), conv_w (Di,
// 1, 3, 3), conv_b (Di) float32; outputs x, z (B, H, W, Di) bf16. Scratch
// w16 >= 2*Di*ldw bf16 (ldw = Dm rounded up to 8; W_in's bf16 copy);
// xpre: null, or (B, H, W, Di) float32 for the x half of in_proj. Dm <= 464.
int tpuir_mixer_prologue_bf16(const float* h, const float* w_in, const float* conv_w,
                              const float* conv_b, __nv_bfloat16* w16, float* xpre,
                              __nv_bfloat16* x, __nv_bfloat16* z, int B, int H, int W, int Dm,
                              int Di, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || H <= 0 || W <= 0 || Dm <= 0 || Di <= 0 || B > 65535 ||
      (Dm + 15) / 16 * 16 > kMaxDm || (long long)B * H * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int ldw = (Dm + 7) / 8 * 8;
  int err = tc::round_rows_bf16(w_in, w16, 2 * Di, Dm, ldw, st);
  if (err) return err;
  Prologue p{h, w16, conv_w, conv_b, xpre, x, z, H, W, Dm, Di, ldw};
  const bool vec4 = Dm % 4 == 0 && ((uintptr_t)h & 15) == 0;
  return vec4 ? launch_prologue_bf16<true>(p, B, st) : launch_prologue_bf16<false>(p, B, st);
}

}  // extern "C"
