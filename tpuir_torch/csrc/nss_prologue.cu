// K6: the MaIR mixer's prologue in float32 on Hopper (sm_90a), hand-written.
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
// C interface (ctypes, no PyTorch headers): launches go on the caller's
// stream, nothing is allocated or synchronised, the first cudaError_t met
// is returned (0 = success).

#include <cuda_runtime.h>
#include <math.h>

#include "tc_gemm.cuh"

namespace {

// Columns [0, di) of the in_proj output to x, [di, 2*di) to z; a pair
// (n, n + 1), n even, as one float2 when di is even (the pair then lies in
// one half, 8-byte aligned).
struct SplitXZ {
  float* x;
  float* z;
  int di;
  __device__ __forceinline__ void one(long long m, int n, float v) const {
    if (n < di)
      x[m * di + n] = v;
    else
      z[m * di + (n - di)] = v;
  }
  __device__ __forceinline__ void operator()(long long m, int n, float v0, float v1,
                                             bool two) const {
    if (two && (di & 1) == 0) {
      float* dst = n < di ? x + m * di + n : z + m * di + (n - di);
      *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
    } else {
      one(m, n, v0);
      if (two) one(m, n + 1, v1);
    }
  }
};

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

constexpr int kDwThreads = 256;
constexpr int kDwRun = 8;  // outputs a thread slides its window over

// out = silu(dw3x3(in) + b), channels-last (B, H, W, C), w (C, 1, 3, 3).
// Block: 32 channels x 8 runs of kDwRun pixels along x of one image row;
// grid (B*H rows, x runs, channel tiles).
__global__ void __launch_bounds__(kDwThreads) dwconv3x3_bias_silu_kernel(
    const float* __restrict__ in, const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ out, int H, int W, int C) {
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
    out[(img + (long long)y * W + x) * C + c] = silu(s + bc);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      l[d] = m[d];
      m[d] = r[d];
    }
  }
}

}  // namespace

extern "C" {

// h (B, H, W, Dm) channels-last float32; w_in (2*Di, Dm) (torch Linear
// layout); conv_w (Di, 1, 3, 3); conv_b (Di). Outputs x, z: (B, H, W, Di).
// Scratch xpre >= B*H*W*Di floats.
int tpuir_mixer_prologue_f32(const float* h, const float* w_in, const float* conv_w,
                             const float* conv_b, float* xpre, float* x, float* z, int B, int H,
                             int W, int Dm, int Di, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || H <= 0 || W <= 0 || Dm <= 0 || Di <= 0) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  if (M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const tc::Args p{h, 0, Dm, w_in, 0, (int)M, 2 * Di, Dm};
  int err = tc::launch_tc_gemm(p, 1, tc::NoPrologue{}, SplitXZ{xpre, z, Di}, st);
  if (err) return err;
  const dim3 block(32, kDwThreads / 32);
  const dim3 grid(B * H, (W + block.y * kDwRun - 1) / (block.y * kDwRun), (Di + 31) / 32);
  dwconv3x3_bias_silu_kernel<<<grid, block, 0, st>>>(xpre, conv_w, conv_b, x, H, W, Di);
  return (int)cudaGetLastError();
}

}  // extern "C"
