// K5: MaIR's gather-free four-direction NSS selective scan in float32 on
// Hopper (sm_90a), hand-written, with its projections and pooled sums.
//
// Replaces: tpuir/ops/nss_fused.py:_seq_scan_call (the Pallas TPU kernel
// _make_kernel, via nss_scan_fused), which MaIR's mixers take under
// TPUIR_NSS=fused on levels whose H and W are multiples of scan_len. Same
// math as K2 (nss_scan.cu). For each image b, direction k in 0..3 and
// position t of the NSS path, with p the image pixel the path visits at t:
//   x_dbl = W_xp[k] . x[b, p]                    (R + 2N values)
//   dt    = softplus(W_dt[k] . x_dbl[:R] + bias[k])   per channel d
//   h_t   = exp(dt * A[k]) * h_{t-1} + dt * x_dbl[R:R+N] * x[b, p]   per (d, n)
//   y     = x_dbl[R+N:] . h_t + D[k] * x[b, p]
// Directions 0 and 1 write y to pixel p of an (H, W) image (y01), 2 and 3
// to the transposed pixel of a (W, H) image (y23), as the JAX function
// returns them; pooled[b, k, d] is the sum of y over the path. d_state
// N <= 32, dt rank R <= 64.
//
// What bounds it on this card. At MaIR-CDN@128, batch 8 (L = 16,384
// positions, D = 234 channels, N = 16 states, R = 12): it must read x
// (123 MB) and write y (491 MB), 0.18 ms at 3.35 TB/s; it does 1.96 G state
// updates, each an exponential and about six float32 operations, plus
// 13.7 GFLOP of projections: about 25 GFLOP, 0.38 ms at the 67 TFLOP/s
// float32 peak. The three-pass chunked scan takes two exponentials a state
// update on the MUFU pipe: its floor is 0.95 ms at the measured exp2 rate,
// and the passes are bound by that pipe (chunk_scan.cuh).
//
// What the parity body's design does about it:
//   * x_dbl depends only on (pixel, k), not on the path, so it is one SIMT
//     GEMM over all pixels first (x . W_xp^T, 4*(R+2N) columns), as in K2;
//     the TPU kernel projects inside the scan's staging instead. dt is
//     recomputed from x_dbl inside the scan (R FMAs a channel).
//   * The scan is chunk_scan.cuh's passes on StripePath: the pixel a
//     position visits is computed from t by the stripe arithmetic
//     (nss_pixel: stripe, alternate vertical flip, boustrophedon, the
//     shifted variant's narrow lead and tail stripes, rot180, transpose)
//     instead of read from an id table, once a chunk; x and y are read and
//     written at that pixel, a block's channels a step, so both coalesce.
//   * The pooled sums are the chunks' partial sums of y added in chunk
//     order by a fourth launch: no float atomics, the output repeats bit
//     for bit.
//   * The TPU kernel's XLA stripe permutations outside the kernel, D padded
//     to 128 lanes, L padded to the chunk, its (S, P) vertical schedule and
//     the 8-sublane pooled buffer are TPU layouts with no counterpart here.
//
// The serving body (tpuir_nss_scan_fused_bf16; the TPU kernel with
// serving=True) computes the same function on bf16 x and y, with K2's
// serving roundings (nss_scan.cu): x_dbl the float32 sum of exact bf16
// products (x, and W_xp rounded at load), dt_proj's operands rounded to bf16,
// B, C, softplus, the recurrence and D*x float32, y stored rounded to
// nearest even, pooled summed from the float32 y. Its floor is one
// exponential a state update, 0.47 ms at MaIR-CDN@128, batch 8. On the
// chunked passes (float32 parity's design, two exponentials an update, dt
// computed in both passes, a thread a channel) it took 2.92 ms there and
// 1.19 at the 384x328 tile, batch 2: as for K2 serving, a position's own
// work (dt's R-term dot and softplus, twice), pass 1 and the gathered u held
// it, not the MUFU pipe (PERF.md section 6).
// Its design is K2 serving's walk (nss_walk.cuh), on the stripe path:
//   * x_proj's weight packed into the staged row order, x_dbl (B, L, 4, CS)
//     on the SIMT GEMM's bf16 A mode, as K2 serving's;
//   * a walk of each chunk with a channel's states across G lanes of a warp,
//     dt and dt*u computed once a position and channel by a lane of the
//     warp, one exponential an update, the chunk count from the wrapper
//     (ops/nss_stripe.py:serving_chunks, from this instance's resident
//     blocks, tpuir_nss_scan_fused_bf16_resident_blocks): with one chunk the
//     walk is the whole scan; otherwise the chunks' end states, the carry
//     chain, then the walk that writes y;
//   * the positions come from the stripe arithmetic (WalkStripe): the first
//     32 threads compute nss_pixel of tile i + 2 while tile i is walked, into
//     a ring of pixels and a ring of the rows of y they write, so the two
//     integer divisions run once a position and block, and the x_dbl rows
//     and u (two channels a 4-byte copy: D even) are staged at the pixel two
//     tiles ahead; y is stored as bf16 pairs at its row, in the transposed
//     (W, H) image for directions 2 and 3, so the stores still coalesce
//     along d.

// C interface (ctypes, no PyTorch headers): launches go on the caller's
// stream, nothing is allocated or synchronised, the first cudaError_t met
// is returned (0 = success).

#include <cuda_runtime.h>

#include "chunk_scan.cuh"
#include "nss_walk.cuh"
#include "simt_gemm.cuh"

namespace {

int nss_scan_fused(const float* x, const float* x_proj_w, const float* dt_w, const float* A,
                   const float* Dskip, const float* bias, float* y, float* pooled,
                   float* scratch, int B, int H, int W, int D, int N, int R, int scan_len,
                   int shift, cudaStream_t st) {
  if (B <= 0 || H <= 0 || W <= 0 || D <= 0 || N <= 0 || N > kMaxState || R <= 0 ||
      R > kMaxRank || scan_len < 2 || scan_len % 2 || H % scan_len || W % scan_len)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  if (M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int L = H * W;
  const int C = R + 2 * N;
  const int nchunk = chunk_count(L);
  const long long BK = (long long)B * kK;
  float* xdbl = scratch;
  float* hstate = xdbl + M * kK * C;
  float* decay = hstate + BK * nchunk * D * N;
  float* partial = decay + BK * nchunk * D * N;

  // 0. x_dbl for every pixel and direction: (B*L, D) . (4*C, D)^T
  int err = launch_simt_gemm(x, x_proj_w, xdbl, (int)M, kK * C, D, st);
  if (err) return err;

  // 1-3. the chunked scan along the stripe arithmetic
  ChunkScanArgs a{x, nullptr, xdbl, dt_w, A, Dskip, bias, y, hstate, decay, partial,
                  L, D, N, R, nchunk};
  a.H = H;
  a.W = W;
  a.scan_len = scan_len;
  a.shift = shift;
  if ((err = run_chunk_scan<StripePath>(a, BK, st))) return err;
  // 4. pooled sums in chunk order
  return launch_sum_partials<StripePath>(partial, pooled, BK, nchunk, D, st);
}

}  // namespace

extern "C" {

// x (B, H, W, D) float32; x_proj_w (4, R + 2N, D); dt_w (4, D, R); A (4, D, N)
// (= -exp(A_logs)); Dskip, bias (4, D). Outputs y (B, 4, H*W, D), directions
// 0 and 1 as (H, W) images and 2 and 3 as (W, H) images, and pooled
// (B, 4, D). H and W multiples of scan_len (even); N <= 32, R <= 64. The
// scratch is laid out as K2's, tpuir_nss_scan_scratch_numel(B, H*W, D, N, R)
// floats: x_dbl, the chunk states and decay products, the chunk partials.
int tpuir_nss_scan_fused_f32(const float* x, const float* x_proj_w, const float* dt_w,
                             const float* A, const float* Dskip, const float* bias, float* y,
                             float* pooled, float* scratch, int B, int H, int W, int D, int N,
                             int R, int scan_len, int shift, void* stream) {
  return nss_scan_fused(x, x_proj_w, dt_w, A, Dskip, bias, y, pooled, scratch, B, H, W, D, N, R,
                        scan_len, shift, (cudaStream_t)stream);
}

// The serving body: x and y bf16 (D even), the weights float32 as
// tpuir_nss_scan_fused_f32 takes them (rounded to bf16 where they are
// products' operands), pooled float32 (summed from the float32 y). chunk:
// positions a chunk of the walk, a multiple of 32 (the wrapper's
// serving_chunks); scratch of tpuir_nss_scan_bf16_scratch_numel(B, H*W, D, N,
// R, chunk) floats, laid out as K2's serving body's.
int tpuir_nss_scan_fused_bf16(const __nv_bfloat16* x, const float* x_proj_w, const float* dt_w,
                              const float* A, const float* Dskip, const float* bias,
                              __nv_bfloat16* y, float* pooled, float* scratch, int B, int H,
                              int W, int D, int N, int R, int scan_len, int shift, int chunk,
                              void* stream) {
  if (H <= 0 || W <= 0 || scan_len < 2 || scan_len % 2 || H % scan_len || W % scan_len ||
      (long long)H * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  StripeWalkArgs a{};
  a.x = x, a.dt_w = dt_w, a.A = A, a.Dskip = Dskip, a.bias = bias, a.y = y, a.pooled = pooled;
  a.L = H * W, a.D = D, a.N = N, a.R = R, a.chunk = chunk;
  a.H = H, a.W = W, a.scan_len = scan_len, a.shift = shift;
  return serving_walk<WalkStripe>(a, x_proj_w, scratch, B, (cudaStream_t)stream);
}

// Blocks of the serving walk one SM of the current device holds at once for
// N states and R ranks (-1 on a CUDA error): the wrapper's chunk rule.
int tpuir_nss_scan_fused_bf16_resident_blocks(int N, int R) {
  return walk_resident_blocks<WalkStripe>(N, R);
}

}  // extern "C"
