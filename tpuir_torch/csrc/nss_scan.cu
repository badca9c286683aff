// K2: MaIR's four-direction NSS selective scan in float32 on Hopper
// (sm_90a), hand-written, with its projections.
//
// Replaces: tpuir/ops/nss_stripe.py:_forward_core (square tiles, via
// nss_scan_stripe_pre / nss_scan_stripe) and :_launch_single (rectangular
// tiles): one kernel here covers both. Same math. For each image b,
// direction k in 0..3 and position t of the NSS path, with p = ids[k][t]
// the image pixel the path visits at t (tpuir_torch/ops/scan_ids.py, the
// shifted variant being just another table):
//   x_dbl = W_xp[k] . x[b, p]                    (R + 2N values)
//   dt    = softplus(W_dt[k] . x_dbl[:R] + bias[k])   per channel d
//   h_t   = exp(dt * A[k]) * h_{t-1} + dt * x_dbl[R:R+N] * x[b, p]   per (d, n)
//   y     = x_dbl[R+N:] . h_t + D[k] * x[b, p]
// y is written to image position p of direction k's output (B, 4, H, W, D),
// and pooled[b, k, d] is the sum of y over the path. d_state N <= 32.
//
// What bounds it on this card. At MaIR-CDN@128, batch 8 (L = 16,384
// positions, D = 234 channels, N = 16 states, R = 12): the function must
// read x (123 MB) and write y (491 MB), 0.18 ms at 3.35 TB/s; it does
// 1.96 G state updates, each an exponential and about six float32
// operations, plus 13.7 GFLOP of projections: about 25 GFLOP, 0.38 ms at
// the 67 TFLOP/s float32 peak. The three-pass chunked scan that spreads
// the 16,384 dependent steps of each of the B*K*D = 7,488 recurrences over
// the card takes two exponentials a state update, one a pass, on the MUFU
// pipe (16 lanes an SM against 128 float32 lanes): its floor is 0.95 ms at
// the measured exp2 rate, and the passes are bound by that pipe
// (chunk_scan.cuh).
//
// What the design does about it:
//   * x_dbl depends only on (pixel, k), not on the path, so it is one SIMT
//     GEMM over all pixels first (x . W_xp^T, 4*(R+2N) columns); dt is
//     recomputed from it inside the scan (R FMAs a channel), never stored.
//   * The scan is chunk_scan.cuh's three passes on ImageIdsPath: x and y are
//     read and written through the id table, a block's channels of one
//     pixel a step, so the gather and the scatter coalesce; one MUFU.EX2 a
//     state update a pass, x_dbl rows staged ahead by cp.async and x loaded
//     ahead. A fourth launch here sums the chunks' partial sums of y in
//     chunk order.
//   * The TPU kernel's stripe block maps, half-block L/R buffers, serpentine
//     static slices, x^T frames, lane padding and VMEM segments exist to
//     avoid gathers on the TPU and have no counterpart here.
//
// The serving body (tpuir_nss_scan_bf16; the TPU kernel with serving=True)
// is the same launches on bf16 x and y: x_proj takes x widened and W_xp
// rounded to bf16 at load (simt_gemm.cuh), so x_dbl is the float32 sum of
// exact bf16 products and stays float32 in scratch; the scan runs on
// ImageIdsBf16Path (chunk_scan.cuh), which rounds dt_proj's operands (the
// dt columns of x_dbl and W_dt) in shared memory, keeps B, C, softplus,
// the recurrence and D*x in float32, stores y rounded to nearest even and
// sums pooled from the float32 y. Halving x's and y's bytes moves little:
// the scan is bound by its exponentials, not its bytes.
//
// The bf16-recurrence serving body (tpuir_nss_scan_recur_bf16; the TPU
// kernel with serving=True, recur_bf16=True, tpuir/ops/nss_stripe.py:218-233
// and :273-276) keeps x_proj of the serving body (the SIMT GEMM's bf16 A
// mode into scratch) and replaces the float32 scan by the TPU kernel's
// two-level one. Along each direction's path the level-1 recurrence
// restarts at every subchunk start (rp rows of a stripe,
// tpuir_torch/ops/scan_ids.py:mair_subchunk_starts) and runs
// in bf16: av = bf16(exp2(dt * A log2 e)), bv = bf16(B * (dt * x)), at a
// start hA = av, hB = bv, else hA = bf16(av * hA), hB = bf16(bf16(av * hB)
// + bv). The level-2 carry chains the subchunks in float32 across the whole
// path, cc = hA_end * cc + hB_end (a multiply and an add, not an FMA), and
// each position takes h = bf16(hA * bf16(cc at its subchunk's start)) + hB
// in float32, y = sum_n h C_n + D x, stored bf16, pooled from the float32
// y. These are the rounding points of the TPU kernel as XLA runs it on the
// CPU (the product hA * CE rounded as a bf16 op, its sum with hB kept
// float32 because C promotes it), bit for bit on the tested shapes
// (tests/test_torch_recur_serving.py); dt is an FMA chain of exact bf16
// products in rank order plus the bias, then log1pf(expf(.)) below 20, and
// the decay is exp2f, so that PyTorch's own float32 ops on the card repeat
// the level-1 inputs bit for bit (utils/serving_check.py).
//
// Design: the TPU kernel's own two levels, as three passes. Level 1 is
// independent from one subchunk to the next, so passes 1 and 3 walk every
// subchunk in parallel: a block takes 4 consecutive subchunks of one (image,
// direction) (their starts from the table ``off``, derived from
// ``mair_subchunk_starts``) and 32 channels, each channel 4 lanes of a warp
// with N/4 of its states in registers; a tile of 32 positions' ids, x_dbl
// rows (dt columns rounded as staged) and x is staged in shared memory a
// __syncthreads; each of a channel's 4 lanes computes the dt of one of 4
// positions and shuffles it to the others, and y's sum over the states is
// a butterfly over them. Pass 1 stores each subchunk's end state (hA, hB: bf16 values,
// a bf16 pair); pass 2, one thread a (image, direction, channel, state),
// runs the float32 carry chain over the subchunks in path order, exactly the
// TPU kernel's sequential chain, and stores the carry at each subchunk's
// start; pass 3 walks the subchunks again from those carries and stores y
// and each subchunk's sum of y, which a fourth launch adds in path order.
// The first version walked each whole path in one block (7,488 walks of
// 16,384 dependent steps at MaIR-CDN@128, batch 8, under two warps a
// scheduler): 18.7 ms against K2 serving's 2.9 (PERF.md). What
// bounds this one: the level-1 work twice (a position's dt, R FMAs and
// softplus; a state update's exp2f and about 10 roundings and products),
// issue-bound, plus 2 GB of end states and carries at MaIR-CDN@128, batch
// 8; PERF.md holds its time beside K2 serving's chunked scan.
//
// C interface (ctypes, no PyTorch headers): launches go on the caller's
// stream, nothing is allocated or synchronised, the first cudaError_t met
// is returned (0 = success).

#include <cuda_runtime.h>

#include "chunk_scan.cuh"
#include "simt_gemm.cuh"

extern "C" {

// Floats of scratch tpuir_nss_scan_f32 needs: x_dbl, the chunk states and
// decay products, the chunk partial sums.
long long tpuir_nss_scan_scratch_numel(int B, int L, int D, int N, int R) {
  const long long bk = (long long)B * kK;
  return (long long)B * L * kK * (R + 2 * N) + chunk_state_numel(bk, L, D, N) +
         bk * chunk_count(L) * D;
}

}  // extern "C"

namespace {

template <class Path>
int nss_scan(const typename Path::io_t* x, const int* ids, const float* x_proj_w,
             const float* dt_w, const float* A, const float* Dskip, const float* bias,
             typename Path::io_t* y, float* pooled, float* scratch, int B, int L, int D, int N,
             int R, cudaStream_t st) {
  if (B <= 0 || L <= 0 || D <= 0 || N <= 0 || N > kMaxState || R <= 0 || R > kMaxRank)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * L;
  if (M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
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

  // 1-3. the chunked scan through the id table
  const ChunkScanArgs a{x, ids, xdbl, dt_w, A, Dskip, bias, y, hstate, decay, partial,
                        L, D, N, R, nchunk};
  if ((err = run_chunk_scan<Path>(a, BK, st))) return err;
  // 4. pooled sums in chunk order
  return launch_sum_partials<Path>(partial, pooled, BK, nchunk, D, st);
}


// ---------------------------------------------------------------------------
// The bf16-recurrence serving body
// ---------------------------------------------------------------------------

constexpr int kRecurLanes = 4;     // lanes a channel, each with N / 4 states
constexpr int kRecurChannels = 32; // channels a block
constexpr int kRecurTile = 32;     // positions staged a __syncthreads
constexpr int kRecurGroup = 4;     // subchunks a block walks

__device__ __forceinline__ float recur_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// softplus as PyTorch's float32 F.softplus computes it (threshold 20)
__device__ __forceinline__ float recur_softplus(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}

// Passes 1 and 3: the bf16 level-1 walk of kRecurGroup consecutive subchunks
// of one (image, direction) for kRecurChannels channels, each a subchunk
// from its start. EMIT = false (pass 1): each subchunk's end state (hA, hB)
// into ends. EMIT = true (pass 3): each position's y from the carry at its
// subchunk's start (pass 2's), and each subchunk's sum of y into partial.
// grid (ceil(D / kRecurChannels), ceil(S / kRecurGroup), B * 4),
// kRecurChannels * kRecurLanes threads; dynamic shared memory: W_dt (R x
// kRecurChannels), the tile's x_dbl rows (kRecurTile x C), x (kRecurTile x
// kRecurChannels), ids.
template <int MAXN, bool EMIT>
__global__ void __launch_bounds__(kRecurChannels * kRecurLanes) recur_walk_kernel(
    const __nv_bfloat16* __restrict__ x, const int* __restrict__ ids,
    const int* __restrict__ off, const float* __restrict__ xdbl,
    const float* __restrict__ dt_w, const float* __restrict__ A, const float* __restrict__ Dskip,
    const float* __restrict__ bias, __nv_bfloat162* __restrict__ ends,
    const float* __restrict__ carries, __nv_bfloat16* __restrict__ y,
    float* __restrict__ partial, int S, int L, int D, int N, int R) {
  constexpr int SPL = MAXN / kRecurLanes;  // states a lane
  const int C = R + 2 * N;
  const int bk = blockIdx.z, b = bk / kK, k = bk % kK;
  const int tid = threadIdx.x, lane = tid % kRecurLanes, cl = tid / kRecurLanes;
  const int c0 = blockIdx.x * kRecurChannels, ch = c0 + cl;
  const bool live = ch < D;
  const int* offk = off + k * (S + 1);
  const int s0 = blockIdx.y * kRecurGroup;
  const int t_begin = offk[s0], t_end = offk[min(s0 + kRecurGroup, S)];
  extern __shared__ float smem[];
  float* wdt_s = smem;                                  // (R, kRecurChannels)
  float* row_s = wdt_s + R * kRecurChannels;            // (kRecurTile, C)
  float* x_s = row_s + kRecurTile * C;                  // (kRecurTile, kRecurChannels)
  int* id_s = reinterpret_cast<int*>(x_s + kRecurTile * kRecurChannels);

  for (int e = tid; e < R * kRecurChannels; e += blockDim.x) {
    const int r = e / kRecurChannels, c = c0 + e % kRecurChannels;
    wdt_s[e] = c < D ? recur_bf16(dt_w[((long long)k * D + c) * R + r]) : 0.f;
  }
  float a2[SPL], hA[SPL], hB[SPL], ce[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int n = i * kRecurLanes + lane;
    a2[i] = live && n < N ? __fmul_rn(A[((long long)k * D + ch) * N + n], kLog2e) : 0.f;
    hA[i] = 1.f, hB[i] = 0.f, ce[i] = 0.f;
  }
  const float dsk = live ? Dskip[k * D + ch] : 0.f;
  const float bs = live ? bias[k * D + ch] : 0.f;
  const float* xdbl_b = xdbl + (long long)b * L * kK * C + k * C;
  const __nv_bfloat16* x_b = x + (long long)b * L * D;
  __nv_bfloat16* y_bk = y + (long long)bk * L * D;
  float pool = 0.f;
  int s = s0 - 1, next = t_begin;  // the subchunk being walked; where the next starts

  // subchunk s is finished: its end state (pass 1) or its sum of y (pass 3)
  auto finish = [&]() {
    if (s < s0 || !live) return;
    const long long row = ((long long)bk * S + s) * D + ch;
    if constexpr (EMIT) {
      if (lane == 0) partial[row] = pool;
    } else {
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        const int n = i * kRecurLanes + lane;
        if (n < N) ends[row * N + n] = __floats2bfloat162_rn(hA[i], hB[i]);
      }
    }
  };

  for (int t0 = t_begin; t0 < t_end; t0 += kRecurTile) {
    const int nt = min(kRecurTile, t_end - t0);
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < nt; e += blockDim.x) id_s[e] = ids[(long long)k * L + t0 + e];
    __syncthreads();
    for (int e = tid; e < nt * C; e += blockDim.x) {
      const int p = e / C, j = e % C;
      const float v = xdbl_b[(long long)id_s[p] * kK * C + j];
      row_s[e] = j < R ? recur_bf16(v) : v;  // dt_proj's operand rounded once
    }
    for (int e = tid; e < nt * kRecurChannels; e += blockDim.x) {
      const int p = e / kRecurChannels, c = c0 + e % kRecurChannels;
      x_s[e] = c < D ? __bfloat162float(x_b[(long long)id_s[p] * D + c]) : 0.f;
    }
    __syncthreads();
    float dt_own = 0.f;
    for (int p = 0; p < nt; ++p) {
      if (p % kRecurLanes == 0) {
        // dt_proj of position p + lane: exact bf16 products summed in rank
        // order; the channel's lanes then share their four dt
        const int q = p + lane;
        float acc = 0.f;
        if (q < nt)
          for (int r = 0; r < R; ++r) acc = fmaf(row_s[q * C + r], wdt_s[r * kRecurChannels + cl], acc);
        dt_own = recur_softplus(__fadd_rn(acc, bs));
      }
      const float dt = __shfl_sync(0xffffffffu, dt_own,
                                   (tid % 32) / kRecurLanes * kRecurLanes + p % kRecurLanes);
      const int t = t0 + p;
      const bool start = t == next;
      if (start) {
        finish();
        pool = 0.f;
        ++s;
        next = offk[s + 1];
      }
      const float* row = row_s + p * C;
      const float xv = x_s[p * kRecurChannels + cl];
      const float du = __fmul_rn(dt, xv);
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        const int n = i * kRecurLanes + lane;
        if (n < N) {
          const float av = recur_bf16(exp2f(__fmul_rn(dt, a2[i])));
          const float bv = recur_bf16(__fmul_rn(row[R + n], du));
          if (start) {
            if constexpr (EMIT) {
              // the level-2 carry at this subchunk's start, rounded
              const float cc = live ? carries[(((long long)bk * S + s) * D + ch) * N + n] : 0.f;
              ce[i] = recur_bf16(cc);
            }
            hA[i] = av, hB[i] = bv;
          } else {
            hA[i] = recur_bf16(av * hA[i]);
            hB[i] = recur_bf16(__fadd_rn(recur_bf16(av * hB[i]), bv));
          }
          if constexpr (EMIT) {
            const float h = __fadd_rn(recur_bf16(hA[i] * ce[i]), hB[i]);
            part = fmaf(h, row[R + N + n], part);
          }
        }
      }
      if constexpr (EMIT) {
#pragma unroll
        for (int o = 1; o < kRecurLanes; o <<= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        const float out = fmaf(dsk, xv, part);
        if (live && lane == 0) {
          y_bk[(long long)id_s[p] * D + ch] = __float2bfloat16_rn(out);
          pool += out;
        }
      }
    }
  }
  finish();
}

// Pass 2: the float32 level-2 chain of one (image, direction, channel,
// state) over its subchunks in path order: the carry at each subchunk's
// start into carries (0 for the padding past a direction's last subchunk),
// then cc = hA_end * cc + hB_end, a multiply and an add.
__global__ void recur_chain_kernel(const __nv_bfloat162* __restrict__ ends,
                                   const int* __restrict__ off, float* __restrict__ carries,
                                   int S, int D, int N, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int n = (int)(idx % N), ch = (int)(idx / N % D);
  const long long bk = idx / N / D;
  const int* offk = off + (bk % kK) * (S + 1);
  float cc = 0.f;
#pragma unroll 4
  for (int s = 0; s < S; ++s) {
    const long long e = ((bk * S + s) * D + ch) * N + n;
    const bool real = offk[s] < offk[s + 1];
    carries[e] = real ? cc : 0.f;
    if (real) {
      const float2 h = __bfloat1622float2(ends[e]);
      cc = __fadd_rn(__fmul_rn(h.x, cc), h.y);
    }
  }
}

// Pass 4: pooled[b, k, ch], the subchunks' sums of y added in path order.
__global__ void recur_pool_kernel(const float* __restrict__ partial, const int* __restrict__ off,
                                  float* __restrict__ pooled, int S, int D, int total) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int bk = idx / D, ch = idx % D;
  const int* offk = off + (bk % kK) * (S + 1);
  float sum = 0.f;
  for (int s = 0; s < S; ++s)
    if (offk[s] < offk[s + 1]) sum += partial[((long long)bk * S + s) * D + ch];
  pooled[idx] = sum;
}

template <int MAXN>
int launch_recur(const __nv_bfloat16* x, const int* ids, const int* off, const float* xdbl,
                 const float* dt_w, const float* A, const float* Dskip, const float* bias,
                 __nv_bfloat16* y, float* pooled, __nv_bfloat162* ends, float* partial,
                 float* carries, int S, int B, int L, int D, int N, int R, cudaStream_t st) {
  const int C = R + 2 * N;
  const size_t smem = sizeof(float) * ((size_t)R * kRecurChannels + (size_t)kRecurTile * C +
                                       (size_t)kRecurTile * kRecurChannels) +
                      sizeof(int) * kRecurTile;
  const dim3 grid((D + kRecurChannels - 1) / kRecurChannels,
                  (S + kRecurGroup - 1) / kRecurGroup, B * kK);
  constexpr int threads = kRecurChannels * kRecurLanes;
  recur_walk_kernel<MAXN, false><<<grid, threads, smem, st>>>(
      x, ids, off, xdbl, dt_w, A, Dskip, bias, ends, carries, y, partial, S, L, D, N, R);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long states = (long long)B * kK * D * N;
  recur_chain_kernel<<<(unsigned)((states + 255) / 256), 256, 0, st>>>(ends, off, carries, S, D,
                                                                       N, states);
  if ((err = (int)cudaGetLastError())) return err;
  recur_walk_kernel<MAXN, true><<<grid, threads, smem, st>>>(
      x, ids, off, xdbl, dt_w, A, Dskip, bias, ends, carries, y, partial, S, L, D, N, R);
  if ((err = (int)cudaGetLastError())) return err;
  const int rows = B * kK * D;
  recur_pool_kernel<<<(rows + 255) / 256, 256, 0, st>>>(partial, off, pooled, S, D, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, L, D) float32, pixels row-major; ids (4, L) int32, a permutation of
// 0..L-1 per direction; x_proj_w (4, R + 2N, D); dt_w (4, D, R); A (4, D, N)
// (= -exp(A_logs)); Dskip, bias (4, D). Outputs y (B, 4, L, D) in image
// order and pooled (B, 4, D). N <= 32, R <= 64.
int tpuir_nss_scan_f32(const float* x, const int* ids, const float* x_proj_w, const float* dt_w,
                       const float* A, const float* Dskip, const float* bias, float* y,
                       float* pooled, float* scratch, int B, int L, int D, int N, int R,
                       void* stream) {
  return nss_scan<ImageIdsPath>(x, ids, x_proj_w, dt_w, A, Dskip, bias, y, pooled, scratch, B,
                                L, D, N, R, (cudaStream_t)stream);
}

// The serving body: x and y bf16, the weights float32 as tpuir_nss_scan_f32
// takes them (rounded to bf16 where they are products' operands), pooled
// float32; the same scratch.
int tpuir_nss_scan_bf16(const __nv_bfloat16* x, const int* ids, const float* x_proj_w,
                        const float* dt_w, const float* A, const float* Dskip, const float* bias,
                        __nv_bfloat16* y, float* pooled, float* scratch, int B, int L, int D,
                        int N, int R, void* stream) {
  return nss_scan<ImageIdsBf16Path>(x, ids, x_proj_w, dt_w, A, Dskip, bias, y, pooled, scratch,
                                    B, L, D, N, R, (cudaStream_t)stream);
}

// Floats of scratch tpuir_nss_scan_recur_bf16 needs: x_dbl, the subchunks'
// end states (a bf16 pair each) and their sums of y.
long long tpuir_nss_scan_recur_scratch_numel(int B, int L, int D, int N, int R, int S) {
  const long long rows = (long long)B * kK * S * D;
  return (long long)B * L * kK * (R + 2 * N) + rows * N + rows;
}

// The bf16-recurrence serving body: x_dbl as tpuir_nss_scan_bf16 computes it,
// then the three passes and the pooled sums. off (4, S + 1) int32: the
// position where each of a direction's subchunks starts, in path order,
// padded with L past its last one (S at least the subchunks of any
// direction). carries (B, 4, S, D, N) float32 receives the level-2 carry at
// each subchunk's start (0 in the padding).
int tpuir_nss_scan_recur_bf16(const __nv_bfloat16* x, const int* ids, const int* off,
                              const float* x_proj_w, const float* dt_w, const float* A,
                              const float* Dskip, const float* bias, __nv_bfloat16* y,
                              float* pooled, float* scratch, float* carries, int S, int B, int L,
                              int D, int N, int R, void* stream) {
  if (B <= 0 || L <= 0 || D <= 0 || N <= 0 || N > kMaxState || R <= 0 || R > kMaxRank || S <= 0)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * L;
  if (M > 0x7fffffffLL || (long long)S > 65535LL * kRecurGroup || B * kK > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* xdbl = scratch;
  auto* ends = reinterpret_cast<__nv_bfloat162*>(xdbl + M * kK * (R + 2 * N));
  float* partial = reinterpret_cast<float*>(ends + (long long)B * kK * S * D * N);
  int err = launch_simt_gemm(x, x_proj_w, xdbl, (int)M, kK * (R + 2 * N), D, st);
  if (err) return err;
  if (N <= 8)
    return launch_recur<8>(x, ids, off, xdbl, dt_w, A, Dskip, bias, y, pooled, ends, partial,
                           carries, S, B, L, D, N, R, st);
  if (N <= 16)
    return launch_recur<16>(x, ids, off, xdbl, dt_w, A, Dskip, bias, y, pooled, ends, partial,
                            carries, S, B, L, D, N, R, st);
  return launch_recur<32>(x, ids, off, xdbl, dt_w, A, Dskip, bias, y, pooled, ends, partial,
                          carries, S, B, L, D, N, R, st);
}

}  // extern "C"
