// The serving walk of MaIR's four-direction NSS scan, shared by K2's serving
// body (nss_scan.cu, tpuir_nss_scan_bf16) and K5's (nss_fused.cu,
// tpuir_nss_scan_fused_bf16): x_proj's weight packed into the staged row
// order, x_dbl on the SIMT GEMM's bf16 A mode, then a walk of each chunk of
// each sequence with a channel's states across the lanes of a warp. The two
// differ only in where a position's pixel comes from (the Pos argument):
//   WalkIds (K2): pixel p = ids[k][t], the NSS id table, read by cp.async
//     into a ring two tiles ahead of the tile that stages from it; y is
//     written at p.
//   WalkStripe (K5): the stripe arithmetic of chunk_scan.cuh's nss_pixel,
//     computed two tiles ahead by the first T threads of the block (its two
//     integer divisions once a position and block, not once a lane) into a
//     ring of pixels and a ring of the rows of y they write; y is written at
//     that row, which for directions 2 and 3 lies in the transposed (W, H)
//     image, so the bf16 pair stores still coalesce along d.
// nss_scan.cu's source note gives the math, what bounds the walk on the card
// and what the design does about it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "chunk_scan.cuh"
#include "seq_lanes.cuh"
#include "simt_gemm.cuh"

namespace {

constexpr int kWalkWarps = 4;     // warps a block
constexpr int kWalkIdSlots = 8;   // tiles of positions in their ring: tile i's
                                  // for its y rows while tiles up to i + 4 load

// How a channel's MAXN states lie across a warp: S states a lane, G lanes a
// channel, 32 / G channels a warp.
template <int MAXN>
struct WalkLanes;
template <>
struct WalkLanes<4> { static constexpr int S = 1, G = 4; };
template <>
struct WalkLanes<8> { static constexpr int S = 4, G = 2; };
template <>
struct WalkLanes<16> { static constexpr int S = 4, G = 4; };
template <>
struct WalkLanes<32> { static constexpr int S = 4, G = 8; };

// Names the walk's launches of chunk_scan.cuh's carry chain and partial sums.
struct WalkChunks {};

struct WalkArgs {
  const __nv_bfloat16* x;  // (B, L, D), pixels row-major
  const int* ids;          // (4, L): WalkIds
  const float* xdbl;       // (B, L, 4, CS): packed rows
  const float* dt_w;       // (4, D, R)
  const float* A;          // (4, D, N)
  const float* Dskip;      // (4, D)
  const float* bias;       // (4, D)
  __nv_bfloat16* y;        // (B, 4, L, D)
  float* pooled;           // (B, 4, D), written by the walk where nchunk is 1
  float* hstate;           // (B*4, nchunk, D, N): chunk end states, then initial states
  float* decay;            // (B*4, nchunk, D, N): chunk decay products
  float* partial;          // (B*4, nchunk, D): chunk sums of y
  int L, D, N, R, R4, CS, chunk, nchunk;
};
// K5's: the H x W image (L = H*W) and its stripes besides
struct StripeWalkArgs : WalkArgs {
  int H, W, scan_len, shift;
};

// Where a walk's positions come from: its arguments, and kRings rings of
// ints (the pixels; then, where they differ, the rows of y).
struct WalkIds {
  static constexpr bool kStripe = false;
  static constexpr int kRings = 1;
  using Args = WalkArgs;
};
struct WalkStripe {
  static constexpr bool kStripe = true;
  static constexpr int kRings = 2;
  using Args = StripeWalkArgs;
};

// Shared memory of a block of CB channels, in floats: the x_dbl ring
// [stages][T][CS], W_dt [CB][R4], the (dt, dt*u) table [CB][T] of float2,
// the y tile [T][CB + 1], the u ring [stages][T][CB + 2] of bf16 (rows of an
// odd count of 4-byte words), the positions rings [rings][kWalkIdSlots][T] of
// ints.
struct WalkSmem {
  int xring, wdt, dtdu, ytile, uring, ids, total;
  __host__ __device__ WalkSmem(int CS, int R4, int CB, int rings = 1) {
    xring = 0;
    wdt = xring + kSeqStages * kSeqT * CS;
    dtdu = wdt + CB * R4;
    ytile = dtdu + 2 * CB * kSeqT;
    uring = ytile + kSeqT * (CB + 1);
    ids = uring + kSeqStages * kSeqT * (CB + 2) / 2;
    total = ids + kWalkIdSlots * kSeqT * rings;
  }
};

// WalkStripe: position t of direction k, the pixel it reads into *pixel_at
// and the row it writes in y's direction-k image into *out_at; zeros where
// not live.
__device__ __forceinline__ void stripe_position(const StripeWalkArgs& a, int k, int t,
                                                bool live, int* pixel_at, int* out_at) {
  int pixel = 0, out = 0;
  if (live) nss_pixel(k, t, a.H, a.W, a.scan_len, a.shift != 0, pixel, out);
  *pixel_at = pixel;
  *out_at = out;  // y's row: in the transposed image for directions 2 and 3
}

// The walk of chunk blockIdx.y of (image, direction) blockIdx.z for the CB
// channels of block blockIdx.x. FINAL = false (never the last chunk): from
// a zero state, store the chunk's end state and decay product. FINAL = true:
// from the state entering the chunk (zero for the first), store y and the
// chunk's sum of y (one chunk: pooled). Grid (ceil(D / CB), chunks, B*4) of
// kWalkWarps * 32 threads; dynamic shared memory WalkSmem(CS, R4, CB,
// Pos::kRings).total floats. (K2's expressions are written as K2's walk
// needs them and K5's in branches of their own: another form of the same
// index, or K5's arguments in WalkArgs, changes the SASS of K2's instances.)
template <class Pos, int MAXN, bool FINAL>
__device__ __forceinline__ void walk_chunk(const typename Pos::Args& a) {
  constexpr int S = WalkLanes<MAXN>::S, G = WalkLanes<MAXN>::G;
  constexpr int T = kSeqT, NT = kWalkWarps * 32;
  constexpr int CW = 32 / G;            // channels a warp
  constexpr int CB = kWalkWarps * CW;   // channels a block
  constexpr int CBP = CB + 1;           // y tile row pitch
  constexpr int V = T / G;              // positions whose sums a lane ends with
  constexpr int UP = CB + 2;            // u row pitch, in bf16
  constexpr int PAIRS = CB / 2;         // channel pairs: u copies, y stores
  constexpr int PROWS = NT / PAIRS;     // rows of pairs the block covers at once
  constexpr int YRING = kWalkIdSlots * T;  // the rows of y after the pixels (K5)
  static_assert(T % PROWS == 0 && PROWS * PAIRS * 2 <= T * CBP, "pair rows");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = a.L, D = a.D, N = a.N, R4 = a.R4, CS = a.CS;
  const WalkSmem lay(CS, R4, CB, Pos::kRings);
  float* xring = smem + lay.xring;
  float* wdt = smem + lay.wdt;
  float2* dtdu = reinterpret_cast<float2*>(smem + lay.dtdu);
  float* ytile = smem + lay.ytile;
  __nv_bfloat16* uring = reinterpret_cast<__nv_bfloat16*>(smem + lay.uring);
  int* idring = reinterpret_cast<int*>(smem + lay.ids);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane & (G - 1);            // this lane's states g*S .. g*S + S - 1
  const int cb = warp * CW + lane / G;     // of channel cb of the block
  const int d0 = blockIdx.x * CB, d = d0 + cb;
  const int c = blockIdx.y;
  const int bk = blockIdx.z, b = bk / kK, k = bk - b * kK;
  const int t0 = c * a.chunk;
  const int nc = min(a.chunk, L - t0);     // positions of this chunk
  const int ntiles = (nc + T - 1) / T;
  // one 64-bit base a block; offsets inside an image are 32-bit (the caller
  // checks L * max(D, 4 CS) < 2^31)
  const float* xdbl_b = a.xdbl + (long long)b * L * kK * CS + k * CS;
  const __nv_bfloat16* x_b = a.x + (long long)b * L * D;
  __nv_bfloat16* y_b = a.y + (long long)bk * L * D;
  const int* ids_c = Pos::kStripe ? nullptr : a.ids + (long long)k * L + t0;
  const long long kD = (long long)k * D;

  for (int e = tid; e < CB * R4; e += NT) {
    const int cc = e / R4, r = e - cc * R4;
    const float w = (d0 + cc < D && r < a.R) ? a.dt_w[(kD + d0 + cc) * a.R + r] : 0.f;
    wdt[e] = scan_round_bf16(w);  // dt_proj's operand
  }
  // the positions of tiles 0 and 1
  if constexpr (Pos::kStripe) {
    for (int e = tid; e < 2 * T; e += NT)
      stripe_position(a, k, t0 + e, e < nc, idring + e, idring + YRING + e);
  } else {
    for (int e = tid; e < 2 * T; e += NT) idring[e] = e < nc ? ids_c[e] : 0;
  }
  // A in base 2, so that a decay is exp2 of one product
  const long long state = (((long long)bk * a.nchunk + c) * D + d) * N;
  float A2[S], h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = g * S + s;
    const bool live = d < D && n < N;
    A2[s] = live ? a.A[(kD + d) * N + n] * kLog2e : 0.f;
    h[s] = FINAL && c > 0 && live ? a.hstate[state + n] : 0.f;  // the chained carry
  }
  float bias_w[CW];  // the warp's channels' dt bias, for the dt lanes
#pragma unroll
  for (int cc = 0; cc < CW; ++cc) {
    const int dc = d0 + warp * CW + cc;
    bias_w[cc] = dc < D ? a.bias[kD + dc] : 0.f;
  }
  // the u copies and the y stores: thread tid takes channels dp, dp + 1 of
  // rows prow + PROWS * j (D is even, so both or neither are in)
  const int pc = tid % PAIRS, prow = tid / PAIRS, dp = d0 + 2 * pc;
  const float D0 = dp < D ? a.Dskip[kD + dp] : 0.f, D1 = dp < D ? a.Dskip[kD + dp + 1] : 0.f;
  float pool0 = 0.f, pool1 = 0.f, sum_dt = 0.f;
  __syncthreads();

  // Stage tile i into ring slot i % kSeqStages: its x_dbl rows (16-byte
  // copies, zeros past the chunk) and its u rows of the block's channel
  // pairs, at the pixels of tile i; then the positions of tile i + 2 (K2:
  // their ids by cp.async; K5: computed, visible after the next barrier).
  auto stage = [&](int i) {
    const int nt = min(T, nc - i * T);
    const int* id = idring + (i % kWalkIdSlots) * T;
    float* xd = xring + (i % kSeqStages) * T * CS;
    const int q4 = CS >> 2;
    for (int e = tid; e < T * q4; e += NT) {
      const int row = e / q4;
      const bool ok = row < nt;
      cp_async16_zf(xd + 4 * e, ok ? xdbl_b + id[row] * (kK * CS) + 4 * (e - row * q4) : xdbl_b,
                    ok);
    }
    __nv_bfloat16* ud = uring + (i % kSeqStages) * T * UP;
    for (int row = prow; row < T; row += PROWS) {
      const bool ok = row < nt && dp < D;
      const __nv_bfloat16* src = ok ? x_b + id[row] * D + dp : x_b;
      cp_async4_zf(reinterpret_cast<float*>(ud + row * UP + 2 * pc),
                   reinterpret_cast<const float*>(src), ok);
    }
    const int q = (i + 2) * T + tid;
    if constexpr (Pos::kStripe) {
      const int e = ((i + 2) % kWalkIdSlots) * T + tid;
      if (tid < T && i + 2 < ntiles)
        stripe_position(a, k, t0 + q, q < nc, idring + e, idring + YRING + e);
    } else {
      if (tid < T && i + 2 < ntiles)
        cp_async4_zf(reinterpret_cast<float*>(idring + ((i + 2) % kWalkIdSlots) * T + tid),
                     reinterpret_cast<const float*>(ids_c + (q < nc ? q : 0)), q < nc);
    }
  };

  stage(0);
  cp_async_commit();
  if (ntiles > 1) stage(1);
  cp_async_commit();
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<1>();                // this thread's copies of tile i have landed
    __syncthreads();                   // everyone's; everyone is done with tile i - 1
    if (i + 2 < ntiles) stage(i + 2);  // into tile i - 1's slot
    cp_async_commit();                 // (empty at the tail: keeps one group a tile)
    const int nt = min(T, nc - i * T);
    const float* xd = xring + (i % kSeqStages) * T * CS;
    const __nv_bfloat16* ud = uring + (i % kSeqStages) * T * UP;

    // (a) dt and dt*u of position i*T + lane, for each of the warp's channels
    {
      const float* xr = xd + lane * CS;
      const float* wr = wdt + warp * CW * R4;
      float dr[CW];
#pragma unroll
      for (int cc = 0; cc < CW; ++cc) dr[cc] = bias_w[cc];
      for (int r = 0; r < R4; r += 4) {
        float4 x4 = *reinterpret_cast<const float4*>(xr + r);
        // dt_proj's operand: the position's dt columns rounded to bf16
        x4.x = scan_round_bf16(x4.x), x4.y = scan_round_bf16(x4.y);
        x4.z = scan_round_bf16(x4.z), x4.w = scan_round_bf16(x4.w);
#pragma unroll
        for (int cc = 0; cc < CW; ++cc) {
          const float4 w4 = *reinterpret_cast<const float4*>(wr + cc * R4 + r);
          dr[cc] = fmaf(w4.w, x4.w, fmaf(w4.z, x4.z, fmaf(w4.y, x4.y, fmaf(w4.x, x4.x, dr[cc]))));
        }
      }
      const bool live = lane < nt;  // past the chunk: dt = 0, no step
#pragma unroll
      for (int cc = 0; cc < CW; ++cc) {
        const float dt = live ? softplus(dr[cc]) : 0.f;
        dtdu[(warp * CW + cc) * T + lane] =
            make_float2(dt, dt * __bfloat162float(ud[lane * UP + warp * CW + cc]));
      }
    }
    __syncwarp();

    // (b) the tile's 32 updates of this lane's S states; p[j] = their C . h
    float p[FINAL ? T : 1];
    {
      const float4* q4 = reinterpret_cast<const float4*>(dtdu + cb * T);
      const float* bq = xd + R4 + g * S;  // B of the lane's states; C at + MAXN
#pragma unroll
      for (int j = 0; j < T; j += 2) {
        const float4 q = q4[j / 2];  // (dt, dt*u) of positions j and j + 1
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float dt = jj ? q.z : q.x, du = jj ? q.w : q.y;
          float bv[S];
          load_vec<S>(bq + (j + jj) * CS, bv);
#pragma unroll
          for (int s = 0; s < S; ++s) h[s] = fmaf(exp2_mufu(dt * A2[s]), h[s], du * bv[s]);
          if constexpr (FINAL) {
            float cv[S];
            load_vec<S>(bq + (j + jj) * CS + MAXN, cv);
            float acc = cv[0] * h[0];
#pragma unroll
            for (int s = 1; s < S; ++s) acc = fmaf(cv[s], h[s], acc);
            p[j + jj] = acc;
          } else {
            sum_dt += dt;
          }
        }
      }
    }
    if constexpr (FINAL) {
      // (c) the sums over the channel's lanes, into the y tile
      sum_over_lanes<G>(p, lane);
#pragma unroll
      for (int v = 0; v < V; ++v) ytile[(g * V + v) * CBP + cb] = p[v];
      __syncthreads();

      // (d) y = sum + D*u of a channel pair, stored as a bf16 pair at the
      //     position's row of y; pooled from the float32 y
      if (dp < D) {
        const int* id = idring + (i % kWalkIdSlots) * T;
        if constexpr (Pos::kStripe) id += YRING;  // the rows of y
        for (int row = prow; row < nt; row += PROWS) {
          const float2 u = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(ud + row * UP + 2 * pc));
          const float y0 = fmaf(D0, u.x, ytile[row * CBP + 2 * pc]);
          const float y1 = fmaf(D1, u.y, ytile[row * CBP + 2 * pc + 1]);
          *reinterpret_cast<__nv_bfloat162*>(y_b + id[row] * D + dp) =
              __floats2bfloat162_rn(y0, y1);  // y's rounding
          pool0 += y0, pool1 += y1;  // the float32 y, before it is rounded
        }
      }
    }
  }
  if constexpr (FINAL) {
    // the chunk's sum of y of each channel: the pair threads' sums, in row order
    __syncthreads();
    float2* ps = reinterpret_cast<float2*>(ytile);  // [PROWS][PAIRS]
    ps[prow * PAIRS + pc] = make_float2(pool0, pool1);
    __syncthreads();
    if (tid < CB && d0 + tid < D) {
      float sum = 0.f;
      for (int r = 0; r < PROWS; ++r) {
        const float2 v = ps[r * PAIRS + (tid >> 1)];
        sum += tid & 1 ? v.y : v.x;
      }
      if (a.nchunk == 1)
        a.pooled[(long long)bk * D + d0 + tid] = sum;
      else
        a.partial[((long long)bk * a.nchunk + c) * D + d0 + tid] = sum;
    }
  } else {
    // the chunk's end state and decay product exp(A * sum of dt), one MUFU a state
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int n = g * S + s;
      if (d < D && n < N) {
        a.hstate[state + n] = h[s];
        a.decay[state + n] = exp2_mufu(A2[s] * sum_dt);
      }
    }
  }
}

// K2's walk (positions from the id table) and K5's (from the stripe
// arithmetic), kernels of their own names.
template <int MAXN, bool FINAL>
__global__ void __launch_bounds__(kWalkWarps * 32) nss_walk_kernel(WalkArgs a) {
  walk_chunk<WalkIds, MAXN, FINAL>(a);
}
template <int MAXN, bool FINAL>
__global__ void __launch_bounds__(kWalkWarps * 32) nss_stripe_walk_kernel(StripeWalkArgs a) {
  walk_chunk<WalkStripe, MAXN, FINAL>(a);
}

// Pos's walk kernel for MAXN states, FINAL or not.
template <class Pos, int MAXN, bool FINAL>
constexpr auto walk_kernel() {
  if constexpr (Pos::kStripe)
    return nss_stripe_walk_kernel<MAXN, FINAL>;
  else
    return nss_walk_kernel<MAXN, FINAL>;
}

// The walk's dynamic shared memory, in bytes, into smem, after raising the
// kernels' limit where it passes 48 KB; the CUDA error of that, or 0.
template <class Pos, int MAXN>
int walk_smem(int CS, int R4, size_t& smem) {
  constexpr int CB = kWalkWarps * 32 / WalkLanes<MAXN>::G;
  smem = sizeof(float) * WalkSmem(CS, R4, CB, Pos::kRings).total;
  if (smem <= 48 * 1024) return 0;
  int err = (int)cudaFuncSetAttribute(walk_kernel<Pos, MAXN, false>(),
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (!err)
    err = (int)cudaFuncSetAttribute(walk_kernel<Pos, MAXN, true>(),
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return err;
}

// Blocks of the walk that emits y (the last pass) one SM holds at once.
template <class Pos, int MAXN>
int walk_resident(int CS, int R4) {
  size_t smem;
  int blocks = 0;
  if (walk_smem<Pos, MAXN>(CS, R4, smem) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, walk_kernel<Pos, MAXN, true>(),
                                                    kWalkWarps * 32, smem))
    return -1;
  return blocks;
}

template <class Pos, int MAXN>
int launch_walk(const typename Pos::Args& a, long long BK, cudaStream_t st) {
  constexpr int CB = kWalkWarps * 32 / WalkLanes<MAXN>::G;
  size_t smem;
  int err = walk_smem<Pos, MAXN>(a.CS, a.R4, smem);
  if (err) return err;
  const unsigned blocks = (unsigned)((a.D + CB - 1) / CB);
  if (a.nchunk > 1) {
    // 1. the end state and decay product of every chunk but the last
    const auto ends = walk_kernel<Pos, MAXN, false>();
    ends<<<dim3(blocks, a.nchunk - 1, (unsigned)BK), kWalkWarps * 32, smem, st>>>(a);
    if ((err = (int)cudaGetLastError())) return err;
    // 2. the state entering each chunk
    const long long chains = BK * a.D * a.N;
    chain_carries_kernel<WalkChunks><<<(unsigned)((chains + 255) / 256), 256, 0, st>>>(
        a.hstate, a.decay, BK, a.nchunk, a.D * a.N);
    if ((err = (int)cudaGetLastError())) return err;
  }
  // 3. y, and each chunk's sum of y
  const auto walk = walk_kernel<Pos, MAXN, true>();
  walk<<<dim3(blocks, a.nchunk, (unsigned)BK), kWalkWarps * 32, smem, st>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  // 4. pooled: the chunks' sums in chunk order
  if (a.nchunk > 1)
    return launch_sum_partials<WalkChunks>(a.partial, a.pooled, BK, a.nchunk, a.D, st);
  return 0;
}

// The packed row of the walk for N states, R ranks: {R4, MAXN, CS}.
struct WalkRow {
  int R4, maxn, CS;
  WalkRow(int N, int R) : R4((R + 3) & ~3), maxn(seq_maxn(N)), CS(R4 + 2 * maxn) {}
};

inline int walk_chunks(int L, int chunk) { return (L + chunk - 1) / chunk; }

// Floats of the serving body's scratch: x_dbl's packed rows, the packed
// weight, and with more than one chunk the chunk states, decay products and
// sums of y.
long long walk_scratch_numel(int B, int L, int D, int N, int R, int chunk) {
  const WalkRow row(N, R);
  const long long BK = (long long)B * kK, nchunk = walk_chunks(L, chunk);
  return (long long)B * L * kK * row.CS + (long long)kK * row.CS * D +
         (nchunk > 1 ? BK * nchunk * D * (2LL * N + 1) : 0);
}

// Blocks of Pos's walk one SM of the current device holds at once for N
// states and R ranks (-1 on a CUDA error or an N or R out of range).
template <class Pos>
int walk_resident_blocks(int N, int R) {
  if (N <= 0 || N > kMaxState || R <= 0 || R > kMaxRank) return -1;
  const WalkRow row(N, R);
  switch (row.maxn) {
    case 4: return walk_resident<Pos, 4>(row.CS, row.R4);
    case 8: return walk_resident<Pos, 8>(row.CS, row.R4);
    case 16: return walk_resident<Pos, 16>(row.CS, row.R4);
    default: return walk_resident<Pos, 32>(row.CS, row.R4);
  }
}

// The serving body on B images of a.L pixels: a holds x, the walk's
// positions (ids, or H, W, scan_len, shift), the scan weights, y, pooled,
// L, D, N, R and chunk (positions a chunk, a multiple of 32); the rest is
// filled in here, from scratch of walk_scratch_numel floats. D must be even.
template <class Pos>
int serving_walk(typename Pos::Args a, const float* x_proj_w, float* scratch, int B,
                 cudaStream_t st) {
  const int L = a.L, D = a.D, N = a.N, R = a.R;
  if (B <= 0 || L <= 0 || D <= 0 || D % 2 || N <= 0 || N > kMaxState || R <= 0 ||
      R > kMaxRank || a.chunk <= 0 || a.chunk % kSeqT)
    return (int)cudaErrorInvalidValue;
  const WalkRow row(N, R);
  const long long M = (long long)B * L, BK = (long long)B * kK;
  const int nchunk = walk_chunks(L, a.chunk);
  if (M > 0x7fffffffLL || BK > 65535 || nchunk > 65535 ||
      (long long)L * (D > kK * row.CS ? D : kK * row.CS) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  float* xdbl = scratch;
  float* wp = xdbl + M * kK * row.CS;
  a.xdbl = xdbl;
  a.hstate = wp + (long long)kK * row.CS * D;
  a.decay = a.hstate + BK * nchunk * D * N;
  a.partial = a.decay + BK * nchunk * D * N;
  a.R4 = row.R4;
  a.CS = row.CS;
  a.nchunk = nchunk;

  // 0. the x_proj weight in the staged row order, then x_dbl of every pixel
  //    and direction: (B*L, D) . (4*CS, D)^T, W_xp rounded to bf16 at load
  pack_xproj_kernel<<<dim3(row.CS, kK), 256, 0, st>>>(x_proj_w, wp, D, N, R, row.R4, row.maxn,
                                                      row.CS);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if ((err = launch_simt_gemm(a.x, wp, xdbl, (int)M, kK * row.CS, D, st))) return err;

  // 1-4. the walks
  switch (row.maxn) {
    case 4: return launch_walk<Pos, 4>(a, BK, st);
    case 8: return launch_walk<Pos, 8>(a, BK, st);
    case 16: return launch_walk<Pos, 16>(a, BK, st);
    default: return launch_walk<Pos, 32>(a, BK, st);
  }
}

}  // namespace
