// What K3 (scan_fused_proj.cu) and the serving walk of K2 and K5 (nss_walk.cuh) share
// to walk a sequence with a channel's states across the lanes of a warp:
// the tile of positions, the staging copies, the register ceiling of the
// states, the butterfly sum over a channel's lanes, and the x_proj weight
// packed into the order of a staged x_dbl row. Each caller's source note
// gives the design.

#pragma once

#include "chunk_scan.cuh"

namespace {

constexpr int kSeqT = 32;            // positions a tile
constexpr int kSeqStages = 3;        // tiles in the cp.async ring

// Asynchronous 16- and 4-byte copies to shared memory that write zeros
// instead where ok is false.
__device__ __forceinline__ void cp_async16_zf(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4_zf(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0));
}

// The register ceiling of the states (4, 8, 16 or 32) for N states.
inline int seq_maxn(int N) { return N <= 4 ? 4 : N <= 8 ? 8 : N <= 16 ? 16 : 32; }

// How a channel's MAXN states lie across a warp: S states a lane, G lanes a
// channel, 32 / G channels a warp.
template <int MAXN>
struct SeqLanes;
template <>
struct SeqLanes<4> { static constexpr int S = 1, G = 4; };
template <>
struct SeqLanes<8> { static constexpr int S = 2, G = 4; };
template <>
struct SeqLanes<16> { static constexpr int S = 1, G = 16; };
template <>
struct SeqLanes<32> { static constexpr int S = 4, G = 8; };

// S floats at p (S * 4-byte aligned) into v.
template <int S>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[S]) {
  if constexpr (S == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (S == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

// The sum over the G lanes of a channel of each of p[0..31] (position j of
// the tile), by halving: at each step a lane sends the half of its
// positions that its partner (lane ^ W) keeps and adds the partner's share
// to the half it keeps. After log2(G) steps lane g of the channel holds the
// sums of positions g * 32/G + v in p[v], v < 32/G, taken as a fold in
// halves over g: (g, g + G/2), then (g, g + G/4), and so on. (One step a
// template instance, so that every index is a constant and p stays in
// registers.)
template <int G, int W = G / 2>
__device__ __forceinline__ void sum_over_lanes(float (&p)[kSeqT], int lane) {
  constexpr int half = kSeqT * W / G;
  const bool up = (lane & W) != 0;
#pragma unroll
  for (int i = 0; i < half; ++i) {
    const float send = up ? p[i] : p[i + half];
    const float keep = up ? p[i + half] : p[i];
    p[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
  if constexpr (W > 1) sum_over_lanes<G, W / 2>(p, lane);
}

// The x_proj weight (4, R + 2N, D) with its rows in the order of a staged
// x_dbl row, [dt_r (R, zeros to R4) | B (maxn) | C (maxn)] and zero rows to
// CS (K3: seq_row_floats): grid (CS, 4), wp (4, CS, D).
__global__ void __launch_bounds__(256) pack_xproj_kernel(const float* __restrict__ w,
                                                         float* __restrict__ wp, int D, int N,
                                                         int R, int R4, int maxn, int CS) {
  const int j = blockIdx.x, k = blockIdx.y;
  int src = -1;
  if (j < R)
    src = j;
  else if (j >= R4 && j < R4 + N)
    src = R + (j - R4);  // B_n
  else if (j >= R4 + maxn && j < R4 + maxn + N)
    src = R + N + (j - R4 - maxn);  // C_n
  const float* ws = w + ((long long)k * (R + 2 * N) + (src >= 0 ? src : 0)) * D;
  float* wd = wp + ((long long)k * CS + j) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) wd[d] = src >= 0 ? ws[d] : 0.f;
}

}  // namespace
