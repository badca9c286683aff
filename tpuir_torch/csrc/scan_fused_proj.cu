// K3: MaIR's selective scan with fused projections, on sequences already
// gathered along the four NSS paths, in float32 on Hopper (sm_90a),
// hand-written.
//
// Replaces: tpuir/ops/scan_pallas.py:_fused_forward (the Pallas TPU
// kernels _make_fused_kernel_vert / _make_fused_kernel, via
// selective_scan_fused_proj). MaIR takes it on a pyramid level whose H or W
// is not a multiple of scan_len, where the stripe kernel (K2) does not
// apply: the mixer gathers x into xs (B, 4, L, D) by the scan ids and
// scatters y back itself. Same math, per image b, direction k, position t:
//   x_dbl = W_xp[k] . xs[b, k, t]                (R + 2N values)
//   dt    = softplus(W_dt[k] . x_dbl[:R] + bias[k])   per channel d
//   h_t   = exp(dt * A[k]) * h_{t-1} + dt * x_dbl[R:R+N] * xs[b, k, t]
//   y     = x_dbl[R+N:] . h_t + D[k] * xs[b, k, t]
// y (B, 4, L, D) in sequence order; no pooled output, as in the TPU kernel.
// d_state N <= 32 (MaIRUNet's latent level has 32).
//
// What bounds it on this card. At MaIRUNet's latent level of a 481x321
// request (two 48x41 tiles, D = 768, N = 32, R = 24; B*4*L = 15,744
// sequence positions) and at its level 3 (two 96x82 tiles, D = 384, N = 16,
// R = 12) the work is the same: 387 M state updates. The function must read
// xs and write y (97 MB, 0.03 ms at 3.35 TB/s); the projections and the
// updates are about 5.5 GFLOP (0.08 ms at the 67 TFLOP/s float32 peak); and
// each update takes one exponential on the MUFU pipe, whose 16 lanes an SM
// give 4.1 Telem/s (P1): 0.094 ms. Besides the exponential an update issues
// a multiply (dt * A), dt*u*B, the FMA into h and its share of C . h, and a
// position adds dt's R-term dot and softplus, the sum over the states and
// the staging, so the issue slots, not the bytes, decide how close the scan
// comes to that floor.
//
// What the design does about it:
//   * x_dbl is one batch of B*4 products of (L, D) . (CS, D)^T on the SIMT
//     GEMM that K2 and K5 share (simt_gemm.cuh), image z reading direction
//     z % 4's weight, each output one FMA chain over k in ascending order.
//     The scan compounds x_dbl's rounding over a sequence, and at MaIRUNet's
//     two K3 shapes the scan's tolerance against the plain version is
//     tighter than float32's own error against float64 there: with x_dbl on
//     the 3xTF32 tensor-core core (tc_gemm.cuh) y came two to four times
//     nearer float64 than the plain version and still missed the tolerance
//     against it (PERF.md §6). On the H100 the plain version's x_dbl
//     (a torch.einsum) measured bit for bit an ascending FMA chain at those
//     shapes; tests/test_torch_scan_fused.py checks that on the card, by
//     name, for the plain version and for this kernel. The weight is first
//     copied with its rows in the staged order, zero rows in the padding
//     (pack_xproj_kernel), so that each x_dbl row comes out as the scan
//     stages it, CS floats: [dt_r (R, zeros to R4) | B (MAXN) | C (MAXN)],
//     MAXN the ceiling over N (4, 8, 16 or 32, zeros past N), CS a multiple
//     of 4 whose quarter is odd, so that 32 lanes reading 32 rows a float4 at
//     a time hit 32 distinct banks.
//   * The scan walks each sequence once from a zero state: one exponential
//     an update, no chunk carries, no second reading of x_dbl or u. A
//     channel's MAXN states lie across G lanes of a warp, S a lane (SeqLanes:
//     N 32 as 8 lanes x 4, N 16 as 16 x 1), so that a warp holds 32 / G
//     channels: a lane's S independent updates a position give the issue
//     slots something to overlap, its S values of B and of C come as one
//     vector load each, and the sum over the states crosses only G lanes.
//     At the latent (768 channels) 8 x 4 was the fastest layout measured;
//     level 3 (384 channels, L 7,872) has a quarter of its state lanes and
//     is bound by latency, not issue, so it takes the layout with the most
//     warps, 16 x 1 (PERF.md §6). A block is 4 warps of consecutive
//     channels of one sequence: 384 blocks on 132 SMs at both of MaIRUNet's
//     K3 levels of a 481x321 request. L is not cut into
//     segments: a segment after the first needs the state entering it,
//     which costs a second walk or a second exponential an update, the
//     price of chunk_scan.cuh's passes that this kernel exists to avoid.
//   * Positions go 32 a tile through a three-tile cp.async ring: the tile's
//     x_dbl rows (contiguous, 16-byte copies) and its u rows of the block's
//     channels (4-byte copies into rows padded to an odd stride). Per tile:
//     (a) lane i of each warp computes dt and dt*u of position i for each
//     of the warp's channels (the R-term dot from its staged row, W_dt from
//     shared memory, the two-MUFU softplus of chunk_scan.cuh) into a
//     warp-private table of (dt, dt*u) pairs, read back two positions a
//     float4 broadcast; (b) each lane runs the tile's 32 positions of its S
//     states and keeps their C . h of each position in a register; (c) a
//     butterfly over the channel's G lanes sums those (log2 G exchange
//     steps, halving the positions each step), leaving lane g the sums of
//     positions g*32/G onwards; (d) the sums go through a shared tile and
//     leave as rows of the block's channels, y = sum + D*u.
//   * Bit for bit on repeat: no atomics, every sum in a fixed order.
// The TPU kernel's padding of D to 128 lanes and L to the chunk, and its
// (S, P) vertical schedule, are TPU layouts with no counterpart here.
//
// The serving body (tpuir_scan_fused_proj_bf16; the TPU kernel with
// serving=True) is the same launches on bf16 xs: x_proj takes xs widened and
// the packed W_xp rounded to bf16 at load (simt_gemm.cuh), so x_dbl is the
// float32 sum of exact bf16 products and stays float32 in scratch; the scan
// stages u as bf16 (one 4-byte cp.async a pair of channels, so D must be
// even) and widens it where it is used, rounds W_dt to bf16 where it is
// staged and each dt column of a position's x_dbl row where the R-term dot
// reads it, so that each dt product is exact in float32 (the JAX kernel's
// bf16 x bf16 dt_proj); B, C, softplus, the states, D*u and y stay float32,
// and y is stored float32, as the TPU kernel stores it. u's bytes do not
// bound the scan: the serving body measured within 4% of the float32 one
// (PERF.md §6).
//
// C interface (ctypes, no PyTorch headers): launches go on the caller's
// stream, nothing is allocated or synchronised, the first cudaError_t met
// is returned (0 = success).

#include <cuda_runtime.h>

#include "chunk_scan.cuh"
#include "seq_lanes.cuh"
#include "simt_gemm.cuh"

namespace {

constexpr int kSeqWarps = 4;        // warps a block

// Floats of a staged x_dbl row: [dt_r (R, zeros to R4) | B (MAXN) | C
// (MAXN)], then 4 more if needed so that the row's count of float4s is odd.
inline int seq_row_floats(int R, int maxn) {
  const int cs = ((R + 3) & ~3) + 2 * maxn;
  return (cs / 4) % 2 ? cs : cs + 4;
}

struct SeqScanArgs {
  const void* x;       // xs (B*4, L, D), float or bf16
  const float* xdbl;   // (B*4, L, CS), packed rows
  const float* dt_w;   // (4, D, R)
  const float* A;      // (4, D, N)
  const float* Dskip;  // (4, D)
  const float* bias;   // (4, D)
  float* y;            // (B*4, L, D)
  int L, D, N, R, R4, CS;
};

// Shared memory of a block of CB channels, in floats: the x_dbl ring
// [stages][T][CS], W_dt [CB][R4], the (dt, dt*u) table [CB][T] of float2,
// the y tile [T][CB + 1], then the u ring [stages][T][CB + 1] (bf16 u:
// [stages][T][CB + 2] bf16 values, rows of an odd count of 4-byte words).
struct SeqSmem {
  int xring, wdt, dtdu, ytile, uring, total;
  __host__ __device__ SeqSmem(int CS, int R4, int CB, bool bf16_u = false) {
    xring = 0;
    wdt = xring + kSeqStages * kSeqT * CS;
    dtdu = wdt + CB * R4;
    ytile = dtdu + 2 * CB * kSeqT;
    uring = ytile + kSeqT * (CB + 1);
    total = uring + kSeqStages * kSeqT * (bf16_u ? (CB + 2) / 2 : CB + 1);
  }
};

// Grid (ceil(D / CB), B*4) of blocks of 32 * warps threads, CB = warps *
// 32 / G channels; dynamic shared memory SeqSmem(CS, R4, CB, TX is bf16)
// .total floats. TX: the type of xs, float or (the serving body, D even)
// bf16.
template <int MAXN, class TX>
__global__ void __launch_bounds__(kSeqWarps * 32) seq_scan_kernel(SeqScanArgs a) {
  constexpr bool kBf16 = std::is_same_v<TX, __nv_bfloat16>;
  constexpr int S = SeqLanes<MAXN>::S, G = SeqLanes<MAXN>::G;
  constexpr int CW = 32 / G;       // channels a warp
  constexpr int V = kSeqT / G;     // positions whose sums a lane ends with
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = a.L, D = a.D, N = a.N, R = a.R, R4 = a.R4, CS = a.CS;
  const int nthreads = blockDim.x;
  const int CB = (nthreads / 32) * CW, CBP = CB + 1;
  const int UP = kBf16 ? CB + 2 : CBP;  // u row pitch: bf16 rows of an odd count of words
  const int rows_a_pass = nthreads / CB;  // rows of CB channels the block covers at once
  const SeqSmem lay(CS, R4, CB, kBf16);
  float* xring = smem + lay.xring;
  float* wdt = smem + lay.wdt;
  float2* dtdu = reinterpret_cast<float2*>(smem + lay.dtdu);
  float* ytile = smem + lay.ytile;
  TX* uring = reinterpret_cast<TX*>(smem + lay.uring);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane & (G - 1);            // this lane's states g*S .. g*S + S - 1
  const int cb = warp * CW + lane / G;     // of channel cb of the block
  const int d0 = blockIdx.x * CB;
  const int bk = blockIdx.y, k = bk % kK;
  const int d = d0 + cb;
  // one 64-bit base a block; offsets inside a sequence are 32-bit (the
  // caller checks L * max(D, CS) < 2^31)
  const float* xdbl_b = a.xdbl + (long long)bk * L * CS;
  const TX* x_b = static_cast<const TX*>(a.x) + (long long)bk * L * D;
  float* y_b = a.y + (long long)bk * L * D;
  const long long kD = (long long)k * D;

  for (int e = tid; e < CB * R4; e += nthreads) {
    const int c = e / R4, r = e - c * R4;
    const float w = (d0 + c < D && r < R) ? a.dt_w[(kD + d0 + c) * R + r] : 0.f;
    wdt[e] = kBf16 ? scan_round_bf16(w) : w;
  }
  // A in base 2, so that a decay is exp2 of one product
  float A2[S], h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = g * S + s;
    A2[s] = (d < D && n < N) ? a.A[(kD + d) * N + n] * kLog2e : 0.f;
    h[s] = 0.f;
  }
  float bias_w[CW];  // the warp's channels' dt bias, for the dt lanes
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    const int dc = d0 + warp * CW + c;
    bias_w[c] = dc < D ? a.bias[kD + dc] : 0.f;
  }
  // the u copies and the y stores: thread tid takes column sc of rows
  // tid / CB + rows_a_pass * i (nthreads is a multiple of CB)
  const int sc = tid % CB, srow = tid / CB;
  const float D_s = d0 + sc < D ? a.Dskip[kD + d0 + sc] : 0.f;

  // Stage tile i into ring slot i % kSeqStages: its x_dbl rows, contiguous
  // (zeros past L), and its u rows of the block's channels (zeros past L
  // and D).
  auto stage = [&](int i) {
    const int t0 = i * kSeqT;
    float* xd = xring + (i % kSeqStages) * kSeqT * CS;
    const int nf = min(kSeqT, L - t0) * CS;
    for (int e = 4 * tid; e < kSeqT * CS; e += 4 * nthreads) {
      const bool ok = e < nf;
      cp_async16_zf(xd + e, ok ? xdbl_b + t0 * CS + e : xdbl_b, ok);
    }
    TX* ud = uring + (i % kSeqStages) * kSeqT * UP;
    if constexpr (kBf16) {
      // two channels (2 * pc, 2 * pc + 1) a copy, rows prow + 2 * rows_a_pass * i
      const int pc = tid % (CB / 2), prow = tid / (CB / 2);
      for (int row = prow; row < kSeqT; row += 2 * rows_a_pass) {
        const bool ok = t0 + row < L && d0 + 2 * pc < D;
        const TX* src = ok ? x_b + (t0 + row) * D + d0 + 2 * pc : x_b;
        cp_async4_zf(reinterpret_cast<float*>(ud + row * UP + 2 * pc),
                     reinterpret_cast<const float*>(src), ok);
      }
    } else {
      for (int row = srow; row < kSeqT; row += rows_a_pass) {
        const bool ok = t0 + row < L && d0 + sc < D;
        cp_async4_zf(ud + row * UP + sc, ok ? x_b + (t0 + row) * D + d0 + sc : x_b, ok);
      }
    }
  };

  const int ntiles = (L + kSeqT - 1) / kSeqT;
  stage(0);
  cp_async_commit();
  if (ntiles > 1) stage(1);
  cp_async_commit();
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<1>();                // this thread's copies of tile i have landed
    __syncthreads();                   // everyone's; everyone is done with tile i - 1
    if (i + 2 < ntiles) stage(i + 2);  // into tile i - 1's slot
    cp_async_commit();                 // (empty at the tail: keeps one group a tile)
    const int t0 = i * kSeqT;
    const float* xd = xring + (i % kSeqStages) * kSeqT * CS;
    const TX* ud = uring + (i % kSeqStages) * kSeqT * UP;

    // (a) dt and dt*u of position t0 + lane, for each of the warp's channels
    {
      const float* xr = xd + lane * CS;
      const float* wr = wdt + warp * CW * R4;
      float dr[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) dr[c] = bias_w[c];
      for (int r = 0; r < R4; r += 4) {
        float4 x4 = *reinterpret_cast<const float4*>(xr + r);
        if constexpr (kBf16) {  // dt_proj's operand: this lane's dt columns
          x4.x = scan_round_bf16(x4.x), x4.y = scan_round_bf16(x4.y);
          x4.z = scan_round_bf16(x4.z), x4.w = scan_round_bf16(x4.w);
        }
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const float4 w4 = *reinterpret_cast<const float4*>(wr + c * R4 + r);
          dr[c] = fmaf(w4.w, x4.w, fmaf(w4.z, x4.z, fmaf(w4.y, x4.y, fmaf(w4.x, x4.x, dr[c]))));
        }
      }
      const bool live = t0 + lane < L;  // past L: dt = 0, no step
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float dt = live ? softplus(dr[c]) : 0.f;
        dtdu[(warp * CW + c) * kSeqT + lane] =
            make_float2(dt, dt * scan_widen(ud[lane * UP + warp * CW + c]));
      }
    }
    __syncwarp();

    // (b) the tile's 32 updates of this lane's S states; p[j] = their C . h
    float p[kSeqT];
    {
      const float4* q4 = reinterpret_cast<const float4*>(dtdu + cb * kSeqT);
      const float* bq = xd + R4 + g * S;  // B of the lane's states; C at + MAXN
#pragma unroll
      for (int j = 0; j < kSeqT; j += 2) {
        const float4 q = q4[j / 2];  // (dt, dt*u) of positions j and j + 1
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float dt = jj ? q.z : q.x, du = jj ? q.w : q.y;
          float bv[S], cv[S];
          load_vec<S>(bq + (j + jj) * CS, bv);
          load_vec<S>(bq + (j + jj) * CS + MAXN, cv);
#pragma unroll
          for (int s = 0; s < S; ++s) h[s] = fmaf(exp2_mufu(dt * A2[s]), h[s], du * bv[s]);
          float acc = cv[0] * h[0];
#pragma unroll
          for (int s = 1; s < S; ++s) acc = fmaf(cv[s], h[s], acc);
          p[j + jj] = acc;
        }
      }
    }

    // (c) the sums over the channel's lanes, into the y tile
    sum_over_lanes<G>(p, lane);
#pragma unroll
    for (int v = 0; v < V; ++v) ytile[(g * V + v) * CBP + cb] = p[v];
    __syncthreads();

    // (d) y = sum + D*u, rows of the block's channels
    if (d0 + sc < D) {
      for (int row = srow; row < kSeqT && t0 + row < L; row += rows_a_pass)
        y_b[(t0 + row) * D + d0 + sc] =
            fmaf(D_s, scan_widen(ud[row * UP + sc]), ytile[row * CBP + sc]);
    }
  }
}

template <int MAXN, class TX>
int launch_seq_scan(const SeqScanArgs& a, long long BK, cudaStream_t st) {
  constexpr int CB = kSeqWarps * 32 / SeqLanes<MAXN>::G;
  const size_t smem =
      sizeof(float) * SeqSmem(a.CS, a.R4, CB, std::is_same_v<TX, __nv_bfloat16>).total;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        seq_scan_kernel<MAXN, TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.D + CB - 1) / CB, (unsigned)BK);
  seq_scan_kernel<MAXN, TX><<<grid, kSeqWarps * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// Both bodies: the packed weight, x_dbl on the SIMT GEMM (a bf16 xs rounds
// W_xp at load), then the scan.
template <class TX>
int scan_fused_proj(const TX* xs, const float* x_proj_w, const float* dt_w, const float* A,
                    const float* Dskip, const float* bias, float* y, float* scratch, int B, int L,
                    int D, int N, int R, cudaStream_t st) {
  if (B <= 0 || L <= 0 || D <= 0 || N <= 0 || N > kMaxState || R <= 0 || R > kMaxRank)
    return (int)cudaErrorInvalidValue;
  if (std::is_same_v<TX, __nv_bfloat16> && D % 2) return (int)cudaErrorInvalidValue;
  const long long BK = (long long)B * kK;
  const int maxn = seq_maxn(N);
  const int R4 = (R + 3) & ~3;
  const int CS = seq_row_floats(R, maxn);
  if (BK > 65535 || BK * L > 0x7fffffffLL || (long long)L * (D > CS ? D : CS) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  float* xdbl = scratch;
  float* wp = xdbl + BK * L * CS;

  // 0. the x_proj weight in the staged row order, then x_dbl of every
  //    sequence position: xs[b, k] (L, D) . wp[k]^T, a batch of B*4
  //    products, image z reading direction z % 4's weight
  pack_xproj_kernel<<<dim3(CS, kK), 256, 0, st>>>(x_proj_w, wp, D, N, R, R4, maxn, CS);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if ((err = launch_simt_gemm(xs, wp, xdbl, L, CS, D, st, (int)BK, kK))) return err;

  // 1. the scan, one pass over each sequence
  const SeqScanArgs a{xs, xdbl, dt_w, A, Dskip, bias, y, L, D, N, R, R4, CS};
  switch (maxn) {
    case 4: return launch_seq_scan<4, TX>(a, BK, st);
    case 8: return launch_seq_scan<8, TX>(a, BK, st);
    case 16: return launch_seq_scan<16, TX>(a, BK, st);
    default: return launch_seq_scan<32, TX>(a, BK, st);
  }
}

}  // namespace

extern "C" {

// Floats of scratch tpuir_scan_fused_proj_f32 and _bf16 need: the packed
// x_dbl rows and the packed x_proj weight.
long long tpuir_scan_fused_proj_scratch_numel(int B, int L, int D, int N, int R) {
  const long long CS = seq_row_floats(R, seq_maxn(N));
  return (long long)B * kK * L * CS + kK * CS * D;
}

// xs (B, 4, L, D) float32 in sequence order; x_proj_w (4, R + 2N, D);
// dt_w (4, D, R); A (4, D, N) (= -exp(A_logs)); Dskip, bias (4, D). Output
// y (B, 4, L, D). N <= 32, R <= 64.
int tpuir_scan_fused_proj_f32(const float* xs, const float* x_proj_w, const float* dt_w,
                              const float* A, const float* Dskip, const float* bias, float* y,
                              float* scratch, int B, int L, int D, int N, int R, void* stream) {
  return scan_fused_proj(xs, x_proj_w, dt_w, A, Dskip, bias, y, scratch, B, L, D, N, R,
                         (cudaStream_t)stream);
}

// The serving body: xs bf16 (D even), the weights float32 as
// tpuir_scan_fused_proj_f32 takes them (rounded to bf16 where they are
// products' operands), y float32; the same scratch.
int tpuir_scan_fused_proj_bf16(const __nv_bfloat16* xs, const float* x_proj_w,
                               const float* dt_w, const float* A, const float* Dskip,
                               const float* bias, float* y, float* scratch, int B, int L, int D,
                               int N, int R, void* stream) {
  return scan_fused_proj(xs, x_proj_w, dt_w, A, Dskip, bias, y, scratch, B, L, D, N, R,
                         (cudaStream_t)stream);
}

}  // extern "C"
