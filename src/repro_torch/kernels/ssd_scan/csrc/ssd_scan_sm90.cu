// Mamba-2 SSD chunked scan for NVIDIA Hopper (sm_90a) on the tensor cores:
// bf16 x, B, C at head dim 64, d_state 16, 64 or 128, chunks of 64, 128 or
// 256. Plain C entry points, one per pass: ssd_chunk_state_sm90,
// ssd_state_pass_sm90, ssd_chunk_scan_sm90 (ops.py calls the three in turn
// for the "sm90" variant; ssd_scan_mma_sm90.cu takes the other bf16 shapes,
// "mma", and ssd_scan_f32_sm90.cu float32, "tf32x3").
//
// Replaces: the Pallas TPU kernel `_ssd_kernel`, launched by `ssd_scan_pallas`
// (src/repro/kernels/ssd_scan/ssd_scan.py:24, :75), for bf16 inputs. It
// computes the same function, the contract of `ssd_chunked`: with cum = the
// prefix sum of dt * A over a chunk,
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j    (intra)
//          + exp(cum_i) C_i . state_in                               (inter)
//   state <- state exp(cum_last) + sum_j B_j exp(cum_last - cum_j) dt_j x_j
// Head h reads group h / (nh / g) of B and C; y in bf16, the final state in
// float32.
//
// Bound on an H100 SXM at the two serving shapes, both bytes:
//   mamba2-130m prefill (b 8, s 4096, nh 24, p 64, g 1, n 128, c 256; 24
//   launches a wave): x read and y written (100.7 MB each), B and C (16.8
//   MB), dt (3.1 MB), the final state (6.3 MB): ~227 MB, 0.0679 ms at 3.35
//   TB/s; ~40 GFLOP of products, 0.040 ms at the bf16 peak.
//   jamba-v0.1-52b prefill (b 8, s 1024, nh 128, p 64, g 1, n 16, c 256; 7
//   launches a wave): x and y (134.2 MB each), B and C (0.26 MB each), dt
//   and the final state (4.2 MB each): ~277 MB, 0.0828 ms; ~22 GFLOP,
//   0.022 ms.
//
// Design. The chunk-parallel split of `ssd_chunked`, each step a kernel:
//   1. ssd_fwd_chunk_state, grid (head tiles, chunks, batch), one warpgroup:
//      TMA brings the chunk's B (c x n) once and each head's x (c x 64);
//      warp 0 scans dt * A (f32) and writes cum per (b, head, s) for pass
//      3; x's rows are scaled in shared memory by dt exp(cum_last - cum)
//      (bf16) and s_k = (x w)^T B is one wgmma chain (M p = 64, N n, K c;
//      both operands MN-major), stored in f32.
//   2. ssd_fwd_state_pass, grid (p n / 1024, heads, batch): the in-order
//      recurrence state <- state exp(cum_last) + s_k in f32, four values a
//      thread; writes each chunk's starting state in bf16 (only ever the
//      bf16 wgmma operand of pass 3) and the final state in f32.
//   3. ssd_fwd_chunk_scan, grid (chunks x batch x head tiles, pairs of row
//      tiles of 64), the heaviest causal pairs first; two consumer
//      warpgroups, one per row tile of the pair (one exponentiates while the
//      other's products run; the pair shares its x and state loads), and a
//      producer warpgroup that gives its registers to them (setmaxnreg 40 /
//      232) and issues every copy from one thread. Each consumer forms S_j =
//      C_i B_j^T for every column tile j <= i ONCE on wgmma (both K-major)
//      and keeps it in f32 registers for all the block's heads (up to 32
//      heads of a group share it, instead of once per head). Per head, from a
//      two-stage ring (x tiles, starting state, cum, dt): y = exp(cum_i)
//      C_i state^T on wgmma (K n), then per column tile P = S o exp(cum_i -
//      cum_j) o dt_j, masked to j <= i BEFORE the exponential, split into
//      two bf16 parts (hi = bf16(P), lo = bf16(P - hi)) in the accumulator's
//      register order, each issued as the register-A operand of y += P x_j
//      with x MN-major (tnspB), as flash attention's P V. One bf16 P moved
//      mamba2's bf16 prefill logits by 0.43-0.47 against a 0.456 limit
//      (0.1 x max |logit|); hi + lo carries ~16 bits of P for twice the P x
//      products (16 GFLOP more at the main shape, ~62 issued in all). y is
//      stored in bf16 from registers.
//
// Along n (NBox). At n 64 and 128, B, C and the starting states come in
// boxes of 64 columns, 128-byte rows with 128-byte swizzle, a k16 step 32
// bytes inside the row. At n 16 a 64-column box would be three quarters
// zeros (TMA fills past the tensor's edge): 4x the n-products, 4x the shared
// memory of C, B and the states, and pass 1 would store 64-wide states.
// Instead a row is 16 bf16 = 32 bytes, TMA boxes are 16 columns with
// 32-byte swizzle, and the wgmma descriptors say so (desc_sw32: layout type
// 3, 8-row groups 256 bytes apart). Pass 1's product becomes m64n16k16 (8
// accumulator floats a thread; B MN-major, a k16 step 16 rows = 512 bytes);
// pass 3's C_i B_j^T and C_i state^T are one k16 step each, in place of 4
// or 8. The C, B and state tiles shrink from 8-16 KB to 2 KB. The freed
// shared memory buys nothing yet: registers (two 232-register consumers)
// keep one block of pass 3 per SM, and a ring of four stages read the same
// on the card as two (pass 3's consumers pace it, not its copies), so the
// ring stays at two. What helps at jamba's 128 heads to a group is fewer,
// longer blocks: 16 heads a block in pass 1 and 32 in pass 3 (S_j formed
// once per 32 heads; ops.STATE_HEADS / SCAN_HEADS, level with 4 and 8 at
// mamba2's 24). The P x products, the mask and the exponentials do not
// depend on n and are unchanged.
//
// The split moves more bytes than the bound counts: x is read by passes 1
// and 3 (pass 3 reads each x tile once per row tile at or below it, mostly
// from L2), the f32 chunk states (100.7 MB at mamba2's shape, 16.8 MB at
// jamba's) are written, read, and written again as bf16 starting states,
// read once per row tile. Not done yet: fusing passes 1 and 2, a TMA-store
// epilogue, overlapping one column tile's exponentials with the last one's
// products.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace repro_ssd_sm90 {

using namespace repro_sm90;

constexpr int P = 64;                 // head dim
constexpr int ROW = 128;              // bytes of one swizzled row: 64 bf16
constexpr int TILE = 64;              // rows of a tile (wgmma M)
constexpr int TILE_BYTES = TILE * ROW;
constexpr int CMAX = 256;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * LOG2E));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 pair = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&pair);
}

// B, C and the starting states along n: boxes of BOX columns, one row of a
// box ROWB bytes. n 16: one box of 32-byte rows, 32-byte swizzle; n 64 / 128:
// boxes of 64 columns in 128-byte rows, 128-byte swizzle.
template <int N>
struct NBox {
  static_assert(N == 16 || N == 64 || N == 128, "d_state 16, 64 or 128");
  static constexpr int BOX = N == 16 ? 16 : 64;
  static constexpr int KB = N / BOX;     // boxes along n
  static constexpr int ROWB = BOX * 2;
};

// Descriptor of an n-wide operand tile laid out as NBox<N> says; lbo as the
// swizzle's own helper takes it (unused for the K-major C, B and states).
template <int N>
__device__ __forceinline__ uint64_t desc_n(uint32_t saddr, uint32_t lbo) {
  if constexpr (N == 16) return desc_sw32(saddr, lbo, 256);
  else return desc_sw128(saddr, lbo, 1024);
}

// Start-address step (in 16-byte units) of k16 step kk along K = n of a
// K-major NBox<N> tile of 64 rows: n 16 is a single step; at n 64 / 128 a
// step is 32 bytes inside a 128-byte row, the next 64 columns one box on.
template <int N>
__device__ __forceinline__ uint32_t koff_n(int kk) {
  return N == 16 ? 0u : static_cast<uint32_t>(((kk / 4) * TILE_BYTES + (kk % 4) * 32) >> 4);
}

// (a, b) as the sum of two bf16 pairs: hi = bf16(a, b), lo = bf16(the rest).
// hi x + lo x carries ~16 bits of a and b into a product with bf16 x.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(a - f.x, b - f.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// ---------------------------------------------------------------------------
// Pass 1: chunk states. 128 threads; shared memory: B (CH rows of n, in
// NBox<N> boxes), x (CH rows), the weights w (CMAX floats), two mbarriers.
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int state_smem(int N, int CH) {
  return N * 2 * CH + CH * ROW + CMAX * 4 + 16 + 1024;
}

template <int N>
__global__ void __launch_bounds__(128)
ssd_fwd_chunk_state(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_b,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    float* __restrict__ states, float* __restrict__ cum_out,
                    int S, int NH, int G, int CH, int HPB,
                    long long sdb, long long sds, long long sdh) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  using NB = NBox<N>;
  const uint32_t sB = base;
  const uint32_t xoff = N * 2 * CH;   // a multiple of 1024 for CH >= 64
  const uint32_t sX = base + xoff;
  float* w = reinterpret_cast<float*>(gbase + xoff + CH * ROW);
  const uint32_t bar_b = smem_addr(w + CMAX), bar_x = bar_b + 8;

  const int NC = S / CH;
  const int k = blockIdx.y, b = blockIdx.z;
  const int h0 = blockIdx.x * HPB;
  const int grp = h0 / (NH / G);   // HPB divides NH / G: the block's heads share a group
  const int t0 = k * CH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    mbar_init(bar_b, 1);
    mbar_init(bar_x, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    tma_prefetch_map(&tm_x);
    tma_prefetch_map(&tm_b);
    mbar_arrive_expect_tx(bar_b, N * CH * 2);
#pragma unroll
    for (int q = 0; q < NB::KB; ++q)
      tma_load_4d(sB + q * CH * NB::ROWB, &tm_b, bar_b, NB::BOX * q, grp, t0, b);
    mbar_arrive_expect_tx(bar_x, CH * ROW);
    tma_load_4d(sX, &tm_x, bar_x, 0, h0, t0, b);
  }
  const int row_a = 16 * warp + lane / 4;   // p rows of the accumulator: row_a, row_a + 8
  const int cq = 2 * (lane % 4);
  const uint64_t da = desc_sw128(sX, CH * ROW, 1024);
  const uint64_t db = desc_n<N>(sB, CH * NB::ROWB);   // MN-major: lbo from box to box
  uint4* xg = reinterpret_cast<uint4*>(gbase + xoff);

  for (int hh = 0; hh < HPB; ++hh) {
    const int h = h0 + hh;
    if (warp == 0) {
      // Prefix sum of dt * A: each lane sums its CH / 32 rows in order, then
      // the lanes' totals are scanned across the warp.
      const int per = CH / 32;
      const float a = A[h];
      const float* dh = dt + b * sdb + h * sdh + static_cast<long long>(t0) * sds;
      float v[CMAX / 32], d[CMAX / 32];
      float run = 0.0f;
#pragma unroll
      for (int q = 0; q < CMAX / 32; ++q)
        if (q < per) {
          d[q] = dh[static_cast<long long>(lane * per + q) * sds];
          run += d[q] * a;
          v[q] = run;
        }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      const float off = incl - run;
      const float last = __shfl_sync(0xffffffffu, incl, 31);
      const long long o = (static_cast<long long>(b) * NH + h) * S + t0;
#pragma unroll
      for (int q = 0; q < CMAX / 32; ++q)
        if (q < per) {
          const int j = lane * per + q;
          const float c = v[q] + off;
          cum_out[o + j] = c;
          w[j] = d[q] * fast_exp(last - c);
        }
    }
    __syncthreads();   // w is written
    if (hh == 0) mbar_wait(bar_b, 0);   // B is loaded once, for all the block's heads
    mbar_wait(bar_x, hh & 1);
    // Scale x's rows by w in place. The 128-byte swizzle permutes 16-byte
    // pieces within a row, so piece e belongs to row e / 8 wherever it sits.
    for (int e = tid; e < CH * 8; e += 128) {
      uint4 v = xg[e];
      __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&v);
      const float wr = w[e / 8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(pr[q]);
        pr[q] = __floats2bfloat162_rn(f.x * wr, f.y * wr);
      }
      xg[e] = v;
    }
    fence_proxy_async();
    __syncthreads();

    float acc[N / 2];
    wgmma_fence();
    for (int kk = 0; kk < CH / 16; ++kk) {
      // 16 rows of both MN-major operands: 128-byte rows of x, NB::ROWB of B
      const uint32_t ox = (kk * 16 * ROW) >> 4, ob = (kk * 16 * NB::ROWB) >> 4;
      if constexpr (N == 128) wgmma_ss_m64n128k16<1, 1>(acc, da + ox, db + ob, kk > 0);
      else if constexpr (N == 64) wgmma_ss_m64n64k16<1, 1>(acc, da + ox, db + ob, kk > 0);
      else wgmma_ss_m64n16k16<1, 1>(acc, da + ox, db + ob, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    __syncthreads();   // every warp's products have read x and w
    if (tid == 0 && hh + 1 < HPB) {
      mbar_arrive_expect_tx(bar_x, CH * ROW);
      tma_load_4d(sX, &tm_x, bar_x, 0, h + 1, t0, b);
    }
    float* out = states + ((static_cast<long long>(b) * NC + k) * NH + h) * P * N;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + cq;
      *reinterpret_cast<float2*>(out + row_a * N + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(out + (row_a + 8) * N + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 2: the recurrence over chunks, 256 threads of four values each.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
ssd_fwd_state_pass(const float* __restrict__ states, const float* __restrict__ cum,
                   const float* __restrict__ init, __nv_bfloat16* __restrict__ h_in,
                   float* __restrict__ final_state, int S, int NH, int PN, int CH) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int e = (blockIdx.x * 256 + threadIdx.x) * 4;
  if (e >= PN) return;
  const int NC = S / CH;
  const long long bh = static_cast<long long>(b) * NH + h;
  float4 st = init ? *reinterpret_cast<const float4*>(init + bh * PN + e)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float* last = cum + bh * S + CH - 1;
#pragma unroll 4
  for (int k = 0; k < NC; ++k) {
    const long long off = ((static_cast<long long>(b) * NC + k) * NH + h) * PN + e;
    const float4 sk = *reinterpret_cast<const float4*>(states + off);
    const float dec = expf(last[static_cast<long long>(k) * CH]);
    uint2 packed;
    packed.x = pack_bf16(st.x, st.y);
    packed.y = pack_bf16(st.z, st.w);
    *reinterpret_cast<uint2*>(h_in + off) = packed;
    st.x = st.x * dec + sk.x;
    st.y = st.y * dec + sk.y;
    st.z = st.z * dec + sk.z;
    st.w = st.w * dec + sk.w;
  }
  *reinterpret_cast<float4*>(final_state + bh * PN + e) = st;
}

// ---------------------------------------------------------------------------
// Pass 3: outputs. 384 threads: warpgroups 0 and 1 the consumers of row
// tiles 2m and 2m + 1 of the chunk, warpgroup 2 the producer (one thread
// issues every copy). Shared memory: C for the two row tiles, B_0 ..
// B_{NT-1} (64 rows x N each), two stages of (x tiles 0 .. NT-1, the
// starting state 64 x N, cum and dt over the chunk), five mbarriers.
// ---------------------------------------------------------------------------
struct ScanSmem {
  int cb, stage, x, st, cum, dt, bars, bytes;
  __host__ __device__ ScanSmem(int N, int CH) {
    const int nt = CH / TILE;
    cb = TILE * N * 2;                                // C_i, B_j or a state tile
    x = 0;                                            // offsets inside a stage
    st = nt * TILE_BYTES;
    cum = st + cb;
    dt = cum + CH * 4;
    stage = (dt + CH * 4 + 1023) & ~1023;
    bars = (2 + nt) * cb + 2 * stage;                 // from the aligned base
    bytes = bars + 8 * 5 + 1024;
  }
};

template <int N>
__global__ void __launch_bounds__(384, 1)
ssd_fwd_chunk_scan(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_b,
                   const __grid_constant__ CUtensorMap tm_c,
                   const __grid_constant__ CUtensorMap tm_h,
                   const float* __restrict__ cum, const float* __restrict__ dtT,
                   __nv_bfloat16* __restrict__ y, int S, int NH, int G, int CH, int HPB,
                   long long syb, long long sys, long long syh) {
  using NB = NBox<N>;
  const ScanSmem L(N, CH);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - raw);
  const int NT = CH / TILE, NC = S / CH;
  const uint32_t sB = base + 2 * L.cb;
  const uint32_t stage0 = base + (2 + NT) * L.cb;
  auto stage = [&](int s) { return stage0 + static_cast<uint32_t>(s) * L.stage; };
  const uint32_t bars = base + L.bars;
  const uint32_t full_cb = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (3 + s); };

  // The block's row tiles: i0 = 2m and, where the chunk has it, i0 + 1;
  // the heaviest pairs first.
  const int i0 = 2 * ((NT + 1) / 2 - 1 - static_cast<int>(blockIdx.y));
  const int last = min(i0 + 1, NT - 1), rows = last - i0 + 1;
  const int n_ht = NH / HPB;
  int r = blockIdx.x;
  const int ht = r % n_ht;
  r /= n_ht;
  const int k = r % NC, b = r / NC;
  const int h0 = ht * HPB;
  const int grp = h0 / (NH / G);
  const int t0 = k * CH;
  // warp-uniform through the shuffle: ptxas then sees the consumers' branches
  // on their row tile as uniform and does not serialize their wgmma (C7520)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(full_cb, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * rows);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every copy ----
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      tma_prefetch_map(&tm_x);
      tma_prefetch_map(&tm_b);
      tma_prefetch_map(&tm_c);
      tma_prefetch_map(&tm_h);
      mbar_arrive_expect_tx(full_cb, (rows + last + 1) * L.cb);
      for (int c = 0; c < rows; ++c)
#pragma unroll
        for (int q = 0; q < NB::KB; ++q)
          tma_load_4d(base + c * L.cb + q * TILE * NB::ROWB, &tm_c, full_cb, NB::BOX * q, grp,
                      t0 + TILE * (i0 + c), b);
      for (int j = 0; j <= last; ++j)
#pragma unroll
        for (int q = 0; q < NB::KB; ++q)
          tma_load_4d(sB + j * L.cb + q * TILE * NB::ROWB, &tm_b, full_cb, NB::BOX * q, grp,
                      t0 + TILE * j, b);
      for (int hh = 0; hh < HPB; ++hh) {
        const int s = hh & 1, h = h0 + hh;
        mbar_wait(empty(s), ((hh >> 1) & 1) ^ 1);   // the first two pass at once
        mbar_arrive_expect_tx(full(s), (last + 1) * TILE_BYTES + L.cb + 2 * CH * 4);
        for (int j = 0; j <= last; ++j)
          tma_load_4d(stage(s) + L.x + j * TILE_BYTES, &tm_x, full(s), 0, h, t0 + TILE * j, b);
#pragma unroll
        for (int q = 0; q < NB::KB; ++q)
          tma_load_4d(stage(s) + L.st + q * TILE * NB::ROWB, &tm_h, full(s), NB::BOX * q, 0, h,
                      b * NC + k);
        const long long o = (static_cast<long long>(b) * NH + h) * S + t0;
        bulk_load(stage(s) + L.cum, cum + o, CH * 4, full(s));
        bulk_load(stage(s) + L.dt, dtT + o, CH * 4, full(s));
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: row tile i0 + wg, 64 rows of the chunk ----
  regs_alloc<232>();
  const int i = i0 + wg, ti = t0 + TILE * i;
  if (i > last) return;   // a chunk of one row tile: the second consumer has none
  const int ra = 16 * warp + lane / 4, rb = ra + 8;   // this thread's rows in the tile
  const int cq = 2 * (lane % 4);
  const uint64_t dC = desc_n<N>(base + wg * L.cb, 16);
  mbar_wait(full_cb, 0);

  // S_j = C_i B_j^T, j <= i: K-major operands, K = n in k16 steps (koff_n).
  float sacc[4][32];
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j <= i) {
      const uint64_t dB = desc_n<N>(sB + j * L.cb, 16);
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        wgmma_ss_m64n64k16(sacc[j], dC + koff_n<N>(kk), dB + koff_n<N>(kk), kk > 0);
    }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < 4; ++j) fence_operands(sacc[j]);

  for (int hh = 0; hh < HPB; ++hh) {
    const int s = hh & 1, h = h0 + hh;
    const uint32_t sx = stage(s) + L.x;
    const float* cu = reinterpret_cast<const float*>(gbase + (stage(s) - base) + L.cum);
    const float* dv = reinterpret_cast<const float*>(gbase + (stage(s) - base) + L.dt);
    mbar_wait(full(s), (hh >> 1) & 1);

    // Inter-chunk term: acc = C_i . state^T (K n), rows scaled by exp(cum_i).
    float acc[32];
    const uint64_t dH = desc_n<N>(stage(s) + L.st, 16);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss_m64n64k16(acc, dC + koff_n<N>(kk), dH + koff_n<N>(kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    const float ci_a = cu[TILE * i + ra], ci_b = cu[TILE * i + rb];
    const float ea = fast_exp(ci_a), eb = fast_exp(ci_b);
#pragma unroll
    for (int q = 0; q < 32; ++q) acc[q] *= (q & 2) ? eb : ea;

    // Intra-chunk terms: y += P_j x_j, P_j = S_j o exp(cum_i - cum_j) o dt_j.
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j <= i) {
        uint32_t hi[16], lo[16];
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          float pa[2], pb[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int lc = 8 * jn + cq + e;             // column inside the tile
            const float cc = cu[TILE * j + lc], dd = dv[TILE * j + lc];
            // select before the exponential: above the diagonal cum_i - cum_j > 0
            pa[e] = (j < i || lc <= ra) ? sacc[j][4 * jn + e] * fast_exp(ci_a - cc) * dd : 0.0f;
            pb[e] = (j < i || lc <= rb) ? sacc[j][4 * jn + 2 + e] * fast_exp(ci_b - cc) * dd : 0.0f;
          }
          split_bf16(pa[0], pa[1], hi[2 * jn], lo[2 * jn]);
          split_bf16(pb[0], pb[1], hi[2 * jn + 1], lo[2 * jn + 1]);
        }
        // x_j as the MN-major B operand: K = 64 rows of the tile, 16 rows
        // (2048 bytes) a k16 step; N = p = 64 columns, one box.
        const uint64_t dX = desc_sw128(sx + j * TILE_BYTES, TILE_BYTES, 1024);
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t ah[4] = {hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3]};
          const uint32_t al[4] = {lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3]};
          wgmma_rs_m64n64k16(acc, ah, dX + ((kk * 16 * ROW) >> 4), 1);
          wgmma_rs_m64n64k16(acc, al, dX + ((kk * 16 * ROW) >> 4), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(acc);
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));   // this warp is done with the stage

    __nv_bfloat16* ya = y + b * syb + static_cast<long long>(ti + ra) * sys + h * syh;
    __nv_bfloat16* yb = ya + 8 * sys;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const int col = 8 * jn + cq;
      *reinterpret_cast<uint32_t*>(ya + col) = pack_bf16(acc[4 * jn], acc[4 * jn + 1]);
      *reinterpret_cast<uint32_t*>(yb + col) = pack_bf16(acc[4 * jn + 2], acc[4 * jn + 3]);
    }
  }
}

// The box width along n (NBox<N>::BOX on the card), and the swizzle of a
// box of that many bf16 columns: one 32-byte or 128-byte row.
inline int n_box(int N) { return N == 16 ? 16 : 64; }
inline CUtensorMapSwizzle swizzle_of(int box) {
  return box == 16 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B;
}

// A 4-D map over (inner, second, rows, batch) of a bf16 tensor, element
// strides (batch, row, second), boxes of `inner_box` x 1 x `rows_box` x 1:
// 64 columns with 128-byte swizzle, or 16 with 32-byte swizzle.
bool map_rows(CUtensorMap* map, const void* ptr, int inner, int second, int rows, int batch,
              long long s_batch, long long s_row, long long s_second, int rows_box,
              int inner_box = 64) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(second),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_second) * 2,
                                 static_cast<cuuint64_t>(s_row) * 2,
                                 static_cast<cuuint64_t>(s_batch) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(inner_box), 1,
                             static_cast<cuuint32_t>(rows_box), 1};
  return make_map_bf16(map, ptr, dims, strides, box, swizzle_of(inner_box));
}

bool shape_ok(int batch, int S, int NH, int G, int N, int CH, int HPB) {
  return batch > 0 && S > 0 && NH > 0 && G > 0 && NH % G == 0 &&
         (N == 16 || N == 64 || N == 128) &&
         (CH == 64 || CH == 128 || CH == 256) && S % CH == 0 && HPB > 0 &&
         (NH / G) % HPB == 0;
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace repro_ssd_sm90

using namespace repro_ssd_sm90;

// Pass 1. x (b, s, nh, 64) and B (b, s, g, n) bf16 with element strides
// (b, s, head / group), unit stride last, 16-byte aligned; dt (b, s, nh) f32
// with element strides; A (nh,) f32. Writes states (b, s / c, nh, 64, n) f32
// and cum (b, nh, s) f32, both contiguous. HPB heads per block, a divisor of
// nh / g. Returns a cudaError_t.
extern "C" int ssd_chunk_state_sm90(const void* x, const void* dt, const void* A, const void* B,
                                    void* states, void* cum, int batch, int S, int NH,
                                    int G, int N, int CH, int HPB,
                                    long long sxb, long long sxs, long long sxh,
                                    long long sdb, long long sds, long long sdh,
                                    long long sbb, long long sbs, long long sbg, void* stream) {
  if (!shape_ok(batch, S, NH, G, N, CH, HPB)) return cudaErrorInvalidValue;
  CUtensorMap tm_x, tm_b;
  if (!map_rows(&tm_x, x, P, NH, S, batch, sxb, sxs, sxh, CH) ||
      !map_rows(&tm_b, B, N, G, S, batch, sbb, sbs, sbg, CH, n_box(N)))
    return cudaErrorInvalidValue;
  const int smem = state_smem(N, CH);
  const dim3 grid(NH / HPB, S / CH, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SSD_STATE_LAUNCH(DIM)                                                              \
  err = set_smem(ssd_fwd_chunk_state<DIM>, smem);                                          \
  if (err != cudaSuccess) return err;                                                      \
  ssd_fwd_chunk_state<DIM><<<grid, 128, smem, st>>>(                                       \
      tm_x, tm_b, static_cast<const float*>(dt), static_cast<const float*>(A),             \
      static_cast<float*>(states), static_cast<float*>(cum), S, NH, G, CH, HPB, sdb, sds,  \
      sdh)
  if (N == 128) {
    SSD_STATE_LAUNCH(128);
  } else if (N == 64) {
    SSD_STATE_LAUNCH(64);
  } else {
    SSD_STATE_LAUNCH(16);
  }
#undef SSD_STATE_LAUNCH
  return cudaGetLastError();
}

// Pass 2. states (b, s / c, nh, P, N) and cum (b, nh, s) f32 from pass 1,
// init (b, nh, P, N) f32 or NULL; writes h_in (b, s / c, nh, P, N) bf16, the
// state at each chunk's start, and the final state (b, nh, P, N) f32.
extern "C" int ssd_state_pass_sm90(const void* states, const void* cum, const void* init,
                                   void* h_in, void* final_state, int batch, int S, int NH,
                                   int PN, int CH, void* stream) {
  if (batch <= 0 || S <= 0 || NH <= 0 || CH <= 0 || S % CH != 0 || PN <= 0 || PN % 4 != 0)
    return cudaErrorInvalidValue;
  const dim3 grid((PN / 4 + 255) / 256, NH, batch);
  ssd_fwd_state_pass<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(states), static_cast<const float*>(cum),
      static_cast<const float*>(init), static_cast<__nv_bfloat16*>(h_in),
      static_cast<float*>(final_state), S, NH, PN, CH);
  return cudaGetLastError();
}

// Pass 3. x, B, C as in pass 1 (C like B); cum from pass 1, dtT (b, nh, s)
// f32 (dt transposed, contiguous), h_in from pass 2; writes y (b, s, nh, 64) bf16 through its element strides (unit
// stride last).
extern "C" int ssd_chunk_scan_sm90(const void* x, const void* B, const void* C, const void* cum,
                                   const void* dtT, const void* h_in, void* y, int batch, int S,
                                   int NH, int G, int N, int CH, int HPB,
                                   long long sxb, long long sxs, long long sxh,
                                   long long sbb, long long sbs, long long sbg,
                                   long long scb, long long scs, long long scg,
                                   long long syb, long long sys, long long syh, void* stream) {
  if (!shape_ok(batch, S, NH, G, N, CH, HPB)) return cudaErrorInvalidValue;
  const int NC = S / CH;
  CUtensorMap tm_x, tm_b, tm_c, tm_h;
  // h_in as (N, P, NH, batch * NC): boxes of n_box(N) columns x all 64 rows of p.
  const cuuint64_t hdims[4] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(P),
                               static_cast<cuuint64_t>(NH),
                               static_cast<cuuint64_t>(batch) * NC};
  const cuuint64_t hstrides[3] = {static_cast<cuuint64_t>(N) * 2,
                                  static_cast<cuuint64_t>(P) * N * 2,
                                  static_cast<cuuint64_t>(NH) * P * N * 2};
  const cuuint32_t hbox[4] = {static_cast<cuuint32_t>(n_box(N)), 64, 1, 1};
  if (!map_rows(&tm_x, x, P, NH, S, batch, sxb, sxs, sxh, TILE) ||
      !map_rows(&tm_b, B, N, G, S, batch, sbb, sbs, sbg, TILE, n_box(N)) ||
      !map_rows(&tm_c, C, N, G, S, batch, scb, scs, scg, TILE, n_box(N)) ||
      !make_map_bf16(&tm_h, h_in, hdims, hstrides, hbox, swizzle_of(n_box(N))))
    return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(NC) * batch * (NH / HPB);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = ScanSmem(N, CH).bytes;
  const dim3 grid(static_cast<unsigned>(blocks), (CH / TILE + 1) / 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SSD_SCAN_LAUNCH(DIM)                                                                    \
  err = set_smem(ssd_fwd_chunk_scan<DIM>, smem);                                                \
  if (err != cudaSuccess) return err;                                                           \
  ssd_fwd_chunk_scan<DIM><<<grid, 384, smem, st>>>(                                             \
      tm_x, tm_b, tm_c, tm_h, static_cast<const float*>(cum), static_cast<const float*>(dtT),   \
      static_cast<__nv_bfloat16*>(y), S, NH, G, CH, HPB, syb, sys, syh)
  if (N == 128) {
    SSD_SCAN_LAUNCH(128);
  } else if (N == 64) {
    SSD_SCAN_LAUNCH(64);
  } else {
    SSD_SCAN_LAUNCH(16);
  }
#undef SSD_SCAN_LAUNCH
  return cudaGetLastError();
}
