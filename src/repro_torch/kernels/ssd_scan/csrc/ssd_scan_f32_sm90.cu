// Mamba-2 SSD chunked scan for NVIDIA Hopper (sm_90a) in float32 on the
// tensor cores: the "tf32x3" variant, float32 x, B, C at head dims 16, 32
// and 64, any d_state up to 128, any chunk up to 256. Plain C entry points,
// one per pass: ssd_chunk_state_f32, ssd_state_pass_f32, ssd_chunk_scan_f32
// (ops.py calls the three in turn for the "tf32x3" variant).
//
// Replaces: the Pallas TPU kernel `_ssd_kernel`, launched by `ssd_scan_pallas`
// (src/repro/kernels/ssd_scan/ssd_scan.py:24, :75, pallas_call at :90), for
// float32 inputs. It computes the same function, the contract of
// `ssd_chunked`: with cum = the prefix sum of dt * A over a chunk,
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j    (intra)
//          + exp(cum_i) C_i . state_in                               (inter)
//   state <- state exp(cum_last) + sum_j B_j exp(cum_last - cum_j) dt_j x_j
// Head h reads group h / (nh / g) of B and C; an optional float32 init state;
// y and the final state in float32. No atomics: results are deterministic.
//
// Arithmetic (kernels/csrc/tf32x3.cuh): every product is three TF32
// mma.sync m16n8k8 products of a hi / lo split, lo*hi + hi*lo + hi*hi,
// summed in float32; one TF32 product would miss the float32 limit. The
// exponentials stay float32 on the CUDA cores (ex2), and the causal mask
// j <= i is applied to the exponent BEFORE the exponential, so no inf is ever
// formed above the diagonal.
//
// Bound on an H100 SXM at mamba2-130m's shape in float32 (b 8, s 4096, nh
// 24, p 64, g 1, n 128, c 256): 39.78 GFLOP of the chunked algorithm on the
// causal half of each chunk (C.B^T once per group), three TF32 products
// each, is 119 GFLOP, 0.2411 ms at the dense TF32 peak of 495 TFLOP/s; x
// read and y written (201 MB each), B and C (16.8 MB each), dt and the final
// state: ~446 MB, 0.133 ms at 3.35 TB/s. So it is bound by operations (the
// same work on the CUDA cores in float32: 0.5938 ms at 67 TFLOP/s). The
// split into passes moves more bytes than that bound counts: the float32
// chunk states (201 MB) are written by pass 1, read and written over by
// pass 2 (the starting states, in place) and read by pass 3, and x is read
// by passes 1 and 3; with y that is ~1.44 GB, ~0.43 ms at 3.35 TB/s, a
// floor of this design above the bound.
//
// Design. The chunk-parallel split of `ssd_chunked`, one kernel a pass, all
// on mma.sync TF32 fragments (TF32 wgmma takes its shared-memory operands
// K-major only, so x and the states would need transposed copies, and their
// hi and lo parts both staged there). Operands reach shared memory through
// cp.async into a two-stage ring (16-byte copies where the views allow,
// 4-byte where they do not; the host decides); rows past a ragged chunk's
// end and columns past n arrive as zeros. Shared memory holds the raw
// float32 values, and each thread splits what it loads in registers: a lo
// buffer in shared memory would double the loads, which already pace the
// products. Padded strides (tile width + 4 floats) keep every fragment load
// free of bank conflicts. n is padded to NP, the next power of two from 16,
// in shared memory only. M = p runs in row pairs (row r < 8 of an m-tile is
// p 2r, row r + 8 is p 2r + 1) and K slot t is chunk row 2t, t + 4 row 2t +
// 1, so each x quad is two 8-byte loads.
//   1. ssd_fwd_chunk_state_f32, grid (heads, chunks, batch), four warps:
//      warp 0 scans dt * A in float32, writes cum per (b, head, s) for pass
//      3 and w_j = dt_j exp(cum_last - cum_j); then states = (x w)^T B
//      (M p, N n, K c) in pieces of 64 chunk rows, a warp two 16-row m-tiles
//      of p (one at p 16) and its share of the n-tiles, x scaled by w as it
//      is loaded.
//   2. ssd_fwd_state_pass_f32, grid (p n / 1024, heads, batch): the in-order
//      recurrence state <- state exp(cum_last) + s_k in float32, four values
//      a thread; each chunk's starting state comes out in float32 (pass 3's
//      operand), written over that chunk's own state when the caller passes
//      the same buffer for both (each value is read before it is
//      overwritten: 100.7 MB less at the main shape).
//   3. ssd_fwd_chunk_scan_f32, grid (head tiles x chunks x batch x row tiles
//      of 64, the row tile fastest and the heaviest first, so the blocks that
//      read the same x tiles and starting states run side by side), eight
//      warps: warp w takes 16 rows of the tile and head 2q + w / 4 of each
//      head pair q. In the transposed form y^T = x^T P^T + h_in (exp(cum_i)
//      C_i)^T, with M = p, N = the warp's 16 rows (two n-tiles), K = chunk
//      rows j or n: first S_j = C_i B_j^T (K n) for every column tile j <= i,
//      ONCE for all the block's heads of a group (heads per block:
//      ops.F32_SCAN_HEADS), kept in shared memory in fragment order (one
//      16-byte load a thread an n-tile); then per head pair, from the ring
//      (h_in in pieces of 64 n, x tiles of 64 rows, both heads in a stage),
//      acc = h_in C_i^T, its columns scaled by exp(cum_i), then acc +=
//      x_j^T P_j^T with P_j = S_j o exp(cum_i - cum_j) o dt_j, masked to
//      j <= i before the exponential. S's accumulator pairs for rows i, i + 8
//      and columns 2t, 2t + 1 are P^T's B pairs of K slots t and t + 4 for
//      the two n-tiles as they are, with no shuffle. y is stored from
//      registers, one 8-byte store per row pair of p.
// Not done yet: fusing passes 1 and 2, sharing pass 1's B piece across the
// heads of a group, TF32 wgmma with the lo parts staged K-major.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace repro_ssd_f32 {

using namespace repro_tf32x3;

constexpr int CMAX = 256;       // longest chunk
constexpr int NMAX = 128;       // largest d_state
constexpr int TILE = 64;        // rows of a row or column tile (pass 3)
constexpr int KR = 32;          // chunk rows of a pass-1 piece
constexpr int STAGES = 3;       // ring buffers: two items in flight while one is computed
constexpr int STATE_THREADS = 128;
constexpr int SCAN_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; `bytes` below the size (0) fills the rest of
// the destination with zeros and reads nothing past `bytes`.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory row of p row r of a head's starting state in pass 3: the row
// pairs of M = p (row r' < 8 of an m-tile is p 2r', row r' + 8 is p 2r' + 1),
// so that each A quad is one 16-row block of rows g, g + 8.
__device__ __forceinline__ int pair_row(int r) {
  return (r & ~15) + ((r & 1) << 3) + ((r & 15) >> 1);
}

// Start the copy of a rows x cols tile into shared memory at dst (ld floats
// a row), row r from src + r * rs (unit stride along it), onto row
// pair_row(r) when `pairs`. Rows >= vrows and columns >= vcols arrive as
// zeros. cols is a power of two from 16 to 128, at most the block's threads;
// vec: 16-byte copies (src 16-byte aligned, rs and vcols multiples of 4),
// else 4-byte ones. Every thread of the block takes part.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, long long rs,
                                          int rows, int cols, int vrows, int vcols, bool vec,
                                          bool pairs) {
  const int per = vec ? cols >> 2 : cols;   // copies a row
  const int c = (threadIdx.x % per) * (vec ? 4 : 1);
  const int step = blockDim.x / per;
  for (int r = threadIdx.x / per; r < rows; r += step) {
    const bool ok = r < vrows && c < vcols;
    const uint32_t d = saddr(dst + (pairs ? pair_row(r) : r) * ld + c);
    const float* from = ok ? src + r * rs + c : src;
    if (vec)
      cp16(d, from, ok ? 16 : 0);
    else
      cp4(d, from, ok ? 4 : 0);
  }
}

// n padded for the tiles: the next power of two from 16.
__host__ __device__ inline int n_pad(int N) {
  int np = 16;
  while (np < N) np *= 2;
  return np;
}

// acc[m][nt] += a[m] b[nt] for M m-tiles x N n-tiles, three TF32 products
// each, issued in three rounds over the tiles, so that no product waits on
// the one just issued into the same accumulator.
template <int M, int N>
__device__ __forceinline__ void rounds(float (&acc)[M][N][4], const uint32_t (&ah)[M][4],
                                       const uint32_t (&al)[M][4], const uint32_t (&bh)[N][2],
                                       const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int nt = 0; nt < N; ++nt) mma_tf32(acc[m][nt], al[m], bh[nt][0], bh[nt][1]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int nt = 0; nt < N; ++nt) mma_tf32(acc[m][nt], ah[m], bl[nt][0], bl[nt][1]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int nt = 0; nt < N; ++nt) mma_tf32(acc[m][nt], ah[m], bh[nt][0], bh[nt][1]);
}

// ---------------------------------------------------------------------------
// Pass 1: chunk states. 128 threads. Shared memory (floats): w and dt over
// the chunk (CMAX each), then STAGES ring buffers of {x: KR x (P + 4), B:
// KR x (NP + 4)}.
// ---------------------------------------------------------------------------
__host__ __device__ inline int state_stage_floats(int P, int NP) {
  return KR * (P + 4) + KR * (NP + 4);
}

template <int P>
__global__ void __launch_bounds__(STATE_THREADS)
ssd_fwd_chunk_state_f32(const float* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A, const float* __restrict__ B,
                        float* __restrict__ states, float* __restrict__ cum_out,
                        int S, int NH, int G, int N, int CH, int vx, int vb,
                        long long sxb, long long sxs, long long sxh,
                        long long sdb, long long sds, long long sdh,
                        long long sbb, long long sbs, long long sbg) {
  constexpr int MT = P / 16;          // m-tiles of p
  constexpr int MW = MT < 2 ? MT : 2; // m-tiles a warp holds
  constexpr int MP = MT / MW;         // warps across p
  constexpr int PARTS = 4 / MP;       // warps across n, each a share of the n-tiles
  constexpr int U = 16 / PARTS;       // n-tiles a warp holds at NP 128
  constexpr int LDX = P + 4;
  const int NP = n_pad(N), LDB = NP + 4;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* w = sm;
  float* dts = sm + CMAX;
  const int stage_f = state_stage_floats(P, NP);
  auto xs = [&](int s) { return sm + 2 * CMAX + s * stage_f; };

  const int h = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int NC = S / CH, t0 = k * CH;
  const int grp = h / (NH / G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* xb = x + b * sxb + static_cast<long long>(t0) * sxs + h * sxh;
  const float* bb = B + b * sbb + static_cast<long long>(t0) * sbs + grp * sbg;
  const int n_items = (CH + KR - 1) / KR;

  auto issue = [&](int it) {
    if (it == 0) {
      // dt over the chunk, with the first piece
      const float* dh = dt + b * sdb + h * sdh + static_cast<long long>(t0) * sds;
      for (int j = threadIdx.x; j < CH; j += blockDim.x) cp4(saddr(dts + j), dh + j * sds, 4);
    }
    if (it < n_items) {
      float* st = xs(it % STAGES);
      const int r0 = it * KR, vr = min(KR, CH - r0);
      load_tile(st, LDX, xb + r0 * sxs, sxs, KR, P, vr, P, vx, false);
      load_tile(st + KR * LDX, LDB, bb + r0 * sbs, sbs, KR, NP, vr, N, vb, false);
    }
    cp_commit();
  };
  issue(0);
  issue(1);

  const int mg = warp % MP, part = warp / MP;
  float acc[MW][U][4];
#pragma unroll
  for (int mw = 0; mw < MW; ++mw)
#pragma unroll
    for (int u = 0; u < U; ++u) acc[mw][u][0] = acc[mw][u][1] = acc[mw][u][2] = acc[mw][u][3] = 0.0f;

  for (int it = 0; it < n_items; ++it) {
    const float* X = xs(it % STAGES);
    const float* Bs = X + KR * LDX;
    const int vr = min(KR, CH - it * KR);
    cp_wait<STAGES - 2>();
    // the piece has landed for every thread; every warp is done with the
    // buffer of piece it - 1, which piece it + 2 refills
    __syncthreads();
    if (it == 0) {
      if (warp == 0) {
        // Prefix sum of dt * A: each lane sums its `per` rows in order, then the
        // lanes' totals are scanned across the warp. w = 0 past the chunk.
        const int per = (CH + 31) / 32;
        const float a = A[h];
        float v[CMAX / 32], d[CMAX / 32];
        float run = 0.0f;
#pragma unroll
        for (int q = 0; q < CMAX / 32; ++q) {
          const int j = lane * per + q;
          if (q < per && j < CH) {
            d[q] = dts[j];
            run += d[q] * a;
            v[q] = run;
          }
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
        for (int q = 0; q < CMAX / 32; ++q) {
          const int j = lane * per + q;
          if (q < per && j < CH) {
            const float c = v[q] + off;
            cum_out[o + j] = c;
            w[j] = d[q] * ex2((last - c) * LOG2E);
          }
        }
        for (int j = CH + lane; j < CMAX; j += 32) w[j] = 0.0f;
      }
      __syncthreads();   // w is written
    }
    issue(it + STAGES - 1);
    // one k-step: K slots t, t + 4 = piece rows r, r + 1; A rows g, g + 8 =
    // p 2g, 2g + 1, x scaled by w and split here. `full`: every n-tile of
    // the warp is real (NP 128), so no product sits under a branch (a branch
    // around mma.sync costs a WARPSYNC each).
    auto kstep = [&](int kk, bool full) {
      const int r = 8 * kk + 2 * t;
      const float2 wv = *reinterpret_cast<const float2*>(w + it * KR + r);
      uint32_t ah[MW][4], al[MW][4], bh[U][2], bl[U][2];
#pragma unroll
      for (int mw = 0; mw < MW; ++mw) {
        const int xo = r * LDX + 16 * (mg * MW + mw) + 2 * g;
        const float2 xa = *reinterpret_cast<const float2*>(X + xo);
        const float2 xc = *reinterpret_cast<const float2*>(X + xo + LDX);
        const float a[4] = {xa.x * wv.x, xa.y * wv.x, xc.x * wv.y, xc.y * wv.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[mw][e] = u32(a[e]);
          al[mw][e] = low(a[e]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int nt = part + PARTS * u;
        const int bo = r * LDB + 8 * nt + g;
        const bool real = full || 8 * nt < NP;
        const float b0 = real ? Bs[bo] : 0.0f, b1 = real ? Bs[bo + LDB] : 0.0f;
        bh[u][0] = u32(b0);
        bh[u][1] = u32(b1);
        bl[u][0] = low(b0);
        bl[u][1] = low(b1);
      }
      if (full) {
        rounds<MW, U>(acc, ah, al, bh, bl);
      } else {
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (8 * (part + PARTS * u) < NP)
#pragma unroll
            for (int mw = 0; mw < MW; ++mw) {
              mma_tf32(acc[mw][u], al[mw], bh[u][0], bh[u][1]);
              mma_tf32(acc[mw][u], ah[mw], bl[u][0], bl[u][1]);
              mma_tf32(acc[mw][u], ah[mw], bh[u][0], bh[u][1]);
            }
      }
    };
    const int nk = (vr + 7) / 8;
    if (NP == 8 * PARTS * U) {
#pragma unroll 2
      for (int kk = 0; kk < nk; ++kk) kstep(kk, true);
    } else {
      for (int kk = 0; kk < nk; ++kk) kstep(kk, false);
    }
  }

  // acc[mw][u]: p 16 m + 2g (0, 1) and + 1 (2, 3), n 8 nt + 2t (0, 2) and + 1.
  float* out = states + ((static_cast<long long>(b) * NC + k) * NH + h) * P * N;
#pragma unroll
  for (int mw = 0; mw < MW; ++mw) {
    const int pa = 16 * (mg * MW + mw) + 2 * g;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int col = 8 * (part + PARTS * u) + 2 * t;
      if (col >= N) continue;
      const float* d = acc[mw][u];
      if ((N & 1) == 0) {
        *reinterpret_cast<float2*>(out + pa * N + col) = make_float2(d[0], d[1]);
        *reinterpret_cast<float2*>(out + (pa + 1) * N + col) = make_float2(d[2], d[3]);
      } else {
        out[pa * N + col] = d[0];
        out[(pa + 1) * N + col] = d[2];
        if (col + 1 < N) {
          out[pa * N + col + 1] = d[1];
          out[(pa + 1) * N + col + 1] = d[3];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 2: the recurrence over chunks, 256 threads of four values each.
// states and h_in may be the same buffer (each thread reads a value before
// it writes the same place).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
ssd_fwd_state_pass_f32(const float* states, const float* __restrict__ cum,
                       const float* __restrict__ init, float* h_in,
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
    *reinterpret_cast<float4*>(h_in + off) = st;
    st.x = st.x * dec + sk.x;
    st.y = st.y * dec + sk.y;
    st.z = st.z * dec + sk.z;
    st.w = st.w * dec + sk.w;
  }
  *reinterpret_cast<float4*>(final_state + bh * PN + e) = st;
}

// ---------------------------------------------------------------------------
// Pass 3: outputs. 256 threads, eight warps: warps w < 4 take head 2 q of
// each head pair q, warps w >= 4 head 2 q + 1; of the 64 x p outputs of a
// head, a warp takes 32 rows x 32 p (p 16: 16 rows x 16 p). The C.B^T phase
// splits the tile into 4 slices of 16 rows x 2 halves of each column tile. Shared memory (floats): C_i (TILE x (NP + 4)); S in
// fragment order (4 slices of 16 rows x 8 CT n-tiles x 32 lanes x 4 floats);
// STAGES ring buffers of one B piece or two heads' tiles (each at most 64 x
// 68); two slots of a head pair's (cum, dt) pairs over the chunk.
// ---------------------------------------------------------------------------
struct ScanSmem {
  int c, s, ring, half, stage, head, floats;
  __host__ __device__ ScanSmem(int NP, int CT) {
    c = 0;
    s = TILE * (NP + 4);
    ring = s + 4 * 8 * CT * 128;
    half = TILE * (TILE + 4);
    stage = 2 * half;
    head = ring + STAGES * stage;
    floats = head + 2 * 2 * 2 * CMAX;
  }
};

template <int P>
__global__ void __launch_bounds__(SCAN_THREADS, 1)
ssd_fwd_chunk_scan_f32(const float* __restrict__ x, const float* __restrict__ B,
                       const float* __restrict__ C, const float* __restrict__ cum,
                       const float* __restrict__ dt, const float* __restrict__ h_in,
                       float* __restrict__ y, int S, int NH, int G, int N, int CH, int HPB,
                       int vx, int vbc, int vh,
                       long long sxb, long long sxs, long long sxh,
                       long long sdb, long long sds, long long sdh,
                       long long sbb, long long sbs, long long sbg,
                       long long scb, long long scs, long long scg,
                       long long syb, long long sys, long long syh) {
  constexpr int MT = P / 16;
  constexpr int MW = MT < 2 ? 1 : MT / 2;   // m-tiles of p a warp holds
  constexpr int MG = MT / MW;               // warps across p
  constexpr int NW = 8 * MG / 4;            // n-tiles of 8 rows a warp holds (64 rows / (4 / MG))
  constexpr int LDX = P + 4;
  const int NP = n_pad(N), LDC = NP + 4;
  const int PW = NP < TILE ? NP : TILE, NQ = NP / PW, LDP = PW + 4;
  const int CT = (CH + TILE - 1) / TILE;
  const ScanSmem L(NP, CT);
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* Cs = sm + L.c;
  float* Ss = sm + L.s;
  auto stage = [&](int s) { return sm + L.ring + s * L.stage; };
  // (cum_j, dt_j) pairs of head 2 q + hh of pair q
  auto headbuf = [&](int q, int hh) { return sm + L.head + ((q & 1) * 2 + hh) * 2 * CMAX; };

  // row tile fastest, the heaviest first: the blocks that read the same x
  // tiles and starting states run side by side
  const int it = CT - 1 - static_cast<int>(blockIdx.x % CT);
  int r = blockIdx.x / CT;
  const int n_ht = NH / HPB;
  const int ht = r % n_ht;
  r /= n_ht;
  const int NC = S / CH;
  const int k = r % NC, b = r / NC;
  const int h0 = ht * HPB;
  const int grp = h0 / (NH / G);   // HPB divides NH / G: the block's heads share a group
  const int t0 = k * CH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int sl = warp & 3, hf = warp >> 2;      // C.B^T: slice of 16 rows, half of a column tile
  const int mg = sl % MG, rg = sl / MG;         // outputs: m-tiles mg MW .., rows 8 NW rg ..
  const int i_tile = TILE * it;
  const int i_w = i_tile + 8 * NW * rg;         // the warp's first output row in the chunk
  const bool rows_in = i_w < CH;                // warp-uniform

  // Items, in order: S pieces (column tile jt, n piece q) for jt <= it; then
  // per head pair: h_in pieces q, x tiles jt <= it, both heads in a stage.
  const int n_s = (it + 1) * NQ;
  const int per_pair = NQ + it + 1;
  const int n_items = n_s + ((HPB + 1) / 2) * per_pair;
  const long long hstride = static_cast<long long>(P) * N;

  load_tile(Cs, LDC, C + b * scb + static_cast<long long>(t0 + i_tile) * scs + grp * scg, scs,
            TILE, NP, min(TILE, CH - i_tile), N, vbc, false);
  cp_commit();

  auto issue = [&](int idx) {
    if (idx < n_items) {
      float* st = stage(idx % STAGES);
      if (idx < n_s) {
        const int jt = idx / NQ, q = idx - jt * NQ;
        load_tile(st, LDP,
                  B + b * sbb + static_cast<long long>(t0 + TILE * jt) * sbs + grp * sbg + PW * q,
                  sbs, TILE, PW, min(TILE, CH - TILE * jt), N - PW * q, vbc, false);
      } else {
        const int rr = idx - n_s, q = rr / per_pair, u = rr - q * per_pair;
        for (int hh = 0; hh < 2 && 2 * q + hh < HPB; ++hh) {
          const int h = h0 + 2 * q + hh;
          float* dst = st + hh * L.half;
          if (u < NQ) {
            load_tile(dst, LDP, h_in + ((static_cast<long long>(b) * NC + k) * NH + h) * hstride +
                                    PW * u,
                      N, P, PW, P, N - PW * u, vh, true);
            if (u == 0) {
              float* hb = headbuf(q, hh);
              const float* cs = cum + (static_cast<long long>(b) * NH + h) * S + t0;
              const float* ds = dt + b * sdb + h * sdh + static_cast<long long>(t0) * sds;
              for (int j = threadIdx.x; j < CH; j += blockDim.x) {
                cp4(saddr(hb + 2 * j), cs + j, 4);
                cp4(saddr(hb + 2 * j + 1), ds + j * sds, 4);
              }
            }
          } else {
            const int jt = u - NQ;
            load_tile(dst, LDX,
                      x + b * sxb + static_cast<long long>(t0 + TILE * jt) * sxs + h * sxh, sxs,
                      TILE, P, min(TILE, CH - TILE * jt), P, vx, false);
          }
        }
      }
    }
    cp_commit();
  };
  issue(0);
  issue(1);

  float sacc[1][4][4];
  float acc[MW][NW][4];   // O^T: p rows of m-tile mg MW + m (pairs), rows i_w + 8 nt + (0 .. 7)
  for (int idx = 0; idx < n_items; ++idx) {
    const float* st = stage(idx % STAGES);
    cp_wait<STAGES - 2>();
    // C_i, the item (and its heads' cum and dt) have landed; every warp is
    // done with the buffer of item idx - 1, which item idx + 2 refills
    __syncthreads();
    issue(idx + STAGES - 1);

    if (idx < n_s) {
      // ---- S_jt = C_i B_jt^T, n columns PW q .. PW q + PW - 1: the pair
      // (sl, hf) takes n-tiles 4 hf .. 4 hf + 3 of the column tile; on the
      // diagonal tile only those with a column <= the slice's last row ----
      const int jt = idx / NQ, q = idx - jt * NQ;
      if (q == 0) {
#pragma unroll
        for (int u = 0; u < 4; ++u) sacc[0][u][0] = sacc[0][u][1] = sacc[0][u][2] = sacc[0][u][3] = 0.0f;
      }
      const int rs = 16 * sl;
      if (i_tile + rs < CH) {
        // on the diagonal tile only the n-tiles with a column <= the
        // slice's last row
        const int nu = jt < it ? 4 : min(4, max(0, (rs + 16) / 8 - 4 * hf));
#pragma unroll 2
        for (int kk = 0; kk < PW / 8; ++kk) {
          const float* c0 = Cs + (rs + g) * LDC + PW * q + 8 * kk + t;
          const float a[4] = {c0[0], c0[8 * LDC], c0[4], c0[8 * LDC + 4]};
          const uint32_t ah[1][4] = {{u32(a[0]), u32(a[1]), u32(a[2]), u32(a[3])}};
          const uint32_t al[1][4] = {{low(a[0]), low(a[1]), low(a[2]), low(a[3])}};
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int bo = (8 * (4 * hf + u) + g) * LDP + 8 * kk + t;
            const float b0 = st[bo], b1 = st[bo + 4];
            bh[u][0] = u32(b0);
            bh[u][1] = u32(b1);
            bl[u][0] = low(b0);
            bl[u][1] = low(b1);
          }
          if (nu == 4) {
            rounds<1, 4>(sacc, ah, al, bh, bl);   // no product under a branch (a WARPSYNC each)
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (u < nu) {
                mma_tf32(sacc[0][u], al[0], bh[u][0], bh[u][1]);
                mma_tf32(sacc[0][u], ah[0], bl[u][0], bl[u][1]);
                mma_tf32(sacc[0][u], ah[0], bh[u][0], bh[u][1]);
              }
          }
        }
      }
      if (q == NQ - 1) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          *reinterpret_cast<float4*>(Ss + ((sl * 8 * CT + 8 * jt + 4 * hf + u) * 32 + lane) * 4) =
              make_float4(sacc[0][u][0], sacc[0][u][1], sacc[0][u][2], sacc[0][u][3]);
      }
    } else {
      const int rr = idx - n_s, q = rr / per_pair, u = rr - q * per_pair;
      const int hh = 2 * q + hf, h = h0 + hh;
      const float* mine = st + hf * L.half;
      const float* hb = headbuf(q, hf);   // (cum_j, dt_j) pairs
      if (u < NQ) {
        // ---- inter-chunk term: acc = h_in C_i^T over n PW u .. + PW - 1 ----
        if (u == 0) {
#pragma unroll
          for (int m = 0; m < MW; ++m)
#pragma unroll
            for (int nt = 0; nt < NW; ++nt)
              acc[m][nt][0] = acc[m][nt][1] = acc[m][nt][2] = acc[m][nt][3] = 0.0f;
        }
        if (rows_in && hh < HPB) {
#pragma unroll 2
          for (int kk = 0; kk < PW / 8; ++kk) {
            uint32_t bh[NW][2], bl[NW][2], ah[MW][4], al[MW][4];
#pragma unroll
            for (int nt = 0; nt < NW; ++nt) {
              const float* cb = Cs + (i_w - i_tile + 8 * nt + g) * LDC + PW * u + 8 * kk + t;
              const float b0 = cb[0], b1 = cb[4];
              bh[nt][0] = u32(b0);
              bh[nt][1] = u32(b1);
              bl[nt][0] = low(b0);
              bl[nt][1] = low(b1);
            }
#pragma unroll
            for (int m = 0; m < MW; ++m) {
              const float* hp = mine + (16 * (mg * MW + m) + g) * LDP + 8 * kk + t;
              const float a[4] = {hp[0], hp[8 * LDP], hp[4], hp[8 * LDP + 4]};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                ah[m][e] = u32(a[e]);
                al[m][e] = low(a[e]);
              }
            }
            rounds<MW, NW>(acc, ah, al, bh, bl);
          }
          if (u == NQ - 1) {
            // column i_w + 8 nt + 2t (0, 2) and + 1 (1, 3) times exp(cum_i)
#pragma unroll
            for (int nt = 0; nt < NW; ++nt) {
              const int i = i_w + 8 * nt + 2 * t;
              const float e0 = ex2(hb[2 * min(i, CH - 1)] * LOG2E);
              const float e1 = ex2(hb[2 * min(i + 1, CH - 1)] * LOG2E);
#pragma unroll
              for (int m = 0; m < MW; ++m) {
                acc[m][nt][0] *= e0;
                acc[m][nt][1] *= e1;
                acc[m][nt][2] *= e0;
                acc[m][nt][3] *= e1;
              }
            }
          }
        }
      } else if (rows_in && hh < HPB) {
        // ---- intra-chunk terms of column tile jt: acc += x_jt^T P^T with
        // P = S o exp(cum_i - cum_j) o dt_j ----
        const int jt = u - NQ, j_tile = TILE * jt;
        float ci[NW];   // cum * log2(e) at this thread's rows of P, i_w + 8 nt + g
#pragma unroll
        for (int nt = 0; nt < NW; ++nt) ci[nt] = hb[2 * min(i_w + 8 * nt + g, CH - 1)] * LOG2E;
        // one k-step; `diag`: the diagonal tile, where P is masked to j <= i
        // (and j inside the chunk) before the exponential. Off it every
        // column is before every row and inside the chunk.
        auto kstep = [&](int kk, bool diag) {
          const int ja = j_tile + 8 * kk + 2 * t, jb = ja + 1;
          const float4 cd = *reinterpret_cast<const float4*>(hb + 2 * ja);   // cum, dt at ja, jb
          const float ca = cd.x * LOG2E, cb = cd.z * LOG2E;
          uint32_t bh[NW][2], bl[NW][2], ah[MW][4], al[MW][4];
#pragma unroll
          for (int sp = 0; sp < NW / 2; ++sp) {
            // S's fragment of slice (rows 16 .. + 15 of the warp's), rows g, g + 8
            const float4 sv = *reinterpret_cast<const float4*>(
                Ss + (((i_w - i_tile) / 16 + sp) * 8 * CT + 8 * jt + kk) * 128 + 4 * lane);
            const float sa[2][2] = {{sv.x * cd.y, sv.y * cd.w}, {sv.z * cd.y, sv.w * cd.w}};
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int nt = 2 * sp + hr, i = i_w + 8 * nt + g;
              float p0, p1;
              if (diag) {
                p0 = ja <= i && ja < CH ? sa[hr][0] * ex2(ci[nt] - ca) : 0.0f;
                p1 = jb <= i && jb < CH ? sa[hr][1] * ex2(ci[nt] - cb) : 0.0f;
              } else {
                p0 = sa[hr][0] * ex2(ci[nt] - ca);
                p1 = sa[hr][1] * ex2(ci[nt] - cb);
              }
              bh[nt][0] = u32(p0);
              bh[nt][1] = u32(p1);
              bl[nt][0] = low(p0);
              bl[nt][1] = low(p1);
            }
          }
          const int xo = (8 * kk + 2 * t) * LDX + 16 * mg * MW + 2 * g;
#pragma unroll
          for (int m = 0; m < MW; ++m) {
            const float2 xa = *reinterpret_cast<const float2*>(mine + xo + 16 * m);
            const float2 xc = *reinterpret_cast<const float2*>(mine + xo + LDX + 16 * m);
            const float a[4] = {xa.x, xa.y, xc.x, xc.y};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ah[m][e] = u32(a[e]);
              al[m][e] = low(a[e]);
            }
          }
          rounds<MW, NW>(acc, ah, al, bh, bl);
        };
        if (jt < it) {
#pragma unroll 2
          for (int kk = 0; kk < TILE / 8; ++kk) kstep(kk, false);
        } else {
          // k-steps with a column <= the warp's last row, inside the chunk
          const int nk = min(min(TILE / 8, (i_w + 8 * NW - 1 - j_tile) / 8 + 1),
                             (CH - j_tile + 7) / 8);
          for (int kk = 0; kk < nk; ++kk) kstep(kk, true);
        }
        if (jt == it) {
          // acc[m][nt]: p 16 m + 2g (0, 1) and + 1 (2, 3); rows i_w + 8 nt + 2t
          // (0, 2) and + 1 (1, 3)
#pragma unroll
          for (int nt = 0; nt < NW; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int row = i_w + 8 * nt + 2 * t + e;
              if (row < CH) {
                float* yr = y + b * syb + static_cast<long long>(t0 + row) * sys + h * syh +
                            16 * mg * MW + 2 * g;
#pragma unroll
                for (int m = 0; m < MW; ++m)
                  *reinterpret_cast<float2*>(yr + 16 * m) =
                      make_float2(acc[m][nt][e], acc[m][nt][e + 2]);
              }
            }
        }
      }
    }
  }
}

bool shape_ok(int batch, int S, int NH, int P, int G, int N, int CH) {
  return batch > 0 && S > 0 && NH > 0 && G > 0 && NH % G == 0 &&
         (P == 16 || P == 32 || P == 64) && N > 0 && N <= NMAX && CH > 0 && CH <= CMAX &&
         S % CH == 0 && S / CH <= 65535 && batch <= 65535;
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace repro_ssd_f32

using namespace repro_ssd_f32;

// Pass 1. x (b, s, nh, P) and B (b, s, g, N) float32 with element strides
// (b, s, head / group), unit stride last; dt (b, s, nh) f32 with element
// strides; A (nh,) f32. vx, vb: 16-byte copies of x, B (the host checked
// their alignment). Writes states (b, s / c, nh, P, N) f32 and cum (b, nh, s)
// f32, both contiguous. Returns a cudaError_t.
extern "C" int ssd_chunk_state_f32(const void* x, const void* dt, const void* A, const void* B,
                                   void* states, void* cum, int batch, int S, int NH, int P,
                                   int G, int N, int CH, int vx, int vb,
                                   long long sxb, long long sxs, long long sxh,
                                   long long sdb, long long sds, long long sdh,
                                   long long sbb, long long sbs, long long sbg, void* stream) {
  if (!shape_ok(batch, S, NH, P, G, N, CH)) return cudaErrorInvalidValue;
  const int smem = (2 * CMAX + STAGES * state_stage_floats(P, n_pad(N))) * 4;
  const dim3 grid(NH, S / CH, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SSD_F32_STATE(DIM)                                                                   \
  err = set_smem(ssd_fwd_chunk_state_f32<DIM>, smem);                                        \
  if (err != cudaSuccess) return err;                                                        \
  ssd_fwd_chunk_state_f32<DIM><<<grid, STATE_THREADS, smem, st>>>(                           \
      static_cast<const float*>(x), static_cast<const float*>(dt),                           \
      static_cast<const float*>(A), static_cast<const float*>(B), static_cast<float*>(states), \
      static_cast<float*>(cum), S, NH, G, N, CH, vx, vb, sxb, sxs, sxh, sdb, sds, sdh, sbb,  \
      sbs, sbg)
  if (P == 64) {
    SSD_F32_STATE(64);
  } else if (P == 32) {
    SSD_F32_STATE(32);
  } else {
    SSD_F32_STATE(16);
  }
#undef SSD_F32_STATE
  return cudaGetLastError();
}

// Pass 2. states (b, s / c, nh, P, N) and cum (b, nh, s) f32 from pass 1,
// init (b, nh, P, N) f32 or NULL; writes h_in (b, s / c, nh, P, N) f32, the
// state at each chunk's start (h_in may be states itself: written over in
// place), and the final state (b, nh, P, N) f32.
extern "C" int ssd_state_pass_f32(const void* states, const void* cum, const void* init,
                                  void* h_in, void* final_state, int batch, int S, int NH,
                                  int PN, int CH, void* stream) {
  if (batch <= 0 || S <= 0 || NH <= 0 || CH <= 0 || S % CH != 0 || PN <= 0 || PN % 4 != 0 ||
      NH > 65535 || batch > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((PN / 4 + 255) / 256, NH, batch);
  ssd_fwd_state_pass_f32<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(states), static_cast<const float*>(cum),
      static_cast<const float*>(init), static_cast<float*>(h_in),
      static_cast<float*>(final_state), S, NH, PN, CH);
  return cudaGetLastError();
}

// Pass 3. x, B as in pass 1, C like B; cum from pass 1, dt as in pass 1,
// h_in (b, s / c, nh, P, N) f32 contiguous from pass 2; writes y (b, s, nh,
// P) f32 through its element strides (unit stride last, 8-byte aligned rows).
// HPB heads per block, a divisor of nh / g. vx, vbc, vh: 16-byte copies of
// x, of B and C, of h_in. Returns a cudaError_t.
extern "C" int ssd_chunk_scan_f32(const void* x, const void* B, const void* C, const void* cum,
                                  const void* dt, const void* h_in, void* y, int batch, int S,
                                  int NH, int P, int G, int N, int CH, int HPB, int vx, int vbc,
                                  int vh, long long sxb, long long sxs, long long sxh,
                                  long long sdb, long long sds, long long sdh,
                                  long long sbb, long long sbs, long long sbg,
                                  long long scb, long long scs, long long scg,
                                  long long syb, long long sys, long long syh, void* stream) {
  if (!shape_ok(batch, S, NH, P, G, N, CH) || HPB <= 0 || (NH / G) % HPB != 0)
    return cudaErrorInvalidValue;
  const int CT = (CH + TILE - 1) / TILE;
  const long long blocks = static_cast<long long>(S / CH) * batch * (NH / HPB);
  if (blocks * CT > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = ScanSmem(n_pad(N), CT).floats * 4;
  const dim3 grid(static_cast<unsigned>(blocks * CT));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SSD_F32_SCAN(DIM)                                                                      \
  err = set_smem(ssd_fwd_chunk_scan_f32<DIM>, smem);                                           \
  if (err != cudaSuccess) return err;                                                          \
  ssd_fwd_chunk_scan_f32<DIM><<<grid, SCAN_THREADS, smem, st>>>(                               \
      static_cast<const float*>(x), static_cast<const float*>(B), static_cast<const float*>(C), \
      static_cast<const float*>(cum), static_cast<const float*>(dt),                           \
      static_cast<const float*>(h_in), static_cast<float*>(y), S, NH, G, N, CH, HPB, vx, vbc,  \
      vh, sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg, syb, sys, syh)
  if (P == 64) {
    SSD_F32_SCAN(64);
  } else if (P == 32) {
    SSD_F32_SCAN(32);
  } else {
    SSD_F32_SCAN(16);
  }
#undef SSD_F32_SCAN
  return cudaGetLastError();
}
