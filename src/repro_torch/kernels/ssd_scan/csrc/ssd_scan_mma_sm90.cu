// Mamba-2 SSD chunked scan for NVIDIA Hopper (sm_90a) in bf16 on the tensor
// cores through mma.sync: the "mma" variant, bf16 x, B, C at every shape the
// sm90 kernel (ssd_scan_sm90.cu) does not take: head dims 16, 32 and 64, any
// d_state up to 128, any chunk up to 256 (ragged ones too), any views with
// unit stride last. Plain C entry points for passes 1 and 3,
// ssd_chunk_state_mma and ssd_chunk_scan_mma; pass 2 is the float32
// recurrence of ssd_scan_f32_sm90.cu, ssd_state_pass_f32, as it is (ops.py
// calls the three in turn for the "mma" variant).
//
// Replaces: the Pallas TPU kernel `_ssd_kernel`, launched by `ssd_scan_pallas`
// (src/repro/kernels/ssd_scan/ssd_scan.py:24, :75, pallas_call at :90), for
// bf16 inputs at the shapes above. It computes the same function, the
// contract of `ssd_chunked`: with cum = the prefix sum of dt * A over a chunk,
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j    (intra)
//          + exp(cum_i) C_i . state_in                               (inter)
//   state <- state exp(cum_last) + sum_j B_j exp(cum_last - cum_j) dt_j x_j
// Head h reads group h / (nh / g) of B and C; an optional float32 init state;
// y in bf16, the final state in float32. No atomics: results are
// deterministic.
//
// Arithmetic. Every product is mma.sync m16n8k16 with bf16 operands and
// float32 accumulation, so a product of two bf16 inputs (C_i B_j^T, C_i times
// a state's part, P times x) is exact before the sum. A float32 operand goes
// in as two bf16 parts, hi = bf16(v) and lo = bf16(v - hi), two products:
// x w in pass 1 (w_j = dt_j exp(cum_last - cum_j)), and in pass 3 P = S o
// exp(cum_i - cum_j) o dt_j and the float32 starting states. One bf16 P
// moved mamba2's bf16 prefill logits by 0.43-0.47 of a 0.456 limit on the
// sm90 kernel, which splits P the same way (tests/test_torch_ssd_bf16.py
// models this kernel's arithmetic on the CPU). The starting states stay
// float32 from pass 2 (no bf16 rounding of them, unlike sm90's). The
// exponentials are float32 on the CUDA cores (ex2); the causal mask j <= i
// is applied to the exponent before the exponential and to P by a select,
// so nothing above the diagonal, nor past a ragged chunk's end, is ever
// multiplied in.
//
// Bound on an H100 SXM (chip_smoke.py's ssd_bound, one product each):
//   jamba-v0.1-52b's shape (b 8, s 1024, nh 128, p 64, g 1, n 16, c 256),
//   which runs here in views TMA cannot read (rows padded by 4 bf16): x and
//   y (134.2 MB each), B and C (0.26 MB each), dt and the final state (4.2
//   MB each): ~277 MB, 0.0828 ms at 3.35 TB/s; ~22 GFLOP, 0.022 ms at the
//   bf16 peak: bound by bytes;
//   the serve demo's reduced mamba2 (b 4, s 32, nh 8, p 16, g 1, n 16, c
//   32): ~0.11 MB, 0.03 us: bound by bytes, and in practice by three
//   launches of a few microseconds each.
// The split into passes moves more than the bound counts: x is read by
// passes 1 and 3, the float32 chunk states are written by pass 1, read and
// written over in place by pass 2, and read by pass 3 (16.8 MB each way at
// jamba's shape).
//
// Design. The pass structure of the tf32x3 kernel (ssd_scan_f32_sm90.cu),
// with bf16 fragments in place of its three TF32 products. Operands reach
// shared memory through cp.async into a three-stage ring, in 16-byte copies
// where a view allows them, 4-byte copies where it does not, and 2-byte
// plain loads for a view that starts an odd number of bf16 elements in or
// has an odd stride (the host picks per tensor); rows past a ragged chunk's
// end and columns past n arrive as zeros. Fragments come out of shared
// memory by ldmatrix (.trans where the operand is MN-major: x in both
// passes, B in pass 1); rows of width + 8 bf16 keep every ldmatrix free of
// bank conflicts. n is padded to NP, the next power of two from 16, in shared
// memory only.
//   1. ssd_fwd_chunk_state_mma, grid (heads, chunks, batch), four warps:
//      warp 0 scans dt * A in float32 and writes cum per (b, head, s) for
//      pass 3 and w over the chunk; then states = (x w)^T B (M p, N n, K the
//      chunk's rows) in pieces of 32 rows, a warp one 16-row m-tile of p and
//      its share of the n-tiles; x w is formed from x's fragment in
//      registers and split there.
//   2. ssd_state_pass_f32 (ssd_scan_f32_sm90.cu): the float32 recurrence,
//      the starting states written over the chunk states in place.
//   3. ssd_fwd_chunk_scan_mma, grid (head tiles x chunks x batch x row tiles
//      of 64, the row tile fastest and the heaviest first), eight warps, in
//      the orientation of flash attention's P V: M = the chunk's rows i.
//      First S_j = C_i B_j^T (K n) for every column tile j <= i, ONCE for
//      the block's heads of a group (ops.F32_SCAN_HEADS at most), kept in
//      shared memory in accumulator order; then per head pair, warps w < 4
//      on head 2q and w >= 4 on head 2q + 1, 16 rows each: acc = C_i h_in^T
//      (h_in hi + lo, n in pieces of 64), its rows scaled by exp(cum_i), then
//      acc += P_j x_j, where S's accumulator pairs for rows i, i + 8 are P's
//      A fragment as they are, and x_j's B fragment is ldmatrix.trans. y is
//      stored in bf16 from registers. Eight warps a block leave the SM's
//      warps waiting on their own chains; where two blocks fit an SM (n 16:
//      ~111 KB with a two-stage ring, at most 128 registers a thread, no
//      spill) two run, which took jamba's padded shape from ~1.0 to ~0.8 ms
//      on the card (PERF.md). A fourth pass-1 stage moved nothing.
// Not done yet: fusing passes 1 and 2, sharing pass 1's B piece across the
// heads of a group, overlapping one tile's exponentials with another's
// products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_ssd_mma {

using bf16 = __nv_bfloat16;

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

// cp.async of 16 or 4 bytes; `bytes` below the size fills the rest of the
// destination with zeros and reads nothing past `bytes`.
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

// Start the copy of a rows x cols tile into shared memory at dst (ld
// elements a row), row r from src + r * rs (unit stride along it), e
// elements a copy: 16 or 4 bytes by cp.async, 2 bytes (one bf16) by a plain
// load and store, which the barrier before the tile is read covers as it
// covers the cp.async wait. Rows >= vrows and columns >= vcols arrive as
// zeros. cols is a multiple of e, cols / e at most the block's threads.
// Every thread of the block takes part.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, long long rs, int rows,
                                          int cols, int vrows, int vcols, int e) {
  const int per = cols / e;   // copies a row
  const int c = (threadIdx.x % per) * e;
  const int step = blockDim.x / per;
  const int bytes = e * static_cast<int>(sizeof(T));
  const int real = max(0, min(e, vcols - c)) * static_cast<int>(sizeof(T));
  for (int r = threadIdx.x / per; r < rows; r += step) {
    const int nb = r < vrows ? real : 0;
    T* d = dst + r * ld + c;
    const T* from = nb ? src + r * rs + c : src;
    if (bytes == 16)
      cp16(saddr(d), from, nb);
    else if (bytes == 4)
      cp4(saddr(d), from, nb);
    else
      *reinterpret_cast<unsigned short*>(d) =
          nb ? __ldg(reinterpret_cast<const unsigned short*>(from)) : static_cast<unsigned short>(0);
  }
}

// n padded for the tiles: the next power of two from 16.
__host__ __device__ inline int n_pad(int N) {
  int np = 16;
  while (np < N) np *= 2;
  return np;
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. Without .trans lane (g, t) = (l / 4, l % 4)
// receives row g, columns 2t, 2t + 1 of each; with .trans, rows 2t, 2t + 1
// of column g.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D (16 x 8, f32) += A (16 x 16, bf16, row) * B (16 x 8, bf16, col). Lane
// (g, t): a = (row g, cols 2t, 2t + 1), (g + 8, 2t ..), (g, 2t + 8 ..),
// (g + 8, 2t + 8 ..); b = (k 2t, 2t + 1; n g), (k 2t + 8 ..; n g); d = (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). The lower index of a pair is the
// low half of its register.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The pair (a, b) as two bf16 pairs: hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// The bf16 in the low and the high half of a register, as float32.
__device__ __forceinline__ float lo_f(uint32_t r) { return __uint_as_float(r << 16); }
__device__ __forceinline__ float hi_f(uint32_t r) { return __uint_as_float(r & 0xffff0000u); }

// ---------------------------------------------------------------------------
// Pass 1: chunk states. 128 threads. Shared memory: w and dt over the chunk
// (CMAX floats each), then STAGES ring buffers of {x: KR x (P + 8) bf16, B:
// KR x (NP + 8) bf16}.
// ---------------------------------------------------------------------------
__host__ __device__ inline int state_stage_bytes(int P, int NP) {
  return KR * (P + 8) * 2 + KR * (NP + 8) * 2;
}

template <int P>
__global__ void __launch_bounds__(STATE_THREADS)
ssd_fwd_chunk_state_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A, const bf16* __restrict__ B,
                        float* __restrict__ states, float* __restrict__ cum_out,
                        int S, int NH, int G, int N, int CH, int ex, int eb,
                        long long sxb, long long sxs, long long sxh,
                        long long sdb, long long sds, long long sdh,
                        long long sbb, long long sbs, long long sbg) {
  // A warp holds one m-tile of p (at p 64 each warp one, so that at n 16
  // every warp has an n-tile pair) and its share of the n-tile pairs.
  constexpr int MT = P / 16;          // m-tiles of p
  constexpr int MW = 1;               // m-tiles a warp holds
  constexpr int MP = MT / MW;         // warps across p
  constexpr int PARTS = 4 / MP;       // warps across n, each a share of the n-tile pairs
  constexpr int V = 8 / PARTS;        // n-tile pairs a warp holds at NP 128
  constexpr int LDX = P + 8;
  const int NP = n_pad(N), LDB = NP + 8;
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);
  float* dts = w + CMAX;
  char* ring = reinterpret_cast<char*>(dts + CMAX);
  const int stage_b = state_stage_bytes(P, NP);
  auto xs = [&](int s) { return reinterpret_cast<bf16*>(ring + s * stage_b); };

  const int h = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int NC = S / CH, t0 = k * CH;
  const int grp = h / (NH / G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int g = lane >> 2, mi = lane >> 3, rr = lane & 7;
  const bf16* xb = x + b * sxb + static_cast<long long>(t0) * sxs + h * sxh;
  const bf16* bb = B + b * sbb + static_cast<long long>(t0) * sbs + grp * sbg;
  const int n_items = (CH + KR - 1) / KR;

  auto issue = [&](int it) {
    if (it == 0) {
      // dt over the chunk, with the first piece
      const float* dh = dt + b * sdb + h * sdh + static_cast<long long>(t0) * sds;
      for (int j = threadIdx.x; j < CH; j += blockDim.x) cp4(saddr(dts + j), dh + j * sds, 4);
    }
    if (it < n_items) {
      bf16* st = xs(it % STAGES);
      const int r0 = it * KR, vr = min(KR, CH - r0);
      load_tile(st, LDX, xb + r0 * sxs, sxs, KR, P, vr, P, ex);
      load_tile(st + KR * LDX, LDB, bb + r0 * sbs, sbs, KR, NP, vr, N, eb);
    }
    cp_commit();
  };
  issue(0);
  issue(1);

  const int mg = warp % MP, part = warp / MP;
  float acc[MW][2 * V][4];
#pragma unroll
  for (int mw = 0; mw < MW; ++mw)
#pragma unroll
    for (int u = 0; u < 2 * V; ++u) acc[mw][u][0] = acc[mw][u][1] = acc[mw][u][2] = acc[mw][u][3] = 0.0f;

  for (int it = 0; it < n_items; ++it) {
    const bf16* X = xs(it % STAGES);
    const bf16* Bs = X + KR * LDX;
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
    // one k-step of 16 piece rows: A = (x w)^T (M p, K rows) from x's
    // fragment by ldmatrix.trans, scaled by w and split into hi + lo; B =
    // the piece of B (K rows, N n) by ldmatrix.trans, two n-tiles a load.
    // `full`: every n-tile pair of the warp is real (NP 128), so no product
    // sits under a branch.
    auto kstep = [&](int kk, bool full) {
      const int r = 16 * kk;
      const float2 w0 = *reinterpret_cast<const float2*>(w + it * KR + r + 2 * t);
      const float2 w1 = *reinterpret_cast<const float2*>(w + it * KR + r + 8 + 2 * t);
      uint32_t ah[MW][4], al[MW][4];
#pragma unroll
      for (int mw = 0; mw < MW; ++mw) {
        uint32_t f[4];
        // matrix mi: rows r + 8 (mi / 2), p columns 16 m + 8 (mi % 2)
        ldsm4t(f, saddr(X + (r + rr + 8 * (mi >> 1)) * LDX + 16 * (mg * MW + mw) + 8 * (mi & 1)));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 wv = e < 2 ? w0 : w1;
          split(lo_f(f[e]) * wv.x, hi_f(f[e]) * wv.y, ah[mw][e], al[mw][e]);
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int pr = part + PARTS * v;
        if (!full && 16 * pr >= NP) continue;
        uint32_t f[4];
        // matrix mi: rows r + 8 (mi % 2), n columns 16 pr + 8 (mi / 2)
        ldsm4t(f, saddr(Bs + (r + rr + 8 * (mi & 1)) * LDB + 16 * pr + 8 * (mi >> 1)));
#pragma unroll
        for (int mw = 0; mw < MW; ++mw) {
          mma_bf16(acc[mw][2 * v], ah[mw], f[0], f[1]);
          mma_bf16(acc[mw][2 * v + 1], ah[mw], f[2], f[3]);
        }
#pragma unroll
        for (int mw = 0; mw < MW; ++mw) {
          mma_bf16(acc[mw][2 * v], al[mw], f[0], f[1]);
          mma_bf16(acc[mw][2 * v + 1], al[mw], f[2], f[3]);
        }
      }
    };
    const int nk = (vr + 15) / 16;
    if (NP == 16 * PARTS * V) {
#pragma unroll 2
      for (int kk = 0; kk < nk; ++kk) kstep(kk, true);
    } else {
      for (int kk = 0; kk < nk; ++kk) kstep(kk, false);
    }
  }

  // acc[mw][u]: p 16 m + g (0, 1) and + 8 (2, 3), n 8 nt + 2t (0, 2) and + 1.
  float* out = states + ((static_cast<long long>(b) * NC + k) * NH + h) * P * N;
#pragma unroll
  for (int mw = 0; mw < MW; ++mw) {
    const int pa = 16 * (mg * MW + mw) + g;
#pragma unroll
    for (int u = 0; u < 2 * V; ++u) {
      const int col = 8 * (2 * (part + PARTS * (u >> 1)) + (u & 1)) + 2 * t;
      if (col >= N) continue;
      const float* d = acc[mw][u];
      if ((N & 1) == 0) {
        *reinterpret_cast<float2*>(out + pa * N + col) = make_float2(d[0], d[1]);
        *reinterpret_cast<float2*>(out + (pa + 8) * N + col) = make_float2(d[2], d[3]);
      } else {
        out[pa * N + col] = d[0];
        out[(pa + 8) * N + col] = d[2];
        if (col + 1 < N) {
          out[pa * N + col + 1] = d[1];
          out[(pa + 8) * N + col + 1] = d[3];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 3: outputs. 256 threads, eight warps: warp w takes rows 16 (w % 4) ..
// + 15 of the row tile, of head 2q + w / 4 of each head pair q. Shared memory
// (bytes): C_i (TILE x (NP + 8) bf16); S in accumulator order (4 slices of
// 16 rows x 8 CT n-tiles x 32 lanes x 4 floats); `stages` ring buffers of one
// B tile (TILE x (NP + 8) bf16) or two heads' pieces (a starting state's n
// piece, P x (PW + 8) floats, or an x tile, TILE x (P + 8) bf16); two slots
// of a head pair's (cum, dt) pairs over the chunk. Where two blocks of two
// stages fit an SM (n 16 at every chunk: ~111 KB a block), a block runs with
// two stages and at most 128 registers a thread (`Occ<2>`), so that 16 warps
// share an SM instead of 8; else with three (`Occ<1>`).
// ---------------------------------------------------------------------------
struct ScanSmem {
  int c, s, ring, half, stage, head, bytes;
  __host__ __device__ ScanSmem(int P, int NP, int CT, int stages) {
    const int PW = NP < TILE ? NP : TILE;
    c = 0;
    s = TILE * (NP + 8) * 2;
    ring = s + 4 * 8 * CT * 128 * 4;
    const int hb = P * (PW + 8) * 4, xb = TILE * (P + 8) * 2, bt = TILE * (NP + 8) * 2;
    half = hb > xb ? hb : xb;
    stage = 2 * half > bt ? 2 * half : bt;
    head = ring + stages * stage;
    bytes = head + 2 * 2 * 2 * CMAX * 4;
  }
};

// Blocks an SM runs at once, and the ring's stages at that occupancy.
template <int BLOCKS>
struct Occ {
  static constexpr int stages = BLOCKS == 2 ? 2 : STAGES;
};
constexpr int SM_SMEM = 228 * 1024;   // shared memory of an SM
constexpr int BLOCK_RESERVED = 1024;  // reserved for each resident block

template <int P, int BLOCKS>
__global__ void __launch_bounds__(SCAN_THREADS, BLOCKS)
ssd_fwd_chunk_scan_mma(const bf16* __restrict__ x, const bf16* __restrict__ B,
                       const bf16* __restrict__ C, const float* __restrict__ cum,
                       const float* __restrict__ dt, const float* __restrict__ h_in,
                       bf16* __restrict__ y, int S, int NH, int G, int N, int CH, int HPB,
                       int ex, int ebc, int eh,
                       long long sxb, long long sxs, long long sxh,
                       long long sdb, long long sds, long long sdh,
                       long long sbb, long long sbs, long long sbg,
                       long long scb, long long scs, long long scg,
                       long long syb, long long sys, long long syh) {
  constexpr int NT = P / 8;   // n-tiles of p a warp holds
  constexpr int LDX = P + 8;
  const int NP = n_pad(N), LDC = NP + 8;
  const int PW = NP < TILE ? NP : TILE, NQ = NP / PW, LDH = PW + 8;
  const int CT = (CH + TILE - 1) / TILE;
  constexpr int ST = Occ<BLOCKS>::stages;
  const ScanSmem L(P, NP, CT, ST);
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  bf16* Cs = reinterpret_cast<bf16*>(sm + L.c);
  float* Ss = reinterpret_cast<float*>(sm + L.s);
  auto stage = [&](int s) { return sm + L.ring + s * L.stage; };
  // (cum_j, dt_j) pairs of head 2 q + hh of pair q
  auto headbuf = [&](int q, int hh) {
    return reinterpret_cast<float*>(sm + L.head) + ((q & 1) * 2 + hh) * 2 * CMAX;
  };

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
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int g = lane >> 2, mi = lane >> 3, rr = lane & 7;
  const int sl = warp & 3, hf = warp >> 2;   // slice of 16 rows; head of the pair
  const int i_tile = TILE * it;
  const int i_w = i_tile + 16 * sl;          // the warp's first row in the chunk
  const bool rows_in = i_w < CH;             // warp-uniform
  const int ia = i_w + g, ib = ia + 8;       // this thread's rows of P and y

  // Items, in order: B tiles jt <= it (for S); then per head pair: h_in
  // pieces q, x tiles jt <= it, both heads in a stage.
  const int n_s = it + 1;
  const int per_pair = NQ + it + 1;
  const int n_items = n_s + ((HPB + 1) / 2) * per_pair;
  const long long hstride = static_cast<long long>(P) * N;

  load_tile(Cs, LDC, C + b * scb + static_cast<long long>(t0 + i_tile) * scs + grp * scg, scs,
            TILE, NP, min(TILE, CH - i_tile), N, ebc);
  cp_commit();

  auto issue = [&](int idx) {
    if (idx < n_items) {
      char* st = stage(idx % ST);
      if (idx < n_s) {
        load_tile(reinterpret_cast<bf16*>(st), LDC,
                  B + b * sbb + static_cast<long long>(t0 + TILE * idx) * sbs + grp * sbg, sbs,
                  TILE, NP, min(TILE, CH - TILE * idx), N, ebc);
      } else {
        const int rq = idx - n_s, q = rq / per_pair, u = rq - q * per_pair;
        for (int hh = 0; hh < 2 && 2 * q + hh < HPB; ++hh) {
          const int h = h0 + 2 * q + hh;
          char* dst = st + hh * L.half;
          if (u < NQ) {
            load_tile(reinterpret_cast<float*>(dst), LDH,
                      h_in + ((static_cast<long long>(b) * NC + k) * NH + h) * hstride + PW * u,
                      N, P, PW, P, N - PW * u, eh);
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
            load_tile(reinterpret_cast<bf16*>(dst), LDX,
                      x + b * sxb + static_cast<long long>(t0 + TILE * jt) * sxs + h * sxh, sxs,
                      TILE, P, min(TILE, CH - TILE * jt), P, ex);
          }
        }
      }
    }
    cp_commit();
  };
  for (int i = 0; i < ST - 1; ++i) issue(i);

  // C_i's A fragment of rows 16 sl .., n columns k0 ..: matrix mi is rows
  // + 8 (mi % 2), columns + 8 (mi / 2)
  auto c_frag = [&](uint32_t (&a)[4], int k0) {
    ldsm4(a, saddr(Cs + (16 * sl + rr + 8 * (mi & 1)) * LDC + k0 + 8 * (mi >> 1)));
  };

  float acc[NT][4];   // y: rows ia (0, 1) and ib (2, 3), p 8 nt + 2t (0, 2) and + 1
  for (int idx = 0; idx < n_items; ++idx) {
    const char* st = stage(idx % ST);
    cp_wait<ST - 2>();
    // C_i, the item (and its heads' cum and dt) have landed; every warp is
    // done with the buffer of item idx - 1, which item idx + ST - 1 refills
    __syncthreads();
    issue(idx + ST - 1);

    if (idx < n_s) {
      // ---- S_jt = C_i B_jt^T: warp (sl, hf) takes rows 16 sl .. + 15 and
      // the n-tiles 4 hf .. 4 hf + 3 of the column tile (K n) ----
      const int jt = idx;
      const bf16* Bt = reinterpret_cast<const bf16*>(st);
      float sacc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) sacc[u][0] = sacc[u][1] = sacc[u][2] = sacc[u][3] = 0.0f;
      for (int kk = 0; kk < NP / 16; ++kk) {
        uint32_t a[4];
        c_frag(a, 16 * kk);
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          // matrix mi: B rows (the n-tiles' j) + 8 (mi / 2), n columns + 8 (mi % 2)
          uint32_t f[4];
          ldsm4(f, saddr(Bt + (32 * hf + 16 * pr + rr + 8 * (mi >> 1)) * LDC + 16 * kk +
                         8 * (mi & 1)));
          mma_bf16(sacc[2 * pr], a, f[0], f[1]);
          mma_bf16(sacc[2 * pr + 1], a, f[2], f[3]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float4*>(Ss + ((sl * 8 * CT + 8 * jt + 4 * hf + u) * 32 + lane) * 4) =
            make_float4(sacc[u][0], sacc[u][1], sacc[u][2], sacc[u][3]);
    } else {
      const int rq = idx - n_s, q = rq / per_pair, u = rq - q * per_pair;
      const int hh = 2 * q + hf, h = h0 + hh;
      const char* mine = st + hf * L.half;
      const float* hb = headbuf(q, hf);   // (cum_j, dt_j) pairs
      if (u == 0) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
      }
      if (!rows_in || hh >= HPB) continue;
      if (u < NQ) {
        // ---- inter-chunk term: acc += C_i h_in^T over n PW u .. + PW - 1,
        // h_in (B: K n, N p) as hi + lo ----
        const float* Hs = reinterpret_cast<const float*>(mine);
        for (int kk = 0; kk < PW / 16; ++kk) {
          uint32_t a[4];
          c_frag(a, PW * u + 16 * kk);
          uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float* hp = Hs + (8 * nt + g) * LDH + 16 * kk + 2 * t;
            const float2 v0 = *reinterpret_cast<const float2*>(hp);
            const float2 v1 = *reinterpret_cast<const float2*>(hp + 8);
            split(v0.x, v0.y, bh[nt][0], bl[nt][0]);
            split(v1.x, v1.y, bh[nt][1], bl[nt][1]);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt], a, bh[nt][0], bh[nt][1]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt], a, bl[nt][0], bl[nt][1]);
        }
        if (u == NQ - 1) {
          // rows ia, ib times exp(cum_i)
          const float e0 = ex2(hb[2 * min(ia, CH - 1)] * LOG2E);
          const float e1 = ex2(hb[2 * min(ib, CH - 1)] * LOG2E);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            acc[nt][0] *= e0;
            acc[nt][1] *= e0;
            acc[nt][2] *= e1;
            acc[nt][3] *= e1;
          }
        }
      } else {
        // ---- intra-chunk terms of column tile jt: acc += P x_jt with P = S
        // o exp(cum_i - cum_j) o dt_j (A: M rows, K j, hi + lo) ----
        const int jt = u - NQ, j_tile = TILE * jt;
        const bf16* Xs = reinterpret_cast<const bf16*>(mine);
        const float ca = hb[2 * min(ia, CH - 1)] * LOG2E, cb = hb[2 * min(ib, CH - 1)] * LOG2E;
        // one k-step of 16 columns j; `diag`: P masked to j <= i (and j
        // inside the chunk) before the exponential
        auto kstep = [&](int kk, bool diag) {
          const int j0 = j_tile + 16 * kk + 2 * t;
          // (cum, dt) at j0, j0 + 1 and at j0 + 8, j0 + 9
          const float4 d0 = *reinterpret_cast<const float4*>(hb + 2 * j0);
          const float4 d1 = *reinterpret_cast<const float4*>(hb + 2 * (j0 + 8));
          // S at (ia, j0 ..), (ib, j0 ..) and at columns j0 + 8 ..
          const float* sp = Ss + ((sl * 8 * CT + 8 * jt + 2 * kk) * 32 + lane) * 4;
          const float4 s0 = *reinterpret_cast<const float4*>(sp);
          const float4 s1 = *reinterpret_cast<const float4*>(sp + 128);
          const float cj[4] = {d0.x * LOG2E, d0.z * LOG2E, d1.x * LOG2E, d1.z * LOG2E};
          const float dj[4] = {d0.y, d0.w, d1.y, d1.w};
          const int jj[4] = {j0, j0 + 1, j0 + 8, j0 + 9};
          // A fragment order: (ia, j0 ..), (ib, j0 ..), (ia, j0 + 8 ..), (ib, j0 + 8 ..)
          const float sv[4][2] = {{s0.x, s0.y}, {s0.z, s0.w}, {s1.x, s1.y}, {s1.z, s1.w}};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = (e & 1) ? ib : ia;
            const float ci = (e & 1) ? cb : ca;
            float pv[2];
#pragma unroll
            for (int c2 = 0; c2 < 2; ++c2) {
              const int q2 = 2 * (e >> 1) + c2;
              if (diag) {
                const bool ok = jj[q2] <= i && jj[q2] < CH;
                const float ev = ex2(ok ? ci - cj[q2] : -INFINITY);
                pv[c2] = ok ? sv[e][c2] * dj[q2] * ev : 0.0f;
              } else {
                pv[c2] = sv[e][c2] * dj[q2] * ex2(ci - cj[q2]);
              }
            }
            split(pv[0], pv[1], ah[e], al[e]);
          }
          // x_jt (B: K j, N p) by ldmatrix.trans, two n-tiles of p a load:
          // matrix mi is rows 16 kk + 8 (mi % 2), p columns 16 np + 8 (mi / 2)
          uint32_t bx[NT][2];
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t f[4];
            ldsm4t(f, saddr(Xs + (16 * kk + rr + 8 * (mi & 1)) * LDX + 16 * np + 8 * (mi >> 1)));
            bx[2 * np][0] = f[0];
            bx[2 * np][1] = f[1];
            bx[2 * np + 1][0] = f[2];
            bx[2 * np + 1][1] = f[3];
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt], ah, bx[nt][0], bx[nt][1]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt], al, bx[nt][0], bx[nt][1]);
        };
        if (jt < it) {
#pragma unroll 2
          for (int kk = 0; kk < TILE / 16; ++kk) kstep(kk, false);
        } else {
          // k-steps before the warp's own 16 columns need no mask; its own
          // is the diagonal
          for (int kk = 0; kk < sl; ++kk) kstep(kk, false);
          kstep(sl, true);
          // acc: rows ia (0, 1) and ib (2, 3), p 8 nt + 2t and + 1
          bf16* ya = y + b * syb + static_cast<long long>(t0 + ia) * sys + h * syh + 2 * t;
          bf16* yb = ya + 8 * sys;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (ia < CH)
              *reinterpret_cast<__nv_bfloat162*>(ya + 8 * nt) =
                  __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
            if (ib < CH)
              *reinterpret_cast<__nv_bfloat162*>(yb + 8 * nt) =
                  __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
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

bool elems_ok(int e) { return e == 8 || e == 2 || e == 1; }

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace repro_ssd_mma

using namespace repro_ssd_mma;

// Pass 1. x (b, s, nh, P) and B (b, s, g, N) bf16 with element strides (b,
// s, head / group), unit stride last; dt (b, s, nh) f32 with element
// strides; A (nh,) f32. ex, eb: bf16 elements a copy of x, of B (8: 16-byte
// copies, 2: 4-byte, 1: plain loads; the host checked the alignment). Writes
// states (b, s / c, nh, P, N) f32 and cum (b, nh, s) f32, both contiguous.
// Returns a cudaError_t.
extern "C" int ssd_chunk_state_mma(const void* x, const void* dt, const void* A, const void* B,
                                   void* states, void* cum, int batch, int S, int NH, int P,
                                   int G, int N, int CH, int ex, int eb,
                                   long long sxb, long long sxs, long long sxh,
                                   long long sdb, long long sds, long long sdh,
                                   long long sbb, long long sbs, long long sbg, void* stream) {
  if (!shape_ok(batch, S, NH, P, G, N, CH) || !elems_ok(ex) || !elems_ok(eb))
    return cudaErrorInvalidValue;
  const int smem = 2 * CMAX * 4 + STAGES * state_stage_bytes(P, n_pad(N));
  const dim3 grid(NH, S / CH, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SSD_MMA_STATE(DIM)                                                                    \
  err = set_smem(ssd_fwd_chunk_state_mma<DIM>, smem);                                         \
  if (err != cudaSuccess) return err;                                                         \
  ssd_fwd_chunk_state_mma<DIM><<<grid, STATE_THREADS, smem, st>>>(                            \
      static_cast<const bf16*>(x), static_cast<const float*>(dt),                             \
      static_cast<const float*>(A), static_cast<const bf16*>(B), static_cast<float*>(states), \
      static_cast<float*>(cum), S, NH, G, N, CH, ex, eb, sxb, sxs, sxh, sdb, sds, sdh, sbb,   \
      sbs, sbg)
  if (P == 64) {
    SSD_MMA_STATE(64);
  } else if (P == 32) {
    SSD_MMA_STATE(32);
  } else {
    SSD_MMA_STATE(16);
  }
#undef SSD_MMA_STATE
  return cudaGetLastError();
}

// Pass 3. x, B as in pass 1, C like B; cum from pass 1, dt as in pass 1,
// h_in (b, s / c, nh, P, N) f32 contiguous from pass 2; writes y (b, s, nh,
// P) bf16 through its element strides (unit stride last, 4-byte aligned
// rows). HPB heads per block, a divisor of nh / g. ex, ebc: bf16 elements a
// copy of x, of B and C (8, 2 or 1); eh: float32 elements a copy of h_in (4:
// 16-byte copies, 1: 4-byte). Returns a cudaError_t.
extern "C" int ssd_chunk_scan_mma(const void* x, const void* B, const void* C, const void* cum,
                                  const void* dt, const void* h_in, void* y, int batch, int S,
                                  int NH, int P, int G, int N, int CH, int HPB, int ex, int ebc,
                                  int eh, long long sxb, long long sxs, long long sxh,
                                  long long sdb, long long sds, long long sdh,
                                  long long sbb, long long sbs, long long sbg,
                                  long long scb, long long scs, long long scg,
                                  long long syb, long long sys, long long syh, void* stream) {
  if (!shape_ok(batch, S, NH, P, G, N, CH) || HPB <= 0 || (NH / G) % HPB != 0 ||
      !elems_ok(ex) || !elems_ok(ebc) || (eh != 4 && eh != 1))
    return cudaErrorInvalidValue;
  const int CT = (CH + TILE - 1) / TILE;
  const long long blocks = static_cast<long long>(S / CH) * batch * (NH / HPB);
  if (blocks * CT > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int two = ScanSmem(P, n_pad(N), CT, Occ<2>::stages).bytes;
  const bool pair = 2 * (two + BLOCK_RESERVED) <= SM_SMEM;
  const int smem = pair ? two : ScanSmem(P, n_pad(N), CT, Occ<1>::stages).bytes;
  const dim3 grid(static_cast<unsigned>(blocks * CT));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SSD_MMA_SCAN_AT(DIM, BL)                                                              \
  err = set_smem(ssd_fwd_chunk_scan_mma<DIM, BL>, smem);                                      \
  if (err == cudaSuccess && BL == 2)                                                          \
    err = cudaFuncSetAttribute(ssd_fwd_chunk_scan_mma<DIM, BL>,                               \
                               cudaFuncAttributePreferredSharedMemoryCarveout,                \
                               cudaSharedmemCarveoutMaxShared);                               \
  if (err != cudaSuccess) return err;                                                         \
  ssd_fwd_chunk_scan_mma<DIM, BL><<<grid, SCAN_THREADS, smem, st>>>(                          \
      static_cast<const bf16*>(x), static_cast<const bf16*>(B), static_cast<const bf16*>(C),  \
      static_cast<const float*>(cum), static_cast<const float*>(dt),                          \
      static_cast<const float*>(h_in), static_cast<bf16*>(y), S, NH, G, N, CH, HPB, ex, ebc,  \
      eh, sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg, syb, sys, syh)
#define SSD_MMA_SCAN(DIM)       \
  if (pair) {                   \
    SSD_MMA_SCAN_AT(DIM, 2);    \
  } else {                      \
    SSD_MMA_SCAN_AT(DIM, 1);    \
  }
  if (P == 64) {
    SSD_MMA_SCAN(64);
  } else if (P == 32) {
    SSD_MMA_SCAN(32);
  } else {
    SSD_MMA_SCAN(16);
  }
#undef SSD_MMA_SCAN
#undef SSD_MMA_SCAN_AT
  return cudaGetLastError();
}
