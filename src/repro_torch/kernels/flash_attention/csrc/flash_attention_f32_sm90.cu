// Flash-attention forward for NVIDIA Hopper (sm_90a) in float32 on the
// tensor cores: the "tf32x3" variant, float32 q, k, v at head dims 16, 32,
// 64 and 128. Plain C entry point fa_fwd_tf32x3, called from fa_fwd
// (flash_attention.cu).
//
// Replaces: the Pallas TPU kernel `_fa_kernel`
// (src/repro/kernels/flash_attention/flash_attention.py:25), launched by
// `flash_attention_bhsd` (:63, pallas_call at :79), for float32 inputs. It
// computes the same function: blocked online-softmax attention with GQA (kv
// head = h / (H / KH)), scale 1/sqrt(D), causal mask q_idx >= k_idx
// (top-left aligned) to NEG_INF = -1e30, columns past T at -inf, float32
// running max, sum and accumulator, denominator clamped at 1e-20, float32
// output.
//
// Arithmetic. Float32 reaches the tensor cores only as TF32 (a 10-bit
// mantissa), and one TF32 product misses the float32 limit (1e-4) by 4-9x
// at D 16-128. So every operand x is split as x = hi + lo: hi is x with its
// low 13 bits cleared, which is all a tensor core reads of x (so x itself is
// passed as hi), and lo = x - hi, exact in float32, of which the tensor core
// reads the top 19 bits (a truncation, below 2^-21 |x|). Each product is
// three TF32 products, lo*hi + hi*lo + hi*hi, accumulated in float32 by
// mma.sync m16n8k8; the lo*lo term left out is below 2^-20 |a| |b|. Both
// S = Q K^T and the P V product run so. The softmax stays in float32 on the
// CUDA cores (ex2).
//
// Bound on an H100 SXM at the float32 main shape (B=8, H=32, KH=8,
// S=T=1024, D=128, causal): 68.8 GFLOP of the two products on the causal
// half, three TF32 products each, is 206 GFLOP, 0.417 ms at the dense TF32
// peak of 495 TFLOP/s; 336 MB of q, k, v, o is 0.100 ms at 3.35 TB/s. So
// it is bound by operations (the same work on the CUDA cores in float32:
// 1.03 ms at 67 TFLOP/s). mma.sync itself reaches ~320 TFLOP/s in TF32 on
// this card (65% of that peak), and the hi / lo split costs two CUDA-core
// instructions an element, which compete with the products for issue.
//
// Design, against that bound:
//   * Persistent blocks of 384 threads: a producer warpgroup, whose first
//     thread issues every TMA copy after giving back registers (setmaxnreg),
//     and eight consumer warps of 16 q rows each (a q tile of 128 rows) with
//     232 registers a thread. A block walks q tiles (one q tile of one head
//     and batch) with a stride of the grid, the heaviest causal tiles first.
//   * TMA copies q once per tile and k, v per 64-row kv tile into a
//     two-stage ring, through 4-D tensor maps over (D, heads, rows, batch)
//     with the tensors' own strides, so (B, S, H, D) is read in place. A box
//     row is 32 floats (128 bytes, 128-byte swizzle; at D 16: 16 floats,
//     64-byte swizzle). Rows past S or T arrive as zeros. q and each stage
//     of k and of v have a "full" mbarrier (TMA bytes) and an "empty" one
//     (one arrival per consumer warp, after its last read of the buffer).
//   * Shared memory holds each tile once, in float32 (192 KB at D 128), and
//     each warp splits what it loads in registers. Every raw operand reaches
//     the register quad or pair that mma.sync takes straight from one load,
//     so no instruction moves it (ptxas otherwise spends more moves than
//     products on assembling fragments):
//     - Q, the A operand of S = Q K^T: each warp rewrites its 16 rows once
//       per q tile in fragment order (stage_q), one 16-byte load a quad;
//     - K, its B operand: a thread's four consecutive d's of one kv row (one
//       16-byte load) are the B pairs of two k8 steps, the k slots of each
//       step taking d and d + 1;
//     - the P V product runs as O^T = V^T P^T. V^T's A quad is two 8-byte
//       loads, d and d + 1 of two kv rows; P^T's B pairs are S's own
//       accumulator pairs, with no shuffle and no shared memory, since S's
//       column g holds the kv row that P^T's k slot takes.
//     Which kv row each column of S holds within a group of 8 (`perm<D>`)
//     makes all these loads free of bank conflicts under the swizzle.
//   * Softmax on S's accumulator fragments: a row lives in a quad of lanes
//     (two xor shuffles), ex2, masks only on diagonal and ragged tiles; the
//     kv loop stops at the diagonal, and a warp skips the products of a kv
//     tile that lies wholly above its rows, or all of them when its rows
//     lie past S. O^T holds other q rows than S, so the rescale factors and
//     the final 1/l move there by four shuffles.
//   * Epilogue: divide by max(l, 1e-20), store rows < S in 8-byte vectors
//     straight from registers.
// Why mma.sync and not wgmma: TF32 wgmma takes its shared-memory operands
// K-major only (the transpose bits are for 16-bit types), so V would need a
// transposed copy, and the hi and lo parts of each shared-memory operand
// would both have to be staged there, twice the bytes: at D 128 one stage
// at most.
// Not done yet: splitting k and v once per block instead of once per warp
// (each element is split by all eight warps: 1,024 of a warp's 2,746
// instructions a kv tile at D 128).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fa_tiles.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace repro_fa_tf32 {

using namespace repro_fa_tiles;
using namespace repro_sm90;
using namespace repro_tf32x3;   // low, u32, mma_tf32

constexpr int BM = 128;              // q rows per block
constexpr int BN = 64;               // kv rows per tile
constexpr int WARPS = BM / 16;       // consumer warps, 16 q rows each
constexpr int THREADS = 128 + 32 * WARPS;   // a producer warpgroup, then the consumers
constexpr int STAGES = 2;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int BOX = D == 16 ? 16 : 32;             // floats in a box row
  static constexpr int Q_BYTES = BM * D * 4;
  static constexpr int KV_BYTES = BN * D * 4;
  static constexpr int Q = 0;
  static constexpr int K = Q + Q_BYTES;                     // + stage * KV_BYTES
  static constexpr int V = K + STAGES * KV_BYTES;
  static constexpr int BARS = V + STAGES * KV_BYTES;        // 2 + 4 * STAGES barriers
  static constexpr int BYTES = BARS + 8 * (2 + 4 * STAGES);
  static constexpr int ALLOC = BYTES + 1024;                // slack to align to 1024
};

// Float index of element (r, d) in a tile of R rows as TMA wrote it: D/32
// boxes of R rows x 32 floats one after the other, the 16-byte chunks of a
// row XORed with r % 8 (128-byte swizzle); at D 16 one box of 16-float rows,
// chunks XORed with (r / 2) % 4 (64-byte swizzle). Moving down 8 rows adds
// 8 * ROW<D> (the swizzle pattern repeats every 8 rows), and at D >= 32
// moving right 32 floats adds R * 32 (the next box).
template <int D, int R>
__device__ __forceinline__ int at(int r, int d) {
  if constexpr (D == 16) return r * 16 + ((((d >> 2) ^ (r >> 1)) & 3) << 2) + (d & 3);
  else return (d >> 5) * (R * 32) + r * 32 + ((((d >> 2) ^ r) & 7) << 2) + (d & 3);
}

template <int D>
constexpr int ROW = D == 16 ? 16 : 32;   // floats in a row of a box

// The kv row, within a group of 8, of S's column g (the n of Q K^T) and so,
// through S's accumulator layout, of k slot t (g = 2t) and t + 4
// (g = 2t + 1) of O^T's B fragment. Chosen so that the fragment loads are
// free of bank conflicts: a quarter warp's 16-byte loads of K rows
// perm(2p), perm(2p + 1) hit other 16-byte chunks (the rows differ in bit
// 0 at D 16, in bit 2 above), and a half warp's 8-byte loads of the V rows
// perm(0, 2, 4, 6) (or perm(1, 3, 5, 7)) hit other chunks.
template <int D>
__device__ __forceinline__ int perm(int g) {
  const int t = g >> 1;
  if constexpr (D == 16) {
    const int a = (t & 1) | ((t & 2) << 1);   // 0, 1, 4, 5
    return (g & 1) ? a ^ 3 : a;
  } else {
    return (g & 1) ? (2 * t) ^ 5 : 2 * t;
  }
}

// dst[off .. off + N) = the N floats at src (N = 2 or 4, one vector load).
template <int N, int M>
__device__ __forceinline__ void load_vec(float (&dst)[M], int off, const float* src) {
  if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[off] = v.x;
    dst[off + 1] = v.y;
  } else {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[off] = v.x;
    dst[off + 1] = v.y;
    dst[off + 2] = v.z;
    dst[off + 3] = v.w;
  }
}

// A thread's offsets (floats) into the tiles, the same for every tile. The
// swizzle is an XOR, so they are computed once, and every load in the
// loops is one of them plus a constant:
//   qr: its q rows g and g + 8 of the warp at d = 4t (even kp) and 4t + 16
//       (odd kp), kp >> 1 boxes on, read once per q tile;
//   q:  its 16 bytes in each 512-byte block of the warp's Q fragments (the
//       warp's rows rewritten in fragment order, below);
//   k:  its kv row perm(g) at d = 4t and 4t + 16, as qr;
//   v0, v1: its kv rows perm(2t), perm(2t + 1) at d = 2g (even m-tiles of
//       O^T) and 16 + 2g (odd), mt >> 1 boxes on.
template <int D>
struct Frag {
  static constexpr int BPC = ROW<D> / 8;   // 512-byte fragment blocks in a warp's box rows
  int qr[2], q, k[2], v0[2], v1[2];
  __device__ __forceinline__ Frag(int warp, int lane) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qr[h] = at<D, BM>(16 * warp + g, 4 * t + 16 * h);
      k[h] = at<D, BN>(perm<D>(g), 4 * t + 16 * h);
      v0[h] = at<D, BN>(perm<D>(2 * t), 16 * h + 2 * g);
      v1[h] = at<D, BN>(perm<D>(2 * t + 1), 16 * h + 2 * g);
    }
    q = 16 * warp * ROW<D> + 4 * lane;
  }
  // the block of k8 step i's A fragments
  __device__ __forceinline__ int qblock(int i) const {
    return q + (i / BPC) * (BM * ROW<D>) + (i % BPC) * 128;
  }
};

// Rewrite the warp's 16 q rows in place, in the order of the A fragments
// of S = Q K^T: block i (k8 step i) holds each thread's quad (row g, d(t)),
// (g + 8, d(t)), (g, d(t + 4)), (g + 8, d(t + 4)) as 16 bytes, where k8 step
// 2kp + h takes d(t) = 16 kp + 4t + 2h and d(t + 4) = d(t) + 1. Then each
// A fragment is one 16-byte load, its registers already in mma order.
template <int D>
__device__ __forceinline__ void stage_q(float* qs, const Frag<D>& f) {
  float qa[D / 16][4], qb[D / 16][4];
#pragma unroll
  for (int kp = 0; kp < D / 16; ++kp) {
    const float* src = qs + f.qr[kp & 1] + (kp >> 1) * (BM * 32);
    load_vec<4>(qa[kp], 0, src);
    load_vec<4>(qb[kp], 0, src + 8 * ROW<D>);
  }
  __syncwarp();
#pragma unroll
  for (int kp = 0; kp < D / 16; ++kp)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(qs + f.qblock(2 * kp + h)) =
          make_float4(qa[kp][2 * h], qb[kp][2 * h], qa[kp][2 * h + 1], qb[kp][2 * h + 1]);
  __syncwarp();
}

// S (16 x 64) = Q K^T for one warp: D/16 steps of 16 d's, each a 16-byte
// load of each of the thread's 8 kv rows (two k8 steps of B pairs) and of
// two staged A quads, and three TF32 products a k8 step. The products go in
// rounds over the 8 n-tiles, so that none waits on the one just issued.
template <int D>
__device__ __forceinline__ void qk(float (&s)[BN / 8][4], const float* qs, const float* ks,
                                   const Frag<D>& f) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
  for (int kp = 0; kp < D / 16; ++kp) {
    const float* kb = ks + f.k[kp & 1] + (kp >> 1) * (BN * 32);
    float kv[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) load_vec<4>(kv[j], 0, kb + j * 8 * ROW<D>);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a[4];
      load_vec<4>(a, 0, qs + f.qblock(2 * kp + h));
      const uint32_t ah[4] = {u32(a[0]), u32(a[1]), u32(a[2]), u32(a[3])};
      const uint32_t al[4] = {low(a[0]), low(a[1]), low(a[2]), low(a[3])};
      uint32_t bl[BN / 8][2];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        bl[j][0] = low(kv[j][2 * h]);
        bl[j][1] = low(kv[j][2 * h + 1]);
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) mma_tf32(s[j], al, u32(kv[j][2 * h]), u32(kv[j][2 * h + 1]));
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) mma_tf32(s[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) mma_tf32(s[j], ah, u32(kv[j][2 * h]), u32(kv[j][2 * h + 1]));
    }
  }
}

// O^T (D x 16) += V^T P^T for one warp, in m-tiles of 16 d's (mt) and two
// n-tiles of 8 q rows (n). P^T's k8 step j is S's n-tile j: its B pairs are
// S's own accumulator pairs, (s0, s1) for q rows g and (s2, s3) for g + 8,
// its k slots t and t + 4 the kv rows 8j + perm(2t) and 8j + perm(2t + 1).
// V^T's A quad of m-tile mt takes d 16 mt + 2g (row g of the m-tile) and
// 16 mt + 2g + 1 (row g + 8): two 8-byte loads, one from each kv row. The
// products go in rounds over the D/8 (m-tile, n-tile) pairs.
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 16][2][4], const float (&s)[BN / 8][4],
                                   const float* vs, const Frag<D>& f) {
  constexpr int MT = D / 16;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    float a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int off = (mt >> 1) * (BN * 32) + j * 8 * ROW<D>;
      load_vec<2>(a[mt], 0, vs + f.v0[mt & 1] + off);
      load_vec<2>(a[mt], 2, vs + f.v1[mt & 1] + off);
    }
    const uint32_t bh[2][2] = {{u32(s[j][0]), u32(s[j][1])}, {u32(s[j][2]), u32(s[j][3])}};
    const uint32_t bl[2][2] = {{low(s[j][0]), low(s[j][1])}, {low(s[j][2]), low(s[j][3])}};
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ah[mt][e] = u32(a[mt][e]);
        al[mt][e] = low(a[mt][e]);
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n) mma_tf32(o[mt][n], al[mt], bh[n][0], bh[n][1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n) mma_tf32(o[mt][n], ah[mt], bl[n][0], bl[n][1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n) mma_tf32(o[mt][n], ah[mt], bh[n][0], bh[n][1]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fa_fwd_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     float* __restrict__ o, int B, int S, int T, int H, int KH,
                     long long sob, long long sos, long long soh,
                     float scale_log2, int causal) {
  using L = Smem<D>;
  constexpr int BOXES = D / L::BOX;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_addr(smem);
  const uint32_t bars = base + L::BARS;
  // barrier addresses: full q, empty q, then per stage full k, full v,
  // empty k, empty v
  const uint32_t full_q = bars, empty_q = bars + 8u;
  auto full_k = [&](int s) { return bars + 8u * (2 + s); };
  auto full_v = [&](int s) { return bars + 8u * (2 + STAGES + s); };
  auto empty_k = [&](int s) { return bars + 8u * (2 + 2 * STAGES + s); };
  auto empty_v = [&](int s) { return bars + 8u * (2 + 3 * STAGES + s); };

  const int n_qt = (S + BM - 1) / BM;
  const int n_tiles = n_qt * H * B;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);   // warp-uniform
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, WARPS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), WARPS);
      mbar_init(empty_v(s), WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every copy ----
    regs_dealloc<40>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      int it = 0;   // kv tiles loaded so far, over all of this block's q tiles
      int qi = 0;   // q tiles loaded so far
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++qi) {
        const Tile w = tile_at<BM, BN>(tile, n_qt, S, T, H, KH, B, causal);
        mbar_wait(empty_q, (qi & 1) ^ 1);   // the first wait passes at once
        mbar_arrive_expect_tx(full_q, L::Q_BYTES);
#pragma unroll
        for (int x = 0; x < BOXES; ++x)
          tma_load_4d(base + L::Q + x * BM * L::BOX * 4, &tm_q, full_q, x * L::BOX, w.h, w.q0,
                      w.b);
        for (int j = 0; j < w.n_kv; ++j, ++it) {
          const int s = it % STAGES;
          const uint32_t parity = ((it / STAGES) & 1) ^ 1;
          const uint32_t sk = base + L::K + s * L::KV_BYTES, sv = base + L::V + s * L::KV_BYTES;
          mbar_wait(empty_k(s), parity);
          mbar_arrive_expect_tx(full_k(s), L::KV_BYTES);
#pragma unroll
          for (int x = 0; x < BOXES; ++x)
            tma_load_4d(sk + x * BN * L::BOX * 4, &tm_k, full_k(s), x * L::BOX, w.kvh, j * BN,
                        w.b);
          mbar_wait(empty_v(s), parity);
          mbar_arrive_expect_tx(full_v(s), L::KV_BYTES);
#pragma unroll
          for (int x = 0; x < BOXES; ++x)
            tma_load_4d(sv + x * BN * L::BOX * 4, &tm_v, full_v(s), x * L::BOX, w.kvh, j * BN,
                        w.b);
        }
      }
    }
    return;
  }

  // ---- consumers: 16 q rows a warp ----
  regs_alloc<232>();
  const int warp = threadIdx.x / 32 - 4;
  const int g = lane / 4, t = lane % 4;
  const Frag<D> frag(warp, lane);
  float* qs = reinterpret_cast<float*>(smem + L::Q);
  float acc_o[D / 16][2][4];   // O^T: d rows of m-tile mt, q rows 8n + 2t, 8n + 2t + 1
  float s[BN / 8][4];          // S: q rows g, g + 8

  int it = 0, qi = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++qi) {
    const Tile w = tile_at<BM, BN>(tile, n_qt, S, T, H, KH, B, causal);
    const int lo = w.q0 + 16 * warp, hi = lo + 15;   // the warp's q rows
    const int row_a = lo + g, row_b = row_a + 8;     // the thread's rows of S
    float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.0f, l_b = 0.0f;
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_o[mt][n][e] = 0.0f;

    mbar_wait(full_q, qi & 1);
    if (lo < S) stage_q<D>(qs, frag);
    for (int j = 0; j < w.n_kv; ++j, ++it) {
      const int st = it % STAGES;
      const uint32_t parity = (it / STAGES) & 1;
      const int k0 = j * BN;
      // the warp's products of this tile: none if every row lies past S or,
      // causal, before the tile's first column
      const bool work = lo < S && !(causal && k0 > hi);
      const float* ks = reinterpret_cast<const float*>(smem + L::K + st * L::KV_BYTES);
      const float* vs = reinterpret_cast<const float*>(smem + L::V + st * L::KV_BYTES);
      mbar_wait(full_k(st), parity);
      if (work) qk<D>(s, qs, ks, frag);
      if (j == w.n_kv - 1) fence_proxy_async();   // the staged q, before TMA rewrites it
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(empty_k(st));
        if (j == w.n_kv - 1) mbar_arrive(empty_q);   // q is read for the last time
      }
      if (work) {
        if (k0 + BN > T || (causal && k0 + BN - 1 > lo)) {
#pragma unroll
          for (int n = 0; n < BN / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = k0 + 8 * n + perm<D>(2 * t + (e & 1));
              const int row = (e & 2) ? row_b : row_a;
              if (col >= T) s[n][e] = -INFINITY;
              else if (causal && col > row) s[n][e] = NEG_INF;
            }
        }
        float mx_a = m_a, mx_b = m_b;
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
          mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
          mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
        }
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
        // scores stay unscaled until the exponent: exp2((s - m) * scale_log2)
        const float corr_a = fast_exp2((m_a - mx_a) * scale_log2);
        const float corr_b = fast_exp2((m_b - mx_b) * scale_log2);
        m_a = mx_a;
        m_b = mx_b;
        const float off_a = -mx_a * scale_log2, off_b = -mx_b * scale_log2;
        float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
          s[n][0] = fast_exp2(fmaf(s[n][0], scale_log2, off_a));
          s[n][1] = fast_exp2(fmaf(s[n][1], scale_log2, off_a));
          s[n][2] = fast_exp2(fmaf(s[n][2], scale_log2, off_b));
          s[n][3] = fast_exp2(fmaf(s[n][3], scale_log2, off_b));
          sum_a += s[n][0] + s[n][1];
          sum_b += s[n][2] + s[n][3];
        }
        l_a = l_a * corr_a + sum_a;
        l_b = l_b * corr_b + sum_b;
        // O^T's q rows 2t, 2t + 1 (n-tile 0) and + 8 (n-tile 1) take the
        // factors of the lanes holding S's rows 2t and 2t + 1 (g = 2t, 2t + 1)
        const float c0 = __shfl_sync(0xffffffffu, corr_a, 8 * t);
        const float c1 = __shfl_sync(0xffffffffu, corr_a, 8 * t + 4);
        const float c2 = __shfl_sync(0xffffffffu, corr_b, 8 * t);
        const float c3 = __shfl_sync(0xffffffffu, corr_b, 8 * t + 4);
#pragma unroll
        for (int mt = 0; mt < D / 16; ++mt) {
          acc_o[mt][0][0] *= c0;
          acc_o[mt][0][1] *= c1;
          acc_o[mt][0][2] *= c0;
          acc_o[mt][0][3] *= c1;
          acc_o[mt][1][0] *= c2;
          acc_o[mt][1][1] *= c3;
          acc_o[mt][1][2] *= c2;
          acc_o[mt][1][3] *= c3;
        }
      }
      mbar_wait(full_v(st), parity);
      if (work) pv<D>(acc_o, s, vs, frag);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_v(st));
    }

    // epilogue: the quad's partial sums, 1 / max(l, 1e-20) moved to the
    // lanes that hold the row in O^T, rows < S. The thread holds q rows
    // lo + 8n + 2t + b (n, b in {0, 1}) at d = 16 mt + 2g (acc_o[mt][n][b])
    // and 16 mt + 2g + 1 (acc_o[mt][n][b + 2]).
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float inv_a = 1.0f / fmaxf(l_a, 1e-20f), inv_b = 1.0f / fmaxf(l_b, 1e-20f);
    const float inv[2][2] = {{__shfl_sync(0xffffffffu, inv_a, 8 * t),
                              __shfl_sync(0xffffffffu, inv_a, 8 * t + 4)},
                             {__shfl_sync(0xffffffffu, inv_b, 8 * t),
                              __shfl_sync(0xffffffffu, inv_b, 8 * t + 4)}};
    float* ob = o + w.b * sob + w.h * soh + 2 * g;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int row = lo + 8 * n + 2 * t + b;
        if (row >= S) continue;
        float* orow = ob + row * sos;
#pragma unroll
        for (int mt = 0; mt < D / 16; ++mt)
          *reinterpret_cast<float2*>(orow + 16 * mt) =
              make_float2(acc_o[mt][n][b] * inv[n][b], acc_o[mt][n][b + 2] * inv[n][b]);
      }
  }
}

// A 4-D map over (D, heads, rows, batch) of a float32 tensor with element
// strides (batch, row, head) and unit stride along D; boxes of BOX x 1 x
// `rows_box` x 1.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int heads, int rows, int batch,
              long long s_batch, long long s_row, long long s_head, int rows_box) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_head) * 4,
                                 static_cast<cuuint64_t>(s_row) * 4,
                                 static_cast<cuuint64_t>(s_batch) * 4};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Smem<D>::BOX), 1,
                             static_cast<cuuint32_t>(rows_box), 1};
  return make_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, dims, strides, box,
                     D == 16 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int T, int H, int KH,
                   long long sqb, long long sqs, long long sqh,
                   long long skb, long long sks, long long skh,
                   long long svb, long long svs, long long svh,
                   long long sob, long long sos, long long soh,
                   int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map<D>(&tm_q, q, H, S, B, sqb, sqs, sqh, BM) ||
      !make_map<D>(&tm_k, k, KH, T, B, skb, sks, skh, BN) ||
      !make_map<D>(&tm_v, v, KH, T, B, svb, svs, svh, BN))
    return cudaErrorInvalidValue;
  constexpr int smem = Smem<D>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_tf32x3_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fa_fwd_tf32x3_kernel<D>, THREADS,
                                                        smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long n_tiles = static_cast<long long>((S + BM - 1) / BM) * H * B;
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long slots = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(n_tiles < slots ? n_tiles : slots);
  const float scale_log2 = LOG2E / sqrtf(static_cast<float>(D));
  fa_fwd_tf32x3_kernel<D><<<grid, THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<float*>(o), B, S, T, H, KH, sob, sos, soh, scale_log2,
      causal);
  return cudaGetLastError();
}

}  // namespace repro_fa_tf32

// float32 only, D in {16, 32, 64, 128}. Strides are in elements, for the
// (B, S, H, D) layout (the D stride must be 1; the others multiples of 4
// elements, as TMA needs 16-byte strides). Returns a cudaError_t.
extern "C" int fa_fwd_tf32x3(const void* q, const void* k, const void* v, void* o,
                             int B, int S, int T, int H, int KH, int D,
                             long long sqb, long long sqs, long long sqh,
                             long long skb, long long sks, long long skh,
                             long long svb, long long svs, long long svh,
                             long long sob, long long sos, long long soh,
                             int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_TF32_LAUNCH(DIM)                                                                   \
  return repro_fa_tf32::launch<DIM>(q, k, v, o, B, S, T, H, KH, sqb, sqs, sqh, skb, sks, skh, \
                                    svb, svs, svh, sob, sos, soh, causal, st)
  if (D == 16) FA_TF32_LAUNCH(16);
  if (D == 32) FA_TF32_LAUNCH(32);
  if (D == 64) FA_TF32_LAUNCH(64);
  if (D == 128) FA_TF32_LAUNCH(128);
#undef FA_TF32_LAUNCH
  return cudaErrorInvalidValue;
}
