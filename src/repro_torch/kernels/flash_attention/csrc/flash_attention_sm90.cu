// Flash-attention forward for NVIDIA Hopper (sm_90a) on the tensor cores:
// bf16 q, k, v at head dims 16, 32, 64 and 128. Plain C entry point
// fa_fwd_sm90, called from fa_fwd (flash_attention.cu) for every bf16 call.
//
// Replaces: the Pallas TPU kernel `_fa_kernel`, launched by
// `flash_attention_bhsd` (src/repro/kernels/flash_attention/flash_attention.py),
// for bf16 inputs. It computes the same function: blocked online-softmax
// attention with GQA (kv head = h / (H / KH)), scale 1/sqrt(D), causal mask
// q_idx >= k_idx (top-left aligned) to NEG_INF = -1e30, columns past T at
// -inf, float32 running max, sum and accumulator, denominator clamped at
// 1e-20, output in bf16. The softmax weights are rounded to bf16 before P.V,
// as the plain version rounds them (ref.py).
//
// Bound on an H100 SXM at the serving main path (llama3-8b prefill:
// B=8, H=32, KH=8, S=T=1024, D=128, causal): 68.8 GFLOP of the two products
// on the causal half, ~70 us at the bf16 tensor-core peak of 989 TFLOP/s;
// 168 MB of q, k, v, o, ~50 us at 3.35 TB/s. So it is bound by operations.
// At the same shape with D 16 or 32 (the reduced configs' head dim is 16)
// the products take 8.7 or 17.4 us, but the one exponential per kept (q, k)
// pair, 134.3 M of them, takes 32 us on the SFU (16 a clock per SM, 132
// SMs, 1.98 GHz): there the exponentials bound it, and the softmax, not the
// products, paces the kernel.
//
// Design, against those bounds:
//   * Persistent blocks, one per SM: a producer warpgroup and CONSUMERS
//     consumer warpgroups of 64 q rows each (Schedule<D>). A block walks q
//     tiles of 64 * CONSUMERS rows (a tile is one q tile of one head and
//     batch) with a stride of the grid, the heaviest causal tiles first, so
//     that the next tile's copies overlap the current tile's last products
//     and its epilogue, and the light tiles fill the tail.
//   * The producer gives back registers (setmaxnreg) and one of its threads
//     issues every TMA copy; the consumers take the registers.
//   * TMA copies q once per tile and k, v tile by tile (BN kv rows) into a
//     ring of STAGES stages, through 4-D tensor maps over (D, heads, rows,
//     batch) with the tensors' own strides, so (B, S, H, D) is read in
//     place. A row of D columns is cut into boxes (Width<D>): 64 columns
//     with 128-byte swizzle at D 64 and 128, 16 columns with 32-byte swizzle
//     at D 16 and 32; D 128 and D 32 are two boxes. Rows past S or T arrive
//     as zeros. q and each stage of k and of v have a "full" mbarrier (TMA
//     bytes) and an "empty" one (one arrival per consumer warpgroup, made
//     only after the wgmma that read the buffer has retired).
//   * S = Q K^T on wgmma m64nBNk16, both operands K-major from shared
//     memory, one k16 step per 32 bytes of a row. The f32 scores are scaled
//     by log2(e)/sqrt(D) after the product, inside the exponent (q is not
//     pre-scaled, which would add a bf16 rounding).
//   * Softmax on the accumulator fragments in registers: a row lives in a
//     quad of lanes (two xor shuffles), ex2, masks only on the diagonal tile
//     and the ragged last kv tile; the kv loop stops at the diagonal.
//   * O += P V on wgmma m64nDk16 with P from registers (the f32 score
//     accumulator, packed to bf16 pairs in order, is the A fragment) and V
//     as an MN-major B operand from shared memory (tnspB = 1), whose lbo
//     runs from box to box.
//   * Overlap: inside a consumer, tile j's softmax runs while the tensor
//     cores do tile j-1's P V (each iteration issues S_j = Q K_j^T and
//     O += P_{j-1} V_{j-1} and waits for the first only); where Schedule<D>
//     says TURNS, named barriers make the consumers take turns to issue, so
//     that one computes its softmax while another's products run.
//   * Epilogue: divide by max(l, 1e-20), round to bf16, store rows < S
//     through the output's strides, straight from registers.
// Not done yet: a TMA-store epilogue, clusters that multicast k and v to
// the q tiles of one kv head.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fa_tiles.cuh"
#include "hopper.cuh"

namespace repro_fa_sm90 {

using namespace repro_fa_tiles;
using namespace repro_sm90;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// How a row of D bf16 columns is cut into TMA boxes and read by wgmma. D 64
// and 128: boxes of 64 columns, rows of 128 bytes with 128-byte swizzle (a
// k16 step is 32 bytes inside a row, four steps a box). D 16 and 32: boxes
// of 16 columns, rows of 32 bytes with 32-byte swizzle (a k16 step is a
// whole box). A box holds all the rows of its tile, boxes lie side by side.
template <int D>
struct Width {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dim 16, 32, 64 or 128");
  static constexpr int BOX = D >= 64 ? 64 : 16;    // columns per box
  static constexpr int BOXES = D / BOX;
  static constexpr int ROWB = 2 * BOX;             // bytes of a box row
  static constexpr int STEPS = BOX / 16;           // k16 steps per box
  static constexpr CUtensorMapSwizzle SWIZZLE =
      D >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
};

// wgmma descriptor of a tile laid out as Width<D> says: sbo is one 8-row
// swizzle pattern (8 rows of ROWB bytes); lbo, read for MN-major operands
// only, the stride from one box to the next.
template <int D>
__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo) {
  if constexpr (D >= 64) return desc_sw128(saddr, lbo, 1024);
  else return desc_sw32(saddr, lbo, 256);
}

// The schedule of one head dim, all compile-time: CONSUMERS warpgroups of 64
// q rows (a q tile of 64 * CONSUMERS rows); TURNS: the consumers take turns
// to issue their products; STAGES of the k, v ring; BN kv rows a tile (128
// or 256).
template <int D>
struct Schedule {
  static constexpr int CONSUMERS = 2;
  static constexpr bool TURNS = true;
  static constexpr int STAGES = 2;
  static constexpr int BN = 128;
};

template <int D, class P>
struct Smem {
  static constexpr int BM = 64 * P::CONSUMERS;
  static constexpr int QTILE = BM * D * 2;
  static constexpr int TILE = P::BN * D * 2;                // k or v tile
  static constexpr int Q = 0;
  static constexpr int K = Q + QTILE;                       // + stage * TILE
  static constexpr int V = K + P::STAGES * TILE;
  static constexpr int BARS = V + P::STAGES * TILE;         // 2 + 4 * STAGES barriers
  static constexpr int BYTES = BARS + 8 * (2 + 4 * P::STAGES);
  static constexpr int ALLOC = BYTES + 1024;                // slack to align to 1024
};

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Issue S = Q K^T for one kv tile (64 q rows of this warpgroup x BN kv
// rows): D/16 k16 steps, both operands K-major, 32 bytes apart inside a
// box row, the next box one box of the tile further on (BM rows of q, BN
// of k).
template <int D, int BM, int BN>
__device__ __forceinline__ void issue_qk(float (&acc_s)[BN / 2], uint32_t sq_wg, uint32_t sk) {
  using W = Width<D>;
  const uint64_t dq = desc<D>(sq_wg, 16), dk = desc<D>(sk, 16);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t in_row = (kk % W::STEPS) * 32, box = kk / W::STEPS;
    const uint32_t oq = (box * BM * W::ROWB + in_row) >> 4;   // start address, 16 B units
    const uint32_t ok = (box * BN * W::ROWB + in_row) >> 4;
    if constexpr (BN == 256) wgmma_ss_m64n256k16(acc_s, dq + oq, dk + ok, kk > 0 ? 1 : 0);
    else wgmma_ss_m64n128k16(acc_s, dq + oq, dk + ok, kk > 0 ? 1 : 0);
  }
}

// Issue O += P V for one kv tile: BN/16 k16 steps of 16 kv rows (16 rows of
// the MN-major V tile each), P's bf16 pairs in order as the A fragments.
template <int D, int BN>
__device__ __forceinline__ void issue_pv(float (&acc_o)[D / 2], const uint32_t (&p)[BN / 4],
                                         uint32_t sv) {
  using W = Width<D>;
  const uint64_t dv0 = desc<D>(sv, BN * W::ROWB);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    const uint64_t dv = dv0 + ((kk * 16 * W::ROWB) >> 4);
    if constexpr (D == 128) wgmma_rs_m64n128k16(acc_o, a, dv, 1);
    else if constexpr (D == 64) wgmma_rs_m64n64k16(acc_o, a, dv, 1);
    else if constexpr (D == 32) wgmma_rs_m64n32k16(acc_o, a, dv, 1);
    else wgmma_rs_m64n16k16(acc_o, a, dv, 1);
  }
}

// The rows a thread holds and their running softmax state. Scores stay
// unscaled until the exponent: max(s) * c = max(s * c) for c > 0, and
// exp2(s * c - m * c) is one FMA and one ex2.
struct Rows {
  int a, b;            // this thread's two q rows (b = a + 8)
  int lo;              // first row of the warpgroup
  float m_a, m_b;      // running max of the unscaled scores
  float l_a, l_b;      // this thread's part of the running sums
};

// Mask the tile at kv offset k0 where it needs it, take the running max over
// the quad, and turn the scores in place into the weights
// exp2((s - m) * scale_log2). Returns the factors that rescale O: corr_a,
// corr_b.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&acc_s)[BN / 2], Rows& r, float& corr_a,
                                             float& corr_b, int k0, int T, int causal, int cq,
                                             float scale_log2) {
  constexpr int N = BN / 2;
  if (k0 + BN > T || (causal && k0 + BN - 1 > r.lo)) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int col = k0 + 8 * (i / 4) + cq + (i & 1);
      const int row = (i & 2) ? r.b : r.a;
      if (col >= T) acc_s[i] = -INFINITY;
      else if (causal && col > row) acc_s[i] = NEG_INF;
    }
  }
  float mx_a = r.m_a, mx_b = r.m_b;
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    mx_a = fmaxf(mx_a, fmaxf(acc_s[i], acc_s[i + 1]));
    mx_b = fmaxf(mx_b, fmaxf(acc_s[i + 2], acc_s[i + 3]));
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  corr_a = fast_exp2((r.m_a - mx_a) * scale_log2);
  corr_b = fast_exp2((r.m_b - mx_b) * scale_log2);
  r.m_a = mx_a;
  r.m_b = mx_b;
  const float off_a = -mx_a * scale_log2, off_b = -mx_b * scale_log2;
  float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    acc_s[i] = fast_exp2(fmaf(acc_s[i], scale_log2, off_a));
    acc_s[i + 1] = fast_exp2(fmaf(acc_s[i + 1], scale_log2, off_a));
    acc_s[i + 2] = fast_exp2(fmaf(acc_s[i + 2], scale_log2, off_b));
    acc_s[i + 3] = fast_exp2(fmaf(acc_s[i + 3], scale_log2, off_b));
    sum_a += acc_s[i] + acc_s[i + 1];
    sum_b += acc_s[i + 2] + acc_s[i + 3];
  }
  r.l_a = r.l_a * corr_a + sum_a;
  r.l_b = r.l_b * corr_b + sum_b;
}

// The weights as bf16 pairs, in order: the A fragments of P V.
template <int N>
__device__ __forceinline__ void pack_bf16(const float (&w)[2 * N], uint32_t (&p)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    __nv_bfloat162 pair = __floats2bfloat162_rn(w[2 * i], w[2 * i + 1]);
    p[i] = *reinterpret_cast<uint32_t*>(&pair);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc_o)[N], float corr_a, float corr_b) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc_o[i] *= (i & 2) ? corr_b : corr_a;
}

template <int D, class P>
__global__ void __launch_bounds__(128 * (1 + P::CONSUMERS), 1)
fa_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ o, int B, int S, int T, int H, int KH,
                   long long sob, long long sos, long long soh,
                   float scale_log2, int causal) {
  using W = Width<D>;
  using L = Smem<D, P>;
  constexpr int CONSUMERS = P::CONSUMERS, STAGES = P::STAGES, BN = P::BN, BM = L::BM;
  constexpr int OREGS = D / 2;          // f32 accumulator registers of O
  constexpr int SREGS = BN / 2;         // f32 accumulator registers of S
  // registers a thread after setmaxnreg: 512 a thread slot over the warpgroups
  constexpr uint32_t PRODUCER_REGS = CONSUMERS == 2 ? 40 : 24;
  constexpr uint32_t CONSUMER_REGS = (512 - PRODUCER_REGS) / CONSUMERS / 8 * 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::Q;
  const uint32_t bars = base + L::BARS;
  // barrier addresses: full q, empty q, then per stage full k, full v,
  // empty k, empty v
  const uint32_t full_q = bars, empty_q = bars + 8u;
  auto full_k = [&](int s) { return bars + 8u * (2 + s); };
  auto full_v = [&](int s) { return bars + 8u * (2 + STAGES + s); };
  auto empty_k = [&](int s) { return bars + 8u * (2 + 2 * STAGES + s); };
  auto empty_v = [&](int s) { return bars + 8u * (2 + 3 * STAGES + s); };
  auto tile_k = [&](int s) { return base + L::K + static_cast<uint32_t>(s) * L::TILE; };
  auto tile_v = [&](int s) { return base + L::V + static_cast<uint32_t>(s) * L::TILE; };

  const int n_qt = (S + BM - 1) / BM;
  const int n_tiles = n_qt * H * B;

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);   // warp-uniform
  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, CONSUMERS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), CONSUMERS);
      mbar_init(empty_v(s), CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every copy ----
    regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      int it = 0;   // kv tiles loaded so far, over all of this block's q tiles
      int qi = 0;   // q tiles loaded so far
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++qi) {
        const Tile w = tile_at<BM, BN>(t, n_qt, S, T, H, KH, B, causal);
        mbar_wait(empty_q, (qi & 1) ^ 1);   // the first wait passes at once
        mbar_arrive_expect_tx(full_q, L::QTILE);
#pragma unroll
        for (int x = 0; x < W::BOXES; ++x)
          tma_load_4d(sq + x * BM * W::ROWB, &tm_q, full_q, x * W::BOX, w.h, w.q0, w.b);
        for (int j = 0; j < w.n_kv; ++j, ++it) {
          const int s = it % STAGES;
          const uint32_t parity = ((it / STAGES) & 1) ^ 1;
          mbar_wait(empty_k(s), parity);
          mbar_arrive_expect_tx(full_k(s), L::TILE);
#pragma unroll
          for (int x = 0; x < W::BOXES; ++x)
            tma_load_4d(tile_k(s) + x * BN * W::ROWB, &tm_k, full_k(s), x * W::BOX, w.kvh,
                        j * BN, w.b);
          mbar_wait(empty_v(s), parity);
          mbar_arrive_expect_tx(full_v(s), L::TILE);
#pragma unroll
          for (int x = 0; x < W::BOXES; ++x)
            tma_load_4d(tile_v(s) + x * BN * W::ROWB, &tm_v, full_v(s), x * W::BOX, w.kvh,
                        j * BN, w.b);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    regs_alloc<CONSUMER_REGS>();
    const int cw = wg - 1;
    const int t_wg = threadIdx.x - 128 * wg;
    const int warp = t_wg / 32, lane = t_wg % 32;
    const int cq = 2 * (lane % 4);
    const bool leader = t_wg == 0;   // arrives on the "empty" barriers for the warpgroup
    // this warpgroup's 64 rows of q, in each box
    const uint32_t sq_wg = sq + cw * 64 * W::ROWB;
    // With TURNS, the consumers issue their products in turn (named barrier
    // 1 + cw, 256 threads: consumer cw waits, the one before it arrives), so
    // that one's softmax runs while another's products are on the tensor
    // cores. The first consumer opens its own barrier once; the last skips
    // its very last arrival, so that no arrival is left over.
    const int my_turn = 1 + cw, next_turn = 1 + (cw + 1) % CONSUMERS;
    auto take_turn = [&]() {
      if constexpr (P::TURNS) named_sync<256>(my_turn);
    };
    auto pass_turn = [&](bool very_last) {
      if constexpr (P::TURNS)
        if (!(cw == CONSUMERS - 1 && very_last)) named_arrive<256>(next_turn);
    };
    if (P::TURNS && cw == 0) named_arrive<256>(my_turn);

    float acc_o[OREGS];
    float acc_s[SREGS];
    uint32_t p[SREGS / 2];
    float corr_a, corr_b;
#pragma unroll
    for (int i = 0; i < SREGS; ++i) acc_s[i] = 0.0f;

    int it = 0, qi = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++qi) {
      const Tile w = tile_at<BM, BN>(t, n_qt, S, T, H, KH, B, causal);
      const bool last_tile = t + static_cast<int>(gridDim.x) >= n_tiles;
      Rows r;
      r.lo = w.q0 + 64 * cw;
      r.a = r.lo + 16 * warp + lane / 4;
      r.b = r.a + 8;
      r.m_a = r.m_b = NEG_INF;
      r.l_a = r.l_b = 0.0f;
#pragma unroll
      for (int i = 0; i < OREGS; ++i) acc_o[i] = 0.0f;

      // Tile j's softmax runs while the tensor cores do tile j-1's P V: each
      // iteration issues S_j = Q K_j^T, rescales O, issues O += P_{j-1}
      // V_{j-1}, waits for the first product only, computes the weights of
      // tile j, then waits for the second.
      mbar_wait(full_q, qi & 1);
      {
        const int s = it % STAGES;
        mbar_wait(full_k(s), (it / STAGES) & 1);
        take_turn();
        fence_operands(acc_s);
        wgmma_fence();
        issue_qk<D, BM, BN>(acc_s, sq_wg, tile_k(s));
        wgmma_commit();
        pass_turn(last_tile && w.n_kv == 1);
        wgmma_wait<0>();
        fence_operands(acc_s);
        if (leader) {
          mbar_arrive(empty_k(s));
          if (w.n_kv == 1) mbar_arrive(empty_q);
        }
        softmax_tile<BN>(acc_s, r, corr_a, corr_b, 0, T, causal, cq, scale_log2);
        pack_bf16(acc_s, p);
      }
      for (int j = 1; j < w.n_kv; ++j) {
        const int s = (it + j) % STAGES, sp = (it + j - 1) % STAGES;
        mbar_wait(full_k(s), ((it + j) / STAGES) & 1);
        take_turn();
        fence_operands(acc_s);
        wgmma_fence();
        issue_qk<D, BM, BN>(acc_s, sq_wg, tile_k(s));
        wgmma_commit();
        rescale(acc_o, corr_a, corr_b);
        mbar_wait(full_v(sp), ((it + j - 1) / STAGES) & 1);
        fence_operands(acc_o);
        fence_regs(p);
        wgmma_fence();
        issue_pv<D, BN>(acc_o, p, tile_v(sp));
        wgmma_commit();
        pass_turn(last_tile && j == w.n_kv - 1);
        wgmma_wait<1>();                 // S_j is done, P_{j-1} V_{j-1} may run on
        fence_operands(acc_s);
        if (leader) {
          mbar_arrive(empty_k(s));
          if (j == w.n_kv - 1) mbar_arrive(empty_q);   // q is read for the last time
        }
        softmax_tile<BN>(acc_s, r, corr_a, corr_b, j * BN, T, causal, cq, scale_log2);
        wgmma_wait<0>();
        fence_operands(acc_o);
        fence_regs(p);
        if (leader) mbar_arrive(empty_v(sp));
        pack_bf16(acc_s, p);
      }
      {
        const int sl = (it + w.n_kv - 1) % STAGES;
        rescale(acc_o, corr_a, corr_b);
        mbar_wait(full_v(sl), ((it + w.n_kv - 1) / STAGES) & 1);
        fence_operands(acc_o);
        fence_regs(p);
        wgmma_fence();
        issue_pv<D, BN>(acc_o, p, tile_v(sl));
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(acc_o);
        fence_regs(p);
        if (leader) mbar_arrive(empty_v(sl));
      }
      it += w.n_kv;

      // epilogue: the quad's partial sums, 1 / max(l, 1e-20), bf16, rows < S
      float l_a = r.l_a, l_b = r.l_b;
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
      const float inv_a = 1.0f / fmaxf(l_a, 1e-20f), inv_b = 1.0f / fmaxf(l_b, 1e-20f);
      __nv_bfloat16* ob = o + w.b * sob + w.h * soh;
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn) {
        const int col = 8 * jn + cq;
        if (r.a < S)
          *reinterpret_cast<__nv_bfloat162*>(ob + r.a * sos + col) =
              __floats2bfloat162_rn(acc_o[4 * jn] * inv_a, acc_o[4 * jn + 1] * inv_a);
        if (r.b < S)
          *reinterpret_cast<__nv_bfloat162*>(ob + r.b * sos + col) =
              __floats2bfloat162_rn(acc_o[4 * jn + 2] * inv_b, acc_o[4 * jn + 3] * inv_b);
      }
    }
  }
}

// A 4-D map over (D, heads, rows, batch) of a bf16 tensor with element
// strides (batch, row, head) and unit stride along D; boxes of
// Width<D>::BOX x 1 x box_rows x 1.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int heads, int rows, int batch,
              long long s_batch, long long s_row, long long s_head, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_head) * 2,
                                 static_cast<cuuint64_t>(s_row) * 2,
                                 static_cast<cuuint64_t>(s_batch) * 2};
  const cuuint32_t box[4] = {Width<D>::BOX, 1, static_cast<cuuint32_t>(box_rows), 1};
  return make_map_bf16(map, ptr, dims, strides, box, Width<D>::SWIZZLE);
}

template <int D, class P = Schedule<D>>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int T, int H, int KH,
                   long long sqb, long long sqs, long long sqh,
                   long long skb, long long sks, long long skh,
                   long long svb, long long svs, long long svh,
                   long long sob, long long sos, long long soh,
                   int causal, cudaStream_t stream) {
  using L = Smem<D, P>;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map<D>(&tm_q, q, H, S, B, sqb, sqs, sqh, L::BM) ||
      !make_map<D>(&tm_k, k, KH, T, B, skb, sks, skh, P::BN) ||
      !make_map<D>(&tm_v, v, KH, T, B, svb, svs, svh, P::BN))
    return cudaErrorInvalidValue;
  constexpr int smem = L::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_sm90_kernel<D, P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long n_tiles = static_cast<long long>((S + L::BM - 1) / L::BM) * H * B;
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(n_tiles < sms ? n_tiles : sms);   // one block per SM
  const float scale_log2 = LOG2E / sqrtf(static_cast<float>(D));
  fa_fwd_sm90_kernel<D, P><<<grid, 128 * (1 + P::CONSUMERS), smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), B, S, T, H, KH, sob, sos, soh,
      scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace repro_fa_sm90

// bf16 only, D in {16, 32, 64, 128}. Strides are in elements, for the
// (B, S, H, D) layout (the D stride must be 1; the others multiples of 8
// elements, as TMA needs 16-byte strides). Returns a cudaError_t.
extern "C" int fa_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                           int B, int S, int T, int H, int KH, int D,
                           long long sqb, long long sqs, long long sqh,
                           long long skb, long long sks, long long skh,
                           long long svb, long long svs, long long svh,
                           long long sob, long long sos, long long soh,
                           int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_SM90_LAUNCH(DIM)                                                                  \
  return repro_fa_sm90::launch<DIM>(q, k, v, o, B, S, T, H, KH, sqb, sqs, sqh, skb, sks, skh, \
                                    svb, svs, svh, sob, sos, soh, causal, st)
  if (D == 16) FA_SM90_LAUNCH(16);
  if (D == 32) FA_SM90_LAUNCH(32);
  if (D == 64) FA_SM90_LAUNCH(64);
  if (D == 128) FA_SM90_LAUNCH(128);
#undef FA_SM90_LAUNCH
  return cudaErrorInvalidValue;
}
