// Flash-attention forward for NVIDIA Hopper (sm_90a) on the CUDA cores, plain
// C interface: the "simt" variant, for bf16 at head dims 16 and 32, the
// reduced configs' widths. bf16 at D 64 and 128 goes to the tensor-core
// kernel in flash_attention_sm90.cu, float32 at every head dim to the TF32
// tensor-core kernel in flash_attention_f32_sm90.cu; fa_fwd below holds the
// three apart.
//
// Replaces: the Pallas TPU kernel `_fa_kernel`, launched by
// `flash_attention_bhsd` (src/repro/kernels/flash_attention/flash_attention.py),
// which `repro.kernels.flash_attention.ops.flash_attention` wraps. It computes
// the same function: blocked online-softmax attention with GQA (kv head =
// h / (H / KH)), scale 1/sqrt(D), causal mask q_idx >= k_idx (top-left
// aligned) to NEG_INF = -1e30, float32 running max, sum and accumulator,
// denominator clamped at 1e-20, output in bf16.
//
// Bound on an H100 SXM at the shape it serves (the serve demo's reduced
// llama3-8b prefill: B=4, S=T=32, H=4, KH=2, D=16, causal, bf16): 49 KB of
// q, k, v, o is 1.5e-5 ms at 3.35 TB/s, and its 0.54 MFLOP take less at any
// peak, so it is bound by bytes. But the work is 16 blocks of a few
// microseconds, and a launch and its wrapper cost more than all of it (0.04
// ms measured on an H100). No design inside the kernel moves that; fewer
// launches would.
//
// What this design does: it is simple. Both products run as float32 FMAs
// on the CUDA cores, from register micro-tiles over float32 tiles in shared
// memory. Causal blocks stop at the diagonal tile and the heaviest q tiles
// are scheduled first.
//
// Layout: one thread block per (q tile of 64 rows, head, batch), 128
// threads. A loop over 64-row kv tiles takes the place of the TPU grid's
// sequential ("arbitrary") kv axis. Thread t owns rows 4*(t/8) .. +3 of the
// q tile; for S = Q K^T it owns columns t%8 + 8*i (i < 8) of the kv tile, and
// for O += P V columns t%8 + 8*i (i < D/8) of the head dim. The 8 threads of
// a row group are 8 neighbouring lanes, so row max and row sum reduce with
// three xor shuffles. q, k, v and o are read and written through their
// (B, S, H, D) strides, with no transpose copy. Ragged tails (S, T not a
// multiple of 64) are masked here: rows past the end are loaded as zeros,
// columns past T score -inf, and rows past S are not stored. No atomics, so
// results are deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_fa {

constexpr int BQ = 64;           // q rows per block
constexpr int BK = 64;           // kv rows per tile
constexpr int THREADS = 128;
constexpr int ROWS = 4;          // q rows per thread
constexpr int GROUP = 8;         // threads per row group
constexpr int SCOLS = BK / GROUP;  // score columns per thread
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(BQ == BK, "load_tile stages 64-row tiles for both q and kv");

// The only element type: float32 runs on flash_attention_f32_sm90.cu.
using bf16 = __nv_bfloat16;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

// Stage a 64 x D tile into shared memory as float32 times `mul`. Row r of
// the tile starts at base + r * row_stride; rows >= n_valid are zero.
// Loads are 16-byte vectors (the wrapper checks alignment).
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const bf16* base,
                                          long long row_stride, int n_valid, float mul) {
  constexpr int EPV = 16 / sizeof(bf16);   // elements per vector
  constexpr int VPR = D / EPV;          // vectors per row
  for (int idx = threadIdx.x; idx < BK * VPR; idx += THREADS) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * EPV;
    float vals[EPV];
    if (r < n_valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(base + r * row_stride + c);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < EPV; ++i) vals[i] = __bfloat162float(e[i]) * mul;
    } else {
#pragma unroll
      for (int i = 0; i < EPV; ++i) vals[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < EPV; ++i) dst[r * ld + c + i] = vals[i];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
fa_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o,
              int S, int T_, int H, int KH,
              long long sqb, long long sqs, long long sqh,
              long long skb, long long sks, long long skh,
              long long svb, long long svs, long long svh,
              long long sob, long long sos, long long soh,
              float qk_scale_log2, int causal) {
  constexpr int LDQ = D + 1, LDK = D + 1, LDV = D, LDP = BK + 1;
  constexpr int OCOLS = D / GROUP;      // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LDQ;
  float* Vs = Ks + BK * LDK;
  float* Ps = Vs + BK * LDV;

  const int q_tile = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int q0 = q_tile * BQ;
  const int tid = threadIdx.x;
  const int r0 = (tid / GROUP) * ROWS;
  const int c8 = tid % GROUP;

  const bf16* qb = q + b * sqb + h * sqh + q0 * sqs;
  const bf16* kb = k + b * skb + kvh * skh;
  const bf16* vb = v + b * svb + kvh * svh;

  // Scores are kept in log2 units: q is pre-scaled by log2(e)/sqrt(D).
  load_tile<D>(Qs, LDQ, qb, sqs, min(BQ, S - q0), qk_scale_log2);

  float m[ROWS], l[ROWS], acc[ROWS][OCOLS];
#pragma unroll
  for (int a = 0; a < ROWS; ++a) {
    m[a] = NEG_INF;
    l[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < OCOLS; ++c) acc[a][c] = 0.0f;
  }

  int n_kv = (T_ + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (min(q0 + BQ, S) - 1) / BK + 1);   // stop at the diagonal

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BK;
    const int kv_valid = min(BK, T_ - k0);
    __syncthreads();   // the previous tile's Ks, Vs, Ps are no longer read
    load_tile<D>(Ks, LDK, kb + k0 * sks, sks, kv_valid, 1.0f);
    load_tile<D>(Vs, LDV, vb + k0 * svs, svs, kv_valid, 1.0f);
    __syncthreads();

    // S = Q K^T on a ROWS x SCOLS register micro-tile.
    float s[ROWS][SCOLS];
#pragma unroll
    for (int a = 0; a < ROWS; ++a)
#pragma unroll
      for (int i = 0; i < SCOLS; ++i) s[a][i] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[ROWS], kk[SCOLS];
#pragma unroll
      for (int a = 0; a < ROWS; ++a) qa[a] = Qs[(r0 + a) * LDQ + d];
#pragma unroll
      for (int i = 0; i < SCOLS; ++i) kk[i] = Ks[(c8 + GROUP * i) * LDK + d];
#pragma unroll
      for (int a = 0; a < ROWS; ++a)
#pragma unroll
        for (int i = 0; i < SCOLS; ++i) s[a][i] = fmaf(qa[a], kk[i], s[a][i]);
    }

    // Mask, online softmax, and P to shared memory.
#pragma unroll
    for (int a = 0; a < ROWS; ++a) {
      const int qi = q0 + r0 + a;
      float mx = m[a];
#pragma unroll
      for (int i = 0; i < SCOLS; ++i) {
        const int ki = k0 + c8 + GROUP * i;
        if (ki >= T_) s[a][i] = -INFINITY;
        else if (causal && ki > qi) s[a][i] = NEG_INF;
        mx = fmaxf(mx, s[a][i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float corr = exp2f(m[a] - mx);
      float rs = 0.0f;
#pragma unroll
      for (int i = 0; i < SCOLS; ++i) {
        const float p = exp2f(s[a][i] - mx);
        Ps[(r0 + a) * LDP + c8 + GROUP * i] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[a] = l[a] * corr + rs;
#pragma unroll
      for (int c = 0; c < OCOLS; ++c) acc[a][c] *= corr;
      m[a] = mx;
    }
    __syncthreads();

    // O += P V on a ROWS x OCOLS register micro-tile.
#pragma unroll 8
    for (int jj = 0; jj < BK; ++jj) {
      float pa[ROWS], vv[OCOLS];
#pragma unroll
      for (int a = 0; a < ROWS; ++a) pa[a] = Ps[(r0 + a) * LDP + jj];
#pragma unroll
      for (int c = 0; c < OCOLS; ++c) vv[c] = Vs[jj * LDV + c8 + GROUP * c];
#pragma unroll
      for (int a = 0; a < ROWS; ++a)
#pragma unroll
        for (int c = 0; c < OCOLS; ++c) acc[a][c] = fmaf(pa[a], vv[c], acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < ROWS; ++a) {
    const int qi = q0 + r0 + a;
    if (qi < S) {
      const float inv = 1.0f / fmaxf(l[a], 1e-20f);
      bf16* orow = o + b * sob + h * soh + qi * sos;
#pragma unroll
      for (int c = 0; c < OCOLS; ++c) orow[c8 + GROUP * c] = __float2bfloat16(acc[a][c] * inv);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int T_, int H, int KH,
                   long long sqb, long long sqs, long long sqh,
                   long long skb, long long sks, long long skh,
                   long long svb, long long svs, long long svh,
                   long long sob, long long sos, long long soh,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  const float qk_scale_log2 = LOG2E / sqrtf(static_cast<float>(D));
  fa_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, T_, H, KH, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh,
      sob, sos, soh, qk_scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace repro_fa

using repro_fa::launch;

// flash_attention_sm90.cu: bf16, D 64 and 128, on the tensor cores.
extern "C" int fa_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                           int B, int S, int T, int H, int KH, int D,
                           long long sqb, long long sqs, long long sqh,
                           long long skb, long long sks, long long skh,
                           long long svb, long long svs, long long svh,
                           long long sob, long long sos, long long soh,
                           int causal, void* stream);

// flash_attention_f32_sm90.cu: float32, D 16, 32, 64 and 128, on the tensor
// cores in three TF32 products.
extern "C" int fa_fwd_tf32x3(const void* q, const void* k, const void* v, void* o,
                             int B, int S, int T, int H, int KH, int D,
                             long long sqb, long long sqs, long long sqh,
                             long long skb, long long sks, long long skh,
                             long long svb, long long svs, long long svh,
                             long long sob, long long sos, long long soh,
                             int causal, void* stream);

// dtype: 0 = float32, 1 = bfloat16. variant: 0 = "simt" (this file), 1 =
// "sm90" (bf16 tensor cores), 2 = "tf32x3" (float32 tensor cores), and it
// must be the one the wrapper's table names: tf32x3 for float32, sm90 for
// bf16 at D 64 and 128, simt for bf16 at D 16 and 32. Strides are in
// elements, for the (B, S, H, D) layout (the D stride must be 1). Returns a
// cudaError_t.
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* o,
                      int dtype, int variant, int device,
                      int B, int S, int T, int H, int KH, int D,
                      long long sqb, long long sqs, long long sqh,
                      long long skb, long long sks, long long skh,
                      long long svb, long long svs, long long svh,
                      long long sob, long long sos, long long soh,
                      int causal, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KH <= 0 || H % KH != 0) return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const int want = dtype == 0 ? 2 : (D == 64 || D == 128) ? 1 : 0;
  if (variant != want) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (want == 2)
    return fa_fwd_tf32x3(q, k, v, o, B, S, T, H, KH, D, sqb, sqs, sqh, skb, sks, skh,
                         svb, svs, svh, sob, sos, soh, causal, stream);
  if (want == 1)
    return fa_fwd_sm90(q, k, v, o, B, S, T, H, KH, D, sqb, sqs, sqh, skb, sks, skh,
                       svb, svs, svh, sob, sos, soh, causal, stream);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_LAUNCH(DIM)                                                                      \
  return launch<DIM>(q, k, v, o, B, S, T, H, KH, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, \
                     sob, sos, soh, causal, st)
  if (D == 16) FA_LAUNCH(16);
  if (D == 32) FA_LAUNCH(32);
#undef FA_LAUNCH
  return cudaErrorInvalidValue;
}
