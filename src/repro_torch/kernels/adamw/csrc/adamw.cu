// AdamW with its global-norm clip over a whole float32 tree, for NVIDIA Hopper
// (sm_90a), plain C interface.
//
// Replaces: no Pallas kernel. The reference leaves its optimizer
// (src/repro/train/optimizer.py, adam_update) to XLA, which fuses the
// elementwise terms of a leaf into one loop; the port's per-leaf path in
// train/optimizer.py runs them as ~15 separate PyTorch passes, each with a
// float32 temporary. This kernel is the port's counterpart of XLA's fusion.
//
// Same function as the per-leaf path, term for term and rounding for
// rounding: g' = g * scale; m = b1 m + (1 - b1) g'; v = b2 v + ((1 - b2) g') g';
// u = (m / c1) / (sqrt(v / c2) + eps); u += wd p on leaves with ndim >= 2;
// p -= lr u. Each term is one IEEE operation (__fmul_rn, __fdiv_rn,
// __fsqrt_rn, ...: nvcc never contracts them into an FMA, no --use_fast_math),
// as each is one PyTorch pass there, so p, m and v come out bit for bit as the
// per-leaf path's whenever the clip scale agrees. The scale is
// min(1, clip * (1 / max(norm, 1e-12))), NaN-propagating as torch.clamp is;
// 1 without a clip.
//
// Bound on an H100 SXM: bytes. The clip needs the global norm before any
// element moves, so two passes is the least: the sum of squares reads g
// (4 B an element), the update reads p, g, m, v and writes p, m, v (28 B):
// 32 B an element, 60.3 GB over olmoe-1b-7b-4l's 1.885 B parameters, 18.0 ms
// at 3.35 TB/s. A few dozen operations an element are far below the card's
// rates.
//
// What the design does about it: three launches a step, whatever the number
// of leaves (up to MAXL leaves a launch; more take more launches, chunked as
// multi_tensor_apply does). The leaves' pointers, sizes and tile offsets
// travel in the kernel's parameters (__grid_constant__, read through the
// constant cache); a block finds its leaf by a binary search over the tile
// offsets. 16-byte loads and stores where all four pointers are 16-byte
// aligned, with a scalar tail; evict-first hints, since nothing is read twice
// within a pass.
//   1. adamw_sumsq: SUM_BLOCKS blocks (a fixed number, so the partials and
//      their order do not depend on the card) stride over the tiles of g and
//      sum squares in float64 (exact squares), each block writing its sum to
//      its own slot of a scratch buffer: no atomics. A second batch of leaves
//      adds to the slots in stream order.
//   2. adamw_norm_scale: one block sums the slots in a fixed tree and writes
//      the norm and the clip scale to device memory: no host sync.
//   3. adamw_update: one block per tile; reads scale, lr, c1 and c2 from
//      device pointers and updates p, m and v in place (the same storage: the
//      TCE's snapshot and arenas hold those leaves). g is never written.
// Every sum is taken in a fixed order, so two runs on equal inputs agree bit
// for bit (deterministic training and TRANSOM's replay need that).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_adamw {

constexpr int THREADS = 256;
constexpr int MAXL = 48;              // leaves a launch (the parameters stay under 4 KB)
constexpr int SUM_BLOCKS = 1024;      // fixed: it sets the order of the norm's sum
constexpr int SUM_VEC = 4;            // float4 loads a thread a tile, sum pass
constexpr int UPD_VEC = 2;            // the same, update pass (four arrays each)
constexpr long long SUM_TILE = 4LL * THREADS * SUM_VEC;   // 4096 elements
constexpr long long UPD_TILE = 4LL * THREADS * UPD_VEC;   // 2048 elements

struct Leaves {
  float* p[MAXL];
  const float* g[MAXL];
  float* m[MAXL];
  float* v[MAXL];
  long long n[MAXL];
  long long tile0[MAXL + 1];          // first tile of each leaf; tile0[count] = tiles
  unsigned char vec[MAXL];            // 16-byte aligned (all the pointers used)
  unsigned char decay[MAXL];          // weight decay applies (ndim >= 2)
  int count;
};

struct Hyper {
  float b1, b2, omb1, omb2, eps, wd;   // omb = 1 - b, rounded once, as PyTorch does
};

__device__ __forceinline__ int leaf_of(const Leaves& L, long long t) {
  int lo = 0, hi = L.count - 1;       // the last leaf whose first tile is <= t
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (L.tile0[mid] <= t) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Sum over the block in a fixed tree (shuffles, then warp 0 over the warps).
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  x = lane < THREADS / 32 ? warp_sums[lane] : 0.0;
  if (warp == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  }
  return x;                           // thread 0 holds the sum
}

__device__ __forceinline__ double sq(float x) {
  const double d = x;
  return d * d;                       // exact: 24-bit mantissas
}

__global__ void __launch_bounds__(THREADS)
adamw_sumsq(const __grid_constant__ Leaves L, double* __restrict__ partials, int accumulate) {
  double acc = 0.0;
  const long long tiles = L.tile0[L.count];
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int i = leaf_of(L, t);
    const float* __restrict__ g = L.g[i];
    const long long n = L.n[i];
    const long long base = (t - L.tile0[i]) * SUM_TILE;
    if (L.vec[i]) {
      float4 x[SUM_VEC];
#pragma unroll
      for (int u = 0; u < SUM_VEC; ++u) {
        const long long e = base + 4LL * (u * THREADS + threadIdx.x);
        if (e + 4 <= n) {
          x[u] = __ldcs(reinterpret_cast<const float4*>(g + e));
        } else {
          x[u].x = e < n ? g[e] : 0.0f;
          x[u].y = e + 1 < n ? g[e + 1] : 0.0f;
          x[u].z = e + 2 < n ? g[e + 2] : 0.0f;
          x[u].w = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < SUM_VEC; ++u)
        acc += ((sq(x[u].x) + sq(x[u].y)) + (sq(x[u].z) + sq(x[u].w)));
    } else {
#pragma unroll 4
      for (int u = 0; u < 4 * SUM_VEC; ++u) {
        const long long e = base + u * THREADS + threadIdx.x;
        if (e < n) acc += sq(g[e]);
      }
    }
  }
  const double s = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = accumulate ? partials[blockIdx.x] + s : s;
}

__global__ void __launch_bounds__(THREADS)
adamw_norm_scale(const double* __restrict__ partials, float clip, float* __restrict__ out) {
  double acc = 0.0;
#pragma unroll
  for (int k = 0; k < SUM_BLOCKS / THREADS; ++k) acc += partials[k * THREADS + threadIdx.x];
  const double s = block_sum(acc);
  if (threadIdx.x == 0) {
    const float norm = static_cast<float>(sqrt(s));
    float scale = 1.0f;
    if (clip > 0.0f) {
      const float d = norm != norm ? norm : fmaxf(norm, 1e-12f);
      scale = __fmul_rn(__frcp_rn(d), clip);
      scale = scale != scale ? scale : fminf(scale, 1.0f);
    }
    out[0] = norm;
    out[1] = scale;
  }
}

struct Scalars {
  float scale, lr, c1, c2;
};

__device__ __forceinline__ void adamw1(float& p, float g, float& m, float& v, const Scalars& k,
                                       const Hyper& h, bool decay) {
  g = __fmul_rn(g, k.scale);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(h.omb2, g), g));
  float u = __fdiv_rn(__fdiv_rn(m, k.c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, k.c2)), h.eps));
  if (decay) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(u, k.lr));
}

__device__ __forceinline__ void adamw4(float4& p, const float4& g, float4& m, float4& v,
                                       const Scalars& k, const Hyper& h, bool decay) {
  adamw1(p.x, g.x, m.x, v.x, k, h, decay);
  adamw1(p.y, g.y, m.y, v.y, k, h, decay);
  adamw1(p.z, g.z, m.z, v.z, k, h, decay);
  adamw1(p.w, g.w, m.w, v.w, k, h, decay);
}

__global__ void __launch_bounds__(THREADS)
adamw_update(const __grid_constant__ Leaves L, const float* __restrict__ scale,
             const float* __restrict__ lr, const float* __restrict__ c1,
             const float* __restrict__ c2, const Hyper h) {
  const long long t = blockIdx.x;
  const int i = leaf_of(L, t);
  const long long n = L.n[i];
  const long long base = (t - L.tile0[i]) * UPD_TILE;
  const Scalars k{*scale, *lr, *c1, *c2};
  const bool decay = L.decay[i];
  float* __restrict__ p = L.p[i];
  const float* __restrict__ g = L.g[i];
  float* __restrict__ m = L.m[i];
  float* __restrict__ v = L.v[i];
  if (L.vec[i]) {
    float4 pv[UPD_VEC], gv[UPD_VEC], mv[UPD_VEC], vv[UPD_VEC];
#pragma unroll
    for (int u = 0; u < UPD_VEC; ++u) {
      const long long e = base + 4LL * (u * THREADS + threadIdx.x);
      if (e + 4 <= n) {
        pv[u] = __ldcs(reinterpret_cast<const float4*>(p + e));
        gv[u] = __ldcs(reinterpret_cast<const float4*>(g + e));
        mv[u] = __ldcs(reinterpret_cast<const float4*>(m + e));
        vv[u] = __ldcs(reinterpret_cast<const float4*>(v + e));
      }
    }
#pragma unroll
    for (int u = 0; u < UPD_VEC; ++u) {
      const long long e = base + 4LL * (u * THREADS + threadIdx.x);
      if (e + 4 <= n) {
        adamw4(pv[u], gv[u], mv[u], vv[u], k, h, decay);
        __stcs(reinterpret_cast<float4*>(p + e), pv[u]);
        __stcs(reinterpret_cast<float4*>(m + e), mv[u]);
        __stcs(reinterpret_cast<float4*>(v + e), vv[u]);
      } else {
        for (long long j = e; j < n && j < e + 4; ++j) adamw1(p[j], g[j], m[j], v[j], k, h, decay);
      }
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < 4 * UPD_VEC; ++u) {
      const long long e = base + u * THREADS + threadIdx.x;
      if (e < n) adamw1(p[e], g[e], m[e], v[e], k, h, decay);
    }
  }
}

inline bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Fills L with leaves [first, first + MAXL), in tiles of `tile`; returns the
// index after the last leaf taken.
inline int fill(Leaves& L, int first, int count, void* const* p, const void* const* g,
                void* const* m, void* const* v, const long long* n, const unsigned char* decay,
                long long tile) {
  L.count = 0;
  L.tile0[0] = 0;
  int i = first;
  for (; i < count && L.count < MAXL; ++i) {
    const int k = L.count++;
    L.p[k] = p ? static_cast<float*>(p[i]) : nullptr;
    L.g[k] = static_cast<const float*>(g[i]);
    L.m[k] = m ? static_cast<float*>(m[i]) : nullptr;
    L.v[k] = v ? static_cast<float*>(v[i]) : nullptr;
    L.n[k] = n[i];
    L.vec[k] = aligned(g[i]) && (!p || (aligned(p[i]) && aligned(m[i]) && aligned(v[i])));
    L.decay[k] = decay ? decay[i] : 0;
    L.tile0[k + 1] = L.tile0[k] + (n[i] + tile - 1) / tile;
  }
  return i;
}

}  // namespace repro_adamw

using namespace repro_adamw;

// The float64 scratch adamw_step needs: SUM_BLOCKS partial sums.
extern "C" int adamw_partials() { return SUM_BLOCKS; }

// One AdamW step with its clip over `count` float32 leaves, all on `device`:
// p, g, m, v pointers and each leaf's `n` elements (n > 0); decay[i] != 0
// where the weight decay applies. lr, c1, c2: float32 scalars on the device
// (the schedule and the bias corrections). partials: adamw_partials() float64
// of scratch; norm_scale: two float32, written the norm, then the clip scale
// (clip <= 0: no clip, scale 1). Launches max(1, ceil(count / MAXL)) sum
// passes, one norm_scale and ceil(count / MAXL) updates on `stream`, and
// counts them into launched[0], [1] and [2]; never synchronises; returns a
// cudaError_t (0 on success).
extern "C" int adamw_step(int count, void* const* p, const void* const* g, void* const* m,
                          void* const* v, const long long* n, const unsigned char* decay,
                          const void* lr, const void* c1, const void* c2, float b1, float b2,
                          float omb1, float omb2, float eps, float wd, float clip,
                          void* partials, void* norm_scale, int device, void* stream,
                          int* launched) {
  launched[0] = launched[1] = launched[2] = 0;
  if (count < 0) return cudaErrorInvalidValue;
  long long elems = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] <= 0) return cudaErrorInvalidValue;
    elems += n[i];
  }
  // the update's grid: one block a tile, at most 2^31 - 1 of them a launch
  if (elems / UPD_TILE + count > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<double*>(partials);
  auto* ns = static_cast<float*>(norm_scale);
  Leaves L;
  int i = 0;
  do {                                // no leaves: one pass of no tiles, a zero norm
    const bool more = i > 0;
    i = fill(L, i, count, nullptr, g, nullptr, nullptr, n, nullptr, SUM_TILE);
    adamw_sumsq<<<SUM_BLOCKS, THREADS, 0, st>>>(L, part, more);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++launched[0];
  } while (i < count);
  adamw_norm_scale<<<1, THREADS, 0, st>>>(part, clip, ns);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ++launched[1];
  const Hyper h{b1, b2, omb1, omb2, eps, wd};
  for (i = 0; i < count;) {
    i = fill(L, i, count, p, g, m, v, n, decay, UPD_TILE);
    adamw_update<<<static_cast<unsigned int>(L.tile0[L.count]), THREADS, 0, st>>>(
        L, ns + 1, static_cast<const float*>(lr), static_cast<const float*>(c1),
        static_cast<const float*>(c2), h);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++launched[2];
  }
  return cudaSuccess;
}
