// Blockwise int8 quantise / dequantise for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces: the Pallas TPU kernels `_quant_kernel` (launched by
// `quantize_blockwise_2d`) and `_dequant_kernel` (launched by
// `dequantize_blockwise_2d`), src/repro/kernels/quant_blockwise/quant_blockwise.py,
// which `repro.kernels.quant_blockwise.ops` wraps. Same function, bit for bit:
// per block of `block` consecutive values, s = max(amax, 1e-12) * f32(1/127)
// (the reference as compiled: XLA turns its division by the constant 127 into
// this product, so the codec payload matches byte for byte) and
// q = clip(round(x / s), -127, 127) with an IEEE division (__fdiv_rn, never a
// reciprocal multiply; no --use_fast_math) and round half to even (rintf);
// dequantise x = q * s, rounded once to the output type.
// Non-finite blocks follow the reference: amax propagates NaN as jnp.max
// does (fmaxf would drop it), so s is NaN, or +inf for an infinity; every
// x / s is then 0 or NaN, and NaN converts to q = 0, as the reference's
// float-to-int8 conversion gives.
//
// Bound on an H100 SXM: bytes. Quantise reads 4N bytes of float32 and writes
// N bytes of q and 4N/block bytes of s; at the largest leaf of the training
// checkpoint path, tok/table of llama3-8b (128256 x 4096 = 525.3 M values,
// block 256), that is 2.64 GB, ~0.79 ms at 3.35 TB/s. Dequantise moves the
// same bytes the other way. A handful of operations per value is far below
// the card's rates.
//
// What this design does about that bound: one warp per quant block, so the
// amax is a register reduction and five xor shuffles, with no shared memory
// and no second kernel. For float32 input and a block of 128, 256 or 512 (the
// codec's 256 and the reference's test cases) each lane loads 16 bytes per
// vector, a warp 512 contiguous bytes, and keeps the block in registers for
// the second pass, so every byte of x is read once; q leaves as 4-byte words.
// Other blocks, bf16 input and
// unaligned pointers take a generic path that reads the block twice (the
// second read hits L1). The ragged tail (n not a multiple of the block) is
// read as zeros, which is the zero padding of the reference's wrapper without
// a padded copy; dequantise writes only the first n values. No atomics:
// results are deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_qb {

constexpr int WARPS = 8;               // quant blocks per thread block
constexpr int THREADS = WARPS * 32;
constexpr float EPS = 1e-12f;
constexpr float QMAX = 127.0f;
constexpr float INV_QMAX = 1.0f / 127.0f;   // folded once, as XLA folds it

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// max that keeps a NaN from either side, as jnp.max does
__device__ __forceinline__ float nanmax(float a, float b) { return (b > a || b != b) ? b : a; }

__device__ __forceinline__ float warp_amax(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

__device__ __forceinline__ float block_scale(float amax) {
  const float m = (amax != amax) ? amax : fmaxf(amax, EPS);
  return __fmul_rn(m, INV_QMAX);
}

__device__ __forceinline__ signed char quant1(float x, float s) {
  float r = rintf(__fdiv_rn(x, s));
  if (r != r) return 0;                 // NaN -> 0, as the reference's conversion
  r = fminf(fmaxf(r, -QMAX), QMAX);
  return static_cast<signed char>(static_cast<int>(r));
}

// ---------------------------------------------------------------------------
// Quantise
// ---------------------------------------------------------------------------
// float32 input, block = 128 * VPL, x 16-byte aligned. Lane l holds values
// 4 * (32 j + l) .. +3 of its block for j < VPL.
template <int VPL>
__global__ void __launch_bounds__(THREADS)
quant_f32_vec(const float* __restrict__ x, signed char* __restrict__ q, float* __restrict__ s,
              long long n, long long nblocks) {
  constexpr int B = 128 * VPL;
  const int lane = threadIdx.x & 31;
  const long long blk = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (blk >= nblocks) return;
  const long long base = blk * B;
  float v[VPL][4];
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const long long i = base + 4LL * (32 * j + lane);
    if (i + 4 <= n) {
      const float4 t = __ldcs(reinterpret_cast<const float4*>(x + i));
      v[j][0] = t.x; v[j][1] = t.y; v[j][2] = t.z; v[j][3] = t.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[j][c] = (i + c < n) ? x[i + c] : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) m = nanmax(m, fabsf(v[j][c]));
  }
  const float sc = block_scale(warp_amax(m));
  if (lane == 0) s[blk] = sc;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const long long i = base + 4LL * (32 * j + lane);
    char4 o;
    o.x = quant1(v[j][0], sc); o.y = quant1(v[j][1], sc);
    o.z = quant1(v[j][2], sc); o.w = quant1(v[j][3], sc);
    *reinterpret_cast<char4*>(q + i) = o;   // q holds nblocks * B values
  }
}

// Any block, float32 or bf16 input: two passes over the block.
template <typename T>
__global__ void __launch_bounds__(THREADS)
quant_generic(const T* __restrict__ x, signed char* __restrict__ q, float* __restrict__ s,
              long long n, long long nblocks, int B) {
  const int lane = threadIdx.x & 31;
  const long long blk = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (blk >= nblocks) return;
  const long long base = blk * B;
  float m = 0.0f;
  for (int k = lane; k < B; k += 32) {
    const long long i = base + k;
    m = nanmax(m, fabsf(i < n ? to_f32(x[i]) : 0.0f));
  }
  const float sc = block_scale(warp_amax(m));
  if (lane == 0) s[blk] = sc;
  for (int k = lane; k < B; k += 32) {
    const long long i = base + k;
    q[i] = quant1(i < n ? to_f32(x[i]) : 0.0f, sc);
  }
}

// ---------------------------------------------------------------------------
// Dequantise
// ---------------------------------------------------------------------------
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 w;
  w.x = *reinterpret_cast<unsigned int*>(&lo);
  w.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}

// block = 128 * VPL, q 4-byte and out 4-value aligned.
template <typename T, int VPL>
__global__ void __launch_bounds__(THREADS)
dequant_vec(const signed char* __restrict__ q, const float* __restrict__ s, T* __restrict__ out,
            long long n, long long nblocks) {
  constexpr int B = 128 * VPL;
  const int lane = threadIdx.x & 31;
  const long long blk = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (blk >= nblocks) return;
  const long long base = blk * B;
  const float sc = s[blk];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const long long i = base + 4LL * (32 * j + lane);
    if (i >= n) break;
    const char4 c = __ldcs(reinterpret_cast<const char4*>(q + i));
    const float r[4] = {__fmul_rn(static_cast<float>(c.x), sc), __fmul_rn(static_cast<float>(c.y), sc),
                        __fmul_rn(static_cast<float>(c.z), sc), __fmul_rn(static_cast<float>(c.w), sc)};
    if (i + 4 <= n) {
      store4(out + i, r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i + k < n) out[i + k] = from_f32<T>(r[k]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dequant_generic(const signed char* __restrict__ q, const float* __restrict__ s, T* __restrict__ out,
                long long n, int B) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = from_f32<T>(__fmul_rn(static_cast<float>(q[i]), s[i / B]));
}

inline unsigned int warp_grid(long long nblocks) {
  return static_cast<unsigned int>((nblocks + WARPS - 1) / WARPS);
}

inline bool aligned(const void* p, uintptr_t a) { return reinterpret_cast<uintptr_t>(p) % a == 0; }

// blocks of 128 * vpl values with a vector instantiation
inline bool vec_block(int block) { return block == 128 || block == 256 || block == 512; }

}  // namespace repro_qb

using namespace repro_qb;

// x_dtype / out_dtype: 0 = float32, 1 = bfloat16. n values; nblocks =
// ceil(n / block); q holds nblocks * block values, s nblocks. Returns a
// cudaError_t (0 on success).
extern "C" int qb_quantize(const void* x, int x_dtype, void* q, void* s, long long n,
                           long long nblocks, int block, int device, void* stream) {
  if (n <= 0 || block <= 0 || nblocks != (n + block - 1) / block) return cudaErrorInvalidValue;
  if (x_dtype != 0 && x_dtype != 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned int grid = warp_grid(nblocks);
  auto* qo = static_cast<signed char*>(q);
  auto* so = static_cast<float*>(s);
  if (x_dtype == 0 && vec_block(block) && aligned(x, 16) && aligned(q, 4)) {
    const auto* xf = static_cast<const float*>(x);
    switch (block / 128) {
#define QB_Q(V) case V: quant_f32_vec<V><<<grid, THREADS, 0, st>>>(xf, qo, so, n, nblocks); break;
      QB_Q(1) QB_Q(2) QB_Q(4)
#undef QB_Q
    }
  } else if (x_dtype == 0) {
    quant_generic<float><<<grid, THREADS, 0, st>>>(static_cast<const float*>(x), qo, so, n,
                                                   nblocks, block);
  } else {
    quant_generic<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), qo, so, n, nblocks, block);
  }
  return cudaGetLastError();
}

extern "C" int qb_dequantize(const void* q, const void* s, void* out, int out_dtype,
                             long long n, long long nblocks, int block, int device,
                             void* stream) {
  if (n <= 0 || block <= 0 || nblocks != (n + block - 1) / block) return cudaErrorInvalidValue;
  if (out_dtype != 0 && out_dtype != 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qi = static_cast<const signed char*>(q);
  const auto* si = static_cast<const float*>(s);
  const int vpl = block / 128;
  const bool vec = vec_block(block) && aligned(q, 4) && aligned(out, out_dtype == 0 ? 16 : 8);
  if (vec) {
    const unsigned int grid = warp_grid(nblocks);
    if (out_dtype == 0) {
      auto* o = static_cast<float*>(out);
      switch (vpl) {
#define QB_D(V) case V: dequant_vec<float, V><<<grid, THREADS, 0, st>>>(qi, si, o, n, nblocks); break;
        QB_D(1) QB_D(2) QB_D(4)
#undef QB_D
      }
    } else {
      auto* o = static_cast<__nv_bfloat16*>(out);
      switch (vpl) {
#define QB_D(V) \
  case V: dequant_vec<__nv_bfloat16, V><<<grid, THREADS, 0, st>>>(qi, si, o, n, nblocks); break;
        QB_D(1) QB_D(2) QB_D(4)
#undef QB_D
      }
    }
  } else {
    const long long want = (n + THREADS - 1) / THREADS;
    const unsigned int grid = static_cast<unsigned int>(want < 132 * 32 ? want : 132 * 32);
    if (out_dtype == 0)
      dequant_generic<float><<<grid, THREADS, 0, st>>>(qi, si, static_cast<float*>(out), n, block);
    else
      dequant_generic<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
          qi, si, static_cast<__nv_bfloat16*>(out), n, block);
  }
  return cudaGetLastError();
}
