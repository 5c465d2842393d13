// Mamba-2 SSD chunked scan for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces: the Pallas TPU kernel `_ssd_kernel`, launched by `ssd_scan_pallas`
// (src/repro/kernels/ssd_scan/ssd_scan.py), which
// `repro.kernels.ssd_scan.ops.ssd_scan` wraps. It computes the same function,
// the contract of `ssd_chunked`: chunks of length c run in order, carrying a
// float32 state (p, n) per head. Within a chunk, with cum = the prefix sum of
// dt * A,
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j    (intra)
//          + exp(cum_i) C_i . state                                  (inter)
//   state <- state exp(cum_last) + sum_j B_j exp(cum_last - cum_j) dt_j x_j
// Head h reads group h / (nh / g) of B and C. An optional init state comes in,
// the final state goes out in float32, y in bf16.
//
// bf16 only, the "simt" variant. No full-size serving path reaches this
// kernel: mamba2-130m's and jamba-v0.1-52b's SSM layers (bf16, d_state 128
// and 16) run on ssd_scan_sm90.cu, and float32 at every shape on
// ssd_scan_f32_sm90.cu ("tf32x3"). This one takes bf16 at the head dims,
// d_states, chunks and views the sm90 kernel does not (the reduced configs'
// p 16 / n 16, ragged chunks, views TMA cannot read).
//
// Bound on an H100 SXM at the serving main path (mamba2-130m prefill: b 8,
// s 4096, nh 24, p 64, g 1, n 128, c 256, bf16 x / B / C; 24 launches per
// prefill, one per layer):
//   bytes:      x read and y written (100.7 MB each), B and C (16.8 MB), dt
//               (3.1 MB), final state (6.3 MB): ~227 MB, ~68 us at 3.35 TB/s;
//   operations: ~40 GFLOP for the chunked algorithm on the causal half of
//               each chunk, with C.B^T counted once per group, ~40 us at the
//               bf16 tensor-core peak.
// So the bound is bytes, ~68 us per launch (chip_smoke.py computes it).
//
// What this design does about that bound: it is the simple, correct first
// version, and it is bound by neither. All arithmetic is float32 FMAs on the
// CUDA cores (67 TFLOP/s peak), from 4 x 4 register micro-tiles over float32
// tiles in shared memory, so shared memory bandwidth paces it. One block per
// (head, batch) recomputes C.B^T for every head of a group and runs whole
// 64-row diagonal tiles (~1.9x the operations the bound counts), and 192
// blocks of ~135 KB shared memory run one per SM, 1.45 waves on 132 SMs:
// ~110x the bound at the main shape in bf16 (PERF.md), which is why the
// tensor-core kernels, ssd_scan_sm90.cu (bf16) and ssd_scan_f32_sm90.cu
// (float32), take every shape they can read.
//
// Layout: one block of 256 threads per (head, batch). A loop over chunks
// takes the place of the TPU grid's sequential ("arbitrary") chunk axis; the
// state lives in shared memory across it. A 256-row chunk of B and C does not
// fit beside the state, so the chunk is cut into 64-row tiles: for each row
// tile i, C_i is staged once, the inter term is taken against the state as it
// was at the chunk's start, then every column tile j <= i stages B_j and
// x_j * dt_j, forms S = C_i B_j^T, masks it to j <= i BEFORE the exponential
// (a select, so no inf is ever multiplied by 0), scales by exp(cum_i - cum_j),
// and adds S (x dt)_j into y_i. The diagonal tile also adds its rows'
// contribution to the state increment, kept in registers until the chunk
// ends. Rows past the chunk's end (c not a multiple of 64) are staged as
// zeros, their cum is the chunk's last, and their y is not stored. x, B, C,
// dt and y are read and written through their strides, so the model's views
// into the conv output need no copy. No atomics: results are deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace repro_ssd {

constexpr int THREADS = 256;     // a 16 x 16 grid of threads
constexpr int TILE = 64;         // rows of a chunk tile
constexpr int CMAX = 256;        // longest chunk
constexpr int NMAX = 128;        // largest d_state
constexpr int NK = NMAX / 16;    // state columns per thread, at most

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Floats of shared memory: state (P x N+1), C_i and B_j tiles (TILE x N+1
// each), x_j dt_j (TILE x P), masked S (TILE x TILE+1), and cum, dt and the
// decay to the chunk's end (CMAX each).
__host__ __device__ constexpr int smem_floats(int P, int N) {
  return P * (N + 1) + 2 * TILE * (N + 1) + TILE * P + TILE * (TILE + 1) + 3 * CMAX;
}

// Stage `rows` rows of N values (row r at src + r * row_stride) as float32;
// rows past `rows` up to TILE are zero.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src,
                                           long long row_stride, int rows, int N) {
  for (int e = threadIdx.x; e < TILE * N; e += THREADS) {
    const int r = e / N, c = e - r * N;
    dst[r * ld + c] = r < rows ? to_f32(src[r * row_stride + c]) : 0.0f;
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS, 1)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ B,
               const T* __restrict__ C, const float* __restrict__ init,
               T* __restrict__ y, float* __restrict__ hf,
               int S, int NH, int G, int N, int CH,
               long long sxb, long long sxs, long long sxh,
               long long sdb, long long sds, long long sdh,
               long long sbb, long long sbs, long long sbg,
               long long scb, long long scs, long long scg,
               long long syb, long long sys, long long syh) {
  constexpr int PK = P / 16;     // y columns per thread; state rows per thread
  constexpr int LDS = TILE + 1;
  extern __shared__ float smem[];
  const int ldn = N + 1;
  float* St = smem;                   // carried state, P x ldn
  float* Ci = St + P * ldn;           // C rows of tile i, TILE x ldn
  float* Bj = Ci + TILE * ldn;        // B rows of tile j, TILE x ldn
  float* Xj = Bj + TILE * ldn;        // x * dt rows of tile j, TILE x P
  float* Ss = Xj + TILE * P;          // masked, decayed C_i B_j^T, TILE x LDS
  float* cum = Ss + TILE * LDS;       // prefix sum of dt * A over the chunk
  float* dts = cum + CMAX;            // dt over the chunk
  float* dec = dts + CMAX;            // exp(cum_last - cum_j), 0 past the chunk

  const int h = blockIdx.x, b = blockIdx.y;
  const int grp = h / (NH / G);
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const float a_h = A[h];
  const T* xb = x + b * sxb + h * sxh;
  const float* db = dt + b * sdb + h * sdh;
  const T* Bb = B + b * sbb + grp * sbg;
  const T* Cb = C + b * scb + grp * scg;
  T* yb = y + b * syb + h * syh;
  const long long state_off = (static_cast<long long>(b) * NH + h) * P * N;

  for (int e = tid; e < P * N; e += THREADS)
    St[(e / N) * ldn + e % N] = init ? init[state_off + e] : 0.0f;

  const int n_tiles = (CH + TILE - 1) / TILE;
  for (int t0 = 0; t0 < S; t0 += CH) {
    __syncthreads();   // the previous chunk's cum, dts, dec and state update are done
    if (tid < 32) {
      // Prefix sum of dt * A: each lane sums its 8 rows in order, then the
      // lanes' totals are scanned across the warp. Rows past the chunk add 0,
      // so their cum is the chunk's last.
      constexpr int PER = CMAX / 32;
      float v[PER];
      float run = 0.0f;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int j = tid * PER + q;
        const float d = j < CH ? db[(t0 + j) * sds] : 0.0f;
        dts[j] = d;
        run += d * a_h;
        v[q] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += u;
      }
      const float off = incl - run;
#pragma unroll
      for (int q = 0; q < PER; ++q) cum[tid * PER + q] = v[q] + off;
    }
    __syncthreads();
    const float last = cum[CH - 1];
    for (int j = tid; j < CMAX; j += THREADS) dec[j] = j < CH ? expf(last - cum[j]) : 0.0f;

    float dS[PK][NK];   // state increment: rows tr + 16a, columns tc + 16k
#pragma unroll
    for (int a = 0; a < PK; ++a)
#pragma unroll
      for (int k = 0; k < NK; ++k) dS[a][k] = 0.0f;

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * TILE;
      __syncthreads();   // Ci of the previous tile is no longer read; dec is written
      stage_rows<T>(Ci, ldn, Cb + (t0 + i0) * scs, scs, min(TILE, CH - i0), N);
      __syncthreads();

      // Inter-chunk term: acc = exp(cum_i) C_i . state^T, rows tr + 16a, columns tc + 16k.
      float acc[4][PK];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < PK; ++k) acc[a][k] = 0.0f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[PK];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = Ci[(tr + 16 * a) * ldn + n];
#pragma unroll
        for (int k = 0; k < PK; ++k) sv[k] = St[(tc + 16 * k) * ldn + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < PK; ++k) acc[a][k] = fmaf(cv[a], sv[k], acc[a][k]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float e = expf(cum[i0 + tr + 16 * a]);
#pragma unroll
        for (int k = 0; k < PK; ++k) acc[a][k] *= e;
      }

      // Intra-chunk terms, column tiles j <= i.
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TILE;
        const int rows_j = min(TILE, CH - j0);
        __syncthreads();   // Bj, Xj and Ss of the previous tile are no longer read
        stage_rows<T>(Bj, ldn, Bb + (t0 + j0) * sbs, sbs, rows_j, N);
        for (int e = tid; e < TILE * P; e += THREADS) {
          const int r = e / P, c = e - r * P;
          Xj[e] = r < rows_j ? to_f32(xb[(t0 + j0 + r) * sxs + c]) * dts[j0 + r] : 0.0f;
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) s[a][k] = 0.0f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = Ci[(tr + 16 * a) * ldn + n];
#pragma unroll
          for (int k = 0; k < 4; ++k) bv[k] = Bj[(tc + 16 * k) * ldn + n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int k = 0; k < 4; ++k) s[a][k] = fmaf(cv[a], bv[k], s[a][k]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + tr + 16 * a;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = j0 + tc + 16 * k;
            // Select before the exponential: above the diagonal the
            // difference may be large and positive.
            Ss[(tr + 16 * a) * LDS + tc + 16 * k] = j <= i ? s[a][k] * expf(cum[i] - cum[j]) : 0.0f;
          }
        }
        __syncthreads();

        for (int jj = 0; jj < TILE; ++jj) {
          float sv[4], xv[PK];
#pragma unroll
          for (int a = 0; a < 4; ++a) sv[a] = Ss[(tr + 16 * a) * LDS + jj];
#pragma unroll
          for (int k = 0; k < PK; ++k) xv[k] = Xj[jj * P + tc + 16 * k];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int k = 0; k < PK; ++k) acc[a][k] = fmaf(sv[a], xv[k], acc[a][k]);
        }

        if (jt == it) {
          // This tile's rows into the state increment:
          // dS[p][n] += sum_j x_j[p] dt_j exp(cum_last - cum_j) B_j[n].
          for (int jj = 0; jj < rows_j; ++jj) {
            const float w = dec[j0 + jj];
            float xv[PK], bv[NK];
#pragma unroll
            for (int a = 0; a < PK; ++a) xv[a] = Xj[jj * P + tr + 16 * a] * w;
#pragma unroll
            for (int k = 0; k < NK; ++k) {
              const int n = tc + 16 * k;
              bv[k] = n < N ? Bj[jj * ldn + n] : 0.0f;
            }
#pragma unroll
            for (int a = 0; a < PK; ++a)
#pragma unroll
              for (int k = 0; k < NK; ++k) dS[a][k] = fmaf(xv[a], bv[k], dS[a][k]);
          }
        }
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = i0 + tr + 16 * a;
        if (r < CH) {
          T* yrow = yb + (t0 + r) * sys;
#pragma unroll
          for (int k = 0; k < PK; ++k) yrow[tc + 16 * k] = from_f32<T>(acc[a][k]);
        }
      }
    }

    __syncthreads();   // every read of the chunk's starting state is done
    const float cdec = expf(last);
#pragma unroll
    for (int a = 0; a < PK; ++a)
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const int n = tc + 16 * k;
        if (n < N) {
          float* sp = St + (tr + 16 * a) * ldn + n;
          *sp = fmaf(*sp, cdec, dS[a][k]);
        }
      }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += THREADS) hf[state_off + e] = St[(e / N) * ldn + e % N];
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B,
                   const void* C, const void* init, void* y, void* hf,
                   int batch, int S, int NH, int G, int N, int CH,
                   long long sxb, long long sxs, long long sxh,
                   long long sdb, long long sds, long long sdh,
                   long long sbb, long long sbs, long long sbg,
                   long long scb, long long scs, long long scg,
                   long long syb, long long sys, long long syh, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(P, N);
  cudaError_t err = cudaFuncSetAttribute(ssd_fwd_kernel<T, P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(NH, batch);
  ssd_fwd_kernel<T, P><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<const float*>(init),
      static_cast<T*>(y), static_cast<float*>(hf), S, NH, G, N, CH,
      sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg, syb, sys, syh);
  return cudaGetLastError();
}

}  // namespace repro_ssd

using repro_ssd::launch;

// dtype (of x, B, C and y): 1 = bfloat16, the only one taken (float32 runs
// on ssd_scan_f32_sm90.cu). dt, A, init and the final state are float32; A, init and the final state are contiguous, init
// may be NULL (a zero state). Strides are in elements for x (b, s, h), dt
// (b, s, h), B and C (b, s, g) and y (b, s, h); the last dim of x, B, C and
// y has unit stride. Returns a cudaError_t.
extern "C" int ssd_fwd(const void* x, const void* dt, const void* A, const void* B,
                       const void* C, const void* init, void* y, void* hf,
                       int dtype, int device, int batch, int S, int NH, int P, int G,
                       int N, int CH,
                       long long sxb, long long sxs, long long sxh,
                       long long sdb, long long sds, long long sdh,
                       long long sbb, long long sbs, long long sbg,
                       long long scb, long long scs, long long scg,
                       long long syb, long long sys, long long syh, void* stream) {
  if (batch <= 0 || S <= 0 || NH <= 0 || G <= 0 || NH % G != 0 || N <= 0 ||
      N > repro_ssd::NMAX || CH <= 0 || CH > repro_ssd::CMAX || S % CH != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_LAUNCH(TYPE, DIM)                                                          \
  return launch<TYPE, DIM>(x, dt, A, B, C, init, y, hf, batch, S, NH, G, N, CH, sxb,  \
                           sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg, syb, \
                           sys, syh, st)
  if (dtype == 1) {
    if (P == 16) SSD_LAUNCH(__nv_bfloat16, 16);
    if (P == 32) SSD_LAUNCH(__nv_bfloat16, 32);
    if (P == 64) SSD_LAUNCH(__nv_bfloat16, 64);
  }
#undef SSD_LAUNCH
  return cudaErrorInvalidValue;
}
