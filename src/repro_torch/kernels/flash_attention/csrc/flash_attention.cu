// Flash-attention forward for NVIDIA Hopper (sm_90a): the plain C entry
// point fa_fwd, which hands a call to one of the two tensor-core kernels by
// dtype. bf16 at every head dim (16, 32, 64, 128) goes to
// flash_attention_sm90.cu (wgmma fed by TMA), float32 at every head dim to
// flash_attention_f32_sm90.cu (three TF32 mma.sync products a product).
//
// Replaces: the Pallas TPU kernel `_fa_kernel`, launched by
// `flash_attention_bhsd` (src/repro/kernels/flash_attention/flash_attention.py),
// which `repro.kernels.flash_attention.ops.flash_attention` wraps; each
// kernel's source says how it computes that function and what bounds it.

#include <cuda_runtime.h>

// flash_attention_sm90.cu: bf16, D 16, 32, 64 and 128, on the tensor cores.
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

// dtype: 0 = float32, 1 = bfloat16. variant: 0 = "sm90" (bf16 tensor
// cores), 1 = "tf32x3" (float32 tensor cores), and it must be the one the
// wrapper's table names: sm90 for bf16, tf32x3 for float32. Strides are in
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
  if (variant != (dtype == 0 ? 1 : 0)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (dtype == 0)
    return fa_fwd_tf32x3(q, k, v, o, B, S, T, H, KH, D, sqb, sqs, sqh, skb, sks, skh,
                         svb, svs, svh, sob, sos, soh, causal, stream);
  return fa_fwd_sm90(q, k, v, o, B, S, T, H, KH, D, sqb, sqs, sqh, skb, sks, skh,
                     svb, svs, svh, sob, sos, soh, causal, stream);
}
