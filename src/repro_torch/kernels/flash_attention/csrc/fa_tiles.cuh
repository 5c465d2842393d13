// What the two tensor-core flash-attention kernels (flash_attention_sm90.cu,
// bf16; flash_attention_f32_sm90.cu, float32) share: the walk of a
// persistent block over q tiles, and the exponential of the softmax.
#pragma once

namespace repro_fa_tiles {

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The work of one q tile: rows q0 .. q0 + BM - 1 of head h, batch b, and
// the number of BN-row kv tiles it reads.
struct Tile {
  int q0, h, b, kvh, n_kv;
};

// Tile t of the persistent walk over n_qt q tiles x H heads x B batches:
// the heaviest causal q tiles first (the last q tile of every head and
// batch, then the one before, ...), heads of one kv head side by side so
// that their k, v tiles are read from L2 together. Causal tiles stop at the
// diagonal.
template <int BM, int BN>
__device__ __forceinline__ Tile tile_at(int t, int n_qt, int S, int T, int H, int KH, int B,
                                        int causal) {
  Tile w;
  const int hb = H * B;
  w.q0 = (n_qt - 1 - t / hb) * BM;
  w.h = (t % hb) % H;
  w.b = (t % hb) / H;
  w.kvh = w.h / (H / KH);
  w.n_kv = (T + BN - 1) / BN;
  if (causal) w.n_kv = min(w.n_kv, (min(w.q0 + BM, S) - 1) / BN + 1);
  return w;
}

}  // namespace repro_fa_tiles
