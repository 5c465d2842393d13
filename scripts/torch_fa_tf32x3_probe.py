#!/usr/bin/env python3
"""What paces the float32 flash-attention kernel (``tf32x3``). Needs one
CUDA card.

    python3 scripts/torch_fa_tf32x3_probe.py [--json build/fa_tf32x3_probe.json]

It reports three things, each beside the card's name and power limit:

* ``shapes``: the kernel against its plain version and against SDPA in
  float32 (TF32 off) at chip_smoke.py's main attention shape (8 x 1024, 32
  heads, 8 kv heads, causal) at every head dim it takes, with each one's
  bound (three TF32 products at the TF32 peak, or bytes);
* ``mma_sync_tf32``: the rate of ``mma.sync.m16n8k8`` TF32 alone, from a
  micro-kernel of independent products in registers (8 and 16 warps an SM,
  8 accumulators a warp), built with nvcc into ``build/fa_tf32x3_probe/``:
  the ceiling of the kernel's tensor-core route;
* ``sass``: the instruction mix of the D-128 kernel's main loop (the
  innermost loop that holds every HMMA), from ``cuobjdump -sass`` of the
  built library: products against the splits, loads and moves that share
  their issue slots.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402
from repro_torch.launch.mesh import H100_HBM_BYTES_S, H100_PEAK_TF32_FLOPS  # noqa: E402

SHAPE = (8, 1024, 1024, 32, 8)      # b, s, t, h, kh: chip_smoke.py's MAIN_FA
HEAD_DIMS = (16, 32, 64, 128)
OUT = _build.BUILD_DIR / "fa_tf32x3_probe"

MMA_PEAK_CU = r"""
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
template <int CH>
__global__ void peak(float* out, int iters) {
  float d[CH][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  const uint32_t b0 = threadIdx.x ^ 5u, b1 = 11u;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < CH; ++c)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  float s = 0.0f;
  for (int c = 0; c < CH; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  if (s == 1.2345f) out[0] = s;
}
int main() {
  float* out;
  cudaMalloc(&out, 4);
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int iters = 4096;
  for (int warps : {8, 16}) {
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    peak<8><<<sms, 32 * warps>>>(out, iters);
    cudaEventRecord(e0);
    peak<8><<<sms, 32 * warps>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    const double flop = 2.0 * 16 * 8 * 8 * 8.0 * iters * warps * sms;   // TFLOP/s below
    printf("%d %.6f %.1f %s\n", warps, ms, flop / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}
"""


def time_ms(fn, reps: int = 5, inner: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return sorted(times)[len(times) // 2]


def probe_shapes() -> list:
    b, s, t, h, kh = SHAPE
    rows = []
    for d in HEAD_DIMS:
        g = torch.Generator(device="cuda").manual_seed(d)
        q = torch.randn(b, s, h, d, generator=g, device="cuda")
        k = torch.randn(b, t, kh, d, generator=g, device="cuda")
        v = torch.randn(b, t, kh, d, generator=g, device="cuda")
        before = ops.LAUNCHES_BY_VARIANT["tf32x3"]
        got = ops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        if ops.LAUNCHES_BY_VARIANT["tf32x3"] != before + 1:
            raise SystemExit(f"D {d} did not run tf32x3: {ops.LAUNCHES_BY_VARIANT}")
        want = ref.attention_reference(q, k, v, causal=True)
        err = float((got - want).abs().max())
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(h // kh, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(h // kh, dim=2).transpose(1, 2).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        flops = 4 * b * h * d * sum(i + 1 for i in range(s))
        nbytes = 4 * (2 * b * s * h * d + 2 * b * t * kh * d)
        bound_ms = max(3 * flops / H100_PEAK_TF32_FLOPS, nbytes / H100_HBM_BYTES_S) * 1e3
        kernel_ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=True))
        rows.append({"d": d, "kernel_ms": kernel_ms,
                     "plain_ms": time_ms(lambda: ref.attention_reference(q, k, v, causal=True)),
                     "library_ms": time_ms(lambda: sdpa(qt, kt, vt, is_causal=True)),
                     "bound_ms": bound_ms, "roofline_share": bound_ms / kernel_ms,
                     "max_abs_err": err})
        print(json.dumps(rows[-1]), flush=True)
        del q, k, v, qt, kt, vt, got, want
    return rows


def probe_mma_peak() -> list:
    OUT.mkdir(parents=True, exist_ok=True)
    src, exe = OUT / "mma_peak.cu", OUT / "mma_peak"
    src.write_text(MMA_PEAK_CU)
    subprocess.run([_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o",
                    str(exe), str(src)], check=True, timeout=300)
    res = subprocess.run([str(exe)], check=True, capture_output=True, text=True, timeout=120)
    rows = []
    for line in res.stdout.split("\n"):
        if line.strip():
            warps, ms, tflops, status = line.split(maxsplit=3)
            rows.append({"warps_per_sm": int(warps), "ms": float(ms), "tflops": float(tflops),
                         "status": status})
    return rows


def sass_mix(text: str) -> dict:
    """The instruction mix of the D-128 tf32x3 kernel's main loop in
    ``cuobjdump -sass`` output: the innermost backward-branch loop that
    holds the most HMMAs."""
    func = next(f for f in re.split(r"\n\s*Function : ", text)[1:]
                if "tf32x3_kernelILi128" in f.split("\n", 1)[0])
    ins = [(int(m.group(1), 16), m.group(2).strip())
           for m in re.finditer(r"/\*([0-9a-f]{4,6})\*/\s+(.*?);", func)]

    def opcode(x):
        words = x.split()
        return words[1] if words[0].startswith("@") else words[0]

    best = None
    for addr, x in ins:
        m = re.search(r"BRA\s.*?0x([0-9a-f]+)", x)
        if m and int(m.group(1), 16) < addr:
            body = [opcode(y) for a, y in ins if int(m.group(1), 16) <= a <= addr]
            hmma = sum(op.startswith("HMMA") for op in body)
            if best is None or (hmma, -len(body)) > best[0]:
                best = ((hmma, -len(body)), collections.Counter(body))
    mix = best[1]
    return {"instructions": sum(mix.values()), "hmma": best[0][0],
            "moves": mix["MOV"] + mix["IMAD.MOV.U32"], "mix": dict(mix.most_common(12))}


def probe_sass() -> dict:
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path("flash_attention"))],
                          check=True, capture_output=True, text=True, timeout=300).stdout
    return sass_mix(text)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fa_tf32x3_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    out = {"card": card, "shapes": probe_shapes(), "mma_sync_tf32": probe_mma_peak(),
           "sass": probe_sass()}
    print(json.dumps({k: out[k] for k in ("mma_sync_tf32", "sass")}), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
