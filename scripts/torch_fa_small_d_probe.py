#!/usr/bin/env python3
"""The bf16 flash-attention kernel (``sm90``) at small head dims under other
schedules. Needs one CUDA card.

    python3 scripts/torch_fa_small_d_probe.py [--json build/fa_small_d_probe.json]

``flash_attention_sm90.cu`` takes its schedule from ``Schedule<D>``, all
compile-time: consumer warpgroups, whether they take turns to issue their
products, the depth of the k, v ring and the kv rows a tile. This script
includes that source as it is into one probe library per schedule
(``SCHEDULES``), built with nvcc into ``build/fa_small_d_probe/``, all
started together, and times each against the plain version, SDPA and the
bound at ``SHAPES``: ``chip_smoke.py``'s small-D rate cases (8 x 1024 at D
16 and 32, 2 x 4096 at D 16, causal, GQA 32 / 8) and its main shape at D
128. Each schedule's output is held to the plain version within the bf16
limit first; a schedule whose shared memory is over the 227 KB a block may
take at a head dim (4 stages or 256-row kv tiles at D 128) is skipped there.
The shipped kernel (``ops.flash_attention``) is timed at the same shapes,
and ptxas's registers and spills of every probe kernel are reported. The
card's name and power limit come first. Exits 1 if any schedule disagrees
with the plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
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

OUT = _build.BUILD_DIR / "fa_small_d_probe"
FA_CSRC = _build.KERNELS_DIR / "flash_attention" / "csrc"
# name: (consumer warpgroups, turns, stages, kv rows a tile)
SCHEDULES = {
    "c2_turns_s2_bn128": (2, True, 2, 128),
    "c2_free_s2_bn128": (2, False, 2, 128),
    "c2_turns_s4_bn128": (2, True, 4, 128),
    "c3_turns_s2_bn128": (3, True, 2, 128),
    "c3_free_s2_bn128": (3, False, 2, 128),
    "c2_turns_s2_bn256": (2, True, 2, 256),
    "c2_free_s2_bn256": (2, False, 2, 256),
}
# (b, s, t, h, kh, d, causal): the small-D rate cases, then the main shape
SHAPES = [(8, 1024, 1024, 32, 8, 16, True), (8, 1024, 1024, 32, 8, 32, True),
          (2, 4096, 4096, 32, 8, 16, True), (8, 1024, 1024, 32, 8, 128, True)]
LIMIT = 2.5e-2                       # chip_smoke.py's bf16 TOL
SMEM_LIMIT = 232448                  # dynamic shared memory a block may take


def smem_bytes(schedule, d: int) -> int:
    """``Smem<D, P>::ALLOC`` of flash_attention_sm90.cu: the q tile, the k
    and v ring, the barriers and the alignment slack."""
    c, _, stages, bn = schedule
    return 64 * c * d * 2 + 2 * stages * bn * d * 2 + 8 * (2 + 4 * stages) + 1024

PROBE_CU = r"""
#include "flash_attention_sm90.cu"
struct ProbeSchedule {
  static constexpr int CONSUMERS = %(c)d;
  static constexpr bool TURNS = %(turns)s;
  static constexpr int STAGES = %(stages)d;
  static constexpr int BN = %(bn)d;
};
extern "C" int probe_fa(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T, int H, int KH, int D,
                        long long sqb, long long sqs, long long sqh,
                        long long skb, long long sks, long long skh,
                        long long svb, long long svs, long long svh,
                        long long sob, long long sos, long long soh,
                        int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PROBE_LAUNCH(DIM)                                                                    \
  return repro_fa_sm90::launch<DIM, ProbeSchedule>(q, k, v, o, B, S, T, H, KH, sqb, sqs, sqh, \
                                                   skb, sks, skh, svb, svs, svh, sob, sos,  \
                                                   soh, causal, st)
  if (D == 16) PROBE_LAUNCH(16);
  if (D == 32) PROBE_LAUNCH(32);
  if (D == 128) PROBE_LAUNCH(128);
#undef PROBE_LAUNCH
  return cudaErrorInvalidValue;
}
"""


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_all() -> dict:
    """One library per schedule, all nvcc processes started together.
    Returns {name: (path, ptxas lines)}."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (c, turns, stages, bn) in SCHEDULES.items():
        src = OUT / f"{name}.cu"
        src.write_text(PROBE_CU % {"c": c, "turns": "true" if turns else "false",
                                   "stages": stages, "bn": bn})
        lib = OUT / f"lib{name}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.shared_include()),
               "-I", str(FA_CSRC), "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate(timeout=_build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc exit {proc.returncode}\n{text[-4000:]}")
        out[name] = (lib, [ln.strip() for ln in text.splitlines()
                           if re.search(r"registers|spill|C75\d\d", ln)])
    return out


def bind(lib: Path):
    fn = ctypes.CDLL(str(lib)).probe_fa
    c, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fn.restype = c
    fn.argtypes = [p, p, p, p] + [c] * 6 + [ll] * 12 + [c, p]
    return fn


def call(fn, q, k, v, causal):
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, k.shape[1], h,
            k.shape[2], d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(causal), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe launch failed: CUDA error {rc}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fa_small_d_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    smoke = load_smoke()
    libs = build_all()
    fns = {name: bind(lib) for name, (lib, _) in libs.items()}
    rows = []
    for i, shape in enumerate(SHAPES):
        case = shape + (torch.bfloat16,)
        causal = shape[6]
        q, k, v = smoke.fa_inputs(case, seed=400 + i)
        want = ref.attention_reference(q, k, v, causal=causal).float()
        bound_s, bound_by, _, _ = smoke.fa_bound(case)
        row = {"shape": list(shape[:6]), "causal": causal, "bound_ms": bound_s * 1e3,
               "bound_by": bound_by,
               "shipped_ms": smoke.time_ms(lambda: ops.flash_attention(q, k, v, causal=causal)),
               "library_ms": smoke.time_ms(smoke.sdpa_call(q, k, v, causal)),
               "plain_ms": smoke.time_ms(lambda: ref.attention_reference(q, k, v, causal=causal)),
               "schedules": {}}
        for name, fn in fns.items():
            if smem_bytes(SCHEDULES[name], shape[5]) > SMEM_LIMIT:
                row["schedules"][name] = {"ok": True, "skipped": "shared memory over the limit"}
                continue
            err = float((call(fn, q, k, v, causal).float() - want).abs().max())
            entry = {"max_abs_err": err, "ok": err <= LIMIT}
            if entry["ok"]:
                entry["ms"] = smoke.time_ms(lambda: call(fn, q, k, v, causal))
            row["schedules"][name] = entry
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, want
    out = {"card": card, "shapes": rows,
           "ptxas": {name: lines for name, (_, lines) in libs.items()}}
    print(json.dumps({"ptxas": out["ptxas"]}), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    bad = [(r["shape"], n) for r in rows for n, e in r["schedules"].items() if not e["ok"]]
    if bad:
        print(f"schedules off the plain version: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
