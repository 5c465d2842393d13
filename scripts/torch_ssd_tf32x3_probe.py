#!/usr/bin/env python3
"""What paces the float32 SSD scan kernel (``tf32x3``). Needs one CUDA card.

    python3 scripts/torch_ssd_tf32x3_probe.py [--json build/ssd_tf32x3_probe.json]

It reports, beside the card's name and power limit:

* ``pass3_breakdown``: pass 3 (``ssd_chunk_scan_f32``) at chip_smoke.py's
  MAIN_SSD_F32 (8 x 4096, 24 heads, p 64, n 128, chunks of 256) built from
  copies of ``csrc/ssd_scan_f32_sm90.cu`` (under
  ``build/ssd_tf32x3_probe/``, never the repository's source), each with one
  part taken out: the head pairs' copies (``no_loads``: their x and starting
  state tiles stay stale in shared memory), the intra-chunk products
  (``no_intra``), the inter-chunk products (``no_inter``) and C.B^T
  (``no_cb``). A part's time is the base's less the variant's; the outputs
  of the variants are wrong by design and only timed;
* ``sass``: the instruction mix of every loop that holds HMMAs in pass 3 and
  pass 1 at p 64, from ``cuobjdump -sass`` of the built library (HMMAs
  against the splits, loads, exponentials and the WARPSYNCs that a branch
  around ``mma.sync`` costs).

Each variant is a text substitution of the source; a substitution that no
longer matches fails loudly, so the probe follows the source it measures.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402

SRC = ROOT / "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_f32_sm90.cu"
OUT = _build.BUILD_DIR / "ssd_tf32x3_probe"
# variant: (the source's text, what takes its place)
CUTS = {
    "no_loads": ("        for (int hh = 0; hh < 2 && 2 * q + hh < HPB; ++hh) {",
                 "        for (int hh = 0; hh < 2 && 2 * q + hh < HPB && idx < 0; ++hh) {"),
    "no_intra": ("} else if (rows_in && hh < HPB) {", "} else if (rows_in && hh < -1) {"),
    "no_inter": ("        if (rows_in && hh < HPB) {\n#pragma unroll 2",
                 "        if (rows_in && hh < -1) {\n#pragma unroll 2"),
    "no_cb": ("      if (i_tile + rs < CH) {", "      if (i_tile + rs < -1) {"),
}


def build_variants() -> dict:
    """{name: path of its library}, one nvcc each, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    codes = {"base": text}
    for name, (old, new) in CUTS.items():
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: its text is not in {SRC.name} once")
        codes[name] = text.replace(old, new)
    running = {}
    for name, code in codes.items():
        (OUT / f"{name}.cu").write_text(code)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.shared_include()),
               "-o", str(OUT / f"lib{name}.so"), str(OUT / f"{name}.cu")]
        running[name] = subprocess.Popen(cmd, stdout=open(OUT / f"{name}.log", "w"),
                                         stderr=subprocess.STDOUT)
    for name, proc in running.items():
        if proc.wait(timeout=_build.NVCC_TIMEOUT_S) != 0:
            raise RuntimeError((OUT / f"{name}.log").read_text()[-3000:])
    return {name: OUT / f"lib{name}.so" for name in codes}


def pass3_breakdown(libs: dict) -> dict:
    case = chip_smoke.MAIN_SSD_F32
    b, s, nh, p, g, n, c, _ = case
    x, dtv, A, B, C = chip_smoke.ssd_inputs(case, seed=8)
    states, cum = ops.chunk_state(x, dtv, A, B, c)
    h_in, _ = ops.state_pass(states, cum, c, None, dtype=torch.float32)
    want = ops.chunk_scan(x, dtv, B, C, cum, h_in, c)
    y = torch.empty_like(want)
    heads = ops._f32_scan_heads(nh, g, b * (s // c) * -(-c // 64), x.device)
    vec = [int(ops._vec(x)), int(ops._vec(B, C)), int(ops._vec(h_in))]
    I, L, P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    out = {"shape": list(case[:7]), "heads_per_block": heads}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).ssd_chunk_scan_f32
        fn.restype = I
        fn.argtypes = [P] * 7 + [I] * 11 + [L] * 15 + [P]
        args = [x.data_ptr(), B.data_ptr(), C.data_ptr(), cum.data_ptr(), dtv.data_ptr(),
                h_in.data_ptr(), y.data_ptr(), b, s, nh, p, g, n, c, heads, *vec,
                *x.stride()[:3], *dtv.stride(), *B.stride()[:3], *C.stride()[:3],
                *y.stride()[:3], torch.cuda.current_stream().cuda_stream]

        def run():
            rc = fn(*args)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        run()
        torch.cuda.synchronize()
        out[name] = {"ms": chip_smoke.time_ms(run)}
        if name == "base":
            out[name]["equals_the_wrappers"] = bool(torch.equal(y, want))
    for name in CUTS:
        out[name]["part_ms"] = out["base"]["ms"] - out[name]["ms"]
    return out


def sass(lib: Path) -> dict:
    """Per kernel, every backward-branch loop that holds HMMAs: its size,
    its HMMAs and its most common instructions."""
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=300).stdout

    def opcode(x):
        words = x.split()
        return words[1] if words[0].startswith("@") else words[0]

    out = {}
    for key in ("chunk_scan_f32ILi64", "chunk_state_f32ILi64"):
        func = next(f for f in re.split(r"\n\s*Function : ", text)[1:]
                    if key in f.split("\n", 1)[0])
        ins = [(int(m.group(1), 16), m.group(2).strip())
               for m in re.finditer(r"/\*([0-9a-f]{4,6})\*/\s+(.*?);", func)]
        loops = []
        for addr, x in ins:
            m = re.search(r"BRA\s.*?0x([0-9a-f]+)", x)
            if m and int(m.group(1), 16) < addr:
                body = collections.Counter(opcode(y) for a, y in ins
                                           if int(m.group(1), 16) <= a <= addr)
                hmma = sum(v for k, v in body.items() if k.startswith("HMMA"))
                if hmma:
                    loops.append({"instructions": sum(body.values()), "hmma": hmma,
                                  "warpsync": body["WARPSYNC.ALL"],
                                  "mix": dict(body.most_common(10))})
        out[key] = sorted(loops, key=lambda d: d["instructions"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ssd_tf32x3_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    libs = build_variants()
    out = {"card": card, "pass3_breakdown": pass3_breakdown(libs), "sass": sass(libs["base"])}
    print(json.dumps(out["pass3_breakdown"]), flush=True)
    for key, loops in out["sass"].items():
        for loop in loops:
            print(key, json.dumps(loop), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
