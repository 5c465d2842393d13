#!/usr/bin/env python3
"""Times of the bf16 SSD scan at the shapes the ``sm90`` kernel does not
take, for the port in this checkout or in another. Needs one CUDA card.

    python3 scripts/torch_ssd_bf16_times.py [--tree DIR] [--json PATH]

``--tree`` names the root of another checkout of the repository (an older
commit unpacked with ``git archive``): its ``src/repro_torch`` is timed, with
its kernels built into its own ``build/``. Without it, this checkout's.
To compare two commits, run both trees in one call on one card, in turns
(old, new, new, old).

The cases are ``chip_smoke.py``'s ``mma`` timing cases, in its views into
one conv output: jamba-v0.1-52b's scan in rows padded by 4 bf16 (which TMA
cannot read), the bf16 p-32 case, the serve demo's reduced mamba2, and
mamba2-130m's scan in rows padded by 4 bf16. For each it prints one JSON line:
the variant that ran (``ops.variant``), its time and the plain scan's
(``chip_smoke.time_ms``), the bound (``chip_smoke.ssd_bound``), each pass's
time beside its bound where the variant runs in passes
(``chip_smoke.ssd_pass_times``), the error against the plain scan as a share
of max |y|, and the card's name and power limit as ``nvidia-smi`` gives
them.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="root of the checkout whose port is timed (default: this one)")
    ap.add_argument("--json", type=Path, default=None, help="also write the lines here")
    args = ap.parse_args(argv)
    tree = args.tree.resolve()
    # The timed tree's port first, so that chip_smoke.py (which puts this
    # checkout's src/ first on the path) finds it already imported.
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels.ssd_scan import ops, ref

    if not torch.cuda.is_available():
        print("torch_ssd_bf16_times: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if Path(ops.__file__).resolve().parents[4] != tree:
        raise SystemExit(f"imported {ops.__file__}, not the port of {tree}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    lines = []
    for key, case, pad in (("jamba", smoke.JAMBA_SSD, 4), ("p32", smoke.SSD_CASES[3], 0),
                           ("demo", smoke.DEMO_SSD, 0), ("mamba2", smoke.MAIN_SSD, 4)):
        x, dtv, A, B, C = smoke.ssd_inputs(case, seed=8, pad=pad)
        chunk = case[6]
        kind = ops.variant(case[7], case[3], case[5], chunk, ops.tma_aligned(x, B, C))
        got, _ = ops.ssd_scan(x, dtv, A, B, C, chunk=chunk)
        want, _ = ref.ssd_reference(x, dtv, A, B, C, chunk=chunk)
        err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
        del got, want
        ms = smoke.time_ms(lambda: ops.ssd_scan(x, dtv, A, B, C, chunk=chunk))
        plain_ms = smoke.time_ms(lambda: ref.ssd_reference(x, dtv, A, B, C, chunk=chunk))
        bound_s, bound_by, _, _ = smoke.ssd_bound(case)
        passes = (smoke.ssd_pass_times(ops, case, x, dtv, A, B, C)
                  if kind in ("sm90", "tf32x3", "mma") else None)
        line = {"tree": str(tree), "case": key, "shape": list(case[:7]), "pad": pad,
                "variant": kind, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
                "bound_by": bound_by, "passes": passes, "y_err_share_of_max": err,
                "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del x, dtv, A, B, C
        torch.cuda.empty_cache()
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
