#!/usr/bin/env python3
"""Where the bf16 prefill logits gap of mamba2-130m between the ``sm90`` SSD
kernel and the plain scan comes from. Needs one CUDA card.

    python3 scripts/torch_ssd_gap.py [--json build/ssd_gap.json]

It runs the prefill of ``chip_smoke.py``'s mamba2 serve wave (full width and
depth, bf16, 8 x 4096 tokens, weights from seed 0, prompts from seed 1) and
reads max |logits - plain| / max |plain| for four scans in every layer:

* ``kernel``: the ``sm90`` kernel as built (its exponentials are
  ``ex2.approx``, ``fast_exp`` in ``ssd_scan_sm90.cu``);
* ``kernel_expf``: the same sources with ``expf`` in ``fast_exp``, built
  into ``build/ssd_gap/`` (the repository's kernel is left as it is);
* ``plain_bf16_states``: the plain scan with each chunk's starting state
  rounded to bf16 before pass 3, as the ``sm90`` kernel hands it to the
  tensor cores (pass 2 writes them in bf16);
* ``plain``: the plain scan itself (0: the reference of the gap).

Where ``kernel_expf`` reads as ``kernel``, the approximate exponential does
not make the gap; where ``plain_bf16_states`` reads near ``kernel``, the bf16
starting states do.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
FAST_EXP = 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * LOG2E));'
EXACT_EXP = "y = expf(x);"


def exact_exp_tree(kernels_dir: Path, out: Path) -> Path:
    """A copy of the kernel sources with ``fast_exp`` computing ``expf``."""
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(kernels_dir / "csrc", out / "csrc")
    shutil.copytree(kernels_dir / "ssd_scan" / "csrc", out / "ssd_scan" / "csrc")
    src = out / "ssd_scan" / "csrc" / "ssd_scan_sm90.cu"
    text = src.read_text()
    if text.count(FAST_EXP) != 1:
        raise SystemExit(f"fast_exp's body not found once in {src}")
    src.write_text(text.replace(FAST_EXP, EXACT_EXP))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ssd_gap: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import init_params
    from repro_torch.serve.engine import prefill_fn, serve_params_cast

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("mamba2-130m")
    params = serve_params_cast(init_params(cfg, 0, "cuda", dtype=cfg.compute_dtype), cfg)
    tokens = make_prompts(cfg, 8, 4096, 1, "cuda")

    def logits(**kw):
        with torch.inference_mode():
            out, _ = prefill_fn(params, cfg, {"tokens": tokens}, **kw)
        return out.float()

    plain = logits(attn_impl="plain")
    scale = float(plain.abs().max())
    gap = lambda got: float((got - plain).abs().max()) / scale  # noqa: E731
    res = {"card": card, "arch": cfg.name, "tokens": [8, 4096], "logits_scale": scale,
           "plain": 0.0}

    ssd_ops.LAUNCHES_BY_VARIANT.update({k: 0 for k in ssd_ops.LAUNCHES_BY_VARIANT})
    res["kernel"] = gap(logits())
    check_sm90 = dict(ssd_ops.LAUNCHES_BY_VARIANT)

    kernel_scan = ssd_ops.ssd_scan

    def plain_bf16_states(x, dt, A, B, C, chunk, init_state=None):
        c = min(chunk, x.shape[1])
        states, cum = ssd_ref.chunk_state_reference(x, dt, A, B, c)
        h_in, final = ssd_ref.state_pass_reference(states, cum, c, init_state)
        h16 = h_in.to(torch.bfloat16).float()
        return ssd_ref.chunk_scan_reference(x, dt, B, C, cum, h16, c), final

    ssd_ops.ssd_scan = plain_bf16_states
    try:
        res["plain_bf16_states"] = gap(logits())
    finally:
        ssd_ops.ssd_scan = kernel_scan

    saved = (_build.KERNELS_DIR, _build.BUILD_DIR)
    scratch = ROOT / "build" / "ssd_gap"
    _build.KERNELS_DIR = exact_exp_tree(saved[0], scratch / "kernels")
    _build.BUILD_DIR = scratch / "lib"
    _build._LIBS.pop("ssd_scan", None)
    try:
        ssd_ops.LAUNCHES_BY_VARIANT.update({k: 0 for k in ssd_ops.LAUNCHES_BY_VARIANT})
        res["kernel_expf"] = gap(logits())
        check_expf = dict(ssd_ops.LAUNCHES_BY_VARIANT)
    finally:
        _build.KERNELS_DIR, _build.BUILD_DIR = saved
        _build._LIBS.pop("ssd_scan", None)
    want = {k: cfg.n_layers if k == "sm90" else 0 for k in ssd_ops.LAUNCHES_BY_VARIANT}
    if check_sm90 != want or check_expf != want:
        raise SystemExit(f"launches {check_sm90} / {check_expf}, want {want} each")
    res["launches_by_variant"] = want
    print(json.dumps(res), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
