#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a). It builds the
port's kernels from the sources in this checkout into ``build/``, holds each
kernel against its plain PyTorch version on the card, serves llama3-8b at full
width and depth (seeded random bf16 weights made on the card) through
``repro_torch.launch.serve``, checks what comes out, and prints one JSON line
per phase. The last line is ``{"ok": true, "device": {...}}``. Any failed
check raises, so the script exits nonzero and prints no such line; it also
exits nonzero on a host without a card, or outside a checkout of the repo.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# The main path: llama3-8b serving, one wave of 8 requests x 1024-token
# prompts, 32 generated tokens.
ARCH, REQUESTS, PROMPT_LEN, GEN, SEED = "llama3-8b", 8, 1024, 32, 0

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# Kernel vs plain tolerances. f32: the same arithmetic in another summation
# order. bf16: the plain version rounds the softmax weights to bf16 before
# P.V, the kernel keeps them in f32 (the reference tests' bf16 tolerance).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.5e-2}
# Prefill last-token logits, kernel vs plain, bf16 through 32 layers: every
# layer's attention output differs by ~one bf16 rounding (eps 2^-8) and the
# difference is carried through 32 residual layers; allow a tenth of the
# logits' scale (a wrong mask or wrong head mapping gives O(1) differences).
LOGITS_REL_TOL = 0.1
# Decode vs forward, float32, full width, 2 layers (tests/test_models.py).
DECODE_TOL = 2e-4

# (b, s, t, h, kh, d, causal, dtype): the shapes of tests/test_kernels.py
# FA_CASES, two ragged cases, and the main-path shape last.
FA_CASES = [
    (2, 128, 128, 4, 2, 64, True, torch.float32),
    (1, 256, 256, 8, 8, 64, True, torch.float32),
    (2, 128, 128, 4, 1, 128, False, torch.float32),
    (1, 128, 128, 2, 2, 64, True, torch.bfloat16),
    (1, 64, 64, 4, 4, 32, False, torch.bfloat16),
    (2, 200, 200, 8, 2, 128, True, torch.bfloat16),
    (1, 77, 77, 4, 4, 64, False, torch.float32),
]
MAIN_FA = (REQUESTS, PROMPT_LEN, PROMPT_LEN, 32, 8, 128, True, torch.bfloat16)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, reps: int = 12, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def fa_inputs(case, seed):
    b, s, t, h, kh, d, causal, dt = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(dt)  # noqa: E731
    return mk(b, s, h, d), mk(b, t, kh, d), mk(b, t, kh, d)


def fa_bound(case):
    """Least time (s) for the work: operations this run's mask keeps, and
    bytes of q, k, v read once and o written once."""
    b, s, t, h, kh, d, causal, dt = case
    pairs = sum(min(i + 1, t) for i in range(s)) if causal else s * t
    flops = 2 * 2 * b * h * d * pairs
    nbytes = (2 * b * s * h * d + 2 * b * t * kh * d) * torch.tensor([], dtype=dt).element_size()
    peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "tf32": False})
    return card


def phase_build(build_mod):
    t0 = time.perf_counter()
    libs = build_mod.build()
    secs = time.perf_counter() - t0
    ptxas = {}
    for name in libs:
        log = build_mod.log_path(name)
        if log.exists():
            ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(secs, 2),
          "libs": {k: str(v.relative_to(ROOT)) for k, v in libs.items()}, "ptxas": ptxas})


def phase_kernel(fa_ops, fa_ref):
    rows = []
    for i, case in enumerate(FA_CASES + [MAIN_FA]):
        b, s, t, h, kh, d, causal, dt = case
        q, k, v = fa_inputs(case, seed=100 + i)
        got = fa_ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = fa_ref.attention_reference(q, k, v, causal=causal)
        check(got.dtype == dt and got.shape == q.shape, f"bad output {got.dtype} {tuple(got.shape)}")
        err = (got.float() - want.float()).abs()
        tol = TOL[dt]
        ok = bool((err <= tol + tol * want.float().abs()).all())
        rows.append({"shape": [b, s, t, h, kh, d], "causal": causal, "dtype": str(dt).split(".")[1],
                     "max_abs_err": float(err.max()), "tol": tol, "ok": ok})
        check(ok, f"flash_attention disagrees with its plain version at {rows[-1]}")
    emit({"phase": "kernel_vs_plain", "cases": rows})

    q, k, v = fa_inputs(MAIN_FA, seed=7)
    kernel_ms = time_ms(lambda: fa_ops.flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: fa_ref.attention_reference(q, k, v, causal=True))
    rep = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    bound_s, bound_by, flops, nbytes = fa_bound(MAIN_FA)
    main = {"phase": "kernel_timing", "shape": list(MAIN_FA[:6]), "dtype": "bfloat16",
            "causal": True, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": "scaled_dot_product_attention (GQA expanded)",
            "bound_us": bound_s * 1e6, "bound_by": bound_by, "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6, "kernel_tflops": flops / (kernel_ms * 1e-3) / 1e12,
            "roofline_share": bound_s * 1e3 / kernel_ms,
            "max_abs_err": rows[-1]["max_abs_err"]}
    emit(main)
    return main


def phase_serve(fa_ops, serve_cli, engine):
    from repro_torch.configs import get_config

    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", ARCH, "--requests", str(REQUESTS), "--prompt-len", str(PROMPT_LEN),
            "--gen", str(GEN), "--seed", str(SEED), "--device", "cuda"]
    fa_ops.LAUNCHES = 0
    res = serve_cli.main(argv)                  # the main path, counted
    launches = fa_ops.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg, params, prompts = res["cfg"], res["params"], res["prompts"]
    check(cfg == get_config(ARCH), "serve did not run the full-size config")
    toks = res["tokens"]
    check(tuple(toks.shape) == (REQUESTS, GEN), f"tokens shape {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "token out of [0, vocab)")
    for key in ("prefill_logits", "last_logits"):
        check(bool(torch.isfinite(res[key].float()).all()), f"non-finite {key}")
    check(launches == cfg.n_layers,
          f"flash_attention launched {launches} times in the serve run, want {cfg.n_layers}")

    # Warm wave: steady-state times (cuBLAS and allocator already warm).
    warm = serve_cli.serve_wave(params, cfg, prompts, GEN)

    # Kernel vs plain through the whole prefill.
    with torch.inference_mode():
        plain_logits, _ = engine.prefill_fn(params, cfg, {"tokens": prompts}, attn_impl="plain")
    diff = float((res["prefill_logits"].float() - plain_logits.float()).abs().max())
    scale = float(plain_logits.float().abs().max())
    agree = float((res["prefill_logits"].argmax(-1) == plain_logits.argmax(-1)).float().mean())
    check(diff <= LOGITS_REL_TOL * scale,
          f"prefill logits kernel vs plain: max |diff| {diff} > {LOGITS_REL_TOL} x {scale}")
    out = {"phase": "serve", "arch": ARCH, "n_params": cfg.n_params(), "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "requests": REQUESTS, "prompt_len": PROMPT_LEN, "gen": GEN,
           "dtype": cfg.compute_dtype, "fa_launches": launches,
           "first_prefill_ms": res["prefill_s"] * 1e3, "prefill_ms": warm["prefill_s"] * 1e3,
           "prefill_tok_s": REQUESTS * PROMPT_LEN / warm["prefill_s"],
           "decode_ms_per_step": warm["decode_s"] / (GEN - 1) * 1e3,
           "decode_tok_s": REQUESTS * (GEN - 1) / warm["decode_s"],
           "peak_mem_gb": peak_gb, "logits_max_abs_diff": diff, "logits_scale": scale,
           "logits_rel_tol": LOGITS_REL_TOL, "argmax_agree": agree,
           "warm_tokens_equal": bool(torch.equal(warm["tokens"], toks))}
    emit(out)
    return launches


def phase_decode_check(engine, model_mod):
    """Decode position s-1 after prefilling s-1 tokens == forward over s
    tokens (tests/test_models.py), full width, float32, 2 layers."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(ARCH), n_layers=2, compute_dtype="float32")
    params = model_mod.init_params(cfg, seed=2, device="cuda")
    b, s = 2, 17
    g = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device="cuda")
    with torch.inference_mode():
        full, _, _, _ = model_mod.forward(params, cfg, {"tokens": tokens}, mode="train")
        _, cache = engine.prefill_fn(params, cfg, {"tokens": tokens[:, :s - 1]})
        cache = engine.pad_cache(cfg, cache, b, s + 4)
        pos = torch.full((b,), s - 1, dtype=torch.long, device="cuda")
        dec, _ = engine.decode_fn(params, cfg, tokens[:, s - 1], cache, pos)
    want = full[:, s - 1]
    err = float((dec - want).abs().max())
    ok = bool(((dec - want).abs() <= DECODE_TOL + DECODE_TOL * want.abs()).all())
    emit({"phase": "decode_matches_forward", "n_layers": 2, "d_model": cfg.d_model,
          "dtype": "float32", "max_abs_err": err, "tol": DECODE_TOL, "ok": ok})
    check(ok, f"decode vs forward: max abs err {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import model as model_mod
    from repro_torch.serve import engine

    t0 = time.perf_counter()
    phase_device()
    phase_build(_build)
    timing = phase_kernel(fa_ops, fa_ref)
    launches = phase_serve(fa_ops, serve_cli, engine)
    torch.cuda.empty_cache()
    phase_decode_check(engine, model_mod)
    bound_s, bound_by, _, _ = fa_bound(MAIN_FA)
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:25",
        "launches": launches, "max_abs_err": timing["max_abs_err"],
        "ms": timing["kernel_ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": bound_s * 1e3, "bound_by": bound_by, "library_ms": timing["library_ms"],
        "kernel_ms": timing["kernel_ms"], "bound_us": bound_s * 1e6}]})
    emit({"phase": "done", "seconds": round(time.perf_counter() - t0, 1)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
