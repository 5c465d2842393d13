#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a). It builds the
port's kernels (flash attention, blockwise int8 quantise / dequantise, the
SSD chunked scan) from the sources in this checkout into ``build/``, one nvcc
per kernel package, and holds each kernel against its plain PyTorch version
on the card. Flash attention has two kernels, chosen by dtype and head dim
(``ops.variant``): ``sm90`` on the tensor cores for bf16 at D 64 and 128,
``simt`` on the CUDA cores for float32 and for bf16 at D 32; each case runs
the one the table names. Then it drives the port's main paths with seeded
random weights:

* serving llama3-8b, full width and depth, bf16
  (``repro_torch.launch.serve``): prefill through the ``sm90``
  flash-attention kernel (every launch of the wave), then decode; decode
  against forward in float32 through the ``simt`` kernel;
* serving mamba2-130m, full width and depth, bf16, 8 x 4096 + 32: prefill
  through the SSD-scan kernel (one launch per layer, every one on the
  ``sm90`` kernel: three passes on the tensor cores), then the recurrent
  decode; decode against forward at full width in float32, and a float32
  full-depth prefill through the kernel against the plain scan, both on
  the ``simt`` kernel (CUDA cores);
* one training rank, 4 layers (an Adam state of all 32 does not fit one
  card): ``make_train_step`` for 8 timed steps of 4 x 1024 tokens, then a
  TCE checkpoint of the trained params through ``DiskStore`` with the
  ``int8`` codec, which quantises and dequantises through the hand-written
  kernels, and a restore; then the port's rank worker as a subprocess on the
  card, killed in the middle of a save and restored, at its reduced default.

The train phase also takes two steps that say where a step's time goes: one
with the gradients and the AdamW update timed apart (through the trainer's
own ``_grads_and_metrics``), one under ``torch.profiler`` for the device's
busy share and its kernel time by kind. The port has no benchmark cell yet
that could carry this breakdown, and PERF.md reads it from here.

Each phase checks what comes out and prints one JSON line. The last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits nonzero and prints no such line; it also exits nonzero on a host
without a card, or outside a checkout of the repo.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
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
# order. bf16: the plain version rounds the normalised softmax weights to
# bf16 before P.V, the sm90 kernel the unnormalised ones, the simt kernel
# none (the reference tests' bf16 tolerance).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.5e-2}
# Prefill last-token logits, kernel vs plain, bf16 through 32 layers: every
# layer's attention output differs by ~one bf16 rounding (eps 2^-8) and the
# difference is carried through 32 residual layers; allow a tenth of the
# logits' scale (a wrong mask or wrong head mapping gives O(1) differences).
LOGITS_REL_TOL = 0.1
# Decode vs forward, float32, full width, 2 layers (tests/test_models.py).
DECODE_TOL = 2e-4
# Prefill logits, kernel vs plain, float32 through all 24 mamba2 layers: the
# two differ only in summation order (~1e-7 relative per layer); allow 1e-3 of
# the logits' scale, 100x below the bf16 limit above.
F32_LOGITS_REL_TOL = 1e-3

# The SSM serving path: mamba2-130m, one wave of 8 requests x 4096-token
# prompts (16 chunks of 256), 32 generated tokens, full depth (24 layers).
SSM_ARCH, SSM_REQUESTS, SSM_PROMPT_LEN, SSM_GEN = "mamba2-130m", 8, 4096, 32
SSD_SRC = "src/repro_torch/kernels/ssd_scan/csrc/"
SSD_REPLACES = "src/repro/kernels/ssd_scan/ssd_scan.py:24"
# SSD kernel vs plain (tests/test_kernels.py): y within this share of max |y|,
# the final state at rtol = atol (f32: the same float32 arithmetic in another
# summation order; bf16: x, B, C are bf16, y is rounded to bf16 once).
SSD_Y_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
SSD_STATE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# (b, s, nh, p, g, n, chunk, dtype): tests/test_kernels.py SSD_CASES, the
# chunks of the decode check's 17-token forward and 16-token prefill (simt),
# the sm90 kernel's cases of tests/test_torch_ssd_passes.py (one chunk of 64
# at n 64 and n 128, chunks of 128 and 256 over several chunks, g 2 with
# nh 8), then the main path's shape in bf16 (sm90) and float32 (simt); x, B,
# C are views into one conv output, as the model passes them. Each case runs
# on the kernel ops.variant names.
SSD_CASES = [
    (2, 128, 8, 32, 1, 16, 64, torch.float32),
    (1, 256, 4, 16, 2, 8, 32, torch.float32),
    (1, 64, 2, 64, 1, 32, 64, torch.float32),
    (2, 128, 4, 32, 1, 16, 32, torch.bfloat16),
    (2, 16, 24, 64, 1, 128, 16, torch.float32),
    (2, 17, 24, 64, 1, 128, 17, torch.float32),
    (1, 64, 4, 64, 1, 64, 64, torch.bfloat16),
    (1, 64, 4, 64, 1, 128, 64, torch.bfloat16),
    (2, 512, 4, 64, 1, 128, 128, torch.bfloat16),
    (2, 1024, 4, 64, 1, 128, 256, torch.bfloat16),
    (2, 512, 8, 64, 2, 64, 128, torch.bfloat16),
]
MAIN_SSD = (SSM_REQUESTS, SSM_PROMPT_LEN, 24, 64, 1, 128, 256, torch.bfloat16)
MAIN_SSD_F32 = MAIN_SSD[:7] + (torch.float32,)
# The sm90 kernel and its passes at the main path's token count cut two
# other ways: 64 chunks in a row (the recurrence of pass 2 four times as
# long, a quarter of its blocks) and 4 (four times the blocks).
SSD_RATE_CASES = [(2, 16384) + MAIN_SSD[2:], (32, 1024) + MAIN_SSD[2:]]
SSD_PASSES = ("chunk_state", "state_pass", "chunk_scan")

# (b, s, t, h, kh, d, causal, dtype): the shapes of tests/test_kernels.py
# FA_CASES, two ragged cases, the sm90 kernel's cases of
# tests/test_torch_kernels.py (one tile at D 64 and 128, ragged causal with
# an empty second consumer in the last tile, GQA rep 4 at D 64, D 128
# without the mask), the f32 decode check's two shapes (simt), and the
# main-path shape last.
FA_CASES = [
    (2, 128, 128, 4, 2, 64, True, torch.float32),
    (1, 256, 256, 8, 8, 64, True, torch.float32),
    (2, 128, 128, 4, 1, 128, False, torch.float32),
    (1, 128, 128, 2, 2, 64, True, torch.bfloat16),
    (1, 64, 64, 4, 4, 32, False, torch.bfloat16),
    (2, 200, 200, 8, 2, 128, True, torch.bfloat16),
    (1, 77, 77, 4, 4, 64, False, torch.float32),
    (1, 128, 128, 2, 2, 64, False, torch.bfloat16),
    (1, 128, 128, 2, 2, 128, False, torch.bfloat16),
    (1, 1000, 1000, 32, 8, 128, True, torch.bfloat16),
    (2, 384, 384, 16, 4, 64, True, torch.bfloat16),
    (2, 300, 300, 8, 2, 128, False, torch.bfloat16),
    (2, 17, 17, 32, 8, 128, True, torch.float32),
    (2, 16, 16, 32, 8, 128, True, torch.float32),
]
MAIN_FA = (REQUESTS, PROMPT_LEN, PROMPT_LEN, 32, 8, 128, True, torch.bfloat16)
# The simt kernel is timed at the main path's shape in float32 (serving in
# float32 takes it at any head dim).
MAIN_FA_F32 = MAIN_FA[:7] + (torch.float32,)
# The sm90 kernel against SDPA beside the main shape: without the mask, and
# at 4x the sequence (4x the kv tiles per q tile, so that each q tile's
# first and last steps weigh a quarter as much), to tell the per-q-tile
# cost from the rate of the inner loop.
FA_RATE_CASES = [MAIN_FA[:6] + (False, torch.bfloat16),
                 (2, 4096, 4096, 32, 8, 128, True, torch.bfloat16),
                 (2, 4096, 4096, 32, 8, 128, False, torch.bfloat16)]
FA_SRC = "src/repro_torch/kernels/flash_attention/csrc/"
FA_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:25"

# The training main path: llama3-8b at full width and 4 layers (1.92 B
# params, ~31 GB of f32 params, grads and two moments), 8 timed steps of
# 4 x 1024 tokens, lr 3e-4 from the first step (no warmup: a warmup gives
# lr 0 at step 0).
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 4, 1024, 8, 3e-4
# int8 leaves of its params under the worker's lossless globs: tok/table,
# tok/head and the 7 stacked projections (norm scales stay lossless).
INT8_LEAVES = 9
# Loss on the next batch, restored vs saved params. Each restored weight moves
# by at most s/2 = amax/254 of its block, in no set direction; on an H100 the
# relative change of the loss read 1.4e-5 and 5.8e-5 in two runs. The limit is
# a few times the worst reading: a wrong scale or block order moves it by O(1).
RESTORE_LOSS_REL_TOL = 2e-4
# |x - dequant(quant(x))| <= s/2 per block, up to three roundings, in units
# of a half step s/2: x / s (|x / s| <= 127, half an ulp of 127 = 2^-18 s),
# q * s (2^-24 of 127 s) and the subtraction that measures the error.
HALF_STEP_SLACK = 1 + 2 * (2.0 ** -18 + 127 * 2.0 ** -24) + 2.0 ** -24

QB_BLOCK = 256
# (n, d, block): the cases of tests/test_kernels.py::test_quant_2d_vs_oracle
QUANT_2D = [(64, 512, 128), (256, 256, 256), (32, 1024, 512)]
# the codec layout: leaf sizes of 1, 37, 256 and 301 blocks (ragged tails;
# 301 is the leaf of 76,805 values on which the reference's wrapper asserts)
QUANT_CODEC_N = [200, 37 * 256 - 100, 256 * 256, 76_805]
TIE_VALUES = [0.5, -0.5, 2.5, -3.5, 127.0]        # amax 127 -> s = 1
TIE_WANT = [0, 0, 2, -4, 127]                     # round half to even
TOK_TABLE = (128256, 4096)                        # the largest leaf on the path
QB_SRC = "src/repro_torch/kernels/quant_blockwise/csrc/quant_blockwise.cu"
QB_REPLACES = "src/repro/kernels/quant_blockwise/quant_blockwise.py"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, reps: int = 12, warmup: int = 3, sample_ms: float = 2.0) -> float:
    """Time of one ``fn()`` on the card: the median over ``reps`` samples of
    CUDA events around back-to-back calls (as many as fill ~``sample_ms``,
    at most 20), divided by their count. Back to back, the host's time to
    enqueue a call overlaps the card's work on the one before, as on a
    serving path; one call between two events would count it as device
    time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    inner = max(1, min(20, int(sample_ms / max(start.elapsed_time(end), 1e-3))))
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
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


def quant_bound(n: int, block: int, quantise: bool):
    """Least time (s) for (de)quantising n float32 values: x read once, q and
    s written once (or the reverse); operations per value: |x|, max, a
    division, a round and two clips to quantise, one product to dequantise,
    at the float32 peak outside the tensor cores."""
    nbytes = 4 * n + n + 4 * (n // block)
    ops = (6 if quantise else 1) * n
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes"), nbytes


KERNEL_KINDS = (("ssd_scan", ("ssd_fwd",)), ("flash_attention", ("fa_fwd",)),
                ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "matmul")),
                ("softmax", ("softmax",)), ("reduce", ("reduce",)),
                ("gather / scatter", ("index", "gather", "scatter")),
                ("elementwise / copy", ("elementwise", "copy")))


def kernel_kind(name: str) -> str:
    """A coarse kind for a CUDA kernel's name, for the profile breakdown."""
    low = name.lower()
    return next((kind for kind, keys in KERNEL_KINDS if any(k in low for k in keys)), "other")


def hand_kernel(name: str):
    """The short name of one of the port's kernels (``ssd_fwd_chunk_scan``,
    ``fa_fwd_sm90_kernel``, ...) in a profiler key, else None."""
    m = re.search(r"(ssd_fwd\w*|fa_fwd\w*)", name)
    return m.group(1) if m else None


def plain_codec(qb_ref, x: torch.Tensor, block: int = QB_BLOCK):
    """The plain version of the codec's round trip, on x's device: zero-pad
    the flat leaf to whole blocks, quantise, dequantise, crop."""
    flat = x.reshape(-1).float()
    n = flat.numel()
    pad = (-n) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    q, s = qb_ref.quantize_reference(flat.reshape(-1, block), block)
    xd = qb_ref.dequantize_reference(q, s, block).reshape(-1)[:n].reshape(x.shape)
    return q, s[:, 0], xd


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, a NaN equal to a NaN (the card does not keep NaN bits)."""
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b)) if a.is_floating_point() else (a == b)).all())


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
    ptxas, wgmma_notes = {}, {}
    for name in libs:
        log = build_mod.log_path(name)
        if log.exists():
            text = log.read_text().splitlines()
            ptxas[name] = [ln.strip() for ln in text
                           if "registers" in ln or "spill" in ln or "Performance Loss" in ln]
            # ptxas's notes on wgmma, counted per code and entry function:
            # C7511 / C7515 (wgmma serialized), C7519 (warpgroup.arrive injected)
            notes = {}
            for ln in text:
                m = re.search(r"\((C75\d\d)\).*function '([^']+)'", ln)
                if m:
                    key = f"{m.group(1)} {m.group(2)}"
                    notes[key] = notes.get(key, 0) + 1
            wgmma_notes[name] = notes
    emit({"phase": "build", "seconds": round(secs, 2),
          "libs": {k: str(v.relative_to(ROOT)) for k, v in libs.items()}, "ptxas": ptxas,
          "wgmma_notes": wgmma_notes})


def sdpa_call(q, k, v, causal):
    """scaled_dot_product_attention on the same inputs, GQA expanded to
    (B, H, S, D) outside the timed call."""
    rep = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qt, kt, vt, is_causal=causal)


def phase_kernel(fa_ops, fa_ref):
    """Every case on the kernel the variant table names, against the plain
    version; then each kernel's times at its main shape (sm90: MAIN_FA,
    simt: MAIN_FA_F32)."""
    rows = []
    for i, case in enumerate(FA_CASES + [MAIN_FA, MAIN_FA_F32]):
        b, s, t, h, kh, d, causal, dt = case
        kind = fa_ops.variant(dt, d)
        q, k, v = fa_inputs(case, seed=100 + i)
        fa_ops.LAUNCHES_BY_VARIANT.update(sm90=0, simt=0)
        got = fa_ops.flash_attention(q, k, v, causal=causal)
        launched = dict(fa_ops.LAUNCHES_BY_VARIANT)
        torch.cuda.synchronize()
        check(launched == {"sm90": int(kind == "sm90"), "simt": int(kind == "simt")},
              f"{case} launched {launched}, want one {kind}")
        want = fa_ref.attention_reference(q, k, v, causal=causal)
        check(got.dtype == dt and got.shape == q.shape, f"bad output {got.dtype} {tuple(got.shape)}")
        err = (got.float() - want.float()).abs()
        tol = TOL[dt]
        ok = bool((err <= tol + tol * want.float().abs()).all())
        rows.append({"shape": [b, s, t, h, kh, d], "causal": causal, "dtype": str(dt).split(".")[1],
                     "variant": kind, "max_abs_err": float(err.max()), "tol": tol, "ok": ok})
        check(ok, f"flash_attention disagrees with its plain version at {rows[-1]}")
        del q, k, v, got, want, err
    emit({"phase": "kernel_vs_plain", "cases": rows})

    timings = {}
    for case, row in ((MAIN_FA, rows[-2]), (MAIN_FA_F32, rows[-1])):
        q, k, v = fa_inputs(case, seed=7)
        kernel_ms = time_ms(lambda: fa_ops.flash_attention(q, k, v, causal=True))
        plain_ms = time_ms(lambda: fa_ref.attention_reference(q, k, v, causal=True))
        library_ms = time_ms(sdpa_call(q, k, v, True))
        del q, k, v
        bound_s, bound_by, flops, nbytes = fa_bound(case)
        kind = row["variant"]
        timings[kind] = {
            "phase": "kernel_timing", "variant": kind, "shape": list(case[:6]),
            "dtype": row["dtype"], "causal": True, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": "scaled_dot_product_attention (GQA expanded)",
            "bound_ms": bound_s * 1e3, "bound_by": bound_by, "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6, "kernel_tflops": flops / (kernel_ms * 1e-3) / 1e12,
            "roofline_share": bound_s * 1e3 / kernel_ms, "vs_library": library_ms / kernel_ms,
            "max_abs_err": row["max_abs_err"]}
        emit(timings[kind])

    rates = []
    for i, case in enumerate(FA_RATE_CASES):
        causal = case[6]
        q, k, v = fa_inputs(case, seed=300 + i)
        kernel_ms = time_ms(lambda: fa_ops.flash_attention(q, k, v, causal=causal))
        library_ms = time_ms(sdpa_call(q, k, v, causal))
        del q, k, v
        flops = fa_bound(case)[2]
        rates.append({"shape": list(case[:6]), "causal": causal, "kernel_ms": kernel_ms,
                      "library_ms": library_ms, "kernel_tflops": flops / kernel_ms / 1e9,
                      "library_tflops": flops / library_ms / 1e9})
    emit({"phase": "kernel_rates", "variant": "sm90", "dtype": "bfloat16",
          "library": "scaled_dot_product_attention (GQA expanded)", "cases": rates})
    return timings


def phase_serve(ops, serve_cli, engine, arch, requests, prompt_len, gen, kernel, variant=None):
    """One wave through ``repro_torch.launch.serve.main`` at full size, the
    kernel's launches counted in that run alone (and, where the kernel has
    variants, every launch on ``variant``); then a warm wave, and the
    prefill logits against an all-plain prefill."""
    from repro_torch.configs import get_config

    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", arch, "--requests", str(requests), "--prompt-len", str(prompt_len),
            "--gen", str(gen), "--seed", str(SEED), "--device", "cuda"]
    ops.LAUNCHES = 0
    if variant:
        ops.LAUNCHES_BY_VARIANT.update({k: 0 for k in ops.LAUNCHES_BY_VARIANT})
    res = serve_cli.main(argv)                  # the main path, counted
    launches = ops.LAUNCHES
    by_variant = dict(ops.LAUNCHES_BY_VARIANT) if variant else None
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg, params, prompts = res["cfg"], res["params"], res["prompts"]
    check(cfg == get_config(arch), "serve did not run the full-size config")
    toks = res["tokens"]
    check(tuple(toks.shape) == (requests, gen), f"tokens shape {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "token out of [0, vocab)")
    for key in ("prefill_logits", "last_logits"):
        check(bool(torch.isfinite(res[key].float()).all()), f"non-finite {key}")
    check(launches == cfg.n_layers,
          f"{kernel} launched {launches} times in the serve run, want {cfg.n_layers}")
    if variant:
        want = {k: cfg.n_layers if k == variant else 0 for k in by_variant}
        check(by_variant == want, f"{kernel} launches by variant {by_variant}, want {want}")

    # Warm wave: steady-state times (cuBLAS and allocator already warm).
    warm = serve_cli.serve_wave(params, cfg, prompts, gen)

    # One more prefill under the profiler: device time by kernel kind, and
    # its sum over the prefill's wall time (the busy share).
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof, torch.inference_mode():
        t0 = time.perf_counter()
        engine.prefill_fn(params, cfg, {"tokens": prompts})
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    by_kind: dict = {}
    by_hand_kernel: dict = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            kind = kernel_kind(e.key)
            by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3
            short = hand_kernel(e.key)
            if short:
                by_hand_kernel[short] = by_hand_kernel.get(short, 0.0) + e.self_device_time_total / 1e3
    busy_ms = sum(by_kind.values())

    # Kernel vs plain through the whole prefill.
    with torch.inference_mode():
        plain_logits, _ = engine.prefill_fn(params, cfg, {"tokens": prompts}, attn_impl="plain")
    diff = float((res["prefill_logits"].float() - plain_logits.float()).abs().max())
    scale = float(plain_logits.float().abs().max())
    agree = float((res["prefill_logits"].argmax(-1) == plain_logits.argmax(-1)).float().mean())
    check(diff <= LOGITS_REL_TOL * scale,
          f"prefill logits kernel vs plain: max |diff| {diff} > {LOGITS_REL_TOL} x {scale}")
    out = {"phase": "serve", "arch": arch, "n_params": cfg.n_params(), "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "requests": requests, "prompt_len": prompt_len, "gen": gen,
           "dtype": cfg.compute_dtype, f"{kernel}_launches": launches,
           f"{kernel}_launches_by_variant": by_variant,
           "first_prefill_ms": res["prefill_s"] * 1e3, "prefill_ms": warm["prefill_s"] * 1e3,
           "prefill_tok_s": requests * prompt_len / warm["prefill_s"],
           "decode_ms_per_step": warm["decode_s"] / (gen - 1) * 1e3,
           "decode_tok_s": requests * (gen - 1) / warm["decode_s"],
           "peak_mem_gb": peak_gb, "logits_max_abs_diff": diff, "logits_scale": scale,
           "logits_rel_tol": LOGITS_REL_TOL, "argmax_agree": agree,
           "warm_tokens_equal": bool(torch.equal(warm["tokens"], toks)),
           "profiled_prefill_ms": profiled_ms, "profiled_kernel_ms_by_kind": by_kind,
           f"profiled_{kernel}_ms_by_kernel": by_hand_kernel,
           "profiled_kernel_ms": busy_ms, "device_busy_share_of_prefill": busy_ms / profiled_ms}
    emit(out)
    return launches, out


def phase_decode_check(engine, model_mod, ops, arch, variant=None):
    """Decode position s-1 after prefilling s-1 tokens == forward over s
    tokens (tests/test_models.py), full width, float32, 2 layers; forward and
    prefill go through the kernel (where it has variants, all on
    ``variant``). Returns the kernel's launches in this check."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), n_layers=2, compute_dtype="float32")
    params = model_mod.init_params(cfg, seed=2, device="cuda")
    b, s = 2, 17
    g = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device="cuda")
    before = ops.LAUNCHES
    if variant:
        ops.LAUNCHES_BY_VARIANT.update({k: 0 for k in ops.LAUNCHES_BY_VARIANT})
    with torch.inference_mode():
        full, _, _, _ = model_mod.forward(params, cfg, {"tokens": tokens}, mode="train")
        _, cache = engine.prefill_fn(params, cfg, {"tokens": tokens[:, :s - 1]})
        cache = engine.pad_cache(cfg, cache, b, s + 4)
        pos = torch.full((b,), s - 1, dtype=torch.long, device="cuda")
        dec, _ = engine.decode_fn(params, cfg, tokens[:, s - 1], cache, pos)
    launches = ops.LAUNCHES - before
    by_variant = dict(ops.LAUNCHES_BY_VARIANT) if variant else None
    want = full[:, s - 1]
    err = float((dec - want).abs().max())
    ok = bool(((dec - want).abs() <= DECODE_TOL + DECODE_TOL * want.abs()).all())
    emit({"phase": "decode_matches_forward", "arch": arch, "n_layers": 2,
          "d_model": cfg.d_model, "dtype": "float32", "kernel_launches": launches,
          "kernel_launches_by_variant": by_variant,
          "max_abs_err": err, "tol": DECODE_TOL, "ok": ok})
    check(launches == 2 * cfg.n_layers, f"{launches} kernel launches in forward + prefill")
    if variant:
        check(by_variant[variant] == launches, f"launches by variant {by_variant}, want {variant}")
    check(ok, f"decode vs forward: max abs err {err}")
    return launches


def phase_f32_prefill_check(engine, model_mod, ops, arch, variant):
    """Prefill last-token logits, kernel vs plain, at full width and depth in
    float32 (2 x 1024 tokens, 4 chunks), every launch on ``variant``: where
    the bf16 serve phase's gap is bf16 roundings carried through every layer,
    this one is the kernel's own summation order alone. Returns the kernel's
    launches."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    params = model_mod.init_params(cfg, seed=3, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (2, 1024), generator=g, device="cuda")
    before = ops.LAUNCHES
    ops.LAUNCHES_BY_VARIANT.update({k: 0 for k in ops.LAUNCHES_BY_VARIANT})
    with torch.inference_mode():
        got, _ = engine.prefill_fn(params, cfg, {"tokens": tokens})
        launches = ops.LAUNCHES - before
        by_variant = dict(ops.LAUNCHES_BY_VARIANT)
        want, _ = engine.prefill_fn(params, cfg, {"tokens": tokens}, attn_impl="plain")
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    emit({"phase": "f32_prefill_kernel_vs_plain", "arch": arch, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "tokens": list(tokens.shape), "kernel_launches": launches,
          "kernel_launches_by_variant": by_variant,
          "logits_max_abs_diff": diff, "logits_scale": scale, "rel_tol": F32_LOGITS_REL_TOL})
    check(launches == cfg.n_layers, f"{launches} kernel launches in the f32 prefill")
    check(by_variant[variant] == launches, f"launches by variant {by_variant}, want {variant}")
    check(diff <= F32_LOGITS_REL_TOL * scale,
          f"f32 prefill logits kernel vs plain: max |diff| {diff} > {F32_LOGITS_REL_TOL} x {scale}")
    return launches


def ssd_inputs(case, seed):
    """x, dt, A, B, C for a case: x, B and C as views into one (b, s, conv_dim)
    tensor, as the model hands them to the kernel."""
    b, s, nh, p, g, n, chunk, dt = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d_in = nh * p
    xbc = (torch.randn(b, s, d_in + 2 * g * n, generator=gen, device="cuda") * 0.5).to(dt)
    x = xbc[..., :d_in].reshape(b, s, nh, p)
    B = xbc[..., d_in:d_in + g * n].reshape(b, s, g, n)
    C = xbc[..., d_in + g * n:].reshape(b, s, g, n)
    dtv = torch.nn.functional.softplus(torch.randn(b, s, nh, generator=gen, device="cuda"))
    A = -torch.exp(torch.randn(nh, generator=gen, device="cuda") * 0.3)
    return x, dtv, A, B, C


def ssd_bound(case):
    """Least time (s) for the scan: x read and y written once, B, C, dt and A
    read once, the final state written once; operations of the chunked
    algorithm on the causal half of each chunk (C.B^T once per group, its
    product with x dt, the chunk states and the inter-chunk term), at the
    peak for the inputs' type."""
    b, s, nh, p, g, n, chunk, dt = case
    c = min(chunk, s)
    pairs = c * (c + 1) // 2
    flops = 2 * b * (s // c) * (g * n * pairs + nh * p * pairs + 2 * nh * c * p * n)
    elt = torch.tensor([], dtype=dt).element_size()
    nbytes = (2 * b * s * nh * p + 2 * b * s * g * n) * elt + 4 * (b * s * nh + nh + b * nh * p * n)
    peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def ssd_pass_bound(name, case):
    """Least time (s) for one sm90 pass at ``case``: what the pass must read
    and write (each once) and its products, at the peak for their type.
    chunk_state: x, B, dt, A in; the f32 chunk states and cum (b, nh, s) out;
    (x w)^T B. state_pass: the chunk states and cum_last in, the bf16
    starting states and the final state out; a multiply-add a value a chunk
    (float32, CUDA cores). chunk_scan: x, B, C, cum, dt and the starting
    states in, y out; C.B^T once per group and its product with x on the
    causal half, and the inter-chunk term."""
    b, s, nh, p, g, n, chunk, dt = case
    c = min(chunk, s)
    l, pairs = s // c, c * (c + 1) // 2
    elt = torch.tensor([], dtype=dt).element_size()
    states = b * l * nh * p * n
    if name == "chunk_state":
        nbytes = (b * s * nh * p + b * s * g * n) * elt + 4 * (b * s * nh + nh) + 4 * states \
            + 4 * b * nh * s
        flops, peak = 2 * states * c, PEAK_BF16_FLOPS
    elif name == "state_pass":
        nbytes = 4 * states + 4 * b * nh * l + 2 * states + 4 * b * nh * p * n
        flops, peak = 2 * states, PEAK_F32_FLOPS
    else:
        nbytes = (2 * b * s * nh * p + 2 * b * s * g * n) * elt + 2 * 4 * b * nh * s + 2 * states
        flops = 2 * b * l * (g * n * pairs + nh * p * pairs + nh * c * p * n)
        peak = PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def ssd_pass_times(ssd_ops, case, x, dtv, A, B, C):
    """Each sm90 pass alone at ``case`` (through its wrapper, as ``ssd_scan``
    calls it), beside its own bound."""
    c = min(case[6], case[1])
    states, cum = ssd_ops.chunk_state(x, dtv, A, B, c)
    h_in, _ = ssd_ops.state_pass(states, cum, c, None)
    out = {}
    for name, fn in (("chunk_state", lambda: ssd_ops.chunk_state(x, dtv, A, B, c)),
                     ("state_pass", lambda: ssd_ops.state_pass(states, cum, c, None)),
                     ("chunk_scan", lambda: ssd_ops.chunk_scan(x, dtv, B, C, cum, h_in, c))):
        ms = time_ms(fn)
        bound_s, bound_by = ssd_pass_bound(name, case)
        out[name] = {"ms": ms, "bound_ms": bound_s * 1e3, "bound_by": bound_by,
                     "roofline_share": bound_s * 1e3 / ms}
    return out


def phase_ssd_kernel(ssd_ops, ssd_ref):
    """Every listed shape on the kernel the variant table names, against the
    plain version, and the init-state continuation; each sm90 pass against
    its own plain pass at the main shape; then the times of both kernels at
    the main shape (sm90 in bf16 with each pass beside its bound, simt in
    float32), and of the sm90 kernel at two other cuts of the same tokens."""
    rows = []

    def compare(case, got, want, what, kind):
        (y, h), (wy, wh) = got, want
        dt = case[7]
        check(y.dtype == dt and y.shape == wy.shape and h.dtype == torch.float32
              and h.shape == wh.shape, f"bad output {y.dtype} {tuple(y.shape)} {tuple(h.shape)}")
        err = float((y.float() - wy.float()).abs().max())
        scale = float(wy.float().abs().max()) + 1e-6
        stol = SSD_STATE_TOL[dt]
        state_ok = bool(((h - wh).abs() <= stol + stol * wh.abs()).all())
        ok = err / scale < SSD_Y_TOL[dt] and state_ok
        rows.append({"shape": list(case[:7]), "dtype": str(dt).split(".")[1], "what": what,
                     "variant": kind, "max_abs_err": err, "y_scale": scale,
                     "y_tol": SSD_Y_TOL[dt], "state_max_abs_err": float((h - wh).abs().max()),
                     "state_tol": stol, "ok": ok})
        check(ok, f"ssd_scan disagrees with its plain version at {rows[-1]}")

    for i, case in enumerate(SSD_CASES + [MAIN_SSD, MAIN_SSD_F32]):
        x, dtv, A, B, C = ssd_inputs(case, seed=200 + i)
        c = min(case[6], case[1])
        kind = ssd_ops.variant(case[7], case[3], case[5], c, ssd_ops.tma_aligned(x, B, C))
        ssd_ops.LAUNCHES_BY_VARIANT.update(sm90=0, simt=0)
        got = ssd_ops.ssd_scan(x, dtv, A, B, C, chunk=case[6])
        launched = dict(ssd_ops.LAUNCHES_BY_VARIANT)
        torch.cuda.synchronize()
        check(launched == {"sm90": int(kind == "sm90"), "simt": int(kind == "simt")},
              f"{case} launched {launched}, want one {kind}")
        compare(case, got, ssd_ref.ssd_reference(x, dtv, A, B, C, chunk=c), "kernel vs plain",
                kind)
        del x, dtv, A, B, C, got
    check(rows[-2]["variant"] == "sm90" and rows[-1]["variant"] == "simt",
          "the main shape must run on sm90 in bf16 and on simt in float32")
    # The continuation of tests/test_kernels.py: two halves, the second from
    # the first one's final state, against the whole sequence.
    case = (1, 128, 4, 16, 1, 8, 32, torch.float32)
    x, dtv, A, B, C = ssd_inputs(case, seed=199)
    half = case[1] // 2
    _, h1 = ssd_ops.ssd_scan(x[:, :half], dtv[:, :half], A, B[:, :half], C[:, :half], chunk=32)
    y2, h2 = ssd_ops.ssd_scan(x[:, half:], dtv[:, half:], A, B[:, half:], C[:, half:],
                              chunk=32, init_state=h1)
    torch.cuda.synchronize()
    wy, wh = ssd_ref.ssd_reference(x, dtv, A, B, C, chunk=32)
    compare(case, (y2, h2), (wy[:, half:], wh), "init-state continuation", "simt")
    emit({"phase": "ssd_kernel_vs_plain", "cases": rows})

    # Each sm90 pass against its own plain pass at the main shape (the
    # starting states from an init state; pass 3 given the same bf16 states).
    x, dtv, A, B, C = ssd_inputs(MAIN_SSD, seed=9)
    c = MAIN_SSD[6]
    b, s, nh, p, g, n = MAIN_SSD[:6]
    init = torch.randn(b, nh, p, n, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(10))
    tol = SSD_STATE_TOL[torch.bfloat16]
    states, cum = ssd_ops.chunk_state(x, dtv, A, B, c)
    w_states, w_cum = ssd_ref.chunk_state_reference(x, dtv, A, B, c)
    h_in, final = ssd_ops.state_pass(w_states, w_cum, c, init)
    w_h_in, w_final = ssd_ref.state_pass_reference(w_states, w_cum, c, init)
    h16 = w_h_in.to(torch.bfloat16)
    y = ssd_ops.chunk_scan(x, dtv, B, C, w_cum, h16, c)
    wy = ssd_ref.chunk_scan_reference(x, dtv, B, C, w_cum, h16.float(), c)
    torch.cuda.synchronize()

    def close(got, want, t):
        return float((got.float() - want).abs().max()), bool(
            ((got.float() - want).abs() <= t + t * want.abs()).all())

    passes = {}
    for name, (err, ok), t in (
            ("chunk_state cum", close(cum, w_cum, SSD_STATE_TOL[torch.float32]),
             SSD_STATE_TOL[torch.float32]),
            ("chunk_state states", close(states, w_states, tol), tol),
            ("state_pass h_in", close(h_in, w_h_in, tol), tol),
            ("state_pass final", close(final, w_final, SSD_STATE_TOL[torch.float32]),
             SSD_STATE_TOL[torch.float32])):
        passes[name] = {"max_abs_err": err, "tol": t, "ok": ok}
        check(ok, f"sm90 {name} disagrees with its plain pass: {passes[name]}")
    y_err = float((y.float() - wy.float()).abs().max())
    y_scale = float(wy.float().abs().max())
    passes["chunk_scan y"] = {"max_abs_err": y_err, "y_scale": y_scale,
                              "y_tol": SSD_Y_TOL[torch.bfloat16],
                              "ok": y_err / y_scale < SSD_Y_TOL[torch.bfloat16]}
    check(passes["chunk_scan y"]["ok"], f"sm90 chunk_scan disagrees: {passes['chunk_scan y']}")
    emit({"phase": "ssd_passes_vs_plain", "shape": list(MAIN_SSD[:7]), "passes": passes})
    del states, cum, w_states, w_cum, h_in, final, w_h_in, w_final, h16, y, wy

    timings = {}
    for case, row in ((MAIN_SSD, rows[len(SSD_CASES)]), (MAIN_SSD_F32, rows[len(SSD_CASES) + 1])):
        x, dtv, A, B, C = ssd_inputs(case, seed=8)
        chunk = case[6]
        kernel_ms = time_ms(lambda: ssd_ops.ssd_scan(x, dtv, A, B, C, chunk=chunk))
        plain_ms = time_ms(lambda: ssd_ref.ssd_reference(x, dtv, A, B, C, chunk=chunk))
        bound_s, bound_by, flops, nbytes = ssd_bound(case)
        kind = row["variant"]
        timings[kind] = {
            "phase": "ssd_kernel_timing", "variant": kind, "shape": list(case[:7]),
            "dtype": row["dtype"], "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": None, "library": "none: no single PyTorch call computes the SSD scan",
            "bound_ms": bound_s * 1e3, "bound_by": bound_by, "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6, "kernel_tflops": flops / (kernel_ms * 1e-3) / 1e12,
            "roofline_share": bound_s * 1e3 / kernel_ms, "vs_plain": plain_ms / kernel_ms,
            "max_abs_err": row["max_abs_err"]}
        if kind == "sm90":
            timings[kind]["passes"] = ssd_pass_times(ssd_ops, case, x, dtv, A, B, C)
        del x, dtv, A, B, C
        torch.cuda.empty_cache()
        emit(timings[kind])

    rates = []
    for i, case in enumerate(SSD_RATE_CASES):
        x, dtv, A, B, C = ssd_inputs(case, seed=400 + i)
        kernel_ms = time_ms(lambda: ssd_ops.ssd_scan(x, dtv, A, B, C, chunk=case[6]))
        bound_s = ssd_bound(case)[0]
        rates.append({"shape": list(case[:7]), "kernel_ms": kernel_ms,
                      "bound_ms": bound_s * 1e3, "roofline_share": bound_s * 1e3 / kernel_ms,
                      "passes": ssd_pass_times(ssd_ops, case, x, dtv, A, B, C)})
        del x, dtv, A, B, C
        torch.cuda.empty_cache()
    emit({"phase": "ssd_rates", "variant": "sm90", "dtype": "bfloat16", "cases": rates})
    return timings


def phase_quant_kernel(qb_ops, qb_ref):
    """Both quant kernels vs their plain version on the card, bit for bit,
    then their times at the largest leaf of the checkpoint path."""
    g = torch.Generator(device="cuda").manual_seed(11)
    rows = []

    def record(kind, shape, ok):
        rows.append({"kind": kind, "shape": list(shape), "ok": ok})
        check(ok, f"quant kernel disagrees with its plain version: {rows[-1]}")

    def two_d(x, block, kind):
        q, s = qb_ops.quantize_blockwise_2d(x, block)
        xd = qb_ops.dequantize_blockwise_2d(q, s, block)
        torch.cuda.synchronize()
        qr, sr = qb_ref.quantize_reference(x, block)
        xr = qb_ref.dequantize_reference(qr, sr, block)
        record(kind, x.shape, same(q, qr) and same(s, sr) and same(xd, xr))
        return q, s

    for n, d, block in QUANT_2D:
        two_d(torch.randn(n, d, generator=g, device="cuda") * 3, block, "2d")
    special = torch.zeros(4, QB_BLOCK, device="cuda")
    special[0, :len(TIE_VALUES)] = torch.tensor(TIE_VALUES)
    special[2] = torch.linspace(-1, 1, QB_BLOCK)                  # row 1: all zero
    special[2, 3] = float("nan")
    special[3] = torch.linspace(-1, 1, QB_BLOCK)
    special[3, 5] = float("inf")
    q, s = two_d(special, QB_BLOCK, "tie, zero, nan, inf")
    check(q[0, :len(TIE_WANT)].tolist() == TIE_WANT and float(s[0, 0]) == 1.0,
          f"tie block gave q {q[0, :len(TIE_WANT)].tolist()}, s {float(s[0, 0])}")
    check(not q[1:].any() and bool(torch.isnan(s[2, 0])) and float(s[3, 0]) == math.inf,
          "zero / non-finite blocks")
    for n in QUANT_CODEC_N:
        x = torch.randn(n, generator=g, device="cuda")
        q, s = qb_ops.quantize_blockwise(x)
        xd = qb_ops.dequantize_blockwise(q, s, (n,))
        torch.cuda.synchronize()
        qr, sr, xr = plain_codec(qb_ref, x)
        record(f"codec {q.shape[0]} blocks", (n,), same(q, qr) and same(s, sr) and same(xd, xr))

    # the full-width tok/table leaf: check, then time kernel and plain version
    x = torch.randn(TOK_TABLE, generator=g, device="cuda") * 0.02
    n = x.numel()
    q, s = qb_ops.quantize_blockwise(x)
    xd = qb_ops.dequantize_blockwise(q, s, TOK_TABLE)
    torch.cuda.synchronize()
    x2 = x.reshape(-1, QB_BLOCK)
    qr, sr = qb_ref.quantize_reference(x2, QB_BLOCK)
    xr = qb_ref.dequantize_reference(qr, sr, QB_BLOCK).reshape(TOK_TABLE)
    record("tok/table", TOK_TABLE, same(q, qr) and same(s, sr[:, 0]) and same(xd, xr))
    max_abs_err = float((xd - xr).abs().max())
    del qr, sr, xr, xd
    out = {"phase": "quant_kernel", "cases": rows, "max_abs_err": max_abs_err,
           "leaf": "tok/table", "shape": list(TOK_TABLE), "block": QB_BLOCK}
    for name, quantise in (("quantize", True), ("dequantize", False)):
        if quantise:
            kernel = lambda: qb_ops.quantize_blockwise(x)  # noqa: E731
            plain = lambda: qb_ref.quantize_reference(x2, QB_BLOCK)  # noqa: E731
        else:
            kernel = lambda: qb_ops.dequantize_blockwise(q, s, TOK_TABLE)  # noqa: E731
            plain = lambda: qb_ref.dequantize_reference(q.reshape(-1, QB_BLOCK), s[:, None],  # noqa: E731
                                                        QB_BLOCK)
        bound_s, bound_by, nbytes = quant_bound(n, QB_BLOCK, quantise)
        ms = time_ms(kernel)
        out[name] = {"ms": ms, "plain_ms": time_ms(plain), "bound_ms": bound_s * 1e3,
                     "bound_by": bound_by, "gbytes": nbytes / 1e9,
                     "gb_per_s": nbytes / (ms * 1e-3) / 1e9,
                     "roofline_share": bound_s * 1e3 / ms, "library_ms": None}
    out["library"] = ("none: no single PyTorch call quantises blockwise to int8 with "
                      "absmax scales")
    emit(out)
    return out


def phase_train(fa_ops):
    """make_train_step at full width, 4 layers: 8 timed steps of 4 x 1024
    tokens, then two steps that break the time down."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.train import AdamConfig, init_train_state, make_train_step

    cfg = dataclasses.replace(get_config(ARCH), n_layers=TRAIN_LAYERS)
    opt = AdamConfig(lr=TRAIN_LR, warmup_steps=0, decay_steps=100)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, opt, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    data = SyntheticLMData(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    step_fn = make_train_step(cfg, opt)
    losses, secs = [], []
    fa_ops.LAUNCHES = 0
    for step in range(TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in data.batch_at(step).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    check(fa_ops.LAUNCHES == 0, "training ran the forward-only flash-attention kernel")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    steady = secs[2:]
    step_s = statistics.mean(steady)

    # Two more steps to see where a step's time goes: one with gradients and
    # the optimizer timed apart, one under the profiler (device time of its
    # kernels by kind; their sum over the steady step time is the busy share).
    from repro_torch.train.optimizer import adam_update
    from repro_torch.train.trainer import TrainConfig, _grads_and_metrics
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in data.batch_at(TRAIN_STEPS).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads, _ = _grads_and_metrics(state.params, cfg, batch, TrainConfig())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adam_update(state.params, grads, state.opt, state.step, opt, rng=state.rng)
    torch.cuda.synchronize()
    split_ms = {"grads": (t1 - t0) * 1e3, "adam": (time.perf_counter() - t1) * 1e3}
    del grads
    state = state._replace(step=state.step + 1)
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in data.batch_at(TRAIN_STEPS + 1).items()}
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
    check(int(state.step) == TRAIN_STEPS + 2, f"state.step {int(state.step)}")
    by_kind: dict = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            kind = kernel_kind(e.key)
            by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3
    busy_ms = sum(by_kind.values())
    out = {"phase": "train", "arch": ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "n_params": cfg.n_params(), "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
           "attn_impl": "chunked", "init_s": init_s, "losses": losses,
           "step_ms": [v * 1e3 for v in secs], "steady_ms_per_step": step_s * 1e3,
           "steady_ms_per_step_median": statistics.median(steady) * 1e3,
           "tok_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "split_step_ms": split_ms, "profiled_kernel_ms_by_kind": by_kind,
           "profiled_kernel_ms": busy_ms,
           "device_busy_share_of_steady_step": busy_ms / (step_s * 1e3)}
    emit(out)
    return cfg, state, data


def phase_checkpoint(cfg, state, data, qb_ops, qb_ref):
    """The trained params through DiskStore with the int8 codec, and back."""
    from repro_torch.core.tce import DiskStore, flatten_pytree, shard_state, unflatten_like
    from repro_torch.models.model import loss_fn
    from repro_torch.substrate.worker import LOSSLESS_PATHS

    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in data.batch_at(int(state.step)).items()}
    with torch.no_grad():
        loss_saved = float(loss_fn(state.params, cfg, batch)[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flat = flatten_pytree({"params": state.params})
    d2h_s = time.perf_counter() - t0
    raw_bytes = sum(a.nbytes for a in flat.values())
    shards = shard_state(flat, 1)[0]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as root:
        store = DiskStore(root, device="cuda")
        qb_ops.LAUNCHES.update(quantize=0, dequantize=0)
        t0 = time.perf_counter()
        stored = store.write_rank(0, 0, shards, codec="int8", lossless_paths=LOSSLESS_PATHS)
        store.commit(0, 1)
        encode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = store.read_rank(0, 0)
        decode_s = time.perf_counter() - t0
        launches = dict(qb_ops.LAUNCHES)
        index = store.rank_index(0, 0)
    int8_paths = {e["spec"]["path"] for e in index if e["enc"] == "int8"}
    check(len(int8_paths) == INT8_LEAVES, f"{len(int8_paths)} int8 leaves: {sorted(int8_paths)}")
    check(launches == {"quantize": INT8_LEAVES, "dequantize": INT8_LEAVES},
          f"quant launches {launches}, want {INT8_LEAVES} each")
    worst_half_steps = 0.0
    for path, (_spec, arr) in restored.items():
        if path not in int8_paths:
            check(arr.tobytes() == flat[path].tobytes(), f"lossless leaf {path} changed")
            continue
        x = torch.from_numpy(flat[path]).to("cuda")
        got = torch.from_numpy(arr).to("cuda")
        _q, s, want = plain_codec(qb_ref, x)
        check(same(got, want), f"{path}: restored leaf != plain dequant(plain quant)")
        err = (x - got).reshape(-1, QB_BLOCK).abs().amax(dim=-1)
        worst_half_steps = max(worst_half_steps, float((err / s).max()) * 2)
        del x, got, want, s, err
    check(worst_half_steps <= HALF_STEP_SLACK,
          f"restored error {worst_half_steps} half-steps, want <= 1")
    params = unflatten_like({"params": state.params},
                            {p: a for p, (_s, a) in restored.items()})["params"]
    with torch.no_grad():
        loss_restored = float(loss_fn(params, cfg, batch)[0])
    del params
    rel = abs(loss_restored - loss_saved) / abs(loss_saved)
    check(rel <= RESTORE_LOSS_REL_TOL,
          f"loss {loss_saved} saved vs {loss_restored} restored (rel {rel})")
    out = {"phase": "checkpoint", "codec": "int8", "leaves": len(flat),
           "int8_leaves": len(int8_paths), "quant_launches": launches["quantize"],
           "dequant_launches": launches["dequantize"], "raw_gb": raw_bytes / 1e9,
           "stored_gb": stored / 1e9, "d2h_s": d2h_s, "encode_s": encode_s,
           "decode_s": decode_s, "encode_gb_per_s": raw_bytes / encode_s / 1e9,
           "decode_gb_per_s": raw_bytes / decode_s / 1e9,
           "max_err_half_steps": worst_half_steps, "loss_saved": loss_saved,
           "loss_restored": loss_restored, "loss_rel_diff": rel,
           "loss_rel_tol": RESTORE_LOSS_REL_TOL}
    emit(out)
    return out


def phase_worker():
    """The port's rank worker on the card: a SIGKILL in a save, a restore."""
    from repro_torch.core.tce import DiskStore
    from repro_torch.substrate.worker import RankProcess

    logs = ROOT / "build"
    logs.mkdir(exist_ok=True)
    spec = dict(rank=0, n_ranks=1, seed=SEED, total_steps=20, batch=4, seq=32, device="cuda")

    def call(w, log, cmd):
        resp = w.call(cmd)
        check(resp is not None and resp.get("ok") == 1,
              f"worker {cmd} -> {resp}; log tail: {log.read_text()[-2000:]}")
        return resp

    out = {"phase": "worker", "spec": spec}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_worker_") as root:
        for codec in ("raw", "int8"):
            ckpt = str(Path(root) / codec)
            store = DiskStore(ckpt, device="cuda")
            t0 = time.perf_counter()
            log = logs / f"worker-{codec}-first.log"
            w = RankProcess(dict(spec, ckpt_dir=ckpt, codec=codec), log)
            spawn_s = time.perf_counter() - t0
            try:
                call(w, log, {"cmd": "step", "upto": 4})
                call(w, log, {"cmd": "save", "step": 4})
                store.commit(4, 1)
                tail = call(w, log, {"cmd": "step", "upto": 8})
                digest = call(w, log, {"cmd": "digest"})
                check(w.call({"cmd": "save", "step": 8, "die_at": "after_write"}) is None,
                      "the worker answered a save it was told to die in")
                w.proc.wait(timeout=60)
                check(w.proc.returncode == -9, f"worker exit {w.proc.returncode}, want SIGKILL")
            finally:
                w.close()
            check(store.latest_step() == 4, f"latest step {store.latest_step()}, want 4")
            log = logs / f"worker-{codec}-second.log"
            w = RankProcess(dict(spec, ckpt_dir=ckpt, codec=codec), log)
            try:
                call(w, log, {"cmd": "restore", "step": 4})
                again = call(w, log, {"cmd": "step", "upto": 8})
                digest_again = call(w, log, {"cmd": "digest"})
            finally:
                w.close()
            encs = {e["spec"]["path"]: e["enc"] for e in store.rank_index(4, 0)}
            n_int8 = sum(enc == "int8" for enc in encs.values())
            losses, losses_again = tail["losses"], again["losses"]
            check(all(math.isfinite(v) for _, v in losses + losses_again), "non-finite loss")
            if codec == "raw":
                check(losses_again == losses, f"losses {losses_again} != {losses}")
                check(digest_again["leaves"] == digest["leaves"], "leaf crcs differ after restore")
            else:
                params = [p for p in encs if p.startswith("params/")]
                check(n_int8 == INT8_LEAVES and all(encs[p] == "int8" for p in params
                                                    if not p.endswith("/scale")),
                      f"int8 checkpoint encodings: {encs}")
            out[codec] = {"losses": losses, "losses_restored": losses_again,
                          "bit_identical": losses_again == losses
                          and digest_again["leaves"] == digest["leaves"],
                          "int8_leaves": n_int8, "spawn_s": spawn_s,
                          "steps_5_8_wall_s": tail["wall_s"]}
    emit(out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.quant_blockwise import ops as qb_ops
    from repro_torch.kernels.quant_blockwise import ref as qb_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import model as model_mod
    from repro_torch.serve import engine

    t0 = time.perf_counter()
    phase_device()
    phase_build(_build)
    timing = phase_kernel(fa_ops, fa_ref)
    torch.cuda.empty_cache()
    launches, _ = phase_serve(fa_ops, serve_cli, engine, ARCH, REQUESTS, PROMPT_LEN, GEN,
                              "fa", variant="sm90")
    torch.cuda.empty_cache()
    simt_launches = phase_decode_check(engine, model_mod, fa_ops, ARCH, variant="simt")
    torch.cuda.empty_cache()
    ssd_timing = phase_ssd_kernel(ssd_ops, ssd_ref)
    torch.cuda.empty_cache()
    ssd_launches, _ = phase_serve(ssd_ops, serve_cli, engine, SSM_ARCH, SSM_REQUESTS,
                                  SSM_PROMPT_LEN, SSM_GEN, "ssd", variant="sm90")
    torch.cuda.empty_cache()
    ssd_simt_launches = phase_decode_check(engine, model_mod, ssd_ops, SSM_ARCH, variant="simt")
    ssd_simt_launches += phase_f32_prefill_check(engine, model_mod, ssd_ops, SSM_ARCH, "simt")
    torch.cuda.empty_cache()
    quant = phase_quant_kernel(qb_ops, qb_ref)
    torch.cuda.empty_cache()
    cfg, state, data = phase_train(fa_ops)
    ckpt = phase_checkpoint(cfg, state, data, qb_ops, qb_ref)
    del state
    torch.cuda.empty_cache()
    phase_worker()
    kernels = []
    for name, kind, src, count in (("flash_attention_fwd", "sm90", "flash_attention_sm90.cu",
                                    launches),
                                   ("flash_attention_fwd_simt", "simt", "flash_attention.cu",
                                    simt_launches)):
        t = timing[kind]
        kernels.append({
            "name": name, "route": "cuda", "source": FA_SRC + src, "replaces": FA_REPLACES,
            "launches": count, "max_abs_err": t["max_abs_err"], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "roofline_share": t["roofline_share"],
            "dtype": t["dtype"]})
    for name, line, key, count in (("quantize_blockwise", 18, "quantize", "quant_launches"),
                                   ("dequantize_blockwise", 29, "dequantize", "dequant_launches")):
        t = quant[key]
        kernels.append({
            "name": name, "route": "cuda", "source": QB_SRC, "replaces": f"{QB_REPLACES}:{line}",
            "launches": ckpt[count], "max_abs_err": quant["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    for name, kind, src, count in (("ssd_scan", "sm90", "ssd_scan_sm90.cu", ssd_launches),
                                   ("ssd_scan_simt", "simt", "ssd_scan.cu", ssd_simt_launches)):
        t = ssd_timing[kind]
        kernels.append({
            "name": name, "route": "cuda", "source": SSD_SRC + src, "replaces": SSD_REPLACES,
            "launches": count, "max_abs_err": t["max_abs_err"], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "roofline_share": t["roofline_share"], "dtype": t["dtype"],
            **({"passes": t["passes"]} if "passes" in t else {})})
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": round(time.perf_counter() - t0, 1)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
