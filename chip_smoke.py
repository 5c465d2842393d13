#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a). It builds the
port's kernels (AdamW with its clip, flash attention, blockwise int8
quantise / dequantise, the SSD chunked scan) from the sources in this
checkout into ``build/``, one nvcc per kernel package, and holds each kernel
against its plain PyTorch version on the card (the AdamW kernel at
olmoe-1b-7b-4l's 1.885 B float32 params, twice bit for bit, and timed beside
the optimizer's per-leaf path). Flash attention has two kernels, chosen by dtype
(``ops.variant``), both on the tensor cores at every head dim (16, 32, 64,
128): ``sm90`` for bf16 (16 is every reduced config's head dim), ``tf32x3``
for float32 (three TF32 products a product); each case runs the one the
table names. Then it drives the port's main paths with seeded
random weights:

* serving llama3-8b, full width and depth, bf16
  (``repro_torch.launch.serve``): prefill through the ``sm90``
  flash-attention kernel (every launch of the wave), then decode; decode
  against forward in float32 through the ``tf32x3`` kernel;
* serving mamba2-130m, full width and depth, bf16, 8 x 4096 + 32: prefill
  through the SSD-scan kernel (one launch per layer, every one on the
  ``sm90`` kernel: three passes on the tensor cores), then the recurrent
  decode; decode against forward at full width in float32, and a float32
  full-depth prefill through the kernel against the plain scan, both on
  the ``tf32x3`` kernel (float32 on the tensor cores, three TF32 products a
  product, in the same three passes);
* serving the MoE, hybrid and MLA families at full width, bf16, 8 x 1024 +
  32 each: ``olmoe-1b-7b`` at full depth (16 layers, every prefill
  attention on the ``sm90`` flash-attention kernel, the MoE layers through
  the reference's ``scatter`` dispatch); ``jamba-v0.1-52b`` cut to its
  first period of 8 layers (one attention layer on ``sm90``, seven SSM
  layers on the ``sm90`` SSD kernel at d_state 16, MoE on odd layers), and
  decode against forward in float32 at 2 layers; ``deepseek-v3-671b`` cut
  to its 3 dense layers and one MLA + MoE layer, without the MTP head
  (serving never reads it), which launches no hand kernel (MLA attends at
  head dims 192 / 128 through ``chunked_attention``, as the reference), and
  its absorbed decode against its reconstructing forward; jamba's float32
  decode check runs its SSM layers on ``tf32x3``;
* serving the encoder-decoder and VLM families whole, bf16, 8 requests
  each: ``whisper-tiny`` over its 1,500 stub encoder frames with a 384-token
  prompt and 64 generated tokens (every encoder, decoder and cross
  attention of the prefill on ``sm90``: 12 launches, two of the three
  shapes ragged and the cross attention at S != T), and ``qwen2-vl-2b``
  over 2,048 tokens whose first 1,024 are stub vision embeddings, 32
  generated (28 ``sm90`` launches at GQA rep 6), with one more prefill at
  Qwen2-VL's own M-RoPE positions for a 32 x 32 patch grid, kernel against
  plain and against the default positions; decode against forward in
  float32 for whisper whole and qwen2-vl at 2 layers, on ``tf32x3``;
* the parallel layer on a 1-rank NCCL group: olmoe-1b-7b's prefill, on the
  weights of its family wave, under a (1, 1) ``("data", "model")`` mesh,
  every MoE layer through the shard_map MoE (``all_to_all``, ``all_gather``
  on NCCL, counted) and every attention on ``sm90``, against the no-mesh
  ``scatter`` prefill at no-drop capacity with its routing replayed; after
  the TCE engine phase, one ``compress_pod_grads`` step of the training
  state on a (1,) ``("pod",)`` mesh (the int8 payload all_gathered) against
  the plain step fed the dequantised int8 gradients, bit for bit in
  deterministic mode; the group is destroyed before any phase spawns ranks;
* the four examples (``examples/torch_*.py``) in-process on the card: the
  serve demo's reduced llama3, mamba2 and deepseek-v3 (llama3's attention
  at head dim 16 on ``sm90``, mamba2's scan on the ``mma`` SSD kernel in
  bf16, counted), reduced llama3's prefill logits kernel against plain, the
  quickstart's restore of step 30 (byte for byte) and resume to 40, the
  anomaly demo's table, and the fault-tolerant example on the modelled
  cluster, each against what its CPU run gives;
* the control plane: the 21 scenarios of ``repro_torch.sim.scenarios`` with
  their TOL burn-ins on the card, each report equal to the same scenario's
  on the CPU, and a fleet preset, a replay preset and the default sweep,
  each run twice and equal byte for byte;
* one training rank, 4 layers (an Adam state of all 32 does not fit one
  card): ``make_train_step`` for 8 timed steps of 4 x 1024 tokens, then a
  TCE checkpoint of the trained params through ``DiskStore`` with the
  ``int8`` codec, which quantises and dequantises through the hand-written
  kernels, and a restore; then the TCE engine on the same params (two nodes,
  ring backup, ``int8``): the reconciler's thread persists and backs up
  through the quant kernels while the card trains on, and the state
  comes back from the cache, from the ring backup after a node
  loss and from the store after an adjacent double loss, each leg held to
  the plain codec on the card; then the port's rank worker as a subprocess
  on the card, killed in the middle of a save and restored, at its reduced
  default, with the ``raw`` and the ``int8`` codec at once;
* the TRANSOM recovery loop (``repro_torch.substrate.driver.run_protected``
  over ``ProcessSubstrate(device="cuda")``, the TEE on): two rank processes
  on the card train 24 steps through two SIGKILLs, the streaming TEE scores
  each dead rank, TOL's error checks run on the card, the killed ranks'
  nodes are evicted and spares claimed, and the merged loss curve equals an
  uninterrupted run's bit for bit; then four ranks, one SIGSTOPped, which
  the TEE names. The ranks run the reference's process-mode size (the
  reduced arch, 1 layer) through plain attention and the ``raw`` codec, so
  this phase launches no hand kernel;
* the launcher's ``--substrate single`` in-process (reduced arch, 30 steps,
  a checkpoint every 10): resumed after the chain-safe delete of its last
  step to the same final loss bit for bit, then with the ``int8`` codec,
  whose persists and restore launch the quant kernels from the reconciler;
* the paper's closed loop (``TransomOperator.run_job``, TOL + TEE + TCE):
  mamba2-130m at full width and depth in float32 trains 28 steps through
  node faults at steps 13 and 27 on a 4-node modelled cluster, with a TCE
  save every 5 steps: once with the ``raw`` codec (its final params held to
  an uninterrupted run's), once without faults, and once with ``int8``
  (bf16 Adam moments), whose persists, backups and restores quantise and
  dequantise through the hand-written kernels, each restored shard held to
  the plain codec.

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
import gc
import importlib.util
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): tensor cores, CUDA cores, HBM3
# and the SFU's exponentials, defined once in the port's launch/mesh.py
from repro_torch.launch.mesh import H100_HBM_BYTES_S as PEAK_BYTES_S  # noqa: E402
from repro_torch.launch.mesh import H100_PEAK_BF16_FLOPS as PEAK_BF16_FLOPS  # noqa: E402
from repro_torch.launch.mesh import H100_PEAK_F32_FLOPS as PEAK_F32_FLOPS  # noqa: E402
from repro_torch.launch.mesh import H100_PEAK_TF32_FLOPS as PEAK_TF32_FLOPS  # noqa: E402
from repro_torch.launch.mesh import H100_SFU_OPS as SFU_OPS  # noqa: E402

# The main path: llama3-8b serving, one wave of 8 requests x 1024-token
# prompts, 32 generated tokens.
ARCH, REQUESTS, PROMPT_LEN, GEN, SEED = "llama3-8b", 8, 1024, 32, 0

# Kernel vs plain tolerances. f32: the same arithmetic in another summation
# order (the tf32x3 kernels, flash attention's and the SSD scan's, also leave
# out the lo * lo term of their hi / lo split, below 2^-20 relative). bf16:
# the plain version rounds the normalised softmax weights to bf16 before
# P.V, the sm90 kernel the unnormalised ones (the reference tests' bf16
# tolerance; tests/test_torch_fa_bf16.py models the kernel's rounding).
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
# An MoE model's kernel-vs-plain check replays the kernel pass's routing in
# the other pass (``Routing``). Bounds on the tokens that pass would have
# routed otherwise, as tests/test_torch_families.py holds the bf16 forward
# against the reference: each must be a near tie (k-th and (k+1)-th router
# probabilities within this gap), and at most this share of the routed tokens
# may flip. A kernel error that moves routing beyond near ties breaks either.
ROUTING_FLIP_GAP = 1e-2
ROUTING_FLIP_SHARE = 1 / 8

# The SSM serving path: mamba2-130m, one wave of 8 requests x 4096-token
# prompts (16 chunks of 256), 32 generated tokens, full depth (24 layers).
SSM_ARCH, SSM_REQUESTS, SSM_PROMPT_LEN, SSM_GEN = "mamba2-130m", 8, 4096, 32
SSD_SRC = "src/repro_torch/kernels/ssd_scan/csrc/"
SSD_REPLACES = "src/repro/kernels/ssd_scan/ssd_scan.py:24"
# SSD kernel vs plain (tests/test_kernels.py): y within this share of max |y|,
# the final state at rtol = atol (f32: three TF32 products a product, summed
# in float32 in another order; bf16: x, B, C are bf16, y is rounded to bf16
# once).
SSD_Y_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
SSD_STATE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# The MoE, hybrid, MLA, encoder-decoder and VLM serving paths: one wave of 8
# requests each, at full width. (arch, layers kept, MTP depth, prompt
# length, generated tokens); None keeps the published depth. jamba: one
# whole period of its 1:7 attention interleave (32 layers, ~104 GB in bf16,
# do not fit one card); deepseek-v3: the 3 dense layers and one MLA + MoE
# layer, no MTP head. whisper-tiny and qwen2-vl-2b are served whole:
# whisper over its 1,500 encoder frames, a 384-token decoder prompt and 64
# generated tokens (448 positions, Whisper's text context, arXiv:2212.04356);
# qwen2-vl over 2,048 tokens, the first 1,024 of them the stub vision
# embeddings (n_vision_tokens).
FAMILY_REQUESTS, FAMILY_PROMPT_LEN, FAMILY_GEN = 8, 1024, 32
WHISPER_PROMPT_LEN, WHISPER_GEN, QWEN_VL_PROMPT_LEN = 384, 64, 2048
FAMILY_SERVES = (("olmoe-1b-7b", None, None, FAMILY_PROMPT_LEN, FAMILY_GEN),
                 ("jamba-v0.1-52b", 8, None, FAMILY_PROMPT_LEN, FAMILY_GEN),
                 ("deepseek-v3-671b", 4, 0, FAMILY_PROMPT_LEN, FAMILY_GEN),
                 ("whisper-tiny", None, None, WHISPER_PROMPT_LEN, WHISPER_GEN),
                 ("qwen2-vl-2b", None, None, QWEN_VL_PROMPT_LEN, FAMILY_GEN))
# qwen2-vl's 1,024 vision tokens as a 32 x 32 patch grid, for the prefill at
# Qwen2-VL's M-RoPE positions (arXiv:2409.12191)
QWEN_VL_GRID_W = 32
# The absorbed MLA decode against the reconstructing forward, bf16: 2 x 256
# tokens (prefill 255, decode token 255). The limit is the prefill check's.
MLA_CHECK_BATCH, MLA_CHECK_SEQ = 2, 256

# (b, s, nh, p, g, n, chunk, dtype): tests/test_kernels.py SSD_CASES, the
# chunks of the decode check's 17-token forward and 16-token prefill (tf32x3),
# the sm90 kernel's cases of tests/test_torch_ssd_passes.py (one chunk of 64
# at n 64, n 128 and n 16, chunks of 128 and 256 over several chunks, g 2
# with nh 8), jamba's SSM layers in its serve wave (bf16, p 64, n 16, 128
# heads: sm90), then the main path's shape in bf16 (sm90) and float32
# (tf32x3); x, B, C are views into one conv output, as the model passes
# them. Each case runs on the kernel ops.variant names: every float32 case
# on tf32x3, the bf16 ones on sm90 or mma.
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
    (1, 64, 4, 64, 1, 16, 64, torch.bfloat16),
    (FAMILY_REQUESTS, FAMILY_PROMPT_LEN, 128, 64, 1, 16, 256, torch.bfloat16),
]
JAMBA_SSD = SSD_CASES[-1]
MAIN_SSD = (SSM_REQUESTS, SSM_PROMPT_LEN, 24, 64, 1, 128, 256, torch.bfloat16)
MAIN_SSD_F32 = MAIN_SSD[:7] + (torch.float32,)
# The serve demo's reduced mamba2 scan (examples/torch_serve_demo.py: 4 x 32
# tokens, 8 heads of p 16, n 16, chunks of 32): no sm90 shape, on mma.
DEMO_SSD = (4, 32, 8, 16, 1, 16, 32, torch.bfloat16)
# The tf32x3 kernel beside MAIN_SSD_F32: the float32 prefill check's shape
# (2 x 1024, 4 chunks) and jamba's float32 decode check's forward (2 x 17,
# 128 heads at n 16, one ragged chunk of 17).
PREFILL_SSD_F32 = (2, 1024) + MAIN_SSD[2:7] + (torch.float32,)
JAMBA_DECODE_SSD_F32 = (2, 17, 128, 64, 1, 16, 17, torch.float32)
# The sm90 kernel and its passes at the main path's token count cut two
# other ways: 64 chunks in a row (the recurrence of pass 2 four times as
# long, a quarter of its blocks) and 4 (four times the blocks).
SSD_RATE_CASES = [(2, 16384) + MAIN_SSD[2:], (32, 1024) + MAIN_SSD[2:]]
SSD_PASSES = ("chunk_state", "state_pass", "chunk_scan")
# The sm90 passes' heads per block (pass 1, pass 3) before d_state 16: timed
# beside the wrapper's own at both sm90 shapes.
SSD_OLD_HEADS = (4, 8)
# The tf32x3 pass 3's heads per block timed beside the wrapper's
# (ops.F32_SCAN_HEADS) at mamba2's float32 shape.
SSD_F32_HEADS = (4, 24)

# (b, s, t, h, kh, d, causal, dtype): the shapes of tests/test_kernels.py
# FA_CASES, two ragged cases, the sm90 kernel's cases of
# tests/test_torch_kernels.py (one tile at D 64 and 128, ragged causal with
# an empty second consumer in the last tile, GQA rep 4 at D 64, D 128
# without the mask), olmoe-1b-7b's attention layers in its serve wave (16
# heads, no GQA grouping, D 128: sm90), the f32 decode check's two shapes
# (tf32x3), whisper-tiny's three attentions in its serve wave (the encoder,
# not causal at S = T = 1,500: ragged q and kv tiles; the decoder's causal
# self-attention; cross attention, 384 decoder rows against 1,500 encoder
# rows; 6 heads at D 64: sm90), qwen2-vl-2b's (GQA rep 6 at D 128: sm90),
# S != T in float32 (whisper's f32 decode check: tf32x3), and D 16, the
# reduced configs' head dim (causal GQA and ragged: tf32x3 in float32, sm90
# in bf16). Every float32 case runs on tf32x3, every bf16 case on sm90.
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
    (FAMILY_REQUESTS, FAMILY_PROMPT_LEN, FAMILY_PROMPT_LEN, 16, 16, 128, True, torch.bfloat16),
    (2, 17, 17, 32, 8, 128, True, torch.float32),
    (2, 16, 16, 32, 8, 128, True, torch.float32),
    (FAMILY_REQUESTS, 1500, 1500, 6, 6, 64, False, torch.bfloat16),
    (FAMILY_REQUESTS, WHISPER_PROMPT_LEN, WHISPER_PROMPT_LEN, 6, 6, 64, True, torch.bfloat16),
    (FAMILY_REQUESTS, WHISPER_PROMPT_LEN, 1500, 6, 6, 64, False, torch.bfloat16),
    (FAMILY_REQUESTS, QWEN_VL_PROMPT_LEN, QWEN_VL_PROMPT_LEN, 12, 2, 128, True, torch.bfloat16),
    (2, 17, 1500, 6, 6, 64, False, torch.float32),
    (2, 128, 128, 4, 2, 16, True, torch.float32),
    (2, 128, 128, 4, 2, 16, True, torch.bfloat16),
    (1, 200, 200, 4, 4, 16, False, torch.float32),
    (1, 200, 200, 4, 4, 16, False, torch.bfloat16),
]
MAIN_FA = (REQUESTS, PROMPT_LEN, PROMPT_LEN, 32, 8, 128, True, torch.bfloat16)
# The tf32x3 kernel is timed at the main path's shape in float32 (serving in
# float32 takes it at any head dim).
MAIN_FA_F32 = MAIN_FA[:7] + (torch.float32,)
# The sm90 kernel against SDPA beside the main shape: without the mask, and
# at 4x the sequence (4x the kv tiles per q tile, so that each q tile's
# first and last steps weigh a quarter as much), to tell the per-q-tile
# cost from the rate of the inner loop.
FA_RATE_CASES = [MAIN_FA[:6] + (False, torch.bfloat16),
                 (2, 4096, 4096, 32, 8, 128, True, torch.bfloat16),
                 (2, 4096, 4096, 32, 8, 128, False, torch.bfloat16)]
# The tf32x3 kernel against SDPA in float32 at 4x the sequence, causal and
# not.
FA_RATE_CASES_F32 = [(2, 4096, 4096, 32, 8, 128, True, torch.float32),
                     (2, 4096, 4096, 32, 8, 128, False, torch.float32)]
# The sm90 kernel at small head dims (bf16 at D 16 and 32, paced by the
# exponentials) against SDPA at a shape that is not launch-bound: the main
# path's 8 x 1024, causal, GQA 32 / 8; and at D 16 at 4x the sequence, to
# tell the per-q-tile cost from the rate of the inner loop.
FA_RATE_CASES_SMALL_D = [(REQUESTS, PROMPT_LEN, PROMPT_LEN, 32, 8, d, True, torch.bfloat16)
                         for d in (16, 32)] + [(2, 4096, 4096, 32, 8, 16, True, torch.bfloat16)]
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

# The TCE engine phase: two nodes with a ring backup; the card trains this
# many steps while the first save persists and backs up; the wait for a
# save to become durable; the host memory the phase needs, in saved bytes.
TCE_NODES, TCE_OVERLAP_STEPS, TCE_WAIT_S, TCE_HOST_FACTOR = 2, 48, 300.0, 7

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

# The fused AdamW kernel at olmoe-train's state (olmoe-1b-7b cut to 4 layers:
# 13 leaves, 1.885 B float32 params), at step 10 of a no-warmup schedule with
# the clip engaged (g ~ N(0, 1e-4^2): a norm of ~4.3). Kernel vs its plain
# version: both sum float64 squares, in another order, so the float32 norms
# agree but for a rounding tie and every term to a few ulp. The tolerance is
# each tensor's own: ADAMW_RTOL of an element plus ADAMW_RTOL of the tensor's
# largest magnitude (v is drawn at ~1e-8, where a fixed atol would hide a
# store that never happened); the phase checks that p, m and v as they were
# before the step (a kernel that never stored one) fall outside it.
ADAMW_ARCH, ADAMW_LAYERS, ADAMW_STEP = "olmoe-1b-7b", 4, 10
ADAMW_RTOL = 1e-6
ADAMW_BYTES = 32      # an element: g for the norm; p, g, m, v in and p, m, v out
ADAMW_SRC = "src/repro_torch/kernels/adamw/csrc/adamw.cu"

# The examples phase: examples/torch_*.py on the card. What their CPU runs
# give, as tests/test_torch_examples.py pins it: the quickstart's restore
# source (the memory-first waterfall: every rank's shard from its cache),
# the anomaly demo's table (the reference demo's, line for line), and the
# fault-tolerant example's sim run (two kills, two spares claimed).
QUICKSTART_SOURCES = {"cache": 4, "backup": 0, "store": 0, "store_full": 0}
ANOMALY_TABLE = [
    "category     detected  votes                                  bad ranks (true)",
    "storage      True      lof,nprofile,log                       (6,) ((4,))",
    "network      True      lof,nprofile,cluster                   (4,) ((4,))",
    "node_hw      True      lof,nprofile,cluster                   (3,) ((3,))",
    "user_code    True      log                                    (0,) ((0,))",
    "other        True      lof,nprofile                           () ((7,))",
]
FT_SIM = {"completed": True, "steps_done": 24, "restarts": {"inplace": 0, "resched": 2},
          "by_decision": {"claim_spare": 2}}
# The control-plane phase: the presets run twice each, byte for byte.
CP_FLEET, CP_REPLAY, CP_SWEEP = "two_jobs_rack_outage", "table1_64_week", "default"


T0 = time.perf_counter()   # the script's start: each phase line's t_s counts from it


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 1)}
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
    """Least time (s) for the work: the largest of three terms, which
    ``bound_by`` names. ``operations``: the products this run's mask keeps,
    bf16 ones on the tensor cores at the bf16 peak, float32 ones on the
    tf32x3 kernel as three TF32 products each at the TF32 peak;
    ``exponentials``: one per kept (q, k) pair on the SFU
    (``H100_SFU_OPS``), which paces attention at small head dims; ``bytes``:
    q, k, v read once and o written once. ``flops`` is the function's own
    count (one product each)."""
    b, s, t, h, kh, d, causal, dt = case
    pairs = sum(min(i + 1, t) for i in range(s)) if causal else s * t
    flops = 2 * 2 * b * h * d * pairs
    nbytes = (2 * b * s * h * d + 2 * b * t * kh * d) * torch.tensor([], dtype=dt).element_size()
    terms = {"operations": (flops / PEAK_BF16_FLOPS if dt == torch.bfloat16
                            else 3 * flops / PEAK_TF32_FLOPS),
             "exponentials": b * h * pairs / SFU_OPS,
             "bytes": nbytes / PEAK_BYTES_S}
    bound_by = max(terms, key=terms.get)
    return terms[bound_by], bound_by, flops, nbytes


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
                ("topk", ("topk",)), ("scan / sort", ("scan", "sort", "radix")),
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
    # the maximum SM clock, against which H100_SFU_OPS is counted (1,980 MHz)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": card, "sm_clock_max": clock,
          "name": torch.cuda.get_device_name(0),
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
    tf32x3: MAIN_FA_F32), and the rate cases against SDPA (sm90 at small
    head dims with its plain version's time and its error too)."""
    rows = []
    for i, case in enumerate(FA_CASES + [MAIN_FA, MAIN_FA_F32]):
        b, s, t, h, kh, d, causal, dt = case
        kind = fa_ops.variant(dt, d)
        q, k, v = fa_inputs(case, seed=100 + i)
        fa_ops.LAUNCHES_BY_VARIANT.update({name: 0 for name in fa_ops.LAUNCHES_BY_VARIANT})
        got = fa_ops.flash_attention(q, k, v, causal=causal)
        launched = dict(fa_ops.LAUNCHES_BY_VARIANT)
        torch.cuda.synchronize()
        check(launched == {name: int(name == kind) for name in launched},
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

    for group, kind, cases, seed in (("main", "sm90", FA_RATE_CASES, 300),
                                     ("main", "tf32x3", FA_RATE_CASES_F32, 310),
                                     ("small_d", "sm90", FA_RATE_CASES_SMALL_D, 320)):
        rates = []
        for i, case in enumerate(cases):
            causal = case[6]
            check(fa_ops.variant(case[7], case[5]) == kind, f"{case} is not on {kind}")
            q, k, v = fa_inputs(case, seed=seed + i)
            kernel_ms = time_ms(lambda: fa_ops.flash_attention(q, k, v, causal=causal))
            library_ms = time_ms(sdpa_call(q, k, v, causal))
            bound_s, bound_by, flops, _ = fa_bound(case)
            rates.append({"shape": list(case[:6]), "causal": causal, "kernel_ms": kernel_ms,
                          "library_ms": library_ms, "bound_ms": bound_s * 1e3,
                          "bound_by": bound_by, "kernel_tflops": flops / kernel_ms / 1e9,
                          "library_tflops": flops / library_ms / 1e9})
            if group == "small_d":
                # the kernel's error and its plain version's time here
                rates[-1]["plain_ms"] = time_ms(
                    lambda: fa_ref.attention_reference(q, k, v, causal=causal))
                rates[-1]["max_abs_err"] = float(
                    (fa_ops.flash_attention(q, k, v, causal=causal).float()
                     - fa_ref.attention_reference(q, k, v, causal=causal).float()).abs().max())
                check(rates[-1]["max_abs_err"] <= TOL[torch.bfloat16],
                      f"sm90 at {case}: {rates[-1]['max_abs_err']}")
            del q, k, v
        emit({"phase": "kernel_rates", "variant": kind, "group": group,
              "dtype": str(cases[0][7]).split(".")[1],
              "library": "scaled_dot_product_attention (GQA expanded)", "cases": rates})
        if group == "small_d":
            timings["sm90_small_d"] = rates
    return timings


def layer_counts(cfg) -> dict:
    """Prefill launches one wave should make, per kernel: flash attention
    once per attention layer (MLA layers attend in plain torch), and for the
    encoder-decoder once more per decoder layer (cross attention) and once
    per encoder layer; the SSD scan once per SSM layer."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    fa = 0 if cfg.mla is not None else kinds.count("attn")
    if cfg.family == "encdec":
        fa += cfg.n_layers + cfg.encdec.n_enc_layers
    return {"fa": fa, "ssd": kinds.count("ssm")}


def layer_pattern(cfg) -> list:
    """Each layer as mixer/mlp (the model's own ``layer_spec``)."""
    from repro_torch.models import blocks
    return [f"{sp.kind}/{sp.mlp}" for sp in (blocks.layer_spec(cfg, i)
                                             for i in range(cfg.n_layers))]


class Routing:
    """Records the experts each MoE layer's router picks in one pass and
    makes a later pass route the same way (its gate weights from its own
    probabilities at those experts, renormalised as ``_gate`` does).

    A router's top-k is discrete: where two of its probabilities nearly tie,
    a bf16 rounding anywhere upstream (a kernel's or the plain version's)
    can pick the other expert and change the layer's output by O(1) at that
    token. So a kernel is held against its plain version through an MoE
    model with the routing of the kernel's pass replayed in the plain pass;
    the tokens the plain pass would have routed differently are counted
    (``flips``) with the largest gap between their k-th and (k+1)-th
    probabilities (``flip_gap``)."""

    def __init__(self, moe_mod):
        self.moe, self.gate = moe_mod, moe_mod._gate
        self.mode, self.seen, self.i, self.rows = None, [], 0, slice(None)
        self.flips, self.flip_gap = 0, 0.0

    def __enter__(self):
        self.moe._gate = self._gate
        return self

    def __exit__(self, *exc):
        self.moe._gate = self.gate

    def record(self):
        self.mode, self.seen = "record", []

    def replay(self, positions=slice(None)):
        self.mode, self.i, self.rows = "replay", 0, positions

    def _gate(self, p, x, cfg):
        probs, gate_w, idx = self.gate(p, x, cfg)
        if self.mode == "record":
            self.seen.append(idx)
        elif self.mode == "replay":
            want = self.seen[self.i][:, self.rows]
            self.i += 1
            differ = (idx.sort(-1).values != want.sort(-1).values).any(-1)
            if bool(differ.any()):
                top = probs.sort(-1, descending=True).values
                k = cfg.moe.top_k
                self.flips += int(differ.sum())
                self.flip_gap = max(self.flip_gap,
                                    float((top[..., k - 1] - top[..., k])[differ].max()))
            gate_w = probs.gather(-1, want)
            gate_w, idx = gate_w / (gate_w.sum(-1, keepdim=True) + 1e-9), want
        return probs, gate_w, idx


def top_kernels(prof, n: int = 12) -> list:
    """The ``n`` CUDA kernels with the most device time, [name, ms]."""
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    return [[k[:90], round(ms, 3)] for k, ms in sorted(rows, key=lambda r: -r[1])[:n]]


def reset_counts(kernels) -> None:
    for ops in kernels.values():
        ops.LAUNCHES = 0
        ops.LAUNCHES_BY_VARIANT.update({k: 0 for k in ops.LAUNCHES_BY_VARIANT})


def phase_serve(kernels, serve_cli, engine, cfg, requests, prompt_len, gen, variants,
                compare_plain=True, keep=False, cut=None):
    """One wave at ``cfg``'s size (the published config, or a depth cut at
    full width) through the port's serving entry point,
    ``repro_torch.launch.serve.serve`` (what its ``main`` runs), weights from
    ``SEED``. Every kernel's launches are counted in that run alone, by
    variant, against the layers of its kind (``variants`` names the one each
    kernel must take). Then a warm wave, a profiled prefill, and the prefill
    logits against an all-plain prefill. Every prefill takes the wave's batch
    extras (whisper's encoder frames, qwen2-vl's vision embeddings). ``keep``
    returns the weights and the batch for a later check."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    res = serve_cli.serve(cfg, requests, prompt_len, gen, SEED, torch.device("cuda"))
    launches = {k: ops.LAUNCHES for k, ops in kernels.items()}
    by_variant = {k: dict(ops.LAUNCHES_BY_VARIANT) for k, ops in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    params, prompts, extras = res["params"], res["prompts"], res["extras"]
    batch = {"tokens": prompts, **extras}
    toks = res["tokens"]
    check(tuple(toks.shape) == (requests, gen), f"tokens shape {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "token out of [0, vocab)")
    for key in ("prefill_logits", "last_logits"):
        check(bool(torch.isfinite(res[key].float()).all()), f"non-finite {key}")
    counts = layer_counts(cfg)
    for k, ops in kernels.items():
        want = {v: counts[k] if v == variants.get(k) else 0 for v in ops.LAUNCHES_BY_VARIANT}
        check(launches[k] == counts[k] and by_variant[k] == want,
              f"{cfg.name}: {k} launched {launches[k]} times {by_variant[k]}, want {want}")

    # Warm wave: steady-state times (cuBLAS and allocator already warm).
    warm = serve_cli.serve_wave(params, cfg, prompts, gen, extras)

    # One more prefill under the profiler: device time by kernel kind, and
    # its sum over the prefill's wall time (the busy share).
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof, torch.inference_mode():
        t0 = time.perf_counter()
        engine.prefill_fn(params, cfg, batch)
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

    out = {"phase": "serve", "arch": cfg.name, "cut": cut, "n_params": cfg.n_params(),
           "n_layers": cfg.n_layers, "layer_pattern": layer_pattern(cfg),
           "d_model": cfg.d_model, "requests": requests, "prompt_len": prompt_len, "gen": gen,
           "extras": {k: list(v.shape) for k, v in extras.items()},
           "dtype": cfg.compute_dtype, "launches": launches, "launches_by_variant": by_variant,
           "first_prefill_ms": res["prefill_s"] * 1e3, "prefill_ms": warm["prefill_s"] * 1e3,
           "prefill_tok_s": requests * prompt_len / warm["prefill_s"],
           "decode_ms_per_step": warm["decode_s"] / (gen - 1) * 1e3,
           "decode_tok_s": requests * (gen - 1) / warm["decode_s"],
           "peak_mem_gb": peak_gb, "warm_tokens_equal": bool(torch.equal(warm["tokens"], toks)),
           "profiled_prefill_ms": profiled_ms, "profiled_kernel_ms_by_kind": by_kind,
           "profiled_hand_kernel_ms": by_hand_kernel, "profiled_top_kernels": top_kernels(prof),
           "profiled_kernel_ms": busy_ms, "device_busy_share_of_prefill": busy_ms / profiled_ms}
    if compare_plain:
        # Kernel vs plain through the whole prefill; an MoE model's plain
        # pass takes the kernel pass's routing (``Routing``).
        from repro_torch.models import moe as moe_mod

        with torch.inference_mode():
            plain_logits, _ = engine.prefill_fn(params, cfg, batch, attn_impl="plain")
            got = res["prefill_logits"].float()
            if cfg.moe is not None:
                out["logits_max_abs_diff_own_routing"] = float(
                    (got - plain_logits.float()).abs().max())
                with Routing(moe_mod) as routing:
                    routing.record()
                    got, _ = engine.prefill_fn(params, cfg, batch)
                    routing.replay()
                    plain_logits, _ = engine.prefill_fn(params, cfg, batch, attn_impl="plain")
                got = got.float()
                out.update(routing_flips=routing.flips, routing_flip_gap=routing.flip_gap,
                           routed_tokens=requests * prompt_len * sum(
                               cfg.mlp_kind(i) == "moe" for i in range(cfg.n_layers)))
        diff = float((got - plain_logits.float()).abs().max())
        scale = float(plain_logits.float().abs().max())
        out.update(logits_max_abs_diff=diff, logits_scale=scale, logits_rel_tol=LOGITS_REL_TOL,
                   argmax_agree=float((got.argmax(-1) == plain_logits.argmax(-1)).float().mean()))
        del plain_logits, got
    emit(out)
    if "routing_flips" in out:
        check_flips(out["routing_flips"], out["routing_flip_gap"], out["routed_tokens"],
                    cfg.name)
    if compare_plain:
        check(out["logits_max_abs_diff"] <= LOGITS_REL_TOL * out["logits_scale"],
              f"prefill logits kernel vs plain: max |diff| {out['logits_max_abs_diff']} > "
              f"{LOGITS_REL_TOL} x {out['logits_scale']}")
    return launches, out, ((params, batch) if keep else None)


def check_flips(flips: int, gap: float, routed: int, what: str) -> None:
    """The replayed routing's flips within ``ROUTING_FLIP_GAP`` and
    ``ROUTING_FLIP_SHARE``."""
    check(gap < ROUTING_FLIP_GAP,
          f"{what}: a token flipped routing at a probability gap {gap} >= {ROUTING_FLIP_GAP}")
    check(flips <= int(routed * ROUTING_FLIP_SHARE),
          f"{what}: {flips} of {routed} routed tokens flipped routing, more than "
          f"{ROUTING_FLIP_SHARE} of them")


def no_drop(cfg):
    """``cfg`` with an MoE capacity of the whole group (capacity factor
    n_experts / top_k): no routing slot is dropped, so a token's MoE output
    does not depend on the tokens grouped with it. Prefill plus decode and a
    forward over the longer sequence group the tokens differently; at the
    published factor they would drop different slots."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


# The VLM's decode check overwrites the first 8 of its 17 token embeddings
# with vision embeddings.
DECODE_VISION = 8


def phase_decode_check(engine, model_mod, ops, arch, variant=None, kind="fa", layers=2):
    """Decode position s-1 after prefilling s-1 tokens == forward over s
    tokens (tests/test_models.py), full width, float32, ``layers`` layers
    (None keeps the published depth; MoE at the capacity of the whole group,
    ``no_drop``); forward and prefill go through the kernel (where it has
    variants, all on ``variant``), ``layer_counts(cfg)[kind]`` times each.
    The encoder-decoder takes its encoder frames, the VLM ``DECODE_VISION``
    vision embeddings (all before the decoded token), both from
    ``launch/serve.make_extras``. Returns the kernel's launches in this
    check."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_extras

    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    cfg = no_drop(cfg)
    params = model_mod.init_params(cfg, seed=2, device="cuda")
    b, s = 2, 17
    g = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device="cuda")
    extras = make_extras(cfg, b, DECODE_VISION, 5, "cuda")
    before = ops.LAUNCHES
    if variant:
        ops.LAUNCHES_BY_VARIANT.update({k: 0 for k in ops.LAUNCHES_BY_VARIANT})
    with torch.inference_mode():
        full, _, _, _ = model_mod.forward(params, cfg, {"tokens": tokens, **extras},
                                          mode="train")
        _, cache = engine.prefill_fn(params, cfg, {"tokens": tokens[:, :s - 1], **extras})
        cache = engine.pad_cache(cfg, cache, b, s + 4)
        pos = torch.full((b,), s - 1, dtype=torch.long, device="cuda")
        dec, _ = engine.decode_fn(params, cfg, tokens[:, s - 1], cache, pos)
    launches = ops.LAUNCHES - before
    by_variant = dict(ops.LAUNCHES_BY_VARIANT) if variant else None
    want = full[:, s - 1]
    err = float((dec - want).abs().max())
    ok = bool(((dec - want).abs() <= DECODE_TOL + DECODE_TOL * want.abs()).all())
    per_pass = layer_counts(cfg)[kind]
    emit({"phase": "decode_matches_forward", "arch": arch, "n_layers": cfg.n_layers,
          "layer_pattern": layer_pattern(cfg), "n_params": cfg.n_params(),
          "d_model": cfg.d_model, "dtype": "float32", "tokens": [b, s],
          "extras": {k: list(v.shape) for k, v in extras.items()},
          "kernel_launches": launches, "kernel_launches_per_pass": per_pass,
          "kernel_launches_by_variant": by_variant,
          "max_abs_err": err, "tol": DECODE_TOL, "ok": ok})
    check(launches == 2 * per_pass,
          f"{launches} kernel launches in forward + prefill, want 2 x {per_pass}")
    if variant:
        check(by_variant[variant] == launches, f"launches by variant {by_variant}, want {variant}")
    check(ok, f"decode vs forward: max abs err {err}")
    return launches


def phase_mla_decode_check(engine, model_mod, kernels, params, cfg):
    """The absorbed MLA decode against the reconstructing forward, bf16, at
    the serve phase's weights and width: prefill s - 1 tokens, decode token
    s - 1 through the ``ckv`` / ``kpe`` latent cache, and compare with a
    forward over s tokens at that position (MoE at ``no_drop`` capacity, the
    forward's routing replayed in the prefill and the decode: ``Routing``).
    Launches no hand kernel."""
    cfg = no_drop(cfg)
    b, s = MLA_CHECK_BATCH, MLA_CHECK_SEQ
    g = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device="cuda")
    from repro_torch.models import moe as moe_mod

    reset_counts(kernels)
    with torch.inference_mode(), Routing(moe_mod) as routing:
        routing.record()
        full, _, _, _ = model_mod.forward(params, cfg, {"tokens": tokens}, mode="train")
        want = full[:, s - 1].float()
        del full
        routing.replay(slice(0, s - 1))
        _, cache = engine.prefill_fn(params, cfg, {"tokens": tokens[:, :s - 1]})
        cache = engine.pad_cache(cfg, cache, b, s + 4)
        pos = torch.full((b,), s - 1, dtype=torch.long, device="cuda")
        routing.replay(slice(s - 1, s))
        dec, _ = engine.decode_fn(params, cfg, tokens[:, s - 1], cache, pos)
    launched = {k: ops.LAUNCHES for k, ops in kernels.items()}
    n_moe = sum(cfg.mlp_kind(i) == "moe" for i in range(cfg.n_layers))
    diff = float((dec.float() - want).abs().max())
    scale = float(want.abs().max())
    out = {"phase": "mla_decode_matches_forward", "arch": cfg.name, "n_layers": cfg.n_layers,
           "dtype": cfg.compute_dtype, "tokens": [b, s], "cache_leaves": sorted(
               {k for seg in cache.values() for leaves in seg.values() for k in leaves}),
           "capacity_factor": cfg.moe.capacity_factor, "launches": launched,
           "routing_flips": routing.flips, "routing_flip_gap": routing.flip_gap,
           "routed_tokens": b * s * n_moe, "logits_max_abs_diff": diff,
           "logits_scale": scale, "rel_tol": LOGITS_REL_TOL,
           "argmax_agree": float((dec.argmax(-1) == want.argmax(-1)).float().mean())}
    emit(out)
    check(out["cache_leaves"] == ["ckv", "kpe"], f"MLA cache leaves {out['cache_leaves']}")
    check(not any(launched.values()), f"the MLA check launched {launched}")
    check_flips(routing.flips, routing.flip_gap, out["routed_tokens"], "MLA decode check")
    check(diff <= LOGITS_REL_TOL * scale,
          f"absorbed decode vs forward: max |diff| {diff} > {LOGITS_REL_TOL} x {scale}")
    return out


def grid_positions(b: int, s: int, n_vis: int, width: int, device) -> torch.Tensor:
    """Qwen2-VL's M-RoPE positions (arXiv:2409.12191), (3, b, s): ``n_vis``
    patches on a grid ``width`` wide, patch i at (0, i // width, i % width),
    then text token j at max + 1 + j in all three streams."""
    i = torch.arange(n_vis)
    vis = torch.stack([torch.zeros_like(i), i // width, i % width])
    text = (torch.arange(s - n_vis) + int(vis.max()) + 1).expand(3, s - n_vis)
    return torch.cat([vis, text], dim=1)[:, None].expand(3, b, s).to(device)


def phase_mrope_grid_check(engine, kernels, params, batch, cfg):
    """qwen2-vl's prefill at Qwen2-VL's own M-RoPE positions for its 1,024
    vision tokens as a 32 x 32 grid (``grid_positions``, passed as the batch's
    ``positions``), where the t, h and w streams differ: the kernel prefill
    (one sm90 launch per layer) against the all-plain one within
    ``LOGITS_REL_TOL`` of max |logit|, and both farther than that from the
    default-position logits (t = h = w), which shows that the bands moved."""
    b, s = batch["tokens"].shape
    n_vis = batch["vision_embeds"].shape[1]
    pos = grid_positions(b, s, n_vis, QWEN_VL_GRID_W, "cuda")
    reset_counts(kernels)
    with torch.inference_mode():
        got, _ = engine.prefill_fn(params, cfg, {**batch, "positions": pos})
        launches = {k: dict(ops.LAUNCHES_BY_VARIANT) for k, ops in kernels.items()}
        plain, _ = engine.prefill_fn(params, cfg, {**batch, "positions": pos},
                                     attn_impl="plain")
        default, _ = engine.prefill_fn(params, cfg, batch)
    got, plain, default = got.float(), plain.float(), default.float()
    scale = float(plain.abs().max())
    out = {"phase": "mrope_grid_prefill", "arch": cfg.name, "tokens": [b, s],
           "vision_grid": [n_vis // QWEN_VL_GRID_W, QWEN_VL_GRID_W],
           "mrope_sections": list(cfg.vlm.mrope_sections), "launches_by_variant": launches,
           "logits_max_abs_diff": float((got - plain).abs().max()), "logits_scale": scale,
           "rel_tol": LOGITS_REL_TOL,
           "vs_default_positions_max_abs_diff": float((got - default).abs().max()),
           "argmax_agree": float((got.argmax(-1) == plain.argmax(-1)).float().mean())}
    emit(out)
    want = {v: cfg.n_layers if v == "sm90" else 0 for v in launches["fa"]}
    check(launches["fa"] == want, f"grid prefill launched {launches['fa']}, want {want}")
    check(out["logits_max_abs_diff"] <= LOGITS_REL_TOL * scale,
          f"grid-position prefill kernel vs plain: {out['logits_max_abs_diff']} > "
          f"{LOGITS_REL_TOL} x {scale}")
    check(out["vs_default_positions_max_abs_diff"] > LOGITS_REL_TOL * scale,
          "grid-position logits within the kernel limit of the default-position ones: "
          "the M-RoPE bands did not move")
    return out


def phase_families(kernels, serve_cli, engine, model_mod, mesh):
    """The MoE, hybrid, MLA, encoder-decoder and VLM families at full width
    (``FAMILY_SERVES``): each serve wave (olmoe's then again under ``mesh``
    through the shard_map MoE on the same weights, qwen2-vl's with its
    prefill at grid M-RoPE positions, deepseek-v3's with its absorbed decode
    check), then the float32 decode checks of jamba (2 layers), whisper-tiny
    (whole) and qwen2-vl (2 layers). Each frees its weights before the
    next."""
    from repro_torch.configs import get_config

    def freed(what):
        # each phase must leave the card as it found it (weights freed); and
        # its wall time since the one before, for the script's time budget
        nonlocal t_last
        seconds[what] = time.perf_counter() - t_last
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        gc.collect()
        after_gc = torch.cuda.memory_allocated()
        memory[what] = {"allocated_gb": held / 1e9, "after_gc_gb": after_gc / 1e9}
        check(after_gc <= base + 2 ** 30,
              f"{what} left {(after_gc - base) / 1e9:.2f} GB allocated on the card")
        t_last = time.perf_counter()

    base, memory, runs, seconds = torch.cuda.memory_allocated(), {}, {}, {}
    t_last = time.perf_counter()
    for arch, layers, mtp, prompt_len, gen in FAMILY_SERVES:
        cfg, cut = get_config(arch), []
        if layers is not None and layers != cfg.n_layers:
            cut.append(f"n_layers {cfg.n_layers} -> {layers}")
            cfg = dataclasses.replace(cfg, n_layers=layers)
        if mtp is not None and mtp != cfg.mtp_depth:
            cut.append(f"mtp_depth {cfg.mtp_depth} -> {mtp} (serving never reads the MTP "
                       f"head; with it: {dataclasses.replace(cfg, mtp_depth=1).n_params():,} "
                       "params)")
            cfg = dataclasses.replace(cfg, mtp_depth=mtp)
        mla, vlm, par = cfg.mla is not None, cfg.vlm is not None, arch == PARALLEL_ARCH
        variants = {"fa": "sm90", "ssd": "sm90"}
        launches, out, kept = phase_serve(kernels, serve_cli, engine, cfg, FAMILY_REQUESTS,
                                          prompt_len, gen, variants, compare_plain=not mla,
                                          keep=mla or vlm or par, cut=cut or None)
        if par:
            runs["parallel_moe"] = phase_parallel_moe(engine, kernels, *kept, cfg, mesh)
        if mla:
            out["mla_check"] = phase_mla_decode_check(engine, model_mod, kernels, kept[0], cfg)
        if vlm:
            out["mrope_grid_check"] = phase_mrope_grid_check(engine, kernels, *kept, cfg)
        del kept
        runs[arch] = out
        freed(arch)
    runs["decode_ssd_f32"] = phase_decode_check(engine, model_mod, kernels["ssd"],
                                                "jamba-v0.1-52b", variant="tf32x3", kind="ssd")
    freed("decode_check_jamba")
    for arch, layers in (("whisper-tiny", None), ("qwen2-vl-2b", 2)):
        runs[f"decode_f32_{arch}"] = phase_decode_check(engine, model_mod, kernels["fa"], arch,
                                                        variant="tf32x3", layers=layers)
        freed(f"decode_check_{arch}")
    emit({"phase": "families_memory", "base_gb": base / 1e9, "after": memory,
          "seconds": seconds})
    return runs


# The parallel phase: a 1-rank NCCL group on the card with a (1, 1)
# ("data", "model") mesh, under which olmoe's prefill takes the shard_map MoE
# (PARALLEL_ARCH's weights of its family serve wave), and a (1,) ("pod",)
# mesh for one compress_pod_grads step of the train phase's state.
PARALLEL_ARCH = "olmoe-1b-7b"


def parallel_open():
    """The 1-rank NCCL process group on cuda:0 (an in-memory store: no port)
    and the phase's two meshes."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh

    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1, rank=0,
                            device_id=torch.device("cuda:0"))
    return {"data_model": make_local_mesh(("data", "model")), "pod": make_local_mesh(("pod",)),
            "open_s": time.perf_counter() - t0}


def parallel_close(card, meshes, moe, step) -> None:
    """Destroys the group (before any phase spawns ranks) and prints the
    phase's line."""
    import torch.distributed as dist

    dist.destroy_process_group()
    emit({"phase": "parallel", "card": card, "open_s": meshes["open_s"], "moe": moe,
          "step": step})


def phase_parallel_moe(engine, kernels, params, batch, cfg, mesh):
    """olmoe's prefill at full size under the 1-rank mesh: every MoE layer
    through ``moe_forward_shard_map`` (all_to_all and all_gather on NCCL),
    every attention on the sm90 kernel. Held to the no-mesh ``scatter``
    prefill at no-drop capacity (the two group the tokens differently) with
    the mesh pass's routing replayed."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel import compat
    from repro_torch.parallel.sharding import use_sharding

    cfg = no_drop(cfg)
    n_moe = sum(cfg.mlp_kind(i) == "moe" for i in range(cfg.n_layers))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def mesh_prefill():
        with use_sharding(mesh):
            return engine.prefill_fn(params, cfg, batch)

    with Routing(moe_mod) as routing:
        routing.record()
        reset_counts(kernels)
        compat.COLLECTIVES.clear()
        (got, _), first_ms = timed(mesh_prefill)
        launches = {k: ops.LAUNCHES for k, ops in kernels.items()}
        by_variant = {k: dict(ops.LAUNCHES_BY_VARIANT) for k, ops in kernels.items()}
        collectives = dict(compat.COLLECTIVES)
        routing.replay()
        (want, _), scatter_ms = timed(lambda: engine.prefill_fn(params, cfg, batch))
    _, warm_ms = timed(mesh_prefill)
    got, want = got.float(), want.float()
    b, s = batch["tokens"].shape
    out = {"arch": cfg.name, "mesh": {"data": 1, "model": 1}, "requests": b, "prompt_len": s,
           "capacity_factor": cfg.moe.capacity_factor, "moe_layers": n_moe,
           "launches": launches, "launches_by_variant": by_variant,
           "collectives": collectives, "mesh_first_prefill_ms": first_ms,
           "mesh_prefill_ms": warm_ms, "scatter_replayed_prefill_ms": scatter_ms,
           "logits_max_abs_diff": float((got - want).abs().max()),
           "logits_scale": float(want.abs().max()), "logits_rel_tol": LOGITS_REL_TOL,
           "argmax_agree": float((got.argmax(-1) == want.argmax(-1)).float().mean()),
           "routing_flips": routing.flips, "routing_flip_gap": routing.flip_gap,
           "routed_tokens": b * s * n_moe}
    check(bool(torch.isfinite(got).all()), "non-finite logits under the mesh")
    want_fa = {v: layer_counts(cfg)["fa"] if v == "sm90" else 0
               for v in kernels["fa"].LAUNCHES_BY_VARIANT}
    check(launches == {"fa": layer_counts(cfg)["fa"], "ssd": 0} and by_variant["fa"] == want_fa,
          f"mesh prefill launched {launches} {by_variant}, want {want_fa} flash attention")
    # per MoE layer: the dispatch and return all_to_all, the expert weights'
    # three all_gathers over data, aux's pmean over model and data, the
    # output's reassembly over data and model
    want_coll = {"all_to_all": 2 * n_moe, "all_gather": 5 * n_moe, "all_reduce": 2 * n_moe}
    check(collectives == want_coll, f"collectives {collectives}, want {want_coll}")
    check_flips(routing.flips, routing.flip_gap, out["routed_tokens"], f"{cfg.name} mesh")
    check(out["logits_max_abs_diff"] <= LOGITS_REL_TOL * out["logits_scale"],
          f"mesh vs scatter prefill logits: max |diff| {out['logits_max_abs_diff']} > "
          f"{LOGITS_REL_TOL} x {out['logits_scale']}")
    return out


PARALLEL_STEP = TRAIN_STEPS + 2     # the first batch no earlier step took


def phase_parallel_step(cfg, state, data, mesh):
    """One ``compress_pod_grads`` step of the train phase's state on the
    1-rank pod axis (the int8 payload all_gathered on NCCL), against the
    plain step fed ``s * q`` of ``_quant_leaf(g)``: equal bit for bit in
    deterministic mode, params and moments. ``state`` takes the plain step."""
    from repro_torch import deterministic
    from repro_torch.models.params import tree_items, tree_map
    from repro_torch.parallel import compat
    from repro_torch.train import AdamConfig, TrainConfig, make_train_step
    from repro_torch.train.optimizer import adam_update
    from repro_torch.train.trainer import _grads_and_metrics, _quant_leaf

    opt = AdamConfig(lr=TRAIN_LR, warmup_steps=0, decay_steps=100)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in data.batch_at(PARALLEL_STEP).items()}
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    mine = state._replace(step=state.step.clone(), params=tree_map(torch.clone, state.params),
                          opt=tree_map(torch.clone, state.opt))

    def fed(g):
        q, s = _quant_leaf(g.to(torch.float32))
        return (q.to(torch.float32) * s).to(g.dtype)

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    deterministic("cuda")
    try:
        step = make_train_step(cfg, opt, TrainConfig(compress_pod_grads=True), mesh=mesh)
        compat.COLLECTIVES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mine, metrics = step(mine, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads, _ = _grads_and_metrics(state.params, cfg, batch, TrainConfig())
        adam_update(state.params, tree_map(fed, grads), state.opt, state.step, opt,
                    rng=state.rng)
        del grads
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        differ = [p for tree in ("params", "opt") for (p, x), (_, y) in
                  zip(tree_items(getattr(mine, tree)), tree_items(getattr(state, tree)))
                  if not same(x, y)]
        # the step's cost again, warm (the first pays deterministic mode's
        # first calls); it moves ``mine`` past the compared state
        collectives = dict(compat.COLLECTIVES)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        step(mine, batch)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t3
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    del mine
    leaves = list(tree_items(state.params))
    int8_bytes = sum(t.numel() + 4 * t.numel() // t.shape[-1] for _, t in leaves)
    out = {"arch": ARCH, "n_layers": cfg.n_layers, "mesh": {"pod": 1},
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "deterministic": True,
           "compressed_step_ms": (t1 - t0) * 1e3, "plain_fed_step_ms": (t2 - t1) * 1e3,
           "compressed_step_warm_ms": warm_s * 1e3, "held_before_gb": held_gb,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "collectives": collectives, "leaves": len(leaves),
           "int8_payload_bytes": int8_bytes,
           "f32_grad_bytes": sum(4 * t.numel() for _, t in leaves),
           "loss": float(metrics["loss"]), "leaves_differing": len(differ)}
    check(not differ, f"compressed step vs plain step fed s * q: {differ} differ")
    check(out["collectives"].get("all_gather") == 2 * len(leaves),
          f"collectives {out['collectives']}: want 2 all_gathers per leaf")
    check(math.isfinite(out["loss"]), "non-finite loss")
    return out


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


def ssd_inputs(case, seed, pad=0, start=0):
    """x, dt, A, B, C for a case: x, B and C as views into one (b, s, conv_dim)
    tensor, as the model hands them to the kernel; ``pad`` columns more a row
    (4 makes bf16 rows a multiple of 8 bytes, not 16, which TMA cannot read),
    the views starting ``start`` columns in (1: an odd bf16 offset, which only
    2-byte loads can read)."""
    b, s, nh, p, g, n, chunk, dt = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d_in = nh * p
    xbc = (torch.randn(b, s, start + d_in + 2 * g * n + pad, generator=gen, device="cuda")
           * 0.5).to(dt)[..., start:]
    x = xbc[..., :d_in].reshape(b, s, nh, p)
    B = xbc[..., d_in:d_in + g * n].reshape(b, s, g, n)
    C = xbc[..., d_in + g * n:d_in + 2 * g * n].reshape(b, s, g, n)
    dtv = torch.nn.functional.softplus(torch.randn(b, s, nh, generator=gen, device="cuda"))
    A = -torch.exp(torch.randn(nh, generator=gen, device="cuda") * 0.3)
    return x, dtv, A, B, C


def ssd_bound(case):
    """Least time (s) for the scan: x read and y written once, B, C, dt and A
    read once, the final state written once; operations of the chunked
    algorithm on the causal half of each chunk (C.B^T once per group, its
    product with x dt, the chunk states and the inter-chunk term): bf16 on
    the tensor cores at the bf16 peak, float32 on the tf32x3 kernel as three
    TF32 products each at the TF32 peak (as ``fa_bound``). ``flops`` is the
    function's own count (one product each)."""
    b, s, nh, p, g, n, chunk, dt = case
    c = min(chunk, s)
    pairs = c * (c + 1) // 2
    flops = 2 * b * (s // c) * (g * n * pairs + nh * p * pairs + 2 * nh * c * p * n)
    elt = torch.tensor([], dtype=dt).element_size()
    nbytes = (2 * b * s * nh * p + 2 * b * s * g * n) * elt + 4 * (b * s * nh + nh + b * nh * p * n)
    t_ops = flops / PEAK_BF16_FLOPS if dt == torch.bfloat16 else 3 * flops / PEAK_TF32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def ssd_pass_bound(name, case, kind):
    """Least time (s) for one pass of the ``kind`` kernel (sm90 or mma for
    bf16, tf32x3 for float32) at ``case``: what the pass must read and write
    (each once) and its products, at the peak for their type (bf16: one
    product each at the bf16 peak; float32: three TF32 products each at the
    TF32 peak). chunk_state: x, B, dt, A in; the f32 chunk states and cum
    (b, nh, s) out; (x w)^T B. state_pass: the chunk states and cum_last in,
    the starting states (bf16 for sm90, float32 for tf32x3 and mma) and the
    final state out; a multiply-add a value a chunk (float32, CUDA cores).
    chunk_scan: x, B, C, cum, dt and the starting states in, y out; C.B^T once
    per group and its product with x on the causal half, and the inter-chunk
    term."""
    b, s, nh, p, g, n, chunk, dt = case
    c = min(chunk, s)
    l, pairs = s // c, c * (c + 1) // 2
    elt = torch.tensor([], dtype=dt).element_size()
    states = b * l * nh * p * n
    # the tensor-core products: bf16 at its peak, float32 three TF32 products
    peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_TF32_FLOPS / 3
    h_elt = 2 if kind == "sm90" else 4
    if name == "chunk_state":
        nbytes = (b * s * nh * p + b * s * g * n) * elt + 4 * (b * s * nh + nh) + 4 * states \
            + 4 * b * nh * s
        flops = 2 * states * c
    elif name == "state_pass":
        nbytes = 4 * states + 4 * b * nh * l + h_elt * states + 4 * b * nh * p * n
        flops, peak = 2 * states, PEAK_F32_FLOPS
    else:
        nbytes = (2 * b * s * nh * p + 2 * b * s * g * n) * elt + 2 * 4 * b * nh * s \
            + h_elt * states
        flops = 2 * b * l * (g * n * pairs + nh * p * pairs + nh * c * p * n)
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def ssd_pass_times(ssd_ops, case, x, dtv, A, B, C):
    """Each pass of the kernel that takes ``case`` in these views (sm90 or
    mma for bf16, tf32x3 for float32) alone (through its wrapper, as
    ``ssd_scan`` calls it), beside its own bound. The float32 pass 2 of
    tf32x3 and mma is timed into a buffer of its own (``ssd_scan`` writes it
    over the chunk states)."""
    c = min(case[6], case[1])
    kind = ssd_ops.variant(case[7], case[3], case[5], c, ssd_ops.tma_aligned(x, B, C))
    h_dtype = torch.bfloat16 if kind == "sm90" else torch.float32
    states, cum = ssd_ops.chunk_state(x, dtv, A, B, c)
    h_in, _ = ssd_ops.state_pass(states, cum, c, None, dtype=h_dtype)
    out = {}
    for name, fn in (("chunk_state", lambda: ssd_ops.chunk_state(x, dtv, A, B, c)),
                     ("state_pass", lambda: ssd_ops.state_pass(states, cum, c, None,
                                                               dtype=h_dtype)),
                     ("chunk_scan", lambda: ssd_ops.chunk_scan(x, dtv, B, C, cum, h_in, c))):
        ms = time_ms(fn)
        bound_s, bound_by = ssd_pass_bound(name, case, kind)
        out[name] = {"ms": ms, "bound_ms": bound_s * 1e3, "bound_by": bound_by,
                     "roofline_share": bound_s * 1e3 / ms}
    return out


def ssd_passes_vs_plain(ssd_ops, ssd_ref, case, pad=0):
    """Each pass of the kernel that takes ``case`` in views padded by ``pad``
    (``ssd_inputs``: sm90 or mma for bf16, tf32x3 for float32) against its
    own plain pass: chunk states and cum from the same inputs, the starting
    states from an init state, the outputs from the same starting states
    (rounded to bf16 for sm90). Returns the kernel."""
    x, dtv, A, B, C = ssd_inputs(case, seed=9, pad=pad)
    b, s, nh, p, g, n, c, dt = case
    c = min(c, s)
    kind = ssd_ops.variant(dt, p, n, c, ssd_ops.tma_aligned(x, B, C))
    h_dtype = torch.bfloat16 if kind == "sm90" else torch.float32
    init = torch.randn(b, nh, p, n, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(10))
    tol = SSD_STATE_TOL[dt]
    states, cum = ssd_ops.chunk_state(x, dtv, A, B, c)
    w_states, w_cum = ssd_ref.chunk_state_reference(x, dtv, A, B, c)
    h_in, final = ssd_ops.state_pass(w_states, w_cum, c, init, dtype=h_dtype)
    w_h_in, w_final = ssd_ref.state_pass_reference(w_states, w_cum, c, init)
    h_op = w_h_in.to(h_dtype)
    y = ssd_ops.chunk_scan(x, dtv, B, C, w_cum, h_op, c)
    wy = ssd_ref.chunk_scan_reference(x, dtv, B, C, w_cum, h_op.float(), c)
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
        check(ok, f"{kind} {name} at {list(case[:7])} disagrees with its plain pass: "
                  f"{passes[name]}")
    y_err = float((y.float() - wy.float()).abs().max())
    y_scale = float(wy.float().abs().max())
    passes["chunk_scan y"] = {"max_abs_err": y_err, "y_scale": y_scale,
                              "y_tol": SSD_Y_TOL[dt], "ok": y_err / y_scale < SSD_Y_TOL[dt]}
    check(passes["chunk_scan y"]["ok"],
          f"{kind} chunk_scan at {list(case[:7])} disagrees: {passes['chunk_scan y']}")
    emit({"phase": "ssd_passes_vs_plain", "variant": kind, "shape": list(case[:7]),
          "dtype": str(dt).split(".")[1], "pad": pad, "passes": passes})
    return kind


def phase_ssd_kernel(ssd_ops, ssd_ref):
    """Every listed shape on the kernel the variant table names, against the
    plain version, jamba's shape on mma too (in views TMA cannot read: rows
    padded by 4 bf16, and views one bf16 in), and the init-state
    continuation (tf32x3); each sm90 pass against its own plain pass at
    mamba2's and jamba's shapes, each tf32x3 pass at mamba2's in float32 and
    at jamba's float32 decode check's, each mma pass at jamba's shape in
    padded rows and at the serve demo's; then the kernels' times, each pass
    beside its bound (sm90 at both shapes in bf16, tf32x3 at mamba2's and the
    float32 prefill check's, mma at jamba's and mamba2's shapes in padded
    rows, at the bf16 p-32 case and at the serve demo's), and of the sm90
    kernel at two other cuts of mamba2's tokens."""
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
        check(kind == "tf32x3" if case[7] == torch.float32 else kind != "tf32x3",
              f"{case} runs on {kind}")
        ssd_ops.LAUNCHES_BY_VARIANT.update({k: 0 for k in ssd_ops.LAUNCHES_BY_VARIANT})
        got = ssd_ops.ssd_scan(x, dtv, A, B, C, chunk=case[6])
        launched = dict(ssd_ops.LAUNCHES_BY_VARIANT)
        torch.cuda.synchronize()
        check(launched == {k: int(k == kind) for k in launched},
              f"{case} launched {launched}, want one {kind}")
        compare(case, got, ssd_ref.ssd_reference(x, dtv, A, B, C, chunk=c), "kernel vs plain",
                kind)
        del x, dtv, A, B, C, got
    check(rows[-2]["variant"] == "sm90" and rows[-1]["variant"] == "tf32x3",
          "the main shape must run on sm90 in bf16 and on tf32x3 in float32")
    jamba_row = rows[len(SSD_CASES) - 1]
    check(jamba_row["variant"] == "sm90", "jamba's SSD shape must run on sm90")
    # jamba's shape on mma, in views TMA cannot read: the same inputs in rows
    # padded by 4 bf16 (4-byte copies), and in views one bf16 in (2-byte loads)
    for pad, start, views in ((4, 0, "rows padded by 4 bf16"), (0, 1, "views one bf16 in")):
        x, dtv, A, B, C = ssd_inputs(JAMBA_SSD, seed=200 + len(SSD_CASES) - 1, pad=pad,
                                     start=start)
        kind = ssd_ops.variant(JAMBA_SSD[7], JAMBA_SSD[3], JAMBA_SSD[5], JAMBA_SSD[6],
                               ssd_ops.tma_aligned(x, B, C))
        check(kind == "mma", f"jamba's shape in {views} runs on {kind}, want mma")
        ssd_ops.LAUNCHES_BY_VARIANT.update({k: 0 for k in ssd_ops.LAUNCHES_BY_VARIANT})
        got = ssd_ops.ssd_scan(x, dtv, A, B, C, chunk=JAMBA_SSD[6])
        launched = dict(ssd_ops.LAUNCHES_BY_VARIANT)
        torch.cuda.synchronize()
        check(launched == {k: int(k == kind) for k in launched},
              f"jamba's shape in {views} launched {launched}, want one mma")
        compare(JAMBA_SSD, got, ssd_ref.ssd_reference(x, dtv, A, B, C, chunk=JAMBA_SSD[6]),
                f"kernel vs plain, {views}", kind)
        del x, dtv, A, B, C, got
    # The continuation of tests/test_kernels.py: two halves, the second from
    # the first one's final state, against the whole sequence.
    case = (1, 128, 4, 16, 1, 8, 32, torch.float32)
    x, dtv, A, B, C = ssd_inputs(case, seed=199)
    half = case[1] // 2
    ssd_ops.LAUNCHES_BY_VARIANT.update({k: 0 for k in ssd_ops.LAUNCHES_BY_VARIANT})
    _, h1 = ssd_ops.ssd_scan(x[:, :half], dtv[:, :half], A, B[:, :half], C[:, :half], chunk=32)
    y2, h2 = ssd_ops.ssd_scan(x[:, half:], dtv[:, half:], A, B[:, half:], C[:, half:],
                              chunk=32, init_state=h1)
    torch.cuda.synchronize()
    check(ssd_ops.LAUNCHES_BY_VARIANT["tf32x3"] == 2,
          f"continuation launched {ssd_ops.LAUNCHES_BY_VARIANT}, want two tf32x3")
    wy, wh = ssd_ref.ssd_reference(x, dtv, A, B, C, chunk=32)
    compare(case, (y2, h2), (wy[:, half:], wh), "init-state continuation", "tf32x3")
    emit({"phase": "ssd_kernel_vs_plain", "cases": rows})

    # Each pass against its own plain pass (the starting states from an init
    # state; pass 3 given the same starting states): sm90 at mamba2's and
    # jamba's bf16 shapes, tf32x3 at mamba2's in float32 and at jamba's
    # float32 decode check's, mma at jamba's in rows padded by 4 bf16 and at
    # the serve demo's.
    for case, pad, kind in ((MAIN_SSD, 0, "sm90"), (JAMBA_SSD, 0, "sm90"),
                            (MAIN_SSD_F32, 0, "tf32x3"), (JAMBA_DECODE_SSD_F32, 0, "tf32x3"),
                            (JAMBA_SSD, 4, "mma"), (DEMO_SSD, 0, "mma")):
        got = ssd_passes_vs_plain(ssd_ops, ssd_ref, case, pad=pad)
        check(got == kind, f"the passes at {list(case[:7])}, pad {pad} ran on {got}, not {kind}")

    # each kernel's times at its main-path shapes: sm90 at mamba2's and
    # jamba's (bf16, n 16), tf32x3 at mamba2's and the float32 prefill
    # check's, mma at jamba's and mamba2's in rows padded by 4 bf16, at the
    # bf16 p-32 case and at the serve demo's
    timings = {}
    for key, case, pad in (("sm90", MAIN_SSD, 0), ("sm90_jamba", JAMBA_SSD, 0),
                           ("tf32x3", MAIN_SSD_F32, 0), ("tf32x3_prefill", PREFILL_SSD_F32, 0),
                           ("mma_jamba", JAMBA_SSD, 4), ("mma_p32", SSD_CASES[3], 0),
                           ("mma_demo", DEMO_SSD, 0), ("mma_main", MAIN_SSD, 4)):
        x, dtv, A, B, C = ssd_inputs(case, seed=8, pad=pad)
        chunk = case[6]
        kind = key.split("_")[0]
        check(ssd_ops.variant(case[7], case[3], case[5], chunk,
                              ssd_ops.tma_aligned(x, B, C)) == kind, f"{key} is not {kind}")
        # the error at the timed inputs (the timing shapes' own check)
        got_y, got_h = ssd_ops.ssd_scan(x, dtv, A, B, C, chunk=chunk)
        want_y, want_h = ssd_ref.ssd_reference(x, dtv, A, B, C, chunk=chunk)
        err = float((got_y.float() - want_y.float()).abs().max())
        y_scale = float(want_y.float().abs().max())
        check(err / y_scale < SSD_Y_TOL[case[7]], f"{key}: y error {err} of {y_scale}")
        del got_y, got_h, want_y, want_h
        kernel_ms = time_ms(lambda: ssd_ops.ssd_scan(x, dtv, A, B, C, chunk=chunk))
        plain_ms = time_ms(lambda: ssd_ref.ssd_reference(x, dtv, A, B, C, chunk=chunk))
        bound_s, bound_by, flops, nbytes = ssd_bound(case)
        timings[key] = {
            "phase": "ssd_kernel_timing", "variant": kind, "shape": list(case[:7]),
            "dtype": str(case[7]).split(".")[1], "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": None, "library": "none: no single PyTorch call computes the SSD scan",
            "bound_ms": bound_s * 1e3, "bound_by": bound_by, "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6, "kernel_tflops": flops / (kernel_ms * 1e-3) / 1e12,
            "roofline_share": bound_s * 1e3 / kernel_ms, "vs_plain": plain_ms / kernel_ms,
            "max_abs_err": err, "y_scale": y_scale}
        if pad:
            timings[key]["views"] = f"rows padded by {pad} bf16: not TMA-aligned"
        if kind == "tf32x3":
            # the same operations on the CUDA cores at the float32 peak
            timings[key]["cuda_core_floor_ms"] = flops / PEAK_F32_FLOPS * 1e3
        timings[key]["passes"] = ssd_pass_times(ssd_ops, case, x, dtv, A, B, C)
        if key == "tf32x3":
            # pass 3's heads per block: the wrapper's beside fewer and more
            used = ssd_ops.F32_SCAN_HEADS
            at = {}
            for heads in SSD_F32_HEADS:
                ssd_ops.F32_SCAN_HEADS = heads
                try:
                    at[heads] = time_ms(lambda: ssd_ops.ssd_scan(x, dtv, A, B, C, chunk=chunk))
                finally:
                    ssd_ops.F32_SCAN_HEADS = used
            timings[key]["heads_per_block"] = {"used": used, "kernel_ms": kernel_ms,
                                               "kernel_ms_at": at}
        if kind == "sm90":
            # the heads per block (pass 1, pass 3) the wrapper uses, beside
            # the 4 and 8 it used before d_state 16 came to sm90
            used = (ssd_ops.STATE_HEADS, ssd_ops.SCAN_HEADS)
            ssd_ops.STATE_HEADS, ssd_ops.SCAN_HEADS = SSD_OLD_HEADS
            try:
                old_ms = time_ms(lambda: ssd_ops.ssd_scan(x, dtv, A, B, C, chunk=chunk))
            finally:
                ssd_ops.STATE_HEADS, ssd_ops.SCAN_HEADS = used
            timings[key]["heads_per_block"] = {"used": list(used), "kernel_ms": kernel_ms,
                                               "old": list(SSD_OLD_HEADS),
                                               "kernel_ms_at_old": old_ms}
        del x, dtv, A, B, C
        torch.cuda.empty_cache()
        emit(timings[key])

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


def phase_adamw_kernel(adamw_ops, adamw_ref):
    """The fused AdamW kernel at olmoe-train's state: two runs from equal
    states bit for bit, against its plain version, then timed beside the
    per-leaf path (the route every non-float32 tree takes) and, as a yardstick
    the port never calls, ``torch._fused_adamw_`` (no clip: 28 bytes an
    element)."""
    from repro_torch.configs import get_config
    from repro_torch.models import param_shapes
    from repro_torch.models.params import flatten_params
    from repro_torch.train import AdamConfig, optimizer

    cfg = dataclasses.replace(get_config(ADAMW_ARCH), n_layers=ADAMW_LAYERS)
    shapes = [tuple(s.shape) for s in flatten_params(param_shapes(cfg)).values()]
    n = sum(math.prod(s) for s in shapes)
    opt = AdamConfig(lr=TRAIN_LR, warmup_steps=0, decay_steps=100)
    step = torch.tensor(ADAMW_STEP, dtype=torch.int32, device="cuda")
    lr, c1, c2 = optimizer.step_scalars(opt, step, "cuda")
    kw = dict(b1=opt.b1, b2=opt.b2, eps=opt.eps, weight_decay=opt.weight_decay,
              grad_clip=opt.grad_clip)

    def drawn(seed, scale, positive=False):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return [(torch.rand(s, generator=gen, device="cuda") if positive
                 else torch.randn(s, generator=gen, device="cuda")) * scale for s in shapes]

    def state():            # p, m, v: the same values at every call
        return drawn(SEED + 40, 0.02), drawn(SEED + 41, 1e-4), drawn(SEED + 42, 1e-8, True)

    def bits(x):
        return x.reshape(-1).view(torch.int32)

    def outside(got, want):
        """Indices of the leaves of ``got`` outside the tolerance around
        ``want``, and the worst share of the tolerance any element takes."""
        worst, bad = 0.0, []
        for i, (a, b) in enumerate(zip(got, want)):
            diff = (a - b).abs_()
            room = b.abs().mul_(ADAMW_RTOL).add_(ADAMW_RTOL * float(b.abs().max()))
            worst = max(worst, float((diff / room).max()))
            if not bool((diff <= room).all()):
                bad.append(i)
            del diff, room
        return bad, worst

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = drawn(SEED + 43, 1e-4)
    before = dict(adamw_ops.LAUNCHES)
    p, m, v = state()
    norm = adamw_ops.adamw_(p, g, m, v, lr, c1, c2, **kw)
    p2, m2, v2 = state()
    norm2 = adamw_ops.adamw_(p2, g, m2, v2, lr, c1, c2, **kw)
    torch.cuda.synchronize()
    launched = {k: adamw_ops.LAUNCHES[k] - before[k] for k in before}
    bit_equal = bool(torch.equal(bits(norm), bits(norm2))) and all(
        torch.equal(bits(a), bits(b)) for xs, ys in ((p, p2), (m, m2), (v, v2))
        for a, b in zip(xs, ys))
    del p2, m2, v2
    pr, mr, vr = state()
    norm_ref = adamw_ref.adamw_reference(pr, g, mr, vr, lr, c1, c2, **kw)
    torch.cuda.synchronize()
    worst, bad = 0.0, []
    for name, xs, ys in (("p", p, pr), ("m", m, mr), ("v", v, vr)):
        out, w = outside(xs, ys)
        worst = max(worst, w)
        bad += [f"{name}[{i}]" for i in out]
    # a planted fault: each of p, m, v as it was before the step, as a kernel
    # that never stored it would leave it, has to fall outside the tolerance
    # on every leaf (the times below run on the plain version's state)
    del p, m, v
    unseen = {}
    for name, before_step, ref_after in zip("pmv", state(), (pr, mr, vr)):
        unseen[name] = len(shapes) - len(outside(before_step, ref_after)[0])
    p, m, v = pr, mr, vr
    del pr, mr, vr
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    out = {"phase": "adamw_kernel", "arch": ADAMW_ARCH, "n_layers": ADAMW_LAYERS,
           "leaves": len(shapes), "n_params": n, "step": ADAMW_STEP,
           "grad_norm": float(norm), "grad_norm_ref": float(norm_ref),
           "clip_engaged": float(norm) > opt.grad_clip, "launches": launched,
           "bit_equal_twice": bit_equal, "worst_share_of_tolerance": worst,
           "tolerance": {"rtol": ADAMW_RTOL, "atol": f"{ADAMW_RTOL} x max |ref| a tensor"},
           "unwritten_leaves_unseen": unseen, "peak_mem_gb": peak_gb}
    check(launched == {"sumsq": 2, "norm_scale": 2, "update": 2}, f"launches {launched}")
    check(bit_equal, "two AdamW kernel runs on equal inputs differ")
    check(not bad, f"AdamW kernel vs its plain version: {bad} outside the tolerance")
    check(not any(unseen.values()),
          f"the tolerance does not see a store left undone, leaves per tensor: {unseen}")
    check(out["clip_engaged"] and math.isfinite(out["grad_norm"]), f"grad norm {out['grad_norm']}")

    # times, each on the plain version's state (each call moves it on)
    nbytes = ADAMW_BYTES * n
    ms = time_ms(lambda: adamw_ops.adamw_(p, g, m, v, lr, c1, c2, **kw))
    plain_ms = time_ms(lambda: optimizer._per_leaf_update(p, g, m, v, lr, c1, c2, step, opt,
                                                          None))
    steps = [torch.full((), ADAMW_STEP + 1.0, device="cuda") for _ in shapes]
    lr_f = float(lr)
    library_ms = time_ms(lambda: torch._fused_adamw_(
        p, g, m, v, [], steps, lr=lr_f, beta1=opt.b1, beta2=opt.b2,
        weight_decay=opt.weight_decay, eps=opt.eps, amsgrad=False, maximize=False))
    del p, m, v, g
    bound_ms = nbytes / PEAK_BYTES_S * 1e3
    out.update({"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "library": "torch._fused_adamw_ (no clip; weight decay on every leaf)",
                "bound_ms": bound_ms, "bound_by": "bytes", "gbytes": nbytes / 1e9,
                "gb_per_s": nbytes / (ms * 1e-3) / 1e9, "roofline_share": bound_ms / ms})
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
    return cfg, state, data, step_fn, out


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


def host_mem_available() -> int:
    """Bytes the host can still give (MemAvailable of /proc/meminfo)."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def int8_paths_of(shards, lossless) -> set:
    """The leaves of one rank's shard map that the int8 codec quantises
    (codec.encode_shard's rule: a non-empty float leaf off the lossless
    globs); the rest go through zlib or stay raw."""
    from repro_torch.core.tce.codec import _QUANT_DTYPES, dtype_name, is_lossless_path
    return {p for p, (_sp, d) in shards.items()
            if d.size and dtype_name(d.dtype) in _QUANT_DTYPES
            and not is_lossless_path(p, lossless)}


def phase_tce_engine(cfg, state, data, step_fn, train, qb_ops, qb_ref):
    """The TCE engine at full width, on the trained params: two nodes with a
    ring backup, the int8 codec on the card, the reconciler persisting and
    backing up from its thread while the card keeps training, then restores
    from each leg of the waterfall (cache, ring backup, store)."""
    from repro_torch.core.tce import (DiskStore, TCEConfig, TCEngine, crc32_stream,
                                      flatten_pytree, shard_state, unflatten_like)
    from repro_torch.models.model import loss_fn
    from repro_torch.models.params import tree_items, unflatten
    from repro_torch.substrate.worker import LOSSLESS_PATHS

    n_nodes = TCE_NODES
    layers = cfg.n_layers
    # the phase holds ~7x the saved bytes on the host at its peak: four
    # steps' shards in the arenas (own + backup, two cycles), the saved flat
    # state, a restored one and the codec's transients; a host that cannot
    # spare that saves the first 2 layers
    avail = host_mem_available()
    if avail < TCE_HOST_FACTOR * sum(t.nbytes for _p, t in tree_items(state.params)):
        layers = 2
        cfg = dataclasses.replace(cfg, n_layers=layers)

    def saved(params):
        return unflatten({p: t[:layers] if p.startswith("segments/stack/") else t
                          for p, t in tree_items(params)})

    params = saved(state.params)
    nbytes = sum(t.nbytes for _p, t in tree_items(params))
    check(avail >= TCE_HOST_FACTOR * nbytes,
          f"host has {avail / 1e9:.1f} GB free, the phase needs {TCE_HOST_FACTOR * nbytes / 1e9:.1f}")

    def flat_now():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flat = flatten_pytree({"params": params})
        return flat, time.perf_counter() - t0

    def batch_at(step):
        return {k: torch.from_numpy(v).to("cuda") for k, v in data.batch_at(step).items()}

    flat1, d2h1_s = flat_now()
    shards1 = shard_state(flat1, n_nodes)
    int8_by_rank = [int8_paths_of(sh, LOSSLESS_PATHS) for sh in shards1]
    per_rank = [sum(d.nbytes for _sp, d in sh.values()) for sh in shards1]
    # each node holds max_cycles of its own shards and of its neighbour's
    # backup, plus a page of rounding per leaf
    mem_limit = max(2 * (per_rank[r] + per_rank[r - 1]) + 2 * 4096 * 2 * len(sh)
                    for r, sh in enumerate(shards1))
    digests1 = [{p: crc32_stream(d) for p, (_sp, d) in sh.items()} for sh in shards1]
    del shards1
    timing = {"persist": [], "backup": []}
    root = tempfile.mkdtemp(prefix="chip_smoke_tce_")
    eng = TCEngine(TCEConfig(n_nodes=n_nodes, backup=True, codec="int8", max_cycles=2,
                             mem_limit_bytes=mem_limit, lossless_paths=LOSSLESS_PATHS),
                   DiskStore(root, device="cuda"))
    rec = eng.reconciler
    # the wall time of each leg, per rank and step (a timing wrapper only:
    # each leg runs as the library runs it, on the reconciler thread's
    # default stream)
    for leg in ("persist", "backup"):
        orig = getattr(rec, f"_{leg}")

        def timed(cache, step, shards, digmap, _orig=orig, _leg=leg):
            t0 = time.perf_counter()
            _orig(cache, step, shards, digmap)
            timing[_leg].append((step, cache.rank, time.perf_counter() - t0, t0))
        setattr(rec, f"_{leg}", timed)

    def overlap(h, first_step):
        """The card keeps training while the reconciler persists and backs
        up the save behind ``h``; then ``h`` must become durable."""
        nonlocal state
        steps_s, pending_after, starts = [], [], []
        for k in range(TCE_OVERLAP_STEPS):
            batch = batch_at(first_step + k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            starts.append(t0 - h.t_saved)
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            steps_s.append(time.perf_counter() - t0)
            pending_after.append(rec._pending())
            check(math.isfinite(float(metrics["loss"])), "non-finite loss while persisting")
        t_wait = time.perf_counter()
        check(h.wait(timeout=TCE_WAIT_S), f"save {h.step} not durable within {TCE_WAIT_S} s")
        durable_s = (time.perf_counter() - t_wait) + sum(steps_s)
        check(rec.errors == [], f"reconciler errors: {rec.errors}")
        overlapped = [t * 1e3 for t, p in zip(steps_s, pending_after) if p]
        check(overlapped, "the reconciler finished before the first overlapped step ended")
        # when each leg ran, in seconds from the save's return, beside the
        # steps' start times: which leg a slow step sat under
        legs = sorted((t0 - h.t_saved, t0 - h.t_saved + wall, leg, rank)
                      for leg in timing for st, rank, wall, t0 in timing[leg] if st == h.step)
        return {"steps": TCE_OVERLAP_STEPS,
                "steps_overlapped": len(overlapped), "step_ms": [t * 1e3 for t in steps_s],
                "step_start_s": starts, "legs": legs,
                "overlapped_ms_mean": statistics.mean(overlapped),
                "overlapped_ms_median": statistics.median(overlapped),
                "overlapped_ms_max": max(overlapped),
                "steady_ms_per_step": train["steady_ms_per_step"],
                "durable_after_save_s": durable_s}
    out = {"phase": "tce_engine", "arch": ARCH, "n_layers": layers, "nodes": n_nodes,
           "codec": "int8", "saved_gb": nbytes / 1e9, "mem_limit_gb": mem_limit / 1e9,
           "host_avail_gb": avail / 1e9, "leaves": len(flat1),
           "int8_shards": [len(s) for s in int8_by_rank]}
    launches = {}
    try:
        s1 = int(state.step)
        qb_ops.LAUNCHES.update(quantize=0, dequantize=0)
        clock0 = eng.clock.seconds
        t0 = time.perf_counter()
        h = eng.save(s1, flat1)
        h.t_saved = time.perf_counter()
        save1_s = h.t_saved - t0
        del flat1
        out["save1"] = {"step": s1, "d2h_s": d2h1_s, "d2h_gb_per_s": nbytes / d2h1_s / 1e9,
                        "cache_wall_s": h.cache_wall_s, "save_wall_s": save1_s,
                        "stall_s": d2h1_s + save1_s, "bytes_staged": h.bytes_staged,
                        "modeled_cache_s": h.modeled_cache_s}
        out["overlap"] = {"save1": overlap(h, s1)}
        launches["save1"] = dict(qb_ops.LAUNCHES)

        # save 2: every leaf changed, so each is persisted and backed up anew
        s2 = s1 + TCE_OVERLAP_STEPS
        check(int(state.step) == s2, f"state.step {int(state.step)}, want {s2}")
        params = saved(state.params)
        flat2, d2h2_s = flat_now()
        shards2 = shard_state(flat2, n_nodes)
        changed = [{p for p, (_sp, d) in sh.items() if crc32_stream(d) != digests1[r].get(p)}
                   for r, sh in enumerate(shards2)]
        del shards2
        batch = batch_at(s2)
        with torch.no_grad():        # before training moves the live params on
            loss_saved = float(loss_fn(params, cfg, batch)[0])
        qb_ops.LAUNCHES.update(quantize=0, dequantize=0)
        t0 = time.perf_counter()
        h2 = eng.save(s2, flat2)
        h2.t_saved = time.perf_counter()
        save2_s = h2.t_saved - t0
        out["overlap"]["save2"] = overlap(h2, s2)
        launches["save2"] = dict(qb_ops.LAUNCHES)
        out["save2"] = {"step": s2, "d2h_s": d2h2_s, "d2h_gb_per_s": nbytes / d2h2_s / 1e9,
                        "cache_wall_s": h2.cache_wall_s, "save_wall_s": save2_s,
                        "stall_s": d2h2_s + save2_s, "bytes_staged": h2.bytes_staged,
                        "changed_leaves": [len(c) for c in changed]}
        out["persist"] = _leg_times(timing["persist"], nbytes, (s1, s2))
        out["backup"] = _leg_times(timing["backup"], nbytes, (s1, s2))
        out["modeled_s"] = {"saves_and_reconcile": eng.clock.seconds - clock0}

        # predicted kernel launches, from the shards: every int8 shard is
        # quantised for its persist and for its backup, and dequantised on
        # arrival; on save 2, only the changed ones
        n_int8 = sum(len(s) for s in int8_by_rank)
        n_int8_changed = sum(len(s & c) for s, c in zip(int8_by_rank, changed))
        want = {"save1": {"quantize": 2 * n_int8, "dequantize": n_int8},
                "save2": {"quantize": 2 * n_int8_changed, "dequantize": n_int8_changed}}
        for key in want:
            check(launches[key] == want[key], f"{key}: launches {launches[key]}, want {want[key]}")

        # restores: cache, then ring backup (node 0 lost), then the store
        # (node 1 lost too, which held node 0's backup)
        restores = {}
        saved2 = shard_state(flat2, n_nodes)
        for name, fail, sources in (
                ("cache", None, {"cache": n_nodes, "backup": 0, "store": 0, "store_full": 0}),
                ("backup", 0, {"cache": 1, "backup": 1, "store": 0, "store_full": 0}),
                ("store", 1, {"cache": 0, "backup": 0, "store": n_nodes, "store_full": 0})):
            if fail is not None:
                eng.node_failed(fail)
            qb_ops.LAUNCHES.update(quantize=0, dequantize=0)
            c0 = eng.clock.seconds
            t0 = time.perf_counter()
            got_step, got = eng.restore()
            wall = time.perf_counter() - t0
            launches[f"restore_{name}"] = dict(qb_ops.LAUNCHES)
            check(got_step == s2, f"{name} restore gave step {got_step}, want {s2}")
            check(eng.stats["restore_sources"] == sources,
                  f"{name} restore sources {eng.stats['restore_sources']}, want {sources}")
            worst = _check_restored(got, saved2, fail, int8_by_rank, qb_ref)
            restores[name] = {"wall_s": wall, "gb_per_s": nbytes / wall / 1e9,
                              "modeled_s": eng.clock.seconds - c0,
                              "max_err_half_steps": worst,
                              "launches": launches[f"restore_{name}"]}
            if name == "store":
                restored = unflatten_like({"params": params}, got)["params"]
                with torch.no_grad():
                    loss_restored = float(loss_fn(restored, cfg, batch)[0])
                del restored
                rel = abs(loss_restored - loss_saved) / abs(loss_saved)
                check(rel <= RESTORE_LOSS_REL_TOL,
                      f"loss {loss_saved} saved vs {loss_restored} restored (rel {rel})")
                restores[name].update(loss_saved=loss_saved, loss_restored=loss_restored,
                                      loss_rel_diff=rel)
            del got
        check(launches["restore_cache"] == launches["restore_backup"]
              == {"quantize": 0, "dequantize": 0}, f"restore launches {launches}")
        check(launches["restore_store"] == {"quantize": 0, "dequantize": n_int8},
              f"store restore launches {launches['restore_store']}, want {n_int8} dequantise")
        check(rec.errors == [], f"reconciler errors: {rec.errors}")
        out["restores"] = restores
        out["launches_by_stage"] = launches
        out["launches"] = {k: sum(v[k] for v in launches.values())
                           for k in ("quantize", "dequantize")}
        out["reconciler"] = {"errors": rec.errors, "passes": rec.passes, **rec.stats}
    finally:
        eng.close()
        shutil.rmtree(root, ignore_errors=True)
    emit(out)
    return out


def _leg_times(rows, nbytes, steps):
    """Per step: the wall seconds of one reconciler leg summed over ranks."""
    per = {s: sum(t for st, _r, t, _t0 in rows if st == s) for s in steps}
    return {str(s): {"wall_s": w, "gb_per_s": nbytes / w / 1e9 if w else None}
            for s, w in per.items()}


def _check_restored(got, saved, failed, int8_by_rank, qb_ref):
    """Every restored shard against the saved one: a rank served from its
    cache is bit-exact; a rank served through the int8 codec (its backup or
    the store) is bit-exact with the plain round trip on the card for its
    int8 leaves and byte-exact for the rest. Returns the worst error in
    half steps."""
    from repro_torch.core.tce import shard_state
    worst = 0.0
    for r, shards in enumerate(shard_state(got, len(saved))):
        through_codec = failed is not None and r <= failed
        for path, (_sp, arr) in shards.items():
            want = saved[r][path][1]
            if not through_codec or path not in int8_by_rank[r]:
                check(arr.tobytes() == want.tobytes(), f"rank {r} {path} changed")
                continue
            x = torch.from_numpy(want).to("cuda")
            y = torch.from_numpy(np.ascontiguousarray(arr)).to("cuda")
            _q, s, plain = plain_codec(qb_ref, x)
            check(same(y, plain), f"rank {r} {path}: restored != plain dequant(plain quant)")
            flat_err = (x - y).reshape(-1)
            pad = (-flat_err.numel()) % QB_BLOCK
            err = torch.cat([flat_err, flat_err.new_zeros(pad)]).reshape(-1, QB_BLOCK)
            worst = max(worst, float((err.abs().amax(dim=-1) / s).max()) * 2)
            del x, y, plain, s, err, flat_err
    check(worst <= HALF_STEP_SLACK, f"restored error {worst} half-steps, want <= 1")
    return worst


SINGLE_ARGS = ["--substrate", "single", "--arch", "llama3-8b", "--reduced", "--steps", "30",
               "--ckpt-every", "10", "--log-every", "10", "--device", "cuda"]


def phase_train_single(qb_ops, qb_ref):
    """The launcher's in-process loop on the card (``launch.train.main``, not
    a subprocess: a CUDA spawn costs ~20 s): 30 steps of the reduced arch
    with a raw checkpoint every 10; the last step deleted (chain-safe) and
    the run resumed from step 20 to the same final loss, bit for bit; then
    the same with the int8 codec, whose persists and restore go through the
    quant kernels from the reconciler's thread."""
    from repro_torch.core.tce import DiskStore
    from repro_torch.launch import train as train_cli

    out = {"phase": "train_single", "args": SINGLE_ARGS}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_single_"))
    launches = {"quantize": 0, "dequantize": 0}
    try:
        def run(name, *extra):
            qb_ops.LAUNCHES.update(quantize=0, dequantize=0)
            t0 = time.perf_counter()
            rc = train_cli.main(SINGLE_ARGS + list(extra) + ["--json", str(root / f"{name}.json")])
            wall = time.perf_counter() - t0
            check(rc == 0, f"train --substrate single {' '.join(extra)} exited {rc}")
            rep = json.loads((root / f"{name}.json").read_text())
            check(rep["completed"] and math.isfinite(rep["final_loss"]), f"{name}: {rep}")
            for k in launches:
                launches[k] += qb_ops.LAUNCHES[k]
            out[name] = {"final_loss": rep["final_loss"], "wall_s": wall,
                         "launches": dict(qb_ops.LAUNCHES)}
            return rep, dict(qb_ops.LAUNCHES)

        def int8_written(store, step):      # quantised by that step's persist
            return sum(e.get("enc") == "int8" for e in store.rank_index(step, 0))

        def int8_read(store, step):         # dequantised by a restore of it
            return sum(_resolved_enc(store, e) == "int8" for e in store.rank_index(step, 0))

        raw, int8 = root / "raw", root / "int8"
        a, la = run("raw", "--codec", "raw", "--ckpt-dir", str(raw))
        check(la == {"quantize": 0, "dequantize": 0}, f"raw run launched {la}")
        DiskStore(str(raw)).delete_step(30)
        b, _ = run("raw_resumed", "--codec", "raw", "--ckpt-dir", str(raw), "--resume")
        check(b["final_loss"] == a["final_loss"],
              f"resumed final loss {b['final_loss']} != {a['final_loss']}")
        c, lc = run("int8", "--codec", "int8", "--ckpt-dir", str(int8))
        store = DiskStore(str(int8), device="cuda")
        want_q = sum(int8_written(store, s) for s in (10, 20, 30))
        check(lc == {"quantize": want_q, "dequantize": 0} and want_q > 0,
              f"int8 run launched {lc}, want {want_q} quantise")
        check(c["final_loss"] == a["final_loss"],
              f"int8 run's final loss {c['final_loss']} != raw run's {a['final_loss']}")
        store.delete_step(30)
        d, ld = run("int8_resumed", "--codec", "int8", "--ckpt-dir", str(int8), "--resume")
        want = {"quantize": int8_written(store, 30), "dequantize": int8_read(store, 20)}
        check(ld == want, f"int8 resume launched {ld}, want {want}")
        rel = abs(d["final_loss"] - a["final_loss"]) / abs(a["final_loss"])
        check(rel <= RESTORE_LOSS_REL_TOL,
              f"int8-resumed final loss {d['final_loss']} vs {a['final_loss']} (rel {rel})")
        out.update(bit_identical=True, int8_resumed_loss_rel_diff=rel,
                   int8_loss_rel_tol=RESTORE_LOSS_REL_TOL, launches=launches)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    emit(out)
    return out


def _resolved_enc(store, ent):
    """The encoding of the file an index entry (or its delta ref) names."""
    if "file" in ent:
        return ent.get("enc")
    home = {e["spec"]["path"]: e for e in store.rank_index(int(ent["ref_step"]), 0)}
    return home[ent["spec"]["path"]].get("enc")


def phase_worker():
    """The port's rank worker on the card: a SIGKILL in a save, a restore;
    with the ``raw`` and the ``int8`` codec, in two threads at once (each
    spends most of its time waiting for its worker processes to reach the
    card; each worker writes its own log). So its two timings,
    ``spawn_s_contended`` and ``steps_5_8_wall_s_contended``, are taken
    while the other codec's worker spawns and trains on the same card and
    host: they do not compare with the sequential runs' ``spawn_s`` and
    ``steps_5_8_wall_s`` before this phase ran both at once."""
    from concurrent.futures import ThreadPoolExecutor

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

    def one(root, codec):
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
        return {"losses": losses, "losses_restored": losses_again,
                "bit_identical": losses_again == losses
                and digest_again["leaves"] == digest["leaves"],
                "int8_leaves": n_int8, "spawn_s_contended": spawn_s,
                "steps_5_8_wall_s_contended": tail["wall_s"]}

    out = {"phase": "worker", "spec": spec, "concurrent": ["raw", "int8"]}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_worker_") as root, \
            ThreadPoolExecutor(max_workers=2) as pool:
        futures = {codec: pool.submit(one, root, codec) for codec in ("raw", "int8")}
        for codec, fut in futures.items():
            out[codec] = fut.result()
    emit(out)
    return out


CAPSTONE_KW = dict(n_ranks=2, n_spares=2, seed=0, total_steps=24, batch=2, seq=16, lr=3e-4)
CAPSTONE_CFG = dict(total_steps=24, ckpt_every=6, seed=0)
CAPSTONE_KILLS = ((9, 1), (17, 0))
# the stalled-rank run (tests/test_substrate.py:238-262): four ranks, since
# slow-rank attribution is consensus-based and needs a healthy majority;
# rank 1 SIGSTOPped for 2 s at step 9
STALL_RANKS, STALL = 4, (9, 1, 2.0)


def phase_capstone():
    """The TRANSOM recovery loop on the card: two torch rank processes, each
    with its own CUDA context, train under the port's ``run_protected`` with
    the TEE on; ranks 1 and 0 are SIGKILLed at steps 9 and 17, the streaming
    TEE scores each dead rank, TOL checks and evicts their nodes, claims
    spares and restores from the TCE checkpoint; the merged loss curve must
    equal an uninterrupted run's bit for bit. Then four ranks, one of them
    SIGSTOPped: no restart, and the TEE names the stalled rank. The ranks
    train the reduced arch (1 layer) through the plain attention and
    checkpoint with the ``raw`` codec, as the reference's process ranks do:
    no hand-written kernel runs on this path."""
    from repro_torch.core.tol import error_check_tasks
    from repro_torch.substrate.driver import DriveConfig, KillSpec, StallSpec, run_protected
    from repro_torch.substrate.process import ProcessSubstrate

    checks = error_check_tasks(device="cuda")
    check(all(c.ok for c in checks), f"error checks on the card: {checks}")
    runs, spawns, per_run = {}, [], {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_capstone_") as root:
        for name, kills, stalls, kw in (
                ("faulty", CAPSTONE_KILLS, (), {}),
                ("clean", (), (), {}),
                ("stall", (), (STALL,), {"n_ranks": STALL_RANKS, "n_spares": 0})):
            sub = ProcessSubstrate(ckpt_dir=str(Path(root) / name), device="cuda",
                                   **dict(CAPSTONE_KW, **kw))
            check(sub.tee is not None, "the process substrate runs without its TEE")
            try:
                runs[name] = run_protected(sub, DriveConfig(scenario="capstone", **CAPSTONE_CFG),
                                           tuple(KillSpec(s, r) for s, r in kills),
                                           tuple(StallSpec(*st) for st in stalls))
            finally:
                sub.close()
            spawns += sub.spawn_log
            per_run[name] = len(sub.spawn_log)
    faulty, clean, stall = runs["faulty"], runs["clean"], runs["stall"]
    check(faulty["completed"] and clean["completed"], "a capstone run did not complete")
    check(faulty["restarts"] == {"inplace": 0, "resched": 2},
          f"restarts {faulty['restarts']}, want 2 reschedules")
    check(faulty["decisions"]["by_decision"] == {"claim_spare": 2},
          f"decisions {faulty['decisions']['by_decision']}, want 2 spare claims")
    check(faulty["tee_verdicts"] >= len(CAPSTONE_KILLS),
          f"{faulty['tee_verdicts']} TEE verdicts for {len(CAPSTONE_KILLS)} dead ranks")
    check(clean["restarts"] == {"inplace": 0, "resched": 0}, f"clean run restarted: {clean}")
    check([e[0] for e in faulty["losses"]] == list(range(1, 25)),
          f"merged curve steps {[e[0] for e in faulty['losses']]}")
    check(all(math.isfinite(v) for _, v in faulty["losses"]), "non-finite loss")
    check(faulty["losses"] == clean["losses"], "the merged curve differs from the clean run's")
    check(all(s["device"] == "cuda:0" for s in spawns),
          f"ready lines name {sorted({s['device'] for s in spawns})}, want cuda:0")
    # the stalled rank (tests/test_substrate.py's own checks)
    check(stall["completed"] and stall["restarts"] == {"inplace": 0, "resched": 0},
          f"stall run: completed {stall['completed']}, restarts {stall['restarts']}")
    att = stall["measured"]["stall_attribution"]
    check(len(att) == 1 and att[0]["stalled_ranks"] == [STALL[1]], f"stall attribution {att}")
    a = att[0]
    check(a["slowest_rank"] == STALL[1] and a["slowdown"] > 1.3 and a["anomalous"]
          and STALL[1] in a["attributed_ranks"] and 0.0 < a["confidence"] <= 1.0,
          f"stall attribution {a}")
    wall = {k: r["measured"]["wall_s"] for k, r in runs.items()}
    out = {"phase": "capstone", "settings": dict(CAPSTONE_KW, **CAPSTONE_CFG),
           "kills": [list(k) for k in CAPSTONE_KILLS],
           "error_checks": {c.name: {"ok": c.ok, "seconds": c.elapsed_s} for c in checks},
           "wall_s": wall, "recovery_cost_s": wall["faulty"] - wall["clean"],
           "spawns": per_run, "spawn_count": len(spawns),
           "spawn_s_median": statistics.median(s["spawn_s"] for s in spawns),
           "lost_steps": faulty["lost_steps"], "restarts": faulty["restarts"],
           "decisions": faulty["decisions"]["by_decision"],
           "tee_verdicts": {k: r["tee_verdicts"] for k, r in runs.items()},
           "final_loss": faulty["final_loss"], "bit_identical": True,
           "stall": {"ranks": STALL_RANKS, "spec": list(STALL), "attribution": a},
           "timeline_digest": {k: r["timeline_digest"] for k, r in runs.items()}}
    emit(out)
    return out


# The closed loop (tests/test_system.py::test_closed_loop_recovers_real_lm_training
# at full size): mamba2-130m at full width and depth in float32, 4 x 1024
# tokens a step, under TransomOperator over a 4-node modelled cluster with 4
# spares, a TCE checkpoint every 5 steps, node faults at steps 13 and 27.
# 28 steps, not the reference's 40: one past the last fault. The int8
# run's saves take ~55 s each on the reconciler's host thread (zlib of the
# lossless moments), and 40 steps would take the script past ~900 s.
LOOP_ARCH = "mamba2-130m"
LOOP_OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=60, grad_clip=1.0)
# The int8 run keeps its Adam moments in bf16 (AdamConfig.moment_dtype). The
# codec keeps every optimizer leaf lossless through zlib, once for the
# persist and once for the backup, on the reconciler's one host thread;
# float32 moments, two thirds of the state, make that 2.7 GB of zlib a save,
# more than a minute at the host's rate (the phase measures it): past the
# engine's 60 s window of pipelined durability, so saves pile up behind the
# reconciler and a fault falls back more than the reference's two intervals.
# (int8 moments, a quarter of the bytes, make this training diverge.)
LOOP_INT8_MOMENTS = "bfloat16"
LOOP_BATCH, LOOP_SEQ, LOOP_NODES, LOOP_SPARES = 4, 1024, 4, 4
LOOP_JOB = dict(total_steps=28, ckpt_every=5, n_sim_nodes=LOOP_NODES)
# The engine's pipelined durability: save(N) first waits for save(N-1) to
# be persisted and backed up, which bounds a fault's loss to two intervals
# (the reference test's lost-steps bound) only while the wait outlasts a
# save's reconcile. The default 60 s is within 10% of what an int8 save
# takes here, so the wait is the script's own TCE wait (TCE_WAIT_S).
LOOP_DURABLE_S = TCE_WAIT_S
LOOP_FAULTS = {13: ("node_hw", 1), 27: ("network", 2)}
# recovered vs uninterrupted final params, rtol = atol (tests/test_system.py:82-85)
LOOP_PARAM_TOL = 1e-6
# what the phase's last line repeats of each run's own line
LOOP_SUMMARY = ("moment_dtype", "wall_s", "steps_per_s", "lost_steps", "resumed_from",
                "fault_to_running_s", "modeled_downtime_s", "restore_sources", "tee_verdicts",
                "decisions", "launches")


def _parse_resumes(report):
    """The step each recovery resumed from (the FSM's ``resumed from step N``)."""
    return [int(why.rsplit(" ", 1)[1]) for _t, s, why in report.state_history
            if s == "running" and why.startswith("resumed from step")]


def _tee_polls(resumes, faults, total, every):
    """The operator's TEE count on a schedule: one per fault, and one per
    executed step that ends on a multiple of ``every``, replays included."""
    polls, start = len(faults), 0
    for end, resume in zip(sorted(faults) + [total], list(resumes) + [None]):
        polls += sum(1 for s in range(start + 1, end + 1) if s % every == 0)
        start = resume
    return polls


def phase_closed_loop(qb_ops, qb_ref):
    """The paper's closed loop on the card: ``TransomOperator.run_job`` trains
    mamba2-130m at full width and depth through two node faults (TOL evicts,
    claims spares; the TEE attributes; TCE restores), three times from one
    exported set of weights: with the ``raw`` codec, without faults, and with
    the ``int8`` codec, whose persists, backups and restores quantise and
    dequantise through the hand-written kernels from the reconciler's thread."""
    from repro_torch import deterministic
    from repro_torch.configs import get_config
    from repro_torch.core.tce import (DiskStore, TCEConfig, TCEngine, crc32_stream,
                                      flatten_pytree, shard_state, unflatten_like)
    from repro_torch.core.tce import reconciler as rec_mod
    from repro_torch.core.tce import store as store_mod
    from repro_torch.core.tee import TEEService
    from repro_torch.core.tol import (ClusterSim, JobConfig, JobState, TransomOperator,
                                      TransomServer)
    from repro_torch.core.tol.cluster import NodeState
    from repro_torch.core.tol.orchestrator import SimulatedFault
    from repro_torch.data import SyntheticLMData
    from repro_torch.substrate.sim import _fitted_tee
    from repro_torch.train import AdamConfig, TrainConfig, init_train_state, make_train_step

    deterministic("cuda")
    cfg = dataclasses.replace(get_config(LOOP_ARCH), compute_dtype="float32")
    opts = {"float32": AdamConfig(**LOOP_OPT),
            LOOP_INT8_MOMENTS: AdamConfig(**LOOP_OPT, moment_dtype=LOOP_INT8_MOMENTS)}
    data = SyntheticLMData(cfg.vocab_size, LOOP_SEQ, LOOP_BATCH, seed=SEED)
    inner = {k: make_train_step(cfg, o, TrainConfig(attn_impl="chunked")) for k, o in opts.items()}
    templates = {k: init_train_state(cfg, o, seed=SEED, device="cuda") for k, o in opts.items()}
    init_flat = flatten_pytree(templates["float32"])   # the one exported set of weights
    # each run's initial state: the exported params, zero moments of its dtype
    init_flats = {k: {**flatten_pytree(t), **{p: a for p, a in init_flat.items()
                                              if p.startswith("params/")}}
                  for k, t in templates.items()}
    state_gb = sum(a.nbytes for a in init_flat.values()) / 1e9
    per_rank = [sum(d.nbytes for _sp, d in sh.values()) for sh in shard_state(init_flat, LOOP_NODES)]
    # each node holds two cycles of its own shards and of its neighbour's
    # backup, plus a page of rounding per leaf
    mem_limit = max(2 * (per_rank[r] + per_rank[r - 1]) for r in range(LOOP_NODES)) \
        + 2 * 4096 * 2 * len(init_flat)
    # the leaves the int8 codec quantises (float, off the lossless globs)
    int8_paths = int8_paths_of({p: (None, a) for p, a in init_flat.items()},
                               TCEConfig().lossless_paths)
    tee = TEEService(_fitted_tee(n_ranks=LOOP_NODES))   # fitted once a process
    job = JobConfig(**LOOP_JOB)

    # every int8 encode and decode of the codec, by caller: each must launch
    # its kernel exactly once
    codec_calls = {"encode": 0, "decode": 0}

    def counting(mod):
        enc, dec = mod.encode_shard, mod.decode_shard

        def encode_shard(*a, **k):
            out = enc(*a, **k)
            codec_calls["encode"] += out[0] == "int8"
            return out

        def decode_shard(encoding, *a, **k):
            codec_calls["decode"] += encoding == "int8"
            return dec(encoding, *a, **k)
        return enc, dec, encode_shard, decode_shard

    def run(name, codec, state0, step_fn, toy=False):
        """One ``run_job`` over the fault schedule, instrumented at the
        operator's seams (save, restore, quiesce, FSM, TEE); ``toy``: on the
        CPU, each step waiting for the reconciler first, so that no fault
        races a save."""
        device = "cpu" if toy else "cuda"
        root = tempfile.mkdtemp(prefix=f"chip_smoke_loop_{name}_")
        cluster = ClusterSim(n_nodes=LOOP_NODES, n_spares=LOOP_SPARES)
        tce = TCEngine(TCEConfig(n_nodes=LOOP_NODES, codec=codec,
                                 durability_timeout_s=LOOP_DURABLE_S,
                                 **({} if toy else {"mem_limit_bytes": mem_limit})),
                       DiskStore(root, device=device))
        op = TransomOperator(TransomServer(), cluster, tce, tee, device=device)
        rec = tce.reconciler
        rec_run = {"saves": [], "restores": [], "quiesce": [], "faults": [], "verdicts": [],
                   "running_after_fault_s": [], "saved": {}, "restored": [],
                   "legs": {"persist": [], "backup": []}}
        fired = set()

        def hook(step):
            if step in LOOP_FAULTS and step not in fired:
                fired.add(step)
                cat, rank = LOOP_FAULTS[step]
                node = op.launchers[rank].node
                cluster.nodes[node].state = NodeState.FAILED
                cluster.nodes[node].fail_category = cat
                rec_run["faults"].append({"step": step, "rank": rank, "category": cat,
                                          "t": time.perf_counter(),
                                          "saves_in_flight": rec._pending()})
                raise SimulatedFault(cat, rank)

        to = op.fsm.to

        def fsm_to(state, reason=""):
            to(state, reason)
            if state == JobState.RUNNING and rec_run["faults"] and \
                    len(rec_run["running_after_fault_s"]) < len(rec_run["faults"]):
                rec_run["running_after_fault_s"].append(
                    time.perf_counter() - rec_run["faults"][-1]["t"])
        op.fsm.to = fsm_to

        save, restore, quiesce, detect = tce.save, tce.restore, rec.quiesce, tee.detect_task

        def timed_save(step, state, **kw):
            t0 = time.perf_counter()
            flat = flatten_pytree(state)
            h = save(step, flat, **kw)
            rec_run["saves"].append({"step": step, "stall_s": time.perf_counter() - t0,
                                     "cache_wall_s": h.cache_wall_s,
                                     "t_s": time.perf_counter() - t_run})
            if codec == "int8":        # what a restore of this step is held to
                crcs = {(r, p): crc32_stream(d) for r, sh in enumerate(
                    shard_state({p: a for p, a in flat.items() if p not in int8_paths},
                                LOOP_NODES)) for p, (_sp, d) in sh.items()}
                rec_run["saved"].setdefault(step, []).append(
                    ({p: a for p, a in flat.items() if p in int8_paths}, crcs))
            return h

        def timed_restore(step=None, **k):
            if step is not None:      # the engine's own try of one candidate step
                return restore(step=step, **k)
            t0 = time.perf_counter()
            got_step, flat = restore(**k)
            rec_run["restores"].append({"step": int(got_step),
                                        "wall_s": time.perf_counter() - t0,
                                        "sources": dict(tce.stats["restore_sources"])})
            if codec == "int8":       # held to the saved copy before training moves on
                rec_run["restored"].append(_check_loop_restore(
                    int(got_step), flat, rec_run["saved"].get(int(got_step)),
                    rec_run["restores"][-1]["sources"], qb_ref, crc32_stream))
            return got_step, flat

        def timed_quiesce(timeout=30.0):
            t0 = time.perf_counter()
            ok = quiesce(timeout)
            rec_run["quiesce"].append({"timeout_s": timeout, "ok": ok,
                                       "wall_s": time.perf_counter() - t0})
            return ok

        def recorded_detect(trace):
            v = detect(trace)
            rec_run["verdicts"].append({"anomalous": bool(v.anomalous),
                                        "bad_ranks": list(v.bad_ranks),
                                        "label": trace.label})
            return v

        def settled(state, step):
            quiesce(10)
            return step_fn(state, step)

        if not toy:
            tce.save, tce.restore, rec.quiesce = timed_save, timed_restore, timed_quiesce
            # the wall time of each reconciler leg, per rank and step (a
            # timing wrapper only: each leg runs as the library runs it)
            for leg in ("persist", "backup"):
                def timed_leg(cache, step, shards, digmap, _orig=getattr(rec, f"_{leg}"),
                              _rows=rec_run["legs"][leg]):
                    t0 = time.perf_counter()
                    _orig(cache, step, shards, digmap)
                    _rows.append({"step": step, "rank": cache.rank,
                                  "wall_s": time.perf_counter() - t0,
                                  "t_s": t0 - t_run})
                setattr(rec, f"_{leg}", timed_leg)
        tee.detect_task = recorded_detect
        t0 = t_run = time.perf_counter()
        try:
            report, final = op.run_job(job, state0, settled if toy else step_fn,
                                       fault_hook=hook)
            wall = time.perf_counter() - t0
            durable = quiesce(120)
            check(durable and rec.errors == [],
                  f"{name}: reconciler quiesced {durable}, errors {rec.errors}")
        finally:
            del tee.detect_task
            tce.close()
            shutil.rmtree(root, ignore_errors=True)
        return report, final, wall, rec_run

    # the count the card's runs are held to: the same operator and schedule
    # on the CPU over a numpy step
    toy, _, _, _ = run("toy", "raw", np.zeros((4, 4), np.float32),
                       lambda s, i: s + np.float32(1.0), toy=True)
    check(toy.completed and toy.restarts_resched == 2, f"toy run: {toy}")

    def card_step(losses, moments):
        def step_fn(state, step):
            batch = {k: torch.from_numpy(v).to("cuda") for k, v in data.batch_at(step).items()}
            state, metrics = inner[moments](state, batch)
            losses.append((step, float(metrics["loss"])))
            return state
        return step_fn

    out = {"phase": "closed_loop", "arch": LOOP_ARCH, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_params": cfg.n_params(), "compute_dtype": "float32",
           "batch": LOOP_BATCH, "seq": LOOP_SEQ, "job": LOOP_JOB, "nodes": LOOP_NODES,
           "spares": LOOP_SPARES, "faults": {str(k): list(v) for k, v in LOOP_FAULTS.items()},
           "state_gb": state_gb, "mem_limit_gb": mem_limit / 1e9, "runs": {}}
    reports, finals, losses = {}, {}, {}
    try:
        for name, codec in (("raw", "raw"), ("clean", None), ("int8", "int8")):
            moments = LOOP_INT8_MOMENTS if codec == "int8" else "float32"
            losses[name] = []
            step_fn = card_step(losses[name], moments)
            state0 = unflatten_like(templates[moments], init_flats[moments])
            if codec is None:          # the uninterrupted run
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state = state0
                for s in range(LOOP_JOB["total_steps"]):
                    state = step_fn(state, s)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                finals[name] = state
                out["runs"][name] = {"wall_s": wall, "steps": len(losses[name]),
                                     "steps_per_s": len(losses[name]) / wall,
                                     "final_loss": losses[name][-1][1]}
                emit({"phase": "closed_loop_run", "run": name, **out["runs"][name]})
                continue
            if codec == "int8":
                qb_ops.LAUNCHES.update(quantize=0, dequantize=0)
                patches = [counting(m) for m in (rec_mod, store_mod)]
                for m, (_e, _d, enc, dec) in zip((rec_mod, store_mod), patches):
                    m.encode_shard, m.decode_shard = enc, dec
                codec_calls.update(encode=0, decode=0)
            try:
                report, final, wall, inst = run(name, codec, state0, step_fn)
            finally:
                if codec == "int8":
                    launches = dict(qb_ops.LAUNCHES)
                    for m, (e, d, _enc, _dec) in zip((rec_mod, store_mod), patches):
                        m.encode_shard, m.decode_shard = e, d
            reports[name], finals[name] = report, final
            resumes = _parse_resumes(report)
            row = {"moment_dtype": moments, "wall_s": wall, "steps": len(losses[name]),
                   "steps_per_s": len(losses[name]) / wall,
                   "final_loss": losses[name][-1][1], "completed": report.completed,
                   "restarts": {"inplace": report.restarts_inplace,
                                "resched": report.restarts_resched},
                   "evicted_nodes": report.evicted_nodes, "lost_steps": report.lost_steps,
                   "resumed_from": resumes,
                   "mean_restart_s_modeled": report.mean_restart_s,
                   "modeled_downtime_s": report.modeled_downtime_s,
                   "restore_sources": report.restore_sources,
                   "tee_verdicts": report.tee_verdicts, "tee": inst["verdicts"],
                   "decisions": [d["decision"] for d in report.decisions],
                   "saves": inst["saves"], "restores": inst["restores"],
                   "quiesce": inst["quiesce"],
                   "faults": [{k: v for k, v in f.items() if k != "t"} for f in inst["faults"]],
                   "fault_to_running_s": inst["running_after_fault_s"]}
            # the reference test's assertions (tests/test_system.py:72-78)
            check(report.completed, f"{name}: the job did not complete")
            check(report.restarts_resched == 2 and report.restarts_inplace == 0,
                  f"{name}: restarts {row['restarts']}, want 2 reschedules")
            check(len(report.evicted_nodes) == 2, f"{name}: evicted {report.evicted_nodes}")
            check(report.lost_steps <= 2 * (2 * LOOP_JOB["ckpt_every"]),
                  f"{name}: lost {report.lost_steps} steps")
            check(0 < report.mean_restart_s < 15 * 60,
                  f"{name}: mean restart {report.mean_restart_s} s")
            check([v["anomalous"] for v in inst["verdicts"]] == [True, True],
                  f"{name}: TEE verdicts {inst['verdicts']}")
            check(all(math.isfinite(v) for _s, v in losses[name]), f"{name}: non-finite loss")
            # the TEE's count, held to the toy run's; a restore that fell back
            # one interval further replays (and polls) more
            fell_back = [(f, r, t) for f, r, t in zip(sorted(LOOP_FAULTS), resumes,
                                                      _parse_resumes(toy)) if r != t]
            want_polls = _tee_polls(resumes, LOOP_FAULTS, LOOP_JOB["total_steps"],
                                    job.tee_every)
            check(report.tee_verdicts == (toy.tee_verdicts if not fell_back else want_polls),
                  f"{name}: tee_verdicts {report.tee_verdicts}, toy {toy.tee_verdicts}, "
                  f"fell back {fell_back}")
            row["tee_verdicts_toy"] = toy.tee_verdicts
            row["fell_back"] = [{"fault_step": f, "resumed_from": r, "toy_resumed_from": t}
                                for f, r, t in fell_back]
            if codec == "int8":
                row.update(_check_loop_int8(inst, report, launches, codec_calls, losses[name]))
            row["legs"] = {leg: {"n": len(rows), "wall_s": sum(r["wall_s"] for r in rows),
                                 "max_s": max((r["wall_s"] for r in rows), default=0.0)}
                           for leg, rows in inst["legs"].items()}
            out["runs"][name] = {k: row[k] for k in LOOP_SUMMARY if k in row}
            emit({"phase": "closed_loop_run", "run": name, **row,
                  "legs_timeline": inst["legs"]})

        # the recovered run against the uninterrupted one
        got, want = flatten_pytree(finals["raw"].params), flatten_pytree(finals["clean"].params)
        worst = max(float(np.max(np.abs(got[p] - want[p]))) for p in want)
        for p in want:
            check(np.allclose(got[p], want[p], rtol=LOOP_PARAM_TOL, atol=LOOP_PARAM_TOL),
                  f"raw run's {p} differs from the clean run's")
        out["raw_vs_clean"] = {"max_abs_diff": worst, "bit_identical": worst == 0.0,
                               "tol": LOOP_PARAM_TOL}
        # what float32 moments would cost the int8 run: the host's zlib rate
        # (the codec's level 1) on 32 MB of the largest trained moment leaf,
        # times the moments' bytes a save takes through zlib (persist and
        # backup)
        moments = flatten_pytree(finals["raw"].opt)
        path = max(moments, key=lambda k: moments[k].nbytes)
        sample = np.ascontiguousarray(moments[path]).reshape(-1)[:1 << 23]
        t0 = time.perf_counter()
        packed = zlib.compress(memoryview(sample).cast("B"), 1)
        rate = sample.nbytes / (time.perf_counter() - t0)
        zlib_gb = 2 * sum(a.nbytes for a in moments.values()) / 1e9
        out["float32_moments_zlib"] = {"leaf": f"opt/{path}", "mb": sample.nbytes / 1e6,
                                       "mb_per_s": rate / 1e6, "ratio": len(packed) / sample.nbytes,
                                       "gb_per_save": zlib_gb, "s_per_save": zlib_gb * 1e9 / rate}
        del moments, sample, packed
        # the int8 run decides as the raw run does
        raw, q8 = reports["raw"], reports["int8"]
        check([d["decision"] for d in q8.decisions] == [d["decision"] for d in raw.decisions],
              f"decisions {q8.decisions} vs {raw.decisions}")
        check((q8.restarts_inplace, q8.restarts_resched) ==
              (raw.restarts_inplace, raw.restarts_resched), "int8 run's restarts differ")
        check([s for _t, s, _w in q8.state_history] == [s for _t, s, _w in raw.state_history],
              "int8 run's FSM states differ from the raw run's")
        out["toy"] = {"tee_verdicts": toy.tee_verdicts, "lost_steps": toy.lost_steps,
                      "resumed_from": _parse_resumes(toy)}
        out["launches"] = out["runs"]["int8"]["launches"]
    finally:
        torch.use_deterministic_algorithms(False)
    emit(out)
    return out


def _check_loop_restore(step, flat, versions, sources, qb_ref, crc32_stream):
    """One restore of the int8 run against the saves of its step (a replayed
    step is saved again, and after an int8 restore its values differ): each
    shard of an int8 leaf equal to a saved one byte for byte (a cache that
    kept it) or to the plain codec's round trip of it on the card, bit for
    bit; every other shard equal to a saved one (its crc32). Returns the
    counts, and which save each rank's shards matched."""
    from repro_torch.core.tce import shard_state

    check(bool(versions), f"restore of step {step}: no saved copy kept")
    int8_paths = set(versions[0][0])
    got = shard_state(flat, LOOP_NODES)
    saved = [shard_state(v[0], LOOP_NODES) for v in versions]
    n_cache = n_codec = 0
    matched = {}
    for r, got_sh in enumerate(got):
        for path, (_sp, arr) in got_sh.items():
            if path not in int8_paths:
                hits = [i for i, v in enumerate(versions) if v[1][(r, path)] == crc32_stream(arr)]
                check(hits, f"restore of step {step}: rank {r} {path} matches no save")
            else:
                hits = [i for i, sv in enumerate(saved)
                        if arr.tobytes() == sv[r][path][1].tobytes()]
                if hits:
                    n_cache += 1
                else:
                    y = torch.from_numpy(np.ascontiguousarray(arr)).to("cuda")
                    for i, sv in enumerate(saved):
                        x = torch.from_numpy(np.ascontiguousarray(sv[r][path][1])).to("cuda")
                        if same(y, plain_codec(qb_ref, x)[2]):
                            hits.append(i)
                    check(hits, f"restore of step {step}: rank {r} {path} != plain "
                                f"dequant(plain quant) of any save of the step")
                    n_codec += 1
            matched[r] = matched.get(r, set(hits)) & set(hits)
    # a node failed before every restore: its shards came back through the
    # codec (its neighbour's decoded backup, or the store)
    check(n_codec > 0, f"restore of step {step} from {sources}: no shard came through the codec")
    return {"step": step, "sources": sources, "saves_of_step": len(versions),
            "int8_shards_bit_exact": n_cache, "int8_shards_plain_round_trip": n_codec,
            # per rank, the saves of the step that all its shards match (empty:
            # the rank's shards came from different saves of the step)
            "save_matched_by_rank": {str(r): sorted(h) for r, h in matched.items()}}


def _check_loop_int8(inst, report, launches, codec_calls, losses):
    """The int8 run: one kernel launch per int8 shard encoded or decoded, and
    the first replayed step's loss within RESTORE_LOSS_REL_TOL of its first
    pass (each restore was held to its save as it happened)."""
    want = {"quantize": codec_calls["encode"], "dequantize": codec_calls["decode"]}
    check(launches == want and want["quantize"] > 0 and want["dequantize"] > 0,
          f"int8 run launched {launches}, want {want} (one per int8 shard coded)")
    # the first replayed step after each restore against its first pass
    first_pass = {}
    for step, loss in losses:
        first_pass.setdefault(step, loss)
    replays = [(s, l) for (p, _), (s, l) in zip(losses, losses[1:]) if s <= p]
    resumes = _parse_resumes(report)
    check([s for s, _ in replays] == resumes, f"replays {replays}, resumes {resumes}")
    replay_rows = []
    for step, loss in replays:
        rel = abs(loss - first_pass[step]) / abs(first_pass[step])
        check(rel <= RESTORE_LOSS_REL_TOL,
              f"step {step}: replayed loss {loss} vs {first_pass[step]} (rel {rel})")
        replay_rows.append({"step": step, "first_pass": first_pass[step], "replayed": loss,
                            "rel_diff": rel})
    check(len(inst["restored"]) == len(inst["restores"]) > 0,
          f"{len(inst['restored'])} restores checked of {len(inst['restores'])}")
    return {"launches": launches, "int8_codec_calls": dict(codec_calls),
            "restore_checks": inst["restored"], "replayed_loss": replay_rows,
            "replayed_loss_rel_tol": RESTORE_LOSS_REL_TOL}


def load_example(name: str):
    """``examples/torch_<name>.py`` as a module, for its ``main(argv)``."""
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(kernels, engine, fa_ref):
    """The four examples of ``examples/torch_*.py`` on the card, in-process
    through their ``main(argv)``:

    * the serve demo, one ``main([arch])`` per reduced arch, its launches
      counted by variant against ``layer_counts``: llama3's prefill attention
      at head dim 16 on ``sm90`` (2 layers), mamba2's scan on the ``mma`` SSD
      kernel (p 16, n 16, chunk 32 are no sm90 shape; 2 layers), deepseek-v3's
      MLA on no kernel; then reduced llama's prefill logits, kernel against
      plain, and the D-16 kernel timed at that prefill's attention shape;
    * the quickstart: step 30 restored from the source its CPU run reports,
      the restored leaves equal to the saved ones byte for byte (the raw
      codec), finite losses on to step 40;
    * the anomaly demo's table, the CPU's;
    * the fault-tolerant example on ``--substrate sim``, its TOL burn-ins on
      the card: the CPU run's restarts and decisions, and loss continuity.

    The example's process mode is not run here: ``phase_capstone`` drives the
    same loop with CUDA ranks."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import init_params

    fa_ops = kernels["fa"]
    dev = torch.device("cuda")
    demo = load_example("serve_demo")
    serve = {}
    for arch in demo.ARCHS:
        cfg = get_config(arch).reduced()
        reset_counts(kernels)
        res = demo.main([arch, "--device", "cuda"])[arch]
        by_variant = {k: dict(ops.LAUNCHES_BY_VARIANT) for k, ops in kernels.items()}
        toks = torch.tensor(res["tokens"])
        check(tuple(toks.shape) == (demo.BATCH, demo.STEPS), f"{arch}: tokens {tuple(toks.shape)}")
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), f"{arch}: token out of range")
        counts = layer_counts(cfg)
        # the variant each kernel takes at the reduced configs' shapes
        demo_variant = {"fa": "sm90", "ssd": "mma"}
        want = {k: {v: counts[k] if v == demo_variant[k] else 0 for v in ops.LAUNCHES_BY_VARIANT}
                for k, ops in kernels.items()}
        check(by_variant == want, f"{arch}: launches {by_variant}, want {want}")
        serve[arch] = {"launches_by_variant": by_variant, "seconds": res["seconds"],
                       "sample": res["tokens"][0][:8]}
    check([serve[a]["launches_by_variant"]["fa"]["sm90"] for a in demo.ARCHS] == [2, 0, 0]
          and [serve[a]["launches_by_variant"]["ssd"]["mma"] for a in demo.ARCHS] == [0, 2, 0],
          f"serve demo launches {serve}")

    cfg = get_config("llama3-8b").reduced()
    params = engine.serve_params_cast(init_params(cfg, seed=0, device=dev), cfg)
    batch = {"tokens": make_prompts(cfg, demo.BATCH, demo.PROMPT, 1, dev)}
    with torch.inference_mode():
        got, _ = engine.prefill_fn(params, cfg, batch)
        plain, _ = engine.prefill_fn(params, cfg, batch, attn_impl="plain")
    diff = float((got.float() - plain.float()).abs().max())
    scale = float(plain.float().abs().max())
    check(diff <= LOGITS_REL_TOL * scale,
          f"reduced llama prefill logits kernel vs plain: {diff} > {LOGITS_REL_TOL} x {scale}")
    case = (demo.BATCH, demo.PROMPT, demo.PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
            True, torch.bfloat16)
    q, k, v = fa_inputs(case, seed=11)
    check(fa_ops.variant(q.dtype, cfg.d_head) == "sm90", "D 16 is not on sm90")
    err = float((fa_ops.flash_attention(q, k, v).float()
                 - fa_ref.attention_reference(q, k, v).float()).abs().max())
    check(err <= TOL[torch.bfloat16], f"D 16 kernel vs plain: {err}")
    bound_s, bound_by, _, _ = fa_bound(case)
    d16 = {"shape": list(case[:6]), "dtype": "bfloat16", "causal": True,
           "kernel_ms": time_ms(lambda: fa_ops.flash_attention(q, k, v)),
           "plain_ms": time_ms(lambda: fa_ref.attention_reference(q, k, v)),
           "library_ms": time_ms(sdpa_call(q, k, v, True)),
           "bound_ms": bound_s * 1e3, "bound_by": bound_by, "max_abs_err": err}
    del q, k, v, params

    qs = load_example("quickstart").main(["--device", "cuda"])
    check(qs["restored_step"] == 30 and qs["restore_sources"] == QUICKSTART_SOURCES,
          f"quickstart restored step {qs['restored_step']} from {qs['restore_sources']}")
    check(qs["restored_bit_exact"], "quickstart: restored leaves differ from the saved ones")
    check(qs["resumed_step"] == 40 and qs["resumed_finite"],
          f"quickstart resumed to {qs['resumed_step']}, losses {qs['resumed_losses']}")

    an = load_example("anomaly_detection_demo").main(["--device", "cuda"])
    check(an["table"] == ANOMALY_TABLE, f"anomaly table {an['table']}")

    ft = load_example("fault_tolerant_training").main(["--substrate", "sim",
                                                       "--device", "cuda"])
    rep = ft["report"]
    got_ft = {"completed": rep["completed"], "steps_done": rep["steps_done"],
              "restarts": rep["restarts"], "by_decision": rep["decisions"]["by_decision"]}
    check(got_ft == FT_SIM and ft["continuity"], f"fault-tolerant sim run {got_ft}, "
          f"continuity {ft['continuity']}, want {FT_SIM}")
    out = {"phase": "examples", "serve_demo": serve,
           "llama_prefill": {"logits_max_abs_diff": diff, "logits_scale": scale,
                             "logits_rel_tol": LOGITS_REL_TOL},
           "fa_sm90_d16": d16,
           "quickstart": {k: qs[k] for k in ("n_params", "save_losses", "restored_step",
                                             "restore_sources", "restored_bit_exact",
                                             "resumed_step", "resumed_losses")},
           "anomaly_table_equal": True,
           "fault_tolerant_sim": {**got_ft, "continuity": ft["continuity"],
                                  "lost_steps": rep["lost_steps"],
                                  "final_loss": rep["final_loss"]}}
    emit(out)
    return out


def phase_control_plane():
    """The scenario catalog, fleet, replay and sweep of ``repro_torch`` under
    this machine's Python and numpy: each of the 21 scenarios on
    ``device="cuda"`` (the closed-loop ones run their TOL burn-ins on the
    card) equal to its ``device="cpu"`` run in this script, the volatile
    ``measured`` block dropped (no report field names the device, so no
    other field is dropped); then one fleet preset, one replay preset and
    the sweep's default grid, each run twice and equal byte for byte (they
    touch no device)."""
    from repro_torch.fleet.presets import run_preset
    from repro_torch.report import strip_volatile
    from repro_torch.sim import scenarios
    from repro_torch.sim.replay import run_replay
    from repro_torch.sim.sweep import run_sweep

    t0 = time.perf_counter()
    names = sorted(scenarios.SCENARIOS)
    check(len(names) == 21, f"{len(names)} scenarios, want 21")
    digests, secs = {}, {}
    for name in names:
        t = time.perf_counter()
        card = scenarios.run_scenario(name, seed=0, device="cuda")
        secs[name] = round(time.perf_counter() - t, 3)
        host = scenarios.run_scenario(name, seed=0, device="cpu")
        check(json.dumps(strip_volatile(card), sort_keys=True)
              == json.dumps(strip_volatile(host), sort_keys=True),
              f"scenario {name}: card report != cpu report")
        check(card.get("one_clock", True) is not False, f"scenario {name}: one_clock false")
        digests[name] = card["timeline_digest"]
    twice = {}
    for what, run in ((f"fleet:{CP_FLEET}", lambda: run_preset(CP_FLEET, seed=0)),
                      (f"replay:{CP_REPLAY}", lambda: run_replay(CP_REPLAY, seed=0)),
                      (f"sweep:{CP_SWEEP}", lambda: run_sweep(CP_SWEEP, seed=0))):
        a, b = run(), run()
        check(json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True),
              f"{what}: two runs differ")
        twice[what] = a["timeline_digest"]
    out = {"phase": "control_plane", "scenarios": len(names), "digests": digests,
           "card_run_s": secs, "twice_equal": twice,
           "seconds": round(time.perf_counter() - t0, 2)}
    emit(out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.adamw import ops as adamw_ops
    from repro_torch.kernels.adamw import ref as adamw_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.quant_blockwise import ops as qb_ops
    from repro_torch.kernels.quant_blockwise import ref as qb_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import model as model_mod
    from repro_torch.serve import engine

    t0 = time.perf_counter()
    kernels = {"fa": fa_ops, "ssd": ssd_ops}
    card = phase_device()
    phase_build(_build)
    timing = phase_kernel(fa_ops, fa_ref)
    torch.cuda.empty_cache()
    launches, _, _ = phase_serve(kernels, serve_cli, engine, get_config(ARCH), REQUESTS,
                                 PROMPT_LEN, GEN, {"fa": "sm90"})
    torch.cuda.empty_cache()
    f32_launches = phase_decode_check(engine, model_mod, fa_ops, ARCH, variant="tf32x3")
    torch.cuda.empty_cache()
    ssd_timing = phase_ssd_kernel(ssd_ops, ssd_ref)
    torch.cuda.empty_cache()
    ssd_launches, _, _ = phase_serve(kernels, serve_cli, engine, get_config(SSM_ARCH),
                                     SSM_REQUESTS, SSM_PROMPT_LEN, SSM_GEN, {"ssd": "sm90"})
    torch.cuda.empty_cache()
    ssd_checks = phase_decode_check(engine, model_mod, ssd_ops, SSM_ARCH, variant="tf32x3",
                                    kind="ssd")
    ssd_checks += phase_f32_prefill_check(engine, model_mod, ssd_ops, SSM_ARCH, "tf32x3")
    torch.cuda.empty_cache()
    meshes = parallel_open()
    families = phase_families(kernels, serve_cli, engine, model_mod, meshes["data_model"])
    # the encoder-decoder's and the VLM's serve times beside the card
    emit({"phase": "family_times", "card": card, **{
        arch: {k: families[arch][k] for k in ("prefill_ms", "first_prefill_ms",
                                             "decode_ms_per_step", "peak_mem_gb")}
        for arch in ("whisper-tiny", "qwen2-vl-2b")}})
    torch.cuda.empty_cache()
    examples = phase_examples(kernels, engine, fa_ref)
    phase_control_plane()
    torch.cuda.empty_cache()
    quant = phase_quant_kernel(qb_ops, qb_ref)
    torch.cuda.empty_cache()
    adamw = phase_adamw_kernel(adamw_ops, adamw_ref)
    torch.cuda.empty_cache()
    # AdamW kernel launches (its update pass) by in-process path: every
    # float32 tree on the card takes it
    adamw_paths = {}

    def adamw_count(path, fn, *args):
        before = adamw_ops.LAUNCHES["update"]
        got = fn(*args)
        adamw_paths[path] = adamw_ops.LAUNCHES["update"] - before
        return got

    cfg, state, data, step_fn, train = adamw_count("train", phase_train, fa_ops)
    ckpt = phase_checkpoint(cfg, state, data, qb_ops, qb_ref)
    engine_run = adamw_count("tce_engine", phase_tce_engine, cfg, state, data, step_fn, train,
                             qb_ops, qb_ref)
    par_step = adamw_count("parallel_step", phase_parallel_step, cfg, state, data,
                           meshes["pod"])
    del state, step_fn
    torch.cuda.empty_cache()
    parallel_close(card, meshes, families["parallel_moe"], par_step)
    phase_worker()
    phase_capstone()
    single = adamw_count("train_single", phase_train_single, qb_ops, qb_ref)
    torch.cuda.empty_cache()
    loop = adamw_count("closed_loop", phase_closed_loop, qb_ops, qb_ref)
    fa_paths = {"serve_llama": launches["fa"],
                "serve_olmoe": families["olmoe-1b-7b"]["launches"]["fa"],
                "parallel_olmoe_mesh": families["parallel_moe"]["launches"]["fa"],
                "serve_jamba": families["jamba-v0.1-52b"]["launches"]["fa"],
                "serve_whisper": families["whisper-tiny"]["launches"]["fa"],
                "serve_qwen2_vl": families["qwen2-vl-2b"]["launches"]["fa"],
                "examples_serve_llama":
                examples["serve_demo"]["llama3-8b"]["launches_by_variant"]["fa"]["sm90"]}
    # tf32x3: every float32 attention on the card, the decode checks' forward
    # and prefill (llama3-8b and qwen2-vl-2b at 2 layers, whisper-tiny's 4
    # encoder, 4 decoder and 4 cross attentions)
    f32_paths = {"decode_check_llama": f32_launches,
                 "decode_check_whisper": families["decode_f32_whisper-tiny"],
                 "decode_check_qwen2_vl": families["decode_f32_qwen2-vl-2b"]}
    check(list(f32_paths.values()) == [4, 24, 4], f"float32 decode-check launches {f32_paths}")
    # sm90 beside its main shape: the small head dims (the rate cases at D
    # 16 and 32 and the serve demo's D-16 prefill shape)
    small_d = {f"d{c['shape'][5]}_{c['shape'][0]}x{c['shape'][1]}": c
               for c in timing["sm90_small_d"] + [examples["fa_sm90_d16"]]}
    entries = []
    for name, kind, src, by_path, others in (
            ("flash_attention_fwd", "sm90", "flash_attention_sm90.cu", fa_paths,
             {"small_head_dims": small_d}),
            ("flash_attention_fwd_tf32x3", "tf32x3", "flash_attention_f32_sm90.cu", f32_paths,
             {})):
        t = timing[kind]
        entries.append({
            "name": name, "route": "cuda", "source": FA_SRC + src, "replaces": FA_REPLACES,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": t["max_abs_err"], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "roofline_share": t["roofline_share"],
            "dtype": t["dtype"], "shape": t["shape"],
            # the head dims each dtype takes on this kernel
            "head_dims": {str(dt).split(".")[1]: [d for d in fa_ops.SUPPORTED_D
                                                  if fa_ops.variant(dt, d) == kind]
                          for dt in fa_ops._DTYPE_CODE}, **others})
    for name, line, key, count in (("quantize_blockwise", 18, "quantize", "quant_launches"),
                                   ("dequantize_blockwise", 29, "dequantize", "dequant_launches")):
        t = quant[key]
        # launches: the checkpoint phase's, the engine phase's (both saves
        # and backups, and the restores) and the closed loop's int8 run,
        # with the split beside them
        by_path = {"checkpoint": ckpt[count], "tce_engine": engine_run["launches"][key],
                   "closed_loop": loop["launches"][key],
                   "train_single": single["launches"][key]}
        entries.append({
            "name": name, "route": "cuda", "source": QB_SRC, "replaces": f"{QB_REPLACES}:{line}",
            "launches": by_path["checkpoint"] + by_path["tce_engine"] + by_path["closed_loop"],
            "launches_by_path": by_path, "max_abs_err": quant["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    # tf32x3: every float32 scan on the card, mamba2's decode check (4) and
    # full-depth prefill check (24), jamba's decode check (4); mma: the
    # serve demo's reduced mamba2 prefill, bf16 at p 16
    ssd_paths = {
        "sm90": {"serve_mamba2": ssd_launches["ssd"],
                 "serve_jamba": families["jamba-v0.1-52b"]["launches"]["ssd"]},
        "tf32x3": {"decode_check_jamba": families["decode_ssd_f32"],
                   "f32_checks_mamba2": ssd_checks},
        "mma": {"examples_serve_mamba2":
                examples["serve_demo"]["mamba2-130m"]["launches_by_variant"]["ssd"]["mma"]}}
    check(ssd_paths["tf32x3"] == {"decode_check_jamba": 4, "f32_checks_mamba2": 28},
          f"float32 SSD launches {ssd_paths['tf32x3']}")
    # sm90 at mamba2's shape with jamba's beside it; tf32x3 at mamba2's in
    # float32 with the float32 prefill check's beside it; mma at jamba's
    # bf16 shape in views TMA cannot read, with the bf16 p-32 case, the
    # serve demo's and mamba2's shape in those views beside it
    for name, kind, src, key, others in (
            ("ssd_scan", "sm90", "ssd_scan_sm90.cu", "sm90", {"jamba_shape": "sm90_jamba"}),
            ("ssd_scan_tf32x3", "tf32x3", "ssd_scan_f32_sm90.cu", "tf32x3",
             {"prefill_check_shape": "tf32x3_prefill"}),
            ("ssd_scan_mma", "mma", "ssd_scan_mma_sm90.cu", "mma_jamba",
             {"p32_shape": "mma_p32", "demo_shape": "mma_demo",
              "mamba2_shape_padded_rows": "mma_main"})):
        t = ssd_timing[key]
        entries.append({
            "name": name, "route": "cuda", "source": SSD_SRC + src, "replaces": SSD_REPLACES,
            "launches": sum(ssd_paths[kind].values()), "launches_by_path": ssd_paths[kind],
            "shape": t["shape"], "max_abs_err": t["max_abs_err"], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "roofline_share": t["roofline_share"], "dtype": t["dtype"],
            **{k: t[k] for k in ("passes", "cuda_core_floor_ms", "heads_per_block", "views")
               if k in t},
            **{label: {k: ssd_timing[o][k] for k in (
                "shape", "dtype", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                "roofline_share", "max_abs_err", "passes", "heads_per_block", "views")
                if k in ssd_timing[o]} for label, o in others.items()}})
    # the fused AdamW kernel: no Pallas kernel's counterpart (the reference
    # leaves its optimizer to XLA's fusion); launches of its update pass
    entries.append({
        "name": "adamw", "route": "cuda", "source": ADAMW_SRC,
        "replaces": "none: src/repro/train/optimizer.py:122 adam_update, fused by XLA",
        "launches": sum(adamw_paths.values()), "launches_by_path": adamw_paths,
        "shape": f"{ADAMW_ARCH} x {ADAMW_LAYERS} layers: {adamw['leaves']} leaves, "
                 f"{adamw['n_params']} float32",
        "ms": adamw["ms"], "plain_ms": adamw["plain_ms"], "bound_ms": adamw["bound_ms"],
        "bound_by": adamw["bound_by"], "library_ms": adamw["library_ms"],
        "roofline_share": adamw["roofline_share"], "bit_equal_twice": adamw["bit_equal_twice"],
        "worst_share_of_tolerance": adamw["worst_share_of_tolerance"]})
    idle = [e["name"] for e in entries if not e["launches"]]
    check(not idle, f"kernels never launched on their paths: {idle}")
    emit({"kernels": entries})
    emit({"phase": "done", "seconds": round(time.perf_counter() - t0, 1)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
