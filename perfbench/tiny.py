"""Tiny sizes of each cell for the CPU tests: the same code paths as the
cell, with every width and count cut so that a run takes seconds."""
import time

import torch

from perfbench.lib import harness, spec

OLMOE = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_head": 16, "d_ff": 64,
         "vocab_size": 128, "moe": {"n_experts": 8, "top_k": 2, "d_ff_expert": 32,
                                    "capacity_factor": 1.25, "aux_loss_weight": 0.01,
                                    "impl": "shard_map"}}
MAMBA2 = {"n_layers": 2, "d_model": 64, "vocab_size": 128,
          "ssm": {"d_state": 16, "d_conv": 4, "expand": 2, "head_dim": 16, "n_groups": 1,
                  "chunk": 32}}
# the prefill cell's: deeper, and more chunks to a prompt, so that the
# control's rounding and a lost carry between chunks reach the cell's limits
MAMBA2_PREFILL = {**MAMBA2, "n_layers": 4, "ssm": {**MAMBA2["ssm"], "chunk": 16}}
SIZES = {
    "olmoe-train": (OLMOE, {"batch": 2, "seq": 64, "trace_steps": 2}),
    "mamba2-train-ckpt": (MAMBA2, {"batch": 2, "seq": 64, "trace_steps": 2}),
    "mamba2-prefill": (MAMBA2_PREFILL, {"clients": 4, "prompt": 128, "sample_waves": 5, "cache_waves": 2,
                                "cache_from_first": 2, "trace_waves": 3}),
}
SEED = (1 << 31) + 12345      # above 32 signed bits: run.py takes any such seed


def job(cell: str, trace: bool = False, seconds: float = 0.6, seed: int = SEED):
    bench = spec.benchmark()
    port, traffic = SIZES[cell]
    return bench, harness.make_job(bench, cell, seed, seconds, trace, torch.device("cpu"),
                                   time.perf_counter(), port, traffic)


def run(cell: str, trace: bool = False, **kw) -> dict:
    bench, j = job(cell, trace, **kw)
    return harness.run_cell(bench, j)
