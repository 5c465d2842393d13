"""Multi-pod dry run: account every (arch x shape) cell on the production
meshes, on the meta device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --both-meshes

Counterpart of ``repro.launch.dryrun``, with the same flags, policies, cell
loop and JSON cache (``<out>/<mesh>/<arch>__<shape>.json``), except
``--save-hlo``: nothing is compiled, so there is no HLO to save. Each cell
runs the step's function once on meta tensors (shapes and dtypes, no data,
nothing allocated, so no card either), under the logical production mesh
(``launch.mesh.make_production_mesh``: 16 x 16 or 2 x 16 x 16 chips that need
not exist), and records:

* ``analytic_state_bytes_per_device``: the reference's formula, each state
  leaf's bytes over the shards ``spec_for`` gives it under the rules preset
  (train: params + Adam moments + step + rng; prefill: params; decode:
  params + cache);
* ``flops``: every matmul, einsum and bmm of one step, counted by
  ``launch.opcount`` (train: loss forward + backward; the AdamW update has
  no product; prefill and decode: the forward), lowered as the reference
  lowers it: ``attn_impl="xla"`` (the chunked attention) and the plain SSD
  scan. A LogicalMesh has no ranks, so the shard_map MoE counts as the
  scatter path's math (``models.moe``). ``flops`` is the whole step's count;
  ``flops_per_chip`` splits it evenly over the mesh;
* ``model_flops_total`` / ``_per_chip`` and ``useful_flops_ratio``, as the
  reference computes them (6 or 2 x active params x tokens);
* ``roofline``: ``compute_s`` (FLOPs per chip over the H100's bf16 peak) and
  ``memory_s`` (the state bytes per device, each read once, over its HBM
  rate: a floor, since activations are not counted);
* ``fits_on_card``: the state bytes per device against the card's 80 GB.

No SPMD partitioner runs here, so the record carries no collective bytes and
no compiler memory analysis (``collectives`` says so).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_cells
from repro_torch.launch import opcount
from repro_torch.launch.mesh import (H100_HBM_BYTES, H100_HBM_BYTES_S, H100_PEAK_BF16_FLOPS,
                                     make_production_mesh)
from repro_torch.launch.specs import input_specs
from repro_torch.models import ModelConfig, param_axes
from repro_torch.parallel import sharding as shd
from repro_torch.serve.engine import decode_fn, prefill_fn, serve_param_shapes
from repro_torch.train import AdamConfig, TrainConfig, train_state_axes, train_state_shapes
from repro_torch.train.trainer import _grads_and_metrics

DEFAULT_OUT = "build/dryrun"
NO_COLLECTIVES = ("not counted: no SPMD partitioner inserts collectives on the meta "
                  "device, and no compiler memory analysis runs")


# --------------------------------------------------------------------------- #
# Per-arch production training policy (memory levers for the big models)
# --------------------------------------------------------------------------- #
def default_opt_config(cfg: ModelConfig) -> AdamConfig:
    n = cfg.n_params()
    if n > 100e9:      # deepseek-v3: pure-bf16 params + int8 moments
        return AdamConfig(moment_dtype="int8", stochastic_round_params=True)
    if n > 20e9:       # yi-34b / jamba-52b: bf16 moments
        return AdamConfig(moment_dtype="bfloat16")
    return AdamConfig()


def train_model_config(cfg: ModelConfig) -> ModelConfig:
    if cfg.n_params() > 100e9:
        return dataclasses.replace(cfg, param_dtype="bfloat16")
    return cfg


# --------------------------------------------------------------------------- #
# Cell runner
# --------------------------------------------------------------------------- #
def _analytic_state_bytes(shapes, axes, mesh, rules=None) -> int:
    """Each leaf's bytes over its shards, summed (the reference's formula)."""
    ctx = shd.ShardingContext(mesh, rules)
    total = []
    shd.map_axes(lambda ax, t: total.append(
        t.numel() * t.element_size() / shd.shards_of(shd.spec_for(ax, t.shape, ctx), mesh)),
        axes, shapes)
    return int(sum(total))


def cell_config(arch: str, moe_impl: str = None, remat_policy: str = None) -> ModelConfig:
    base_cfg = get_config(arch)
    if moe_impl and base_cfg.moe is not None:
        base_cfg = dataclasses.replace(
            base_cfg, moe=dataclasses.replace(base_cfg.moe, impl=moe_impl))
    if remat_policy:
        base_cfg = dataclasses.replace(base_cfg, remat_policy=remat_policy)
    return base_cfg


def train_opt_config(cfg: ModelConfig, opt_overrides=None) -> AdamConfig:
    opt_cfg = default_opt_config(cfg)
    return dataclasses.replace(opt_cfg, **opt_overrides) if opt_overrides else opt_cfg


def state_bytes_per_device(base_cfg: ModelConfig, shape_name: str, mesh, rules=None,
                           opt_overrides=None) -> int:
    """The cell's state bytes per device: train, the TrainState (the
    production policy's dtypes); prefill, the serving params; decode, the
    serving params and the cache."""
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        cfg = train_model_config(base_cfg)
        opt_cfg = train_opt_config(cfg, opt_overrides)
        return _analytic_state_bytes(train_state_shapes(cfg, opt_cfg),
                                     train_state_axes(cfg, opt_cfg), mesh, rules)
    total = _analytic_state_bytes(serve_param_shapes(base_cfg), param_axes(base_cfg),
                                  mesh, rules)
    if shape.kind == "decode":
        inputs, in_axes = input_specs(base_cfg, shape)
        total += _analytic_state_bytes(inputs["cache"], in_axes["cache"], mesh, rules)
    return total


def run_cell(arch: str, shape_name: str, multi_pod: bool, opt_overrides=None,
             tcfg: TrainConfig = None, rules_preset: str = "megatron",
             moe_impl: str = None, remat_policy: str = None) -> dict:
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "pod512" if multi_pod else "pod256"
    n_chips = math.prod(mesh.axis_sizes)
    base_cfg = cell_config(arch, moe_impl, remat_policy)
    rules = shd.RULES_PRESETS[rules_preset]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "status": "ok", "rules": rules_preset, "device": "meta"}
    t0 = time.time()
    state_bytes = state_bytes_per_device(base_cfg, shape_name, mesh, rules, opt_overrides)

    with shd.use_sharding(mesh, rules):
        if shape.kind == "train":
            cfg = train_model_config(base_cfg)
            opt_cfg = train_opt_config(cfg, opt_overrides)
            tcfg = dataclasses.replace(tcfg or TrainConfig(), attn_impl="xla")
            inputs, _ = input_specs(cfg, shape)
            rec["opt"] = {"moment_dtype": opt_cfg.moment_dtype,
                          "param_dtype": cfg.param_dtype,
                          "compress_pod_grads": tcfg.compress_pod_grads}
            params = train_state_shapes(cfg, opt_cfg).params
            flops, by_op, _ = opcount.count_flops(_grads_and_metrics, params, cfg,
                                                  inputs["batch"], tcfg)
        else:
            params = serve_param_shapes(base_cfg)
            inputs, _ = input_specs(base_cfg, shape)
            with torch.no_grad():
                if shape.kind == "prefill":
                    flops, by_op, _ = opcount.count_flops(prefill_fn, params, base_cfg,
                                                          inputs["batch"], attn_impl="xla")
                else:
                    flops, by_op, _ = opcount.count_flops(decode_fn, params, base_cfg,
                                                          inputs["token"], inputs["cache"],
                                                          inputs["pos"])
    rec["t_count_s"] = round(time.time() - t0, 2)
    rec["analytic_state_bytes_per_device"] = state_bytes
    rec["flops"] = flops
    rec["flops_per_chip"] = flops / n_chips
    rec["flops_by_op"] = by_op
    rec["collectives"] = NO_COLLECTIVES
    rec["roofline"] = {
        "compute_s": rec["flops_per_chip"] / H100_PEAK_BF16_FLOPS,
        "memory_s": state_bytes / H100_HBM_BYTES_S,
        "n_chips": n_chips,
        "card": "NVIDIA H100 80GB HBM3 (data sheet peaks)",
    }
    rec["fits_on_card"] = state_bytes <= H100_HBM_BYTES
    gb, sl = shape.global_batch, shape.seq_len
    tokens = gb * sl if shape.kind != "decode" else gb
    mult = 6 if shape.kind == "train" else 2
    rec["model_flops_total"] = mult * base_cfg.n_active_params() * tokens
    rec["model_flops_per_chip"] = rec["model_flops_total"] / n_chips
    if flops:
        rec["useful_flops_ratio"] = rec["model_flops_per_chip"] / rec["flops_per_chip"]
    return rec


def cell_path(out_dir: Path, mesh_name: str, arch: str, shape_name: str) -> Path:
    return out_dir / mesh_name / f"{arch}__{shape_name}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--moment-dtype", default=None)
    ap.add_argument("--rules", default="megatron", choices=sorted(shd.RULES_PRESETS))
    ap.add_argument("--moe-impl", default=None)
    ap.add_argument("--remat", default=None, help="full|dots|none")
    ap.add_argument("--compress-pod-grads", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_ok = n_fail = n_skip = 0
    for arch in archs:
        cells = shape_cells(arch)
        shapes = cells if args.shape == "all" else args.shape.split(",")
        for shape_name in shapes:
            if shape_name not in cells:
                print(f"SKIP {arch} {shape_name} (not assigned: quadratic-attn "
                      f"archs skip long_500k)")
                n_skip += 1
                continue
            for mp in meshes:
                mesh_name = "pod512" if mp else "pod256"
                path = cell_path(out_dir, mesh_name, arch, shape_name)
                if path.exists() and not args.force:
                    print(f"CACHED {mesh_name} {arch} {shape_name}")
                    continue
                print(f"RUN {mesh_name} {arch} {shape_name} ...", flush=True)
                try:
                    overrides = ({"moment_dtype": args.moment_dtype}
                                 if args.moment_dtype else None)
                    tcfg = TrainConfig(compress_pod_grads=args.compress_pod_grads and mp)
                    rec = run_cell(arch, shape_name, mp, opt_overrides=overrides, tcfg=tcfg,
                                   rules_preset=args.rules, moe_impl=args.moe_impl,
                                   remat_policy=args.remat)
                    n_ok += 1
                except Exception:
                    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                           "status": "error", "traceback": traceback.format_exc()}
                    n_fail += 1
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_text(json.dumps(rec, indent=2))
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    print(f"  ok: {rec['t_count_s']}s flops/chip={rec['flops_per_chip']:.3e} "
                          f"compute={r['compute_s'] * 1e3:.2f}ms "
                          f"mem={r['memory_s'] * 1e3:.2f}ms "
                          f"state={rec['analytic_state_bytes_per_device'] / 2**30:.2f}GiB",
                          flush=True)
                else:
                    print(f"  FAIL:\n{rec['traceback'][-2000:]}", flush=True)
    print(f"done: ok={n_ok} fail={n_fail} skip={n_skip}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
