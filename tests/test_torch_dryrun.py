"""The port's dry run against the JAX reference's, on the CPU.

``repro_torch.launch.dryrun`` accounts each (arch x shape) cell on the meta
device where ``repro.launch.dryrun`` lowers and compiles it for 256 or 512
host devices. Held here to the reference:

* the shape cells (``SHAPES``, ``shape_cells``, the config properties);
* ``analytic_state_bytes_per_device``, integer for integer, for every
  (arch, cell, mesh, rules preset), the reference side computed in one
  subprocess (importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512
  host devices);
* FLOPs at the reduced configs (batch 2 x 64 tokens) against
  ``repro.launch.hloparse.analyze`` of the reference's 1-device CPU compile:
  prefill and decode equal to 1e-6 (they are equal), train (loss forward +
  backward, the reference's remat off, since its remat recomputes the
  forward) within 5e-3 (the reference's XLA graph and autograd differ in a
  few small products of the MoE router and the SSM's backward: 0.21% at
  most, seen on mamba2-130m);
* the CLI end to end on two archs.

The full sweep (64 records) runs under ``slow``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import shape_cells as jax_shape_cells  # noqa: E402
from repro.launch import hloparse  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.serve.engine import decode_fn as jax_decode_fn  # noqa: E402
from repro.serve.engine import prefill_fn as jax_prefill_fn  # noqa: E402
from repro.serve.engine import serve_param_shapes as jax_serve_param_shapes  # noqa: E402
from repro.train import AdamConfig as JaxAdamConfig  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.train import train_state_shapes as jax_train_state_shapes  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_cells  # noqa: E402
from repro_torch.launch import dryrun, opcount  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.serve.engine import decode_fn, prefill_fn, serve_param_shapes  # noqa: E402
from repro_torch.train import AdamConfig, TrainConfig, train_state_shapes  # noqa: E402
from repro_torch.train.trainer import _grads_and_metrics  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod256": False, "pod512": True}
FLOPS_TOL = {"prefill": 1e-6, "decode": 1e-6, "train": 5e-3}
B, S = 2, 64

REF_STATE_BYTES = textwrap.dedent("""
    import json, sys
    import numpy as np
    from repro.launch import dryrun as D       # sets XLA_FLAGS: 512 host devices
    from repro.configs import ARCHS, SHAPES, get_config, shape_cells
    from repro.launch.specs import input_specs
    from repro.models import param_axes
    from repro.parallel import sharding as shd
    from repro.serve.engine import serve_param_shapes
    from repro.train import train_state_axes, train_state_shapes

    class FakeMesh:
        def __init__(self, shape_map):
            self.axis_names = tuple(shape_map)
            self.devices = np.empty(tuple(shape_map.values()), object)

    MESHES = {"pod256": {"data": 16, "model": 16},
              "pod512": {"pod": 2, "data": 16, "model": 16}}
    out = {}
    for arch in ARCHS:
        base = get_config(arch)
        for shape_name in shape_cells(arch):
            shape = SHAPES[shape_name]
            for mesh_name, shape_map in MESHES.items():
                mesh = FakeMesh(shape_map)
                for preset, rules in shd.RULES_PRESETS.items():
                    # run_cell's state_bytes, line for line
                    if shape.kind == "train":
                        cfg = D.train_model_config(base)
                        opt = D.default_opt_config(cfg)
                        n = D._analytic_state_bytes(train_state_shapes(cfg, opt),
                                                    train_state_axes(cfg, opt), mesh, rules)
                    else:
                        n = D._analytic_state_bytes(serve_param_shapes(base),
                                                    param_axes(base), mesh, rules)
                        if shape.kind == "decode":
                            inputs, in_axes = input_specs(base, shape)
                            n += D._analytic_state_bytes(inputs["cache"], in_axes["cache"],
                                                         mesh, rules)
                    out[f"{arch}|{shape_name}|{mesh_name}|{preset}"] = n
    print("STATE_BYTES " + json.dumps(out))
""")


def test_shape_cells_match_the_reference():
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in JAX_SHAPES.items()}
    assert "long_500k" in shape_cells("mamba2-130m")
    assert "long_500k" in shape_cells("jamba-v0.1-52b")
    assert "long_500k" not in shape_cells("llama3-8b")
    n_cells = 0
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        assert shape_cells(arch) == jax_shape_cells(arch), arch
        assert (cfg.is_quadratic, cfg.is_attention_free, cfg.has_decoder) == (
            jcfg.is_quadratic, jcfg.is_attention_free, jcfg.has_decoder), arch
        n_cells += len(shape_cells(arch))
    assert n_cells == 32     # 8 archs x 3 shapes + 2 archs x 4


def test_state_bytes_match_the_reference_on_every_cell_mesh_and_preset():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REF_STATE_BYTES], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    line = [l for l in proc.stdout.splitlines() if l.startswith("STATE_BYTES ")]
    assert line, proc.stderr[-3000:]
    ref = json.loads(line[0].split(" ", 1)[1])
    port = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape_name in shape_cells(arch):
            for mesh_name, multi_pod in MESHES.items():
                mesh = make_production_mesh(multi_pod=multi_pod)
                for preset, rules in shd.RULES_PRESETS.items():
                    port[f"{arch}|{shape_name}|{mesh_name}|{preset}"] = \
                        dryrun.state_bytes_per_device(cfg, shape_name, mesh, rules)
    assert len(port) == 32 * 2 * 3
    assert port == ref


# --------------------------------------------------------------------------- #
# FLOPs at reduced configs against the reference's compiled HLO
# --------------------------------------------------------------------------- #
def _batches(cfg, labels: bool):
    jb = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    tb = {"tokens": torch.empty((B, S), dtype=torch.int64, device="meta")}
    extra = {}
    if labels:
        extra["labels"] = ((B, S), jnp.int32, torch.int64)
    if cfg.family == "encdec":
        extra["enc_embeds"] = ((B, cfg.encdec.enc_len, cfg.d_model), jnp.float32, torch.float32)
    if cfg.family == "vlm":
        extra["vision_embeds"] = ((B, cfg.vlm.n_vision_tokens, cfg.d_model), jnp.float32,
                                  torch.float32)
    for k, (shape, jdt, tdt) in extra.items():
        jb[k] = jax.ShapeDtypeStruct(shape, jdt)
        tb[k] = torch.empty(shape, dtype=tdt, device="meta")
    return jb, tb


def _ref_flops(fn, *args) -> float:
    return hloparse.analyze(jax.jit(fn).lower(*args).compile().as_text()).flops


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_match_the_reference_compile_at_reduced_config(arch):
    cfg = get_config(arch).reduced()
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), remat=False, remat_policy="none")
    enc_len = cfg.encdec.enc_len if cfg.encdec else None
    tok = torch.empty((B,), dtype=torch.int32, device="meta")
    jtok = jax.ShapeDtypeStruct((B,), jnp.int32)
    got, want = {}, {}

    jb, tb = _batches(cfg, labels=False)
    want["prefill"] = _ref_flops(lambda p, b: jax_prefill_fn(p, jcfg, b),
                                 jax_serve_param_shapes(jcfg), jb)
    want["decode"] = _ref_flops(lambda p, t, c, q: jax_decode_fn(p, jcfg, t, c, q),
                                jax_serve_param_shapes(jcfg), jtok,
                                jax_blocks.cache_struct(jcfg, B, S, enc_len=enc_len), jtok)
    with torch.no_grad():
        got["prefill"], _, _ = opcount.count_flops(prefill_fn, serve_param_shapes(cfg), cfg, tb,
                                                   attn_impl="xla")
        got["decode"], _, _ = opcount.count_flops(
            decode_fn, serve_param_shapes(cfg), cfg, tok,
            blocks.cache_struct(cfg, B, S, enc_len=enc_len, device="meta"), tok)

    jb, tb = _batches(cfg, labels=True)
    want["train"] = _ref_flops(jax_make_train_step(jcfg, JaxAdamConfig(), JaxTrainConfig()),
                               jax_train_state_shapes(jcfg, JaxAdamConfig()), jb)
    got["train"], by_op, _ = opcount.count_flops(
        _grads_and_metrics, train_state_shapes(cfg, AdamConfig()).params, cfg, tb,
        TrainConfig(attn_impl="xla"))
    assert sum(by_op.values()) == got["train"]
    for kind, tol in FLOPS_TOL.items():
        assert want[kind] > 0
        assert got[kind] == pytest.approx(want[kind], rel=tol), (kind, got[kind], want[kind])


def test_wire_factors_are_the_references():
    from repro.launch.hloparse import _wire_factor as ref
    for kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        for n in (1, 2, 16, 512):
            assert opcount._wire_factor(kind, n) == ref(kind, n)


# --------------------------------------------------------------------------- #
# The CLI
# --------------------------------------------------------------------------- #
def test_cli_writes_and_caches_records(tmp_path, capsys):
    args = ["--arch", "mamba2-130m,olmoe-1b-7b", "--shape", "decode_32k,long_500k",
            "--both-meshes", "--out", str(tmp_path)]
    assert dryrun.main(args) == 0
    out = capsys.readouterr().out
    assert "SKIP olmoe-1b-7b long_500k" in out and "done: ok=6 fail=0 skip=1" in out
    recs = sorted(tmp_path.glob("*/*.json"))
    assert [f"{p.parent.name}/{p.name}" for p in recs] == [
        f"{m}/{a}__{s}.json" for m in ("pod256", "pod512")
        for a, s in (("mamba2-130m", "decode_32k"), ("mamba2-130m", "long_500k"),
                     ("olmoe-1b-7b", "decode_32k"))]
    for path in recs:
        rec = json.loads(path.read_text())
        n_chips = 512 if path.parent.name == "pod512" else 256
        assert rec["status"] == "ok" and rec["device"] == "meta"
        assert rec["roofline"]["n_chips"] == n_chips
        assert rec["flops"] > 0 and rec["flops_per_chip"] == rec["flops"] / n_chips
        assert rec["analytic_state_bytes_per_device"] > 0 and rec["fits_on_card"] is True
        assert rec["model_flops_per_chip"] == rec["model_flops_total"] / n_chips
        # the reference's ratio: above 1 where 2 x active params counts the
        # embedding table, which a decode step reads by lookup, not by product
        assert rec["useful_flops_ratio"] == rec["model_flops_per_chip"] / rec["flops_per_chip"]
        assert rec["collectives"].startswith("not counted")
    # the same cells again: every record is cached
    assert dryrun.main(args) == 0
    assert capsys.readouterr().out.count("CACHED") == 6


@pytest.mark.slow
def test_full_sweep_writes_64_records(tmp_path):
    assert dryrun.main(["--arch", "all", "--shape", "all", "--both-meshes",
                        "--out", str(tmp_path)]) == 0
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*/*.json")]
    assert len(recs) == 64 and all(r["status"] == "ok" for r in recs)
