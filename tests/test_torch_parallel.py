"""The port's parallel layer on gloo ranks, against the JAX reference and the
math, on the CPU.

Each test spawns one group of ranks (``torch.multiprocessing.spawn`` from a
script written to the test's tmp dir, file rendezvous, one thread per
rank) with all its cases inside; each rank saves what it computed and the
test compares. The reference's multi-device sides run in a jax subprocess
with forced host devices, as its own tests do.

* The shard_map MoE (``models/moe_shard_map``) on 8 ranks, a (2, 4)
  ``("data", "model")`` mesh: without drops against the dense oracle at the
  reference test's limits (rel 5e-2 in bf16, aux within 0.3); at a binding
  capacity in float32 against the reference's own ``moe_forward_shard_map``
  on 8 devices, with the same weights through ``params_from_flat`` (1e-5 of
  the output's scale); its gradients, every leaf and the input, against the
  dense oracle's (float32, 1e-4 of each gradient's scale: a gradient counted
  once per rank would be 8 times too large); and the collectives it calls.
* GPipe (``parallel/pipeline``) on 2 ranks: against sequential execution
  and against the reference's ``pipeline`` on 2 devices, within 1e-5.
* The cross-pod int8 gradient mean on 2 ranks: both ranks equal, the numpy
  mean of ``s * q`` from the reference's ``_quant_leaf`` within 1e-6, and
  the error at most amax / 127 x 1.01 (the reference's own test of this
  function fails under this jax).
* A 2-rank ``compress_pod_grads`` step on reduced llama3-8b against one
  process fed the int8 mean of the two half-batch gradients (equal).
* ``distribute_tree`` and ``constrain`` on a 2 x 2 mesh (4 ranks): the
  placements ``spec_for`` gives, and the full tensors unchanged.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("torch.distributed.tensor")

from repro.train.trainer import _quant_leaf as jax_quant_leaf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.config import MoEConfig  # noqa: E402
from repro_torch.models.params import params_from_flat, tree_items, tree_like  # noqa: E402
from repro_torch.train import AdamConfig, TrainConfig, init_train_state  # noqa: E402
from repro_torch.train.optimizer import adam_update  # noqa: E402
from repro_torch.train.trainer import _grads_and_metrics  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# (name, n_experts, top_k, capacity factor, compute dtype): the reference
# test's two no-drop cases in bf16, a binding capacity in float32, and the
# no-drop float32 case whose gradients are checked
MOE_CASES = (("e8k2", 8, 2, 8.0, "bfloat16"), ("e16k4", 16, 4, 8.0, "bfloat16"),
             ("bind", 8, 2, 1.0, "float32"), ("grad", 8, 2, 8.0, "float32"))
MOE_B, MOE_S = 4, 64

RANKS = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import make_local_mesh

    def moe_cfg(e, k, cf, dt, impl):
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.models.config import MoEConfig
        return dataclasses.replace(
            get_config("olmoe-1b-7b").reduced(), compute_dtype=dt,
            moe=MoEConfig(n_experts=e, top_k=k, d_ff_expert=64, capacity_factor=cf, impl=impl))

    def case_moe(rank, world, tmp):
        from repro_torch.models import moe as moe_mod
        from repro_torch.models.params import params_from_flat
        from repro_torch.parallel import compat
        from repro_torch.parallel.sharding import use_sharding
        spec = json.load(open(f"{tmp}/spec.json"))
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        x = torch.from_numpy(np.load(f"{tmp}/x.npy"))
        out = {}
        for name, e, k, cf, dt in spec["cases"]:
            cfg = moe_cfg(e, k, cf, dt, "shard_map")
            flat = dict(np.load(f"{tmp}/params_{name}.npz"))
            p = params_from_flat(flat, cfg, "cpu")["segments"]["stack"]["l0"]["mlp"]
            p = {kk: v[0].clone().requires_grad_(True) for kk, v in p.items()}
            xg = x.clone().requires_grad_(True)
            compat.COLLECTIVES.clear()
            with use_sharding(mesh):
                y, aux = moe_mod.moe_forward(p, xg, cfg)
            out[f"{name}/collectives"] = dict(compat.COLLECTIVES)
            out[f"{name}/y"], out[f"{name}/aux"] = y.detach().float(), aux.detach()
            if name == "grad":
                cot = torch.from_numpy(np.load(f"{tmp}/cot.npy"))
                loss = (y * cot).sum() + aux
                grads = torch.autograd.grad(loss, [xg] + [p[kk] for kk in sorted(p)])
                for kk, g in zip(["x"] + sorted(p), grads):
                    out[f"{name}/grad/{kk}"] = g
        torch.save(out, f"{tmp}/out_{rank}.pt")

    def case_pipeline(rank, world, tmp):
        from repro_torch.parallel.pipeline import pipeline
        mesh = make_local_mesh(("pod",), "cpu")
        ref = np.load(f"{tmp}/ref.npz")
        W, x = torch.from_numpy(ref["W"]), torch.from_numpy(ref["x"])
        out = pipeline(lambda w, h: torch.tanh(h @ w), W, x, mesh=mesh, axis="pod", n_micro=4)
        torch.save({"out": out}, f"{tmp}/out_{rank}.pt")

    def case_crosspod(rank, world, tmp):
        from repro_torch.parallel import compat
        from repro_torch.train.trainer import _cross_pod_mean_int8
        mesh = make_local_mesh(("pod",), "cpu")
        g = torch.from_numpy(np.load(f"{tmp}/g.npy")[rank])
        with compat.manual(mesh):
            got = _cross_pod_mean_int8({"w": g})["w"]
        torch.save({"w": got, "collectives": dict(compat.COLLECTIVES)}, f"{tmp}/out_{rank}.pt")

    def case_step(rank, world, tmp):
        from repro_torch.configs import get_config
        from repro_torch.data import SyntheticLMData
        from repro_torch.models.params import tree_items
        from repro_torch.train import AdamConfig, TrainConfig, init_train_state, make_train_step
        mesh = make_local_mesh(("pod",), "cpu")
        cfg = get_config("llama3-8b").reduced()
        opt = AdamConfig(lr=1e-3, warmup_steps=0, decay_steps=10)
        state = init_train_state(cfg, opt, seed=0, device="cpu")
        batch = {k: torch.from_numpy(v)
                 for k, v in SyntheticLMData(cfg.vocab_size, 16, 4, seed=0).batch_at(0).items()}
        step = make_train_step(cfg, opt, TrainConfig(compress_pod_grads=True), mesh=mesh)
        state, metrics = step(state, batch)
        torch.save({"params": dict(tree_items(state.params)), "step": state.step,
                    "metrics": metrics}, f"{tmp}/out_{rank}.pt")

    def names(placements):
        return [f"S{p.dim}" if p.is_shard() else "R" for p in placements]

    def case_dtensor(rank, world, tmp):
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.models import init_params, param_axes
        from repro_torch.models.params import tree_items
        from repro_torch.parallel import sharding as shd
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        cfg = get_config("llama3-8b").reduced()
        params = init_params(cfg, seed=0, device="cpu")
        dist_params = shd.distribute_tree(params, param_axes(cfg), mesh)
        axes = dict(tree_items(param_axes(cfg)))
        ctx = shd.ShardingContext(mesh)
        res = {"leaves": {}}
        for path, t in tree_items(dist_params):
            want = shd.placements(shd.spec_for(axes[path], t.shape, ctx), mesh)
            full = dict(tree_items(params))[path]
            res["leaves"][path] = [names(t.placements), names(want),
                                   bool(torch.equal(t.full_tensor(), full)),
                                   list(t.to_local().shape)]
        x = torch.arange(4 * 8 * 64, dtype=torch.float32).reshape(4, 8, 64)
        xd = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        with shd.use_sharding(mesh):
            y = shd.constrain(xd, ("batch", "seq", "act_embed"))
            v = shd.constrain(xd, ("batch", "seq", "act_vocab"))
            try:
                with shd.use_sharding(make_production_mesh()):
                    pass
                res["nested"] = "allowed"
            except ValueError:
                res["nested"] = "refused"
        res["constrain"] = [names(y.placements), bool(torch.equal(y.full_tensor(), x)),
                            names(v.placements), bool(torch.equal(v.full_tensor(), x)),
                            shd.constrain(x, ("batch",)) is x]
        if rank == 0:
            json.dump(res, open(f"{tmp}/out_0.json", "w"))

    def run(rank, case, world, tmp):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv", world_size=world,
                                rank=rank)
        try:
            globals()["case_" + case](rank, world, tmp)
        finally:
            dist.destroy_process_group()

    if __name__ == "__main__":
        case, world, tmp = sys.argv[1], int(sys.argv[2]), sys.argv[3]
        mp.spawn(run, args=(case, world, tmp), nprocs=world, join=True)
""")

REF_MOE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.core.tce.engine import flatten_pytree
    from repro.models import model as jax_model, moe as moe_mod
    from repro.models.config import MoEConfig
    from repro.parallel import sharding as shd

    tmp = sys.argv[1]
    spec = json.load(open(f"{tmp}/spec.json"))
    x = jnp.asarray(np.load(f"{tmp}/x.npy"))
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    for name, e, k, cf, dt in spec["cases"]:
        cfg = dataclasses.replace(
            get_config("olmoe-1b-7b").reduced(), compute_dtype=dt,
            moe=MoEConfig(n_experts=e, top_k=k, d_ff_expert=64, capacity_factor=cf,
                          impl="shard_map"))
        params = jax_model.init_params(cfg, jax.random.key(1))
        np.savez(f"{tmp}/params_{name}.npz", **flatten_pytree(params))
        p = jax.tree.map(lambda t: t[0], params["segments"]["stack"]["l0"]["mlp"])
        with shd.use_sharding(mesh):
            y, aux = jax.jit(lambda p_, x_: moe_mod.moe_forward(p_, x_, cfg))(p, x)
        np.savez(f"{tmp}/ref_{name}.npz", y=np.asarray(y, np.float32), aux=np.asarray(aux))
    print("REF_MOE_OK")
""")

REF_PIPELINE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp, numpy as np
    from repro.parallel.pipeline import pipeline

    mesh = jax.make_mesh((2,), ("pod",))
    n_stages, layers_per_stage, d, b = 2, 3, 16, 8
    key = jax.random.key(0)
    W = jax.random.normal(key, (n_stages, layers_per_stage, d, d)) * 0.3
    x = jax.random.normal(jax.random.fold_in(key, 1), (b, d))
    out = jax.jit(lambda W_, x_: pipeline(lambda w, h: jnp.tanh(h @ w), W_, x_, mesh=mesh,
                                          axis="pod", n_micro=4))(W, x)
    np.savez(f"{sys.argv[1]}/ref.npz", W=np.asarray(W), x=np.asarray(x), out=np.asarray(out))
    print("REF_PIPELINE_OK")
""")


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1")


def _jax_ref(script: str, tmp: Path, marker: str) -> None:
    proc = subprocess.run([sys.executable, "-c", script, str(tmp)], env=_env(), cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert marker in proc.stdout, proc.stderr[-3000:]


def _spawn(case: str, world: int, tmp: Path) -> list:
    script = tmp / "ranks.py"
    script.write_text(RANKS)
    proc = subprocess.run([sys.executable, str(script), case, str(world), str(tmp)],
                          env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    outs = sorted(tmp.glob("out_*.pt"))
    return [torch.load(p) for p in sorted(outs, key=lambda p: int(p.stem.split("_")[1]))]


def _max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


# --------------------------------------------------------------------------- #
# shard_map MoE, 8 ranks
# --------------------------------------------------------------------------- #
def test_shard_map_moe_on_8_ranks(tmp_path):
    (tmp_path / "spec.json").write_text(json.dumps({"cases": MOE_CASES}))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((MOE_B, MOE_S, 64)).astype(np.float32)
    cot = rng.standard_normal((MOE_B, MOE_S, 64)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "cot.npy", cot)
    _jax_ref(REF_MOE, tmp_path, "REF_MOE_OK")
    outs = _spawn("moe", 8, tmp_path)
    assert len(outs) == 8

    for name, e, k, cf, dt in MOE_CASES:
        cfg = dataclasses.replace(
            get_config("olmoe-1b-7b").reduced(), compute_dtype=dt,
            moe=MoEConfig(n_experts=e, top_k=k, d_ff_expert=64, capacity_factor=cf,
                          impl="dense"))
        flat = dict(np.load(tmp_path / f"params_{name}.npz"))
        p = {kk: v[0].clone().requires_grad_(True) for kk, v in
             params_from_flat(flat, cfg, "cpu")["segments"]["stack"]["l0"]["mlp"].items()}
        xg = torch.from_numpy(x).requires_grad_(True)
        y, aux = outs[0][f"{name}/y"], outs[0][f"{name}/aux"]
        for r in range(1, 8):     # every rank holds the same global output
            assert torch.equal(outs[r][f"{name}/y"], y) and torch.equal(outs[r][f"{name}/aux"], aux)
        # per forward: dispatch and return all_to_all, the expert weights'
        # three all_gathers over data, aux's pmean over model then data,
        # and the output's reassembly over data and model
        assert outs[0][f"{name}/collectives"] == {"all_to_all": 2, "all_gather": 5,
                                                  "all_reduce": 2}
        if cf > 1:
            y_dense, aux_dense = moe_mod.moe_forward(p, xg, cfg)
            assert _max_rel(y, y_dense.detach()) < 5e-2, name
            assert abs(float(aux) - float(aux_dense.detach())) < 0.3, name
            continue
        ref = np.load(tmp_path / f"ref_{name}.npz")
        assert _max_rel(y, torch.from_numpy(ref["y"])) < 1e-5, name
        assert abs(float(aux) - float(ref["aux"])) < 1e-6
        # drops bind: the dense oracle (no drops) differs
        y_dense, _ = moe_mod.moe_forward(p, xg, cfg)
        assert _max_rel(y, y_dense.detach()) > 1e-2

    # gradients at no drops in float32: the dense oracle's output, and the
    # load-balance loss as the shard_map path defines it (each rank's own
    # tokens' loss, meaned over the ranks), once
    cfg = dataclasses.replace(
        get_config("olmoe-1b-7b").reduced(), compute_dtype="float32",
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, capacity_factor=8.0, impl="dense"))
    flat = dict(np.load(tmp_path / "params_grad.npz"))
    p = {kk: v[0].clone().requires_grad_(True) for kk, v in
         params_from_flat(flat, cfg, "cpu")["segments"]["stack"]["l0"]["mlp"].items()}
    xg = torch.from_numpy(x).requires_grad_(True)
    y_dense, _ = moe_mod.moe_forward(p, xg, cfg)
    aux = torch.stack([_block_aux(p, xg[i * 2:(i + 1) * 2, j * 16:(j + 1) * 16], cfg)
                       for i in range(2) for j in range(4)]).mean()
    assert abs(float(outs[0]["grad/aux"]) - float(aux.detach())) < 1e-6
    want = torch.autograd.grad((y_dense * torch.from_numpy(cot)).sum() + aux,
                               [xg] + [p[kk] for kk in sorted(p)])
    for kk, w in zip(["x"] + sorted(p), want):
        for r in range(8):
            got = outs[r][f"grad/grad/{kk}"]
            assert _max_rel(got, w) < 1e-4, (kk, r, _max_rel(got, w))


def _block_aux(p, x, cfg):
    probs, _, idx = moe_mod._gate(p, x, cfg)
    return moe_mod._aux_loss(probs, idx, cfg.moe.n_experts)


# --------------------------------------------------------------------------- #
# GPipe, 2 ranks
# --------------------------------------------------------------------------- #
def test_gpipe_on_2_ranks(tmp_path):
    _jax_ref(REF_PIPELINE, tmp_path, "REF_PIPELINE_OK")
    outs = _spawn("pipeline", 2, tmp_path)
    ref = np.load(tmp_path / "ref.npz")
    W, x = torch.from_numpy(ref["W"]), torch.from_numpy(ref["x"])
    seq = x
    for s in range(W.shape[0]):
        for layer in range(W.shape[1]):
            seq = torch.tanh(seq @ W[s, layer])
    for out in outs:
        got = out["out"]
        assert got.shape == x.shape
        assert float((got - seq).abs().max()) < 1e-5
        assert float((got - torch.from_numpy(ref["out"])).abs().max()) < 1e-5


# --------------------------------------------------------------------------- #
# The cross-pod int8 gradient mean, and the compressed step, 2 ranks
# --------------------------------------------------------------------------- #
def test_cross_pod_int8_mean_on_2_ranks(tmp_path):
    g = np.random.default_rng(0).standard_normal((2, 64, 128)).astype(np.float32)
    np.save(tmp_path / "g.npy", g)
    outs = _spawn("crosspod", 2, tmp_path)
    got0, got1 = outs[0]["w"].numpy(), outs[1]["w"].numpy()
    np.testing.assert_array_equal(got0, got1)
    parts = []
    for r in range(2):
        q, s = jax_quant_leaf(jnp.asarray(g[r]))
        parts.append(np.asarray(q, np.float32) * np.asarray(s))
    np.testing.assert_allclose(got0, np.mean(parts, axis=0), rtol=0, atol=1e-6)
    err = float(np.abs(got0 - g.mean(axis=0)).max())
    assert err <= np.abs(g).max() / 127 * 1.01, err
    # one int8 gather and one of the scales per leaf
    assert outs[0]["collectives"] == {"all_gather": 2}


def _numpy_int8_mean(gs):
    """The reference's _quant_leaf in numpy (float32), dequantised, meaned."""
    parts = []
    for g in gs:
        g = g.numpy()
        amax = np.abs(g).max(axis=-1, keepdims=True) if g.ndim else np.abs(g)
        s = np.maximum(amax, np.float32(1e-12)) / np.float32(127.0)
        q = np.clip(np.round(g / s), -127, 127).astype(np.int8)
        parts.append(torch.from_numpy(q.astype(np.float32) * s))
    return torch.stack(parts).mean(dim=0)


def test_compress_pod_grads_step_on_2_ranks(tmp_path):
    outs = _spawn("step", 2, tmp_path)
    cfg = get_config("llama3-8b").reduced()
    opt = AdamConfig(lr=1e-3, warmup_steps=0, decay_steps=10)
    batch = {k: torch.from_numpy(v)
             for k, v in SyntheticLMData(cfg.vocab_size, 16, 4, seed=0).batch_at(0).items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # the ranks' own thread count: the same sums
    try:
        state = init_train_state(cfg, opt, seed=0, device="cpu")
        halves = [_grads_and_metrics(state.params, cfg, {k: v[i * 2:(i + 1) * 2]
                                                         for k, v in batch.items()},
                                     TrainConfig())[0] for i in range(2)]
        flat = [dict(tree_items(h)) for h in halves]
        mean = tree_like(state.params, {k: _numpy_int8_mean([f[k] for f in flat])
                                        for k in flat[0]})
        adam_update(state.params, mean, state.opt, state.step, opt, rng=state.rng)
    finally:
        torch.set_num_threads(threads)
    for out in outs:
        assert int(out["step"]) == 1
        for path, want in tree_items(state.params):
            assert torch.equal(out["params"][path], want), path
    assert torch.equal(outs[0]["metrics"]["loss"], outs[1]["metrics"]["loss"])


# --------------------------------------------------------------------------- #
# DTensor placement, 4 ranks
# --------------------------------------------------------------------------- #
def test_distribute_tree_and_constrain_on_a_2x2_mesh(tmp_path):
    _spawn("dtensor", 4, tmp_path)
    res = json.loads((tmp_path / "out_0.json").read_text())
    leaves = res["leaves"]
    assert len(leaves) == 12
    for path, (got, want, equal, _) in leaves.items():
        assert got == want and equal, path
    # megatron rules on (data 2, model 2): wq (embed, heads) over (data, model);
    # the embedding table (vocab, embed) over (model, data); norms (embed,) over data
    assert leaves["segments/stack/l0/mix/wq"][0] == ["S1", "S2"]
    assert leaves["segments/stack/l0/mix/wq"][3] == [2, 32, 32]
    assert leaves["tok/table"][0] == ["S1", "S0"]
    assert leaves["norm_f/scale"][0] == ["S0", "R"]
    assert res["constrain"] == [["S0", "R"], True, ["S0", "S2"], True, True]
    assert res["nested"] == "refused"
