"""Training traffic: a closed loop of training steps, as the in-process
training entry point (``launch/train.py``'s ``run_single``) runs them: one
batch of uniform token ids per step from the seed, the step's loss read on
the host after every step. A traffic file may add one TCE checkpoint save at
the first step boundary after a given share of the window.

Set-up builds the one training object (the program's state and step
function, holding the benchmark's weights), drives it through its first
steps with the window's own call and feed, and hands it to the window. The
plain reference follows those first steps once the window has closed; the
numbers compared are each step's loss, the first gradient's norm leaf by
leaf (from the optimizer's first moment after one step), and the norm of
each leaf's change after them.
"""
from __future__ import annotations

import gc
import shutil
import statistics
import tempfile
import time
from typing import Dict, List, Optional

import torch

from perfbench.counts import flops
from perfbench.lib import inputs, program
from perfbench.lib.trace import Profile
from perfbench.reference.common import Precision, adamw, path_order

FIRST_STEPS = 3          # the steps the reference follows
ROUNDING_LEAF = 1e-3     # a leaf whose first gradient is under this share of
                         # the median leaf's moves by round-off alone


def _norms(flat: Dict[str, torch.Tensor]) -> Dict[str, float]:
    paths = list(flat)
    return dict(zip(paths, torch.stack([torch.linalg.vector_norm(flat[p].float())
                                        for p in paths]).tolist()))


def _change_norms(current: Dict[str, torch.Tensor], spec, seed, device) -> Dict[str, float]:
    """Each leaf's distance from the weights it started at (drawn again
    from the seed, one leaf at a time)."""
    out = {}
    for path, p0 in inputs.weights(spec, seed, device, torch.float32):
        out[path] = float(torch.linalg.vector_norm(current[path].float() - p0))
        del p0
    return out


def reference_steps(job, precision: str = "bf16", rows: Optional[int] = None):
    """The plain reference over the first steps from the seed's weights:
    (losses, first-gradient norms, change norms). ``rows`` takes only the
    first rows of each batch (a planted fault's stand-in)."""
    t, m, dev = job.traffic, job.port, job.device
    lp = Precision(precision)
    opt = t["optimizer"]
    spec = job.ref.param_spec(m)
    params = inputs.weight_dict(spec, job.seed, dev, torch.float32)
    order = path_order(params)
    mom = {p: torch.zeros_like(x) for p, x in params.items()}
    vel = {p: torch.zeros_like(x) for p, x in params.items()}
    losses, grad = [], None
    for k in range(FIRST_STEPS):
        b = inputs.batch(job.seed, k, t["batch"], t["seq"], m["vocab_size"], dev)
        if rows is not None:
            b = {key: v[:rows] for key, v in b.items()}
        leaves = {p: params[p].detach().requires_grad_(True) for p in order}
        with torch.enable_grad():
            loss = job.ref.loss(leaves, m, b, lp)
            grads = torch.autograd.grad(loss, [leaves[p] for p in order])
        losses.append(float(loss.detach()))
        del leaves, loss
        adamw(params, list(grads), mom, vel, k, opt)
        del grads
        if k == 0:
            grad = {p: v / (1 - opt["b1"]) for p, v in _norms(mom).items()}
    del mom, vel
    change = _change_norms(params, spec, job.seed, dev)
    del params
    return losses, grad, change


def _worst(prog: Dict[str, float], ref: Dict[str, float], paths) -> tuple:
    med = statistics.median(ref[p] for p in paths)
    return max((abs(prog[p] - ref[p]) / max(ref[p], med), p) for p in paths)


def compare(prog, ref, where: Optional[list] = None) -> Dict[str, float]:
    """The numbers read: the worst step's relative loss gap, and the worst
    leaf's gap of norms (first gradient; change after the first steps),
    each over the reference's norm of that leaf or of the median leaf,
    whichever is larger. Leaves whose reference gradient is under
    ``ROUNDING_LEAF`` of the median leaf's are left out of the change.
    ``where`` collects which step and leaves read worst."""
    (pl, pg, pc), (rl, rg, rc) = prog, ref
    loss_gap, step = max((abs(a - b) / abs(b), k + 1) for k, (a, b) in enumerate(zip(pl, rl)))
    grad_gap, g_leaf = _worst(pg, rg, list(rg))
    med_g = statistics.median(rg.values())
    moved = [p for p in rc if rg[p] >= ROUNDING_LEAF * med_g]
    change_gap, c_leaf = _worst(pc, rc, moved)
    if where is not None:
        where.append(f"worst: loss at step {step}, gradient {g_leaf}, change {c_leaf}; "
                     f"{len(rc) - len(moved)} leaves left out of the change")
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The tensors of a training state under the paths a checkpoint gives
    them: a named tuple's fields by name, dict keys sorted, joined by '/'."""
    if hasattr(tree, "_fields"):
        kids = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        kids = [(str(k), tree[k]) for k in sorted(tree)]
    else:
        return {prefix: tree} if isinstance(tree, torch.Tensor) else {}
    out: Dict[str, torch.Tensor] = {}
    for key, sub in kids:
        out.update(_leaves(sub, f"{prefix}/{key}" if prefix else key))
    return out


class Checkpoint:
    """One TCE engine with its store under TMPDIR, as the traffic file sizes it."""

    def __init__(self, ck: dict, state, device):
        from repro_torch.core.tce import DiskStore, TCEConfig, TCEngine
        leaves = list(_leaves(state).values())
        total = sum(x.nbytes for x in leaves) + 2 * 4096 * len(leaves)
        self.root = tempfile.mkdtemp(prefix="perfbench_tce_")
        # each node holds its own shard and its neighbour's backup: on a ring
        # of two, the whole state
        self.engine = TCEngine(TCEConfig(n_nodes=ck["nodes"], backup=True, codec=ck["codec"],
                                         max_cycles=2, mem_limit_bytes=2 * total),
                               DiskStore(self.root, device=device))
        self.handle = None
        self.copy: Dict[str, torch.Tensor] = {}
        self.stall_s: Optional[float] = None
        self.saved_at: Optional[float] = None
        self.durable_after: Optional[float] = None

    def save(self, step: int, state) -> None:
        # the benchmark's own copy of what the save is handed, for the
        # bit-for-bit restores once the window has closed
        self.copy = {p: x.detach().clone() for p, x in _leaves(state).items()}
        with torch.profiler.record_function("tce_save"):
            t0 = time.perf_counter()
            self.handle = self.engine.save(step, state)
            self.saved_at = time.perf_counter()
            self.stall_s = self.saved_at - t0

    def check(self, wait_s: float) -> Dict[str, float]:
        """Durable within ``wait_s`` with no reconciler error, then restored
        bit for bit from the cache, the ring backup with node 0 lost, and the
        store with both nodes lost. Each leg's number counts the leaves that
        differ, plus one if the leg's sources are not the ones named."""
        out = {"saved": 0.0 if self.handle is not None else 1.0}
        if self.handle is None:
            return out
        eng, step = self.engine, self.handle.step
        durable = self.handle.wait(timeout=wait_s)
        out["not_durable"] = float(not durable or bool(eng.reconciler.errors))
        n = eng.cfg.n_nodes
        legs = (("cache", None, {"cache": n}),
                ("backup", 0, {"cache": n - 1, "backup": 1}),
                ("store", 1, {"store": n}))
        for leg, lose, want in legs:
            if lose is not None:
                eng.node_failed(lose)
            try:
                _s, flat = eng.restore(step=step)
            except FileNotFoundError:
                out[f"restore_{leg}"] = float(len(self.copy) + 1)
                continue
            got = {k: v for k, v in eng.stats["restore_sources"].items() if v}
            out[f"restore_{leg}"] = float(_differing(flat, self.copy) + (got != want))
            del flat
        return out

    def close(self) -> None:
        self.engine.close()
        shutil.rmtree(self.root, ignore_errors=True)


def _differing(flat, copy: Dict[str, torch.Tensor]) -> int:
    bad = len(set(copy) ^ set(flat))
    for p, want in copy.items():
        if p not in flat:
            continue
        got = torch.from_numpy(flat[p].copy()).reshape(-1).view(torch.uint8)
        ref = want.reshape(-1).view(torch.uint8)
        bad += int(got.numel() != ref.numel() or not torch.equal(got.to(ref.device), ref))
    return bad


def run(job) -> dict:
    from repro_torch import deterministic
    from repro_torch.models.params import flatten_params
    from repro_torch.train import AdamConfig, TrainConfig, make_train_step
    from repro_torch.train.optimizer import adam_init
    from repro_torch.train.state import TrainState, init_rng

    t, m, dev = job.traffic, job.port, job.device
    rows, seq = t["batch"], t["seq"]
    # as launch/train.py's run_single: deterministic algorithms, TF32 off
    # (TRANSOM's recovery replays a curve bit for bit)
    deterministic(dev)
    spec = job.ref.param_spec(m)
    params = program.param_tree(job.cfg, inputs.weight_dict(spec, job.seed, dev, torch.float32))
    opt_cfg = AdamConfig(**t["optimizer"])
    state = TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                       rng=init_rng(job.seed), params=params, opt=adam_init(params, opt_cfg))
    del params
    step_fn = make_train_step(job.cfg, opt_cfg, TrainConfig())

    def feed(k):
        return inputs.batch(job.seed, k, rows, seq, m["vocab_size"], dev)

    # the first steps: set-up's warm-up, through the window's own call and feed
    losses, grad = [], None
    check_s = 0.0
    for k in range(FIRST_STEPS):
        state, metrics = step_fn(state, feed(k))
        losses.append(float(metrics["loss"]))
        if k == 0:
            c0 = time.perf_counter()
            grad = {p: v / (1 - opt_cfg.b1)
                    for p, v in _norms(flatten_params(state.opt["m"])).items()}
            check_s += time.perf_counter() - c0
    c0 = time.perf_counter()
    change = _change_norms(flatten_params(state.params), spec, job.seed, dev)
    check_s += time.perf_counter() - c0
    prog = (losses, grad, change)

    ck = Checkpoint(t["checkpoint"], state, dev) if t.get("checkpoint") else None
    try:
        _sync(dev)
        setup_s = time.perf_counter() - job.t_start - check_s

        # the window
        prof = Profile() if job.trace else None
        prof_at = t["checkpoint"]["at"] if ck else t["trace_at"]
        prof_steps = t["trace_steps"]
        prof_state = "idle"
        prof_overhead = 0.0
        window_losses: List[float] = []
        step_ends: List[float] = []
        k = FIRST_STEPS
        steps = 0
        t0 = time.perf_counter()
        deadline = t0 + job.seconds
        while True:
            now = time.perf_counter()
            if prof_state == "idle" and now - t0 >= prof_at * job.seconds:
                if prof is not None:
                    p0 = time.perf_counter()
                    prof.start()
                    prof_overhead += time.perf_counter() - p0
                    prof_state, prof_left = "on", prof_steps
                if ck is not None:
                    ck.save(k, state)
                if prof is None:
                    prof_state = "done"
            with torch.profiler.record_function("bench_step"):
                state, metrics = step_fn(state, feed(k))
                window_losses.append(float(metrics["loss"]))
            k += 1
            steps += 1
            step_ends.append(time.perf_counter())
            if ck is not None and ck.handle is not None and ck.durable_after is None \
                    and ck.handle.step in ck.engine.reconciler.durable_at:
                ck.durable_after = step_ends[-1] - ck.saved_at
            if prof_state == "on":
                prof_left -= 1
                if prof_left == 0:
                    p0 = time.perf_counter()
                    prof.stop()
                    prof_overhead += time.perf_counter() - p0
                    prof_state = "done"
            # the window closes at the first step boundary past its end once
            # the save (if any) is taken and the traced steps (if any) are in
            if time.perf_counter() >= deadline and prof_state == "done":
                break
        t1 = time.perf_counter()
        window_s = t1 - t0
        tokens = steps * rows * seq
        mem_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

        # after the window: the trace, the checkpoint's legs, then the reference
        ck_stall = ck.stall_s if ck else None
        ck_durable = ck.durable_after if ck else None
        ctx = {"kind": "train", "profiled": prof_steps if prof is not None else 0,
               "save_stall_s": ck_stall,
               "mfu_flops": flops.train_flops_per_token(m, seq) * tokens,
               "mfu_seconds": window_s - prof_overhead,
               "trace": prof.read() if prof is not None else None}
        numbers: Dict[str, float] = {}
        if ck is not None:
            numbers.update(ck.check(t["checkpoint"]["durable_within_s"]))
    finally:
        if ck is not None:
            ck.close()
    del state, step_fn, metrics, ck
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gaps = [b - a for a, b in zip([t0] + step_ends, step_ends)]
    notes = [f"window: {steps} steps in {window_s:.3f} s, step median "
             f"{statistics.median(gaps):.4f} s, slowest {max(gaps):.4f} s"]
    if ck_stall is not None:
        notes.append(f"save: stall {ck_stall:.3f} s; durable {ck_durable} s after it, "
                     "at the first step boundary it showed")
    numbers.update(compare(prog, reference_steps(job), notes))
    failed = sum(1 for x in window_losses if not torch.isfinite(torch.tensor(x)))
    return {"e2e": {t["end_to_end"]["tok_s"]: tokens / window_s}, "setup_s": setup_s,
            "numbers": numbers, "attempted": steps, "failed": failed,
            "memory_peak_bytes": mem_peak, "ctx": ctx, "notes": notes}
