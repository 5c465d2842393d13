"""The port's control plane against the reference's: the copied modules
(simulation kernel, recovery planner, report and CLI conventions, the TOL
FSM, lease server, cluster view, fleet simulation and closed-loop operator,
the TEE and the streaming TEE, the Substrate protocol, the recovery driver,
the modelled-cluster substrate, the checkpoint engine's arena, cache, fabric
and theory model, the soak engine, the policy sweep, the trace replay, the
scenario catalog and the multi-job fleet engine) are the reference's source
with the import prefix rewritten, and the TOL checks that run on a device
(burn-in, collective) hold on the CPU.
"""
import difflib
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core.tol import tasks as ref_tasks  # noqa: E402
from repro.sim.topology import NodeState as RefNodeState  # noqa: E402
from repro.sim.topology import Topology as RefTopology  # noqa: E402
from repro_torch.core.tol import tasks  # noqa: E402
from repro_torch.sim.topology import NodeState, Topology  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


def _ref_line(path: str, lineno: int) -> str:
    """One line of a reference module, as it stands."""
    return (SRC / "repro" / path).read_text().splitlines()[lineno - 1]


#: copies of the reference, path -> (reference lines dropped, port lines
#: added) after the import rewrite; none of the plain copies names JAX
COPIES = {
    "sim/clock.py": ((), ()),
    "sim/faults.py": ((), ()),
    "sim/topology.py": ((), ()),
    "recovery/__init__.py": ((), ()),
    "recovery/tiers.py": ((), ()),
    "recovery/planner.py": ((), ()),
    "recovery/executor.py": ((), ()),
    "recovery/cadence.py": ((), ()),
    "report.py": ((), ()),
    "cli.py": ((), ()),
    "core/tol/fsm.py": ((), ()),
    "core/tol/server.py": ((), ()),
    "core/tol/cluster.py": ((), ()),
    "core/tce/arena.py": ((), ()),
    "core/tce/model.py": ((), ()),
    "core/tce/transport.py": ((), ()),
    "core/tee/__init__.py": ((), ()),
    "core/tee/detectors.py": ((), ()),
    "core/tee/preprocess.py": ((), ()),
    "core/tee/service.py": ((), ()),
    "core/tee/traces.py": ((), ()),
    # its registry pickles TEEModels, so a registry loads only in the package
    # that wrote it
    "core/tee/trainer.py": ((), ()),
    "tee_stream/__init__.py": ((), ()),
    "tee_stream/batch.py": ((), ()),
    "tee_stream/correlator.py": ((), ()),
    "tee_stream/ring.py": ((), ()),
    "tee_stream/stream.py": ((), ()),
    "core/tol/simulate.py": ((), ()),
    # three departures: an explicit device for the task suites, a host
    # snapshot of the initial state (the port's step trains in place), and
    # the port's engine (the import rewrite covers it); the docstring names them
    "core/tol/orchestrator.py": (
        ("                 planner: Optional[RecoveryPlanner] = None):",
         "                                       self._rank_to_node())",
         "                state = init_state",
         "        results = warmup_tasks(self.cluster)"),
        ("",
         "Counterpart of ``repro.core.tol.orchestrator``: the reference's source with",
         "the import prefix rewritten and three departures.",
         "",
         "* An explicit device. The port's warm-up and error-check suites take the",
         "  device their burn-in runs on; ``TransomOperator(device=None)`` resolves it",
         "  (the card unless ``\"cpu\"`` is asked for) and hands it to both suites, so",
         "  the burn-in runs on the card the job trains on.",
         "* The initial state is snapshotted. The port's train step updates params",
         "  and moments in place, so a fault before the first checkpoint must not",
         "  fall back to ``init_state`` (by then the trained tensors): ``run_job``",
         "  keeps a host copy (``flatten_pytree``) when it starts and falls back to",
         "  ``unflatten_like(init_state, that copy)``.",
         "* Imports: the engine ``_rebuild_engine`` builds is the port's.",
         "from repro_torch import resolve_device",
         "                 planner: Optional[RecoveryPlanner] = None, device=None):",
         "        self.device = resolve_device(device)",
         "        init_flat = flatten_pytree(init_state)",
         "                                       self._rank_to_node(), device=self.device)",
         "                state = unflatten_like(init_state, init_flat)",
         "        results = warmup_tasks(self.cluster, device=self.device)")),
    # the modelled cluster gains device (resolved first, handed to the
    # operator); a docstring line on the reference's history is restated
    "substrate/sim.py": (
        (_ref_line("substrate/sim.py", 6),
         "                        nas_bw: float = 1e9) -> SimSubstrate:",
         "                               verbose=verbose)"),
        ("wired on top. It also implements the :class:`repro.substrate.base.Substrate`",
         "",
         "Counterpart of ``repro.substrate.sim``; the port's departure is ``device``:",
         "``build_sim_substrate(device=None)`` resolves it (the card unless ``\"cpu\"``",
         "is asked for) before anything is built and hands it to the operator, whose",
         "warm-up and error-check burn-ins are the modelled cluster's only device",
         "work; ``SimSubstrate.device`` is the operator's, for the shared driver.",
         "from repro_torch import resolve_device",
         "",
         "    @property",
         "    def device(self):",
         "        return self.operator.device",
         "                        nas_bw: float = 1e9, device=None) -> SimSubstrate:",
         "    device = resolve_device(device)",
         "                               verbose=verbose, device=device)")),
    # the cache names a leaf's dtype as the codec does (the bf16 carrier)
    "core/tce/cache.py": (
        ("                    stored[path] = StoredShard(spec, sid, n, str(data.dtype),",) * 2
        + ("                    arr = np.array(buf.view(np.dtype(ss.dtype))).reshape(ss.shape)",
           "                    arr = buf.view(np.dtype(ss.dtype)).reshape(ss.shape)"),
        ("from .codec import dtype_name, np_dtype",)
        + ("                    stored[path] = StoredShard(spec, sid, n, dtype_name(data.dtype),",) * 2
        + ("                    arr = np.array(buf.view(np_dtype(ss.dtype))).reshape(ss.shape)",
           "                    arr = buf.view(np_dtype(ss.dtype)).reshape(ss.shape)")),
    # the protocol's docstring names the ranks' framework; it gains device
    "substrate/base.py": (
        ("  JAX ranks (``python -m repro.substrate.worker`` subprocesses running the",),
        ("  PyTorch ranks (``python -m repro.substrate.worker`` subprocesses running the",
         "    device: object      # where the ranks and the error checks run")),
    # the error checks run on the substrate's device
    "substrate/driver.py": (
        ("        checks = error_check_tasks(sub.topology, bad_ranks, rank_to_node)",),
        ("        checks = error_check_tasks(sub.topology, bad_ranks, rank_to_node, "
         "device=sub.device)",)),
    # the soak engine, the fleet control plane and the trace replay: numpy on
    # modelled clocks, no device
    "sim/soak.py": ((), ()),
    "fleet/view.py": ((), ()),
    "fleet/scheduler.py": ((), ()),
    "fleet/engine.py": ((), ()),
    "fleet/presets.py": ((), ()),
    "fleet/__init__.py": ((), ()),
    "sim/__init__.py": ((), ()),
    # the CLIs name the port's module in their usage line
    "fleet/__main__.py": (
        ('        argv, prog="python -m repro.fleet",',),
        ('        argv, prog="python -m repro_torch.fleet",',)),
    "sim/sweep.py": (
        ('        prog="python -m repro.sim.sweep",',
         '            prog="python -m repro.sim.sweep", what="sweep grids",',
         '            hint="python -m repro.sim.sweep --grid <name>")',),
        ('        prog="python -m repro_torch.sim.sweep",',
         '            prog="python -m repro_torch.sim.sweep", what="sweep grids",',
         '            hint="python -m repro_torch.sim.sweep --grid <name>")',)),
    "sim/replay.py": (
        ('        argv, prog="python -m repro.sim.replay",',),
        ('        argv, prog="python -m repro_torch.sim.replay",',)),
    # one departure, an explicit device: every scenario takes it and hands it
    # to each substrate it builds (the fleet presets it registers ignore it),
    # run_scenario and the CLI's --device pass it down; the usage line names
    # the port's module; the docstring names the departure
    "sim/scenarios.py": (
        ('    run: Callable[[int], dict]     # seed -> JSON-able report',
         'def _single_node_crash(seed: int = 0) -> dict:',
         '    sub = build_substrate(n_nodes=4, n_spares=2)',
         'def _straggler(seed: int = 0) -> dict:',
         '    sub = build_substrate(n_nodes=4, n_spares=2)',
         'def _flapping_link(seed: int = 0) -> dict:',
         '    sub = build_substrate(n_nodes=4, n_spares=2)',
         'def _correlated_switch_failure(seed: int = 0) -> dict:',
         '    sub = build_substrate(n_nodes=4, n_spares=4, nodes_per_rack=2)',
         'def _storage_stall(seed: int = 0) -> dict:',
         '    sub = build_substrate(n_nodes=4, n_spares=2)',
         'def _cascading_double_fault(seed: int = 0) -> dict:',
         '    sub = build_substrate(n_nodes=4, n_spares=4)',
         'def _elastic_shrink_then_grow(seed: int = 0) -> dict:',
         '    sub = build_substrate(n_nodes=4, n_spares=0)',
         'def _weekend_closed_loop_pair() -> Tuple[dict, dict]:',
         '    sub_auto = build_substrate(n_nodes=4, n_spares=2)',
         '    sub_man = build_substrate(n_nodes=4, n_spares=2, with_tee=False)',
         'def _weekend_manual_baseline(seed: int = 0) -> dict:',
         '    auto, man = _weekend_closed_loop_pair()',
         'def _save_racing_crash(seed: int = 0) -> dict:',
         '    sub = build_substrate(n_nodes=4, n_spares=2)',
         'def _weeklong_soak(seed: int = 0) -> dict:',
         'def _tiered_outage(seed: int = 0) -> dict:',
         'def _policy_frontier(seed: int = 0) -> dict:',
         '        SCENARIOS[p.name] = Scenario(p.name, f"[fleet] {p.description}",',
         '                                     p.run)',
         'def run_scenario(name: str, seed: int = 0) -> dict:',
         '    return finalize(SCENARIOS[name].run(seed), scenario=name, seed=seed)',
         '        argv, prog="python -m repro.sim.scenarios",',
         '        run=run_scenario, what="scenarios")',),
        ('',
         "Counterpart of ``repro.sim.scenarios``: the reference's source with the",
         'import prefix rewritten and one departure, an explicit device. Every',
         'scenario takes ``device=None`` and hands it to each substrate it builds',
         '(``build_sim_substrate`` resolves it: the card unless ``"cpu"`` is asked',
         "for), whose TOL burn-ins are the modelled cluster's only device work.",
         "``run_scenario(name, seed, device)`` and the CLI's ``--device`` pass it",
         'down; the soak, sweep and fleet presets touch no device and ignore it.',
         '    run: Callable[..., dict]       # (seed, device) -> JSON-able report',
         'def _single_node_crash(seed: int = 0, device=None) -> dict:',
         '    sub = build_substrate(n_nodes=4, n_spares=2, device=device)',
         'def _straggler(seed: int = 0, device=None) -> dict:',
         '    sub = build_substrate(n_nodes=4, n_spares=2, device=device)',
         'def _flapping_link(seed: int = 0, device=None) -> dict:',
         '    sub = build_substrate(n_nodes=4, n_spares=2, device=device)',
         'def _correlated_switch_failure(seed: int = 0, device=None) -> dict:',
         '    sub = build_substrate(n_nodes=4, n_spares=4, nodes_per_rack=2,',
         '                          device=device)',
         'def _storage_stall(seed: int = 0, device=None) -> dict:',
         '    sub = build_substrate(n_nodes=4, n_spares=2, device=device)',
         'def _cascading_double_fault(seed: int = 0, device=None) -> dict:',
         '    sub = build_substrate(n_nodes=4, n_spares=4, device=device)',
         'def _elastic_shrink_then_grow(seed: int = 0, device=None) -> dict:',
         '    sub = build_substrate(n_nodes=4, n_spares=0, device=device)',
         'def _weekend_closed_loop_pair(device=None) -> Tuple[dict, dict]:',
         '    sub_auto = build_substrate(n_nodes=4, n_spares=2, device=device)',
         '    sub_man = build_substrate(n_nodes=4, n_spares=2, with_tee=False,',
         '                              device=device)',
         'def _weekend_manual_baseline(seed: int = 0, device=None) -> dict:',
         '    auto, man = _weekend_closed_loop_pair(device)',
         'def _save_racing_crash(seed: int = 0, device=None) -> dict:',
         '    sub = build_substrate(n_nodes=4, n_spares=2, device=device)',
         'def _weeklong_soak(seed: int = 0, device=None) -> dict:',
         'def _tiered_outage(seed: int = 0, device=None) -> dict:',
         'def _policy_frontier(seed: int = 0, device=None) -> dict:',
         '        SCENARIOS[p.name] = Scenario(',
         '            p.name, f"[fleet] {p.description}",',
         '            lambda seed, device=None, run=p.run: run(seed))',
         'def run_scenario(name: str, seed: int = 0, device=None) -> dict:',
         '    return finalize(SCENARIOS[name].run(seed, device=device), scenario=name,',
         '                    seed=seed)',
         '        argv, prog="python -m repro_torch.sim.scenarios",',
         '        run=run_scenario, what="scenarios",',
         '        add_args=lambda ap: ap.add_argument(',
         '            "--device", choices=("cuda", "cpu"), default="cuda",',
         '            help="where the TOL burn-ins run (default cuda)"),',
         '        run_kwargs=lambda args: {"device": args.device})',)),

}


def _import_rewrite(src: str) -> str:
    return re.sub(r"^(\s*)(from|import) repro\.", r"\1\2 repro_torch.", src, flags=re.M)


@pytest.mark.parametrize("path", sorted(COPIES))
def test_copy_matches_the_reference(path):
    ref = _import_rewrite((SRC / "repro" / path).read_text()).splitlines()
    port = (SRC / "repro_torch" / path).read_text().splitlines()
    diff = list(difflib.ndiff(ref, port))
    dropped = tuple(l[2:] for l in diff if l.startswith("- "))
    added = tuple(l[2:] for l in diff if l.startswith("+ "))
    assert (dropped, added) == COPIES[path]


def test_burn_in_and_collective_check_pass_on_the_cpu():
    burn = tasks.device_burn_in("cpu")
    assert (burn.name, burn.ok, burn.bad_nodes) == ("device_burn_in", True, [])
    coll = tasks.collective_check("cpu")
    assert (coll.name, coll.ok, coll.detail) == ("collective_check", True,
                                                 "single-device trivial pass")


def test_burn_in_fails_on_a_corrupted_operand(monkeypatch):
    matmul = torch.matmul

    def corrupting(x, y):
        x = x.clone()
        x[3, 7] += 1.0          # one flipped value of the first operand
        return matmul(x, y)

    monkeypatch.setattr(torch, "matmul", corrupting)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    burn = tasks.device_burn_in("cpu")
    assert not burn.ok and burn.bad_nodes == ["cpu"]
    assert torch.backends.cuda.matmul.allow_tf32 == tf32


def _failed_cluster(topology_cls, node_state):
    cl = topology_cls(4, n_spares=2, nodes_per_rack=2)
    for rank, node in enumerate(cl.assigned):
        cl.bind_rank(rank, node)
    cl.nodes[cl.assigned[1]].state = node_state.FAILED
    cl.nodes[cl.assigned[2]].state = node_state.DEGRADED
    cl.nodes[cl.assigned[2]].fail_category = "network"
    return cl, {r: cl.node_of_rank(r) for r in range(4)}


def _summary(results):
    return [(r.name, r.ok, r.bad_nodes) for r in results]


def test_error_check_tasks_match_the_reference():
    ref_cl, ref_map = _failed_cluster(RefTopology, RefNodeState)
    cl, rank_map = _failed_cluster(Topology, NodeState)
    ref = ref_tasks.error_check_tasks(ref_cl, [3], ref_map)
    port = tasks.error_check_tasks(cl, [3], rank_map, device="cpu")
    assert [r.name for r in port] == ["disk_check", "device_burn_in", "collective_check",
                                      "node_health_check", "connectivity_check",
                                      "tee_attribution"]
    assert _summary(port) == _summary(ref)
    assert _summary(tasks.warmup_tasks(cl, device="cpu")) == \
        _summary(ref_tasks.warmup_tasks(ref_cl))
    assert [r.name for r in tasks.error_check_tasks(device="cpu")] == \
        [r.name for r in ref_tasks.error_check_tasks()]


def test_checks_need_an_explicit_device():
    with pytest.raises(TypeError):
        tasks.error_check_tasks()
    with pytest.raises(TypeError):
        tasks.warmup_tasks()
