"""ProcessSubstrate: real multi-process PyTorch ranks under the TRANSOM stack.

Counterpart of ``repro.substrate.process``. Each rank is an actual OS
process (``python -m repro_torch.substrate.worker``) running the port's
trainer on a real model on ``device`` (default ``cuda``: every rank holds its
own CUDA context on the card); checkpoints are real train states written
shard-per-rank through the port's TCE ``DiskStore`` datapath (streaming-crc
digests, delta refs, codecs); faults are injected by SIGKILLing a live rank
process. The control plane — the :class:`SimClock` that phase costs charge
to, the :class:`Topology` whose nodes ranks are bound to, the
:class:`TransomServer` bad-node registry — is the same code the simulated
substrate uses, so the recovery driver (:mod:`repro_torch.substrate.driver`)
is oblivious to which substrate it holds.

Torn-save safety is structural: each rank's ``save`` ack means its shards
are durably on disk (tmp-file + rename, index written last), and the
**controller** commits the step manifest only after *every* rank acked.
A rank killed mid-save leaves an invisible, uncommitted step directory —
``latest_step()`` never returns it, so restores can't tear.

One difference from the reference: ``device`` is resolved here, before
any rank is spawned, so asking for ``cuda`` on a host without a card raises
``DeviceUnavailable`` and starts no worker; each worker's ready line must
name the same device.
"""
from __future__ import annotations

import os
import signal
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.tce import DiskStore
from repro_torch.core.tol import TransomServer
from repro_torch.sim.clock import SimClock
from repro_torch.sim.topology import NodeState, Topology

from .base import FaultNotice, RankHealth, StepSlice
from .worker import RankProcess


class ProcessSubstrate:
    """Real-process implementation of the Substrate protocol."""

    def __init__(self, n_ranks: int = 2, n_spares: int = 2,
                 ckpt_dir: Optional[str] = None, seed: int = 0,
                 arch: str = "llama3-8b", layers: int = 1,
                 batch: int = 4, seq: int = 32, lr: float = 1e-2,
                 total_steps: int = 100, codec: str = "raw",
                 delta: bool = True, nodes_per_rack: int = 2,
                 job_id: str = "job0", with_tee: bool = True,
                 log_dir: Optional[str] = None, step_time_s: float = 1.0,
                 device: str = "cuda"):
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", 0)    # a worker's current device
        self.device = device
        self.n_ranks = n_ranks
        self.job_id = job_id
        self.seed = seed
        self.step_time_s = step_time_s
        self.clock = SimClock()
        self.topology = Topology(n_ranks, n_spares=n_spares,
                                 nodes_per_rack=nodes_per_rack,
                                 clock=self.clock)
        self.server = TransomServer()
        self.ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="transom_proc_")
        # the controller decodes on the CPU: prefetch_restore reads every
        # shard here, and an int8 leaf dequantised on the card would open a
        # CUDA context in the controller beside the ranks' own
        self.store = DiskStore(self.ckpt_dir, device="cpu")
        self.log_dir = Path(log_dir or self.ckpt_dir) / "rank_logs"
        self.log_dir.mkdir(parents=True, exist_ok=True)
        if with_tee:
            from repro_torch.core.tee import TEEService

            from .sim import _fitted_tee
            self.tee = TEEService(_fitted_tee(n_ranks=n_ranks))
        else:
            self.tee = None
        self._spec_base = {
            "n_ranks": n_ranks, "seed": seed, "arch": arch, "layers": layers,
            "batch": batch, "seq": seq, "lr": lr, "total_steps": total_steps,
            "ckpt_dir": self.ckpt_dir, "codec": codec, "delta": delta,
            "device": str(self.device),
        }
        self.procs: Dict[int, RankProcess] = {}
        self._pending: Dict[int, str] = {}    # rank -> injected category
        self._last_commit: Optional[int] = None
        self._die_at: Dict[int, tuple] = {}   # rank -> (save_step, mode)
        self._stall_next: Dict[int, float] = {}  # rank -> SIGSTOP seconds
        self.last_rank_walls: Dict[int, float] = {}
        self._step = 0
        # one entry per worker started: rank, pid, its ready line's device
        # and the seconds from spawn to ready
        self.spawn_log: List[dict] = []

    # ------------------------------------------------------------------ #
    def _spawn(self, rank: int) -> None:
        spec = dict(self._spec_base, rank=rank)
        t0 = time.perf_counter()
        proc = RankProcess(
            spec, self.log_dir / f"rank{rank}.{len(self.spawn_log):03d}.log")
        self.spawn_log.append({
            "rank": rank, "pid": proc.pid, "device": proc.ready.get("device"),
            "spawn_s": time.perf_counter() - t0})
        if proc.ready.get("device") != str(self.device):
            proc.close()
            raise RuntimeError(f"rank {rank} worker runs on "
                               f"{proc.ready.get('device')!r}, "
                               f"not {str(self.device)!r}")
        self.procs[rank] = proc

    def start_ranks(self,
                    assignments: Optional[Dict[int, str]] = None) -> None:
        if self.topology.node_of_rank(0) is None and not assignments:
            for rank, node in enumerate(self.topology.assigned):
                self.topology.bind_rank(rank, node)
        for rank, node in (assignments or {}).items():
            self.topology.bind_rank(rank, node)
        for rank in range(self.n_ranks):
            proc = self.procs.get(rank)
            if proc is None or not proc.alive:
                if proc is not None:
                    proc.close()
                self._spawn(rank)

    def health(self) -> List[RankHealth]:
        out = []
        for rank in range(self.n_ranks):
            proc = self.procs.get(rank)
            alive = proc is not None and proc.alive
            node = self.topology.node_of_rank(rank)
            out.append(RankHealth(rank, node or "?", alive,
                                  "" if alive else "process dead"))
        return out

    def kill(self, rank: int, category: str = "node_hw") -> None:
        """SIGKILL a live rank process and fail its node on the topology."""
        node = self.topology.node_of_rank(rank)
        if node is not None and node in self.topology.nodes:
            n = self.topology.nodes[node]
            n.state = NodeState.FAILED
            n.fail_category = category
        self._pending[rank] = category
        proc = self.procs.get(rank)
        if proc is not None:
            proc.kill()

    def stall(self, rank: int, stall_s: float = 1.5) -> None:
        """Freeze ``rank`` for ``stall_s`` during the next training slice
        (SIGSTOP -> sleep -> SIGCONT on the live worker process): a genuine
        straggler whose inflated wall time the metric stream then measures
        (``last_rank_walls``) and the streaming TEE attributes."""
        self._stall_next[rank] = self._stall_next.get(rank, 0.0) + stall_s

    def schedule_save_death(self, rank: int, save_step: int,
                            mode: str = "after_write") -> None:
        """Test hook: make ``rank`` SIGKILL itself during the save of
        ``save_step`` (mode: 'before_write' | 'after_write') — the torn-save
        scenario the manifest-last commit protocol must survive."""
        self._die_at[rank] = (save_step, mode)

    # ------------------------------------------------------------------ #
    def _dead_ranks(self) -> Dict[int, str]:
        dead = {}
        for rank in range(self.n_ranks):
            proc = self.procs.get(rank)
            if proc is None or not proc.alive:
                dead[rank] = self._pending.get(rank, "node_hw")
        return dead

    def step_metrics(self, upto: int) -> StepSlice:
        dead = self._dead_ranks()
        if dead:
            self._pending = {r: c for r, c in self._pending.items()
                             if r not in dead}
            return StepSlice(self._step, fault=FaultNotice(
                step=self._step, dead_ranks=tuple(sorted(dead)),
                categories=dead))
        # stall injection: freeze the stalled ranks BEFORE dispatching the
        # step command, so the slice provably starts with them stopped —
        # a rank too fast to catch mid-step still spends the full stall
        # frozen with work queued on its stdin
        stalled = {r: s for r, s in sorted(self._stall_next.items())
                   if self.procs.get(r) is not None and self.procs[r].alive}
        self._stall_next.clear()
        for rank in stalled:
            os.kill(self.procs[rank].pid, signal.SIGSTOP)
        for proc in self.procs.values():
            proc.send({"cmd": "step", "upto": upto,
                       "t_sent": time.time()})
        elapsed = 0.0
        for rank, s in sorted(stalled.items(), key=lambda kv: kv[1]):
            time.sleep(max(s - elapsed, 0.0))
            elapsed = max(elapsed, s)
            os.kill(self.procs[rank].pid, signal.SIGCONT)
        resps = {rank: proc.recv() for rank, proc in self.procs.items()}
        dead = {rank: self._pending.get(rank, "node_hw")
                for rank, resp in resps.items() if resp is None}
        if dead:
            # a rank died mid-slice; survivors advanced but the job-level
            # step stays at the last committed boundary — recovery rewinds
            # everyone to the checkpoint anyway
            self._pending = {r: c for r, c in self._pending.items()
                             if r not in dead}
            return StepSlice(self._step, fault=FaultNotice(
                step=self._step, dead_ranks=tuple(sorted(dead)),
                categories=dead))
        self.clock.advance(self.step_time_s * max(upto - self._step, 0))
        self._step = upto
        self.last_rank_walls = {
            rank: float(resp.get("wall_s", 0.0))
            for rank, resp in resps.items() if resp is not None}
        # replicated data-parallel: every rank computed the identical
        # full-batch update, so rank 0's losses stand for the job's
        r0 = resps[min(resps)]
        losses = r0.get("losses", [])
        metrics = {"loss": losses[-1][1]} if losses else {}
        return StepSlice(self._step, metrics, losses)

    # ------------------------------------------------------------------ #
    def save_via_tce(self, step: int) -> bool:
        acks = {}
        for rank, proc in self.procs.items():
            cmd = {"cmd": "save", "step": step}
            die = self._die_at.get(rank)
            if die is not None and die[0] == step:
                cmd["die_at"] = die[1]
                del self._die_at[rank]
            proc.send(cmd)
        for rank, proc in self.procs.items():
            acks[rank] = proc.recv()
        if all(a is not None and a.get("ok") for a in acks.values()):
            # manifest-last: the checkpoint becomes visible only now, after
            # every rank's shards are durable
            self.store.commit(step, self.n_ranks, meta={"job": self.job_id},
                              delta_base=self._last_commit)
            self._last_commit = step
            return True
        return False

    def prefetch_restore(self) -> Optional[int]:
        """Warm the restore path while workers are still being checked and
        restarted: read every rank's shards for the latest committed step
        controller-side, so the OS page cache already holds the bytes when
        each worker's restore read lands (no modelled clock here — the win
        is real I/O overlap)."""
        ck = self.store.latest_step()
        if ck is None:
            return None
        try:
            for r in range(self.n_ranks):
                self.store.read_rank(ck, r, verify=False)
        except FileNotFoundError:
            return None
        return int(ck)

    def restore_via_tce(self) -> int:
        ck = self.store.latest_step()
        for proc in self.procs.values():
            proc.send({"cmd": "restore", "step": ck})
        for rank, proc in self.procs.items():
            resp = proc.recv()
            if resp is None or not resp.get("ok"):
                raise RuntimeError(
                    f"rank {rank} failed to restore from step {ck!r}: "
                    f"{resp!r}")
        self._step = int(ck or 0)
        return self._step

    # ------------------------------------------------------------------ #
    def digests(self) -> Dict[int, dict]:
        """Per-rank {leaf path: crc32} of the live state (test support:
        replicated ranks must agree bit-exactly)."""
        out = {}
        for rank, proc in self.procs.items():
            resp = proc.call({"cmd": "digest"})
            if resp is not None and resp.get("ok"):
                out[rank] = resp["leaves"]
        return out

    def close(self) -> None:
        for proc in self.procs.values():
            proc.close()
        self.procs.clear()
