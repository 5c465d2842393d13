"""Rank worker: one real PyTorch training process, driven over JSON lines.

    python -m repro_torch.substrate.worker --spec '<json>'

Counterpart of ``repro.substrate.worker``, with the same protocol on
stdin/stdout (stdout is re-pointed at startup so stray library prints land on
stderr, never inside the protocol stream):

    {"cmd": "step", "upto": N}          -> {"ok":1,"step":N,"losses":[[s,l],..],
                                            "wall_s": W}
    {"cmd": "save", "step": S}          -> {"ok":1,"stored":B,"full":K,"refs":R}
    {"cmd": "restore", "step": S|null}  -> {"ok":1,"step":S}
    {"cmd": "digest"}                   -> {"ok":1,"step":s,"leaves":{path:crc}}
    {"cmd": "ping"}                     -> {"ok":1}
    {"cmd": "exit"}                     -> {"ok":1} then exits

and the same spec keys and defaults (reduced arch, lossless globs, delta
refs), plus ``device`` (default ``cuda``), which takes the place of the
reference's ``JAX_PLATFORMS``. Training is **replicated deterministic
data-parallel**: every rank computes the identical full-batch update from the
same seed, so ranks hold bit-identical state without collectives. On the
card the worker sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before CUDA starts,
turns on ``torch.use_deterministic_algorithms`` and keeps TF32 off, so a
restored rank repeats the uninterrupted loss curve bit for bit.

Each rank persists only its ``shard_state(flat, n_ranks)[rank]`` slice
through the port's ``DiskStore`` (streaming-crc digests, changed-leaves-only
delta refs, optional codecs; ``int8`` leaves are quantised on ``device``);
the *controller* commits the manifest only after every rank acked its shard
write, so a rank killed mid-save never leaves a torn checkpoint. ``save``
accepts ``die_at`` ("before_write" / "after_write") to inject a kill at the
worst moments of the save path. On every restore the delta-tracking map is
cleared: after a rewind the same step number may be written again, and a
delta ref into the aborted write would be self-referential.

Checkpoints carry the reference's flat paths and bytes, so a rank of either
package restores the other's (the train-state trees must match: same arch,
layers and moment dtype).

:class:`RankProcess` is the controller's end of one worker (``ProcessSubstrate``
in :mod:`repro_torch.substrate.process` holds one per rank).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

LOSSLESS_PATHS = ("*opt*", "*adam*", "*mu*", "*nu*", "*step*", "*scale*", "*rng*")


def _hijack_stdout():
    """Reserve real stdout for the protocol; stray prints go to stderr."""
    proto = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    return proto


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spec", required=True, help="JSON worker spec")
    args = ap.parse_args()
    spec = json.loads(args.spec)

    proto = _hijack_stdout()
    device_name = spec.get("device", "cuda")

    import torch

    from repro_torch import deterministic, resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core.tce import DiskStore
    from repro_torch.core.tce.engine import flatten_pytree, unflatten_like
    from repro_torch.core.tce.fastcopy import crc32_stream
    from repro_torch.core.tce.sharding import shard_state, unshard_state
    from repro_torch.data import SyntheticLMData
    from repro_torch.train import AdamConfig, TrainConfig, init_train_state, make_train_step

    deterministic(device_name)
    device = resolve_device(device_name)
    rank = int(spec["rank"])
    n_ranks = int(spec["n_ranks"])
    seed = int(spec.get("seed", 0))
    total_steps = int(spec.get("total_steps", 100))
    batch, seq = int(spec.get("batch", 4)), int(spec.get("seq", 32))
    codec = spec.get("codec", "raw")
    delta = bool(spec.get("delta", True))
    # glob patterns, same defaults as the reference (the rng key and the
    # optimizer state must survive any lossy codec bit-exactly)
    lossless = tuple(spec.get("lossless_paths", LOSSLESS_PATHS))

    cfg = get_config(spec.get("arch", "llama3-8b")).reduced()
    if spec.get("layers"):
        cfg = dataclasses.replace(cfg, n_layers=int(spec["layers"]))
    opt_cfg = AdamConfig(lr=float(spec.get("lr", 3e-4)),
                         warmup_steps=max(total_steps // 10, 1),
                         decay_steps=total_steps)
    store = DiskStore(spec["ckpt_dir"], device=device)
    data = SyntheticLMData(cfg.vocab_size, seq, batch, seed)
    step_fn = make_train_step(cfg, opt_cfg, TrainConfig())

    def fresh_state():
        return init_train_state(cfg, opt_cfg, seed=seed, device=device)

    def make_batch(step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(device) for k, v in data.batch_at(step).items()}

    state = fresh_state()
    step = 0
    # delta bookkeeping: leaf path -> (content crc, step whose rank dir
    # holds the actual bytes). Cleared on every restore (see module doc).
    digest_home: dict = {}

    def handle_step(cmd: dict) -> dict:
        nonlocal state, step
        upto = int(cmd["upto"])
        losses = []
        # wall time runs from the controller's dispatch timestamp, as the
        # reference: time spent stopped before reading the command counts
        t_sent = cmd.get("t_sent")
        wall0 = time.perf_counter()
        while step < upto:
            state, metrics = step_fn(state, make_batch(step))
            step += 1
            losses.append([step, float(metrics["loss"])])
        wall = (time.time() - t_sent if t_sent is not None
                else time.perf_counter() - wall0)
        return {"ok": 1, "step": step, "losses": losses, "wall_s": round(wall, 6)}

    def handle_save(cmd: dict) -> dict:
        nonlocal digest_home
        s = int(cmd["step"])
        die_at = cmd.get("die_at")
        if die_at == "before_write":
            os.kill(os.getpid(), signal.SIGKILL)
        shards = shard_state(flatten_pytree(state), n_ranks)[rank]
        digests = {p: crc32_stream(d) for p, (_sp, d) in shards.items()}
        refs = {}
        if delta:
            for p, dig in digests.items():
                home = digest_home.get(p)
                if home is not None and home[0] == dig:
                    refs[p] = (home[1], dig)
        stored = store.write_rank(s, rank, shards, refs=refs, digests=digests,
                                  codec=codec, lossless_paths=lossless)
        for p, dig in digests.items():
            if p not in refs:
                digest_home[p] = (dig, s)
        if die_at == "after_write":
            os.kill(os.getpid(), signal.SIGKILL)
        return {"ok": 1, "stored": int(stored),
                "full": len(shards) - len(refs), "refs": len(refs)}

    def handle_restore(cmd: dict) -> dict:
        nonlocal state, step, digest_home
        digest_home = {}
        ck = cmd.get("step")
        if ck is None:
            state = fresh_state()
            step = 0
            return {"ok": 1, "step": 0}
        ck = int(ck)
        state = unflatten_like(state, unshard_state(store.read_all(ck)))
        step = ck
        return {"ok": 1, "step": ck}

    def handle_digest(_cmd: dict) -> dict:
        return {"ok": 1, "step": step,
                "leaves": {p: crc32_stream(a) for p, a in flatten_pytree(state).items()}}

    handlers = {"step": handle_step, "save": handle_save,
                "restore": handle_restore, "digest": handle_digest,
                "ping": lambda c: {"ok": 1}}

    proto.write(json.dumps({"ready": 1, "rank": rank, "pid": os.getpid(),
                            "device": str(device)}) + "\n")
    proto.flush()
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        cmd = json.loads(line)
        if cmd.get("cmd") == "exit":
            proto.write(json.dumps({"ok": 1}) + "\n")
            proto.flush()
            break
        try:
            resp = handlers[cmd["cmd"]](cmd)
        except Exception as e:  # report, don't die: the controller decides
            resp = {"ok": 0, "error": f"{type(e).__name__}: {e}"}
        proto.write(json.dumps(resp) + "\n")
        proto.flush()
    return 0


# --------------------------------------------------------------------------- #
# Controller side
# --------------------------------------------------------------------------- #
def _worker_env() -> Dict[str, str]:
    """The parent's environment with this package's src root on PYTHONPATH."""
    env = dict(os.environ)
    src_root = str(Path(__file__).resolve().parents[2])
    parts = [src_root] + [p for p in env.get("PYTHONPATH", "").split(":")
                          if p and p != src_root]
    env["PYTHONPATH"] = ":".join(parts)
    return env


class RankProcess:
    """One live rank worker and its JSON-lines protocol channel.

    ``module`` picks the worker program: this one, or the reference's
    ``repro.substrate.worker`` (the interop tests drive both the same way).
    """

    def __init__(self, spec: dict, log_path, module: str = "repro_torch.substrate.worker",
                 env: Optional[Dict[str, str]] = None):
        self.log = open(log_path, "ab")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, "--spec", json.dumps(spec)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.log,
            text=True, bufsize=1, env=env or _worker_env())
        ready = self.recv()
        if not ready or not ready.get("ready"):
            self.close()
            tail = Path(log_path).read_text(errors="replace")[-2000:]
            raise RuntimeError(f"worker failed to start ({log_path}):\n{tail}")
        self.ready = ready
        self.pid = ready["pid"]

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def send(self, obj: dict) -> bool:
        """Write one protocol line; False = the worker is gone."""
        try:
            self.proc.stdin.write(json.dumps(obj) + "\n")
            self.proc.stdin.flush()
            return True
        except (BrokenPipeError, OSError, ValueError):
            return False

    def recv(self) -> Optional[dict]:
        """Blocking read of one protocol line; None = worker died (EOF).

        EOF comes while the dying worker still tears itself down, before it
        can be reaped, so it is reaped here: ``alive`` then agrees with what
        the channel said, and a respawn decided right after sees it dead."""
        line = self.proc.stdout.readline()
        if line:
            return json.loads(line)
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        return None

    def call(self, obj: dict) -> Optional[dict]:
        return self.recv() if self.send(obj) else None

    def kill(self) -> None:
        """SIGKILL the worker: no cleanup, no flush."""
        try:
            self.proc.kill()
        except OSError:
            pass
        self.proc.wait()

    def close(self) -> None:
        """Ask the worker to exit (kill it if it will not), then release it."""
        if self.alive:
            self.call({"cmd": "exit"})
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        for h in (self.proc.stdin, self.proc.stdout):
            try:
                h.close()
            except OSError:
                pass
        self.log.close()


if __name__ == "__main__":
    sys.exit(main())
