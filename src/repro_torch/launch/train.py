"""Training driver under fault-tolerant recovery (``repro.launch.train`` is
the reference).

    # the in-process loop on the card (real train step, TCE checkpoints),
    # and the same resumed from its freshest checkpoint:
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --reduced --steps 60 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --resume
    # the same on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.train --tiny --steps 20 \
        --ckpt-every 10 --device cpu

    # real multi-process ranks under the TOL/planner recovery loop, with
    # scripted SIGKILLs (the fault-tolerance capstone), on the card:
    PYTHONPATH=src python -m repro_torch.launch.train --substrate process \
        --tiny --ranks 2 --spares 2 --steps 24 --ckpt-every 6 \
        --inject-kills 9:1,17:0 --json /tmp/run.json
    # the same on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.train --substrate process \
        --tiny --ranks 2 --spares 2 --steps 24 --ckpt-every 6 \
        --inject-kills 9:1,17:0 --device cpu

    # the same protected run on the modelled cluster (seconds, no procs;
    # the TOL burn-ins run on --device):
    PYTHONPATH=src python -m repro_torch.launch.train --substrate sim \
        --ranks 4 --steps 40 --ckpt-every 10 --inject-kills 13:1,27:2 \
        --device cpu

The flags are the reference's, plus ``--device`` (default ``cuda``; without
a card the run fails before any rank starts or any checkpoint is written).
``--substrate single`` (the default) is the in-process loop: the real train
step on ``--device``, checkpointing through one local TCE rank
(``TCEConfig(n_nodes=1, backup=False)``: there is no ring to back up to),
resuming from the freshest checkpoint with ``--resume``. It trains in
deterministic mode, so a resumed run repeats the uninterrupted one bit for
bit; it exits 1 unless every checkpoint it took became durable (the
reconciler quiesced and logged no error). ``--substrate process|sim`` hand
the run to the shared recovery driver
(:func:`repro_torch.substrate.driver.run_protected`): the substrate is
built by :func:`repro_torch.substrate.build_substrate` and the driver speaks
only the Substrate protocol. As in the reference, the process ranks always
train the reduced arch, so ``--reduced`` changes nothing there. Exit code
follows the shared convention: 0 iff the run completed.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time

from repro_torch import DeviceUnavailable
from repro_torch.cli import (EXIT_FAILURE, EXIT_OK, EXIT_USAGE, base_parser,
                             list_catalog, write_reports)

SUBSTRATES = {
    "single": "in-process training loop, local TCE checkpoints (--resume)",
    "process": "real multi-process PyTorch ranks + TOL/TEE recovery driver",
    "sim": "modelled cluster under the same recovery driver",
}


def scale_config(cfg, args):
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


def build_argparser():
    ap = base_parser("python -m repro_torch.launch.train",
                     "Train a model, optionally under fault-tolerant "
                     "recovery (substrate modes: single | process | sim).")
    ap.add_argument("--substrate", default="single",
                    choices=sorted(SUBSTRATES),
                    help="where the ranks run (default: single)")
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the arch to its reduced test size")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="shorthand for --reduced --layers 1 with a small "
                         "batch/seq (fast smoke runs)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_ckpt in the "
                         "temp dir for single mode, a fresh tempdir otherwise)")
    ap.add_argument("--codec", default="raw",
                    help="TCE persist codec (raw|zlib|int8)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the freshest checkpoint (single mode)")
    ap.add_argument("--log-every", type=int, default=10)
    # protected-mode knobs (process/sim)
    ap.add_argument("--ranks", type=int, default=2,
                    help="gang size for process/sim substrates")
    ap.add_argument("--spares", type=int, default=2,
                    help="replacement pool size for process/sim substrates")
    ap.add_argument("--inject-kills", default="", metavar="SPECS",
                    help="scripted faults 'STEP:RANK[:CATEGORY],...' "
                         "(process/sim modes)")
    ap.add_argument("--inject-stalls", default="", metavar="SPECS",
                    help="scripted stragglers 'STEP:RANK[:SECONDS],...' — "
                         "SIGSTOP/SIGCONT a live rank (process/sim modes)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where training (single), the ranks (process) and "
                         "the error checks (process, sim) run (default: cuda)")
    return ap


def _apply_tiny(args) -> None:
    if args.tiny:
        args.reduced = True
        args.layers = args.layers or 1
        args.batch = min(args.batch, 2)
        args.seq = min(args.seq, 16)


# --------------------------------------------------------------------------- #
def run_single(args) -> int:
    """The in-process loop: real step fn, local TCE rank."""
    import torch

    from repro_torch import deterministic, resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core.tce import DiskStore, TCEConfig, TCEngine
    from repro_torch.core.tce.engine import unflatten_like
    from repro_torch.data import SyntheticLMData
    from repro_torch.train import (AdamConfig, TrainConfig, init_train_state,
                                   make_train_step)

    try:
        device = resolve_device(args.device)
    except DeviceUnavailable as e:
        print(f"error: DeviceUnavailable: {e}", file=sys.stderr)
        return EXIT_FAILURE
    deterministic(device)
    cfg = scale_config(get_config(args.arch), args)
    opt_cfg = AdamConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                         decay_steps=args.steps)
    print(f"arch={cfg.name} params={cfg.n_params():,} device={device}")

    state = init_train_state(cfg, opt_cfg, seed=args.seed, device=device)
    data = SyntheticLMData(cfg.vocab_size, args.seq, args.batch, args.seed)

    # one local rank, no ring: there is no second machine to back up to
    root = args.ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_ckpt")
    tce = TCEngine(TCEConfig(n_nodes=1, backup=False, codec=args.codec),
                   DiskStore(root, device=device))
    start = 0
    if args.resume:
        try:
            ck_step, flat = tce.restore()
            state = unflatten_like(state, flat)
            start = int(ck_step)
            data.restore(type(data.state)(start))
            print(f"resumed from step {start}")
        except FileNotFoundError:
            print("no checkpoint found; starting fresh")

    step_fn = make_train_step(cfg, opt_cfg, TrainConfig())
    t0 = time.time()
    final_loss = None
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch_at(step).items()}
        state, metrics = step_fn(state, batch)
        final_loss = float(metrics["loss"])
        if (step + 1) % args.log_every == 0 or step == start:
            print(f"step {step+1:5d} loss={final_loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"({(time.time()-t0)/(step-start+1):.2f}s/step)")
        if (step + 1) % args.ckpt_every == 0:
            h = tce.save(step + 1, state)
            print(f"  tce.save(step={step+1}) "
                  f"cache={h.cache_wall_s*1e3:.0f}ms "
                  f"(async persist in background)")
    durable = tce.reconciler.quiesce(60)
    tce.close()
    errors = list(tce.reconciler.errors)
    if not durable or errors:
        # the reconciler keeps going past a failed persist; the run must not
        print(f"error: checkpoints not durable (quiesced: {durable}, "
              f"reconciler errors: {errors})", file=sys.stderr)
        return EXIT_FAILURE
    if args.json or args.out:
        from repro_torch.report import finalize
        rep = finalize({"completed": True, "steps_done": args.steps,
                        "total_steps": args.steps, "arch": cfg.name,
                        "final_loss": final_loss,
                        "measured": {"wall_s": round(time.time() - t0, 3)}},
                       engine="train", scenario="single", seed=args.seed)
        write_reports([rep], json_path=args.json, out_dir=args.out)
    print("done.")
    return EXIT_OK


# --------------------------------------------------------------------------- #
def run_protected_mode(args) -> int:
    """process/sim substrates under the shared recovery driver."""
    from repro_torch.substrate import build_substrate
    from repro_torch.substrate.driver import (DriveConfig, KillSpec,
                                              StallSpec, run_protected)

    try:
        kills = KillSpec.parse_list(args.inject_kills)
        stalls = StallSpec.parse_list(args.inject_stalls)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_USAGE

    try:
        if args.substrate == "process":
            sub = build_substrate(
                "process", n_ranks=args.ranks, n_spares=args.spares,
                ckpt_dir=args.ckpt_dir, seed=args.seed, arch=args.arch,
                layers=args.layers or 1, batch=args.batch, seq=args.seq,
                lr=args.lr, total_steps=args.steps, codec=args.codec,
                device=args.device)
        else:
            sub = build_substrate("sim", n_nodes=args.ranks,
                                  n_spares=args.spares,
                                  store_root=args.ckpt_dir, device=args.device)
    except DeviceUnavailable as e:
        print(f"error: DeviceUnavailable: {e}", file=sys.stderr)
        return EXIT_FAILURE
    cfg = DriveConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      seed=args.seed,
                      scenario=f"train_{args.substrate}")
    try:
        rep = run_protected(sub, cfg, kills, stalls)
    finally:
        sub.close()
    shown = {k: rep[k] for k in ("engine", "scenario", "seed", "completed",
                                 "steps_done", "lost_steps", "restarts",
                                 "final_loss", "timeline_digest")}
    shown["decisions"] = rep["decisions"]["by_decision"]
    print(json.dumps(shown, indent=2, sort_keys=True))
    write_reports([rep], json_path=args.json, out_dir=args.out)
    return EXIT_OK if rep["completed"] else EXIT_FAILURE


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.list:
        return list_catalog(
            SUBSTRATES, prog="python -m repro_torch.launch.train",
            what="substrate modes",
            hint="python -m repro_torch.launch.train --substrate <name>")
    _apply_tiny(args)
    if args.substrate == "single":
        return run_single(args)
    return run_protected_mode(args)


if __name__ == "__main__":
    sys.exit(main())
