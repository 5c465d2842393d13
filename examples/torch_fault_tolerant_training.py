"""End-to-end demo on the PyTorch port: training survives SIGKILLs under the
TRANSOM stack. The counterpart of ``examples/fault_tolerant_training.py``.

Drives the one Substrate API (``repro_torch.substrate``) through the shared
recovery loop (``run_protected``): TOL's launcher FSM and error checks, TEE
anomaly attribution, planner-arbitrated replacement via the Topology claim
ledger, and TCE checkpoint restore. Faults are scripted ``KillSpec``s; on
the (default) process substrate each one SIGKILLs a live rank process
running the port's trainer, on the sim substrate it fails a modelled node —
the driver cannot tell the difference, by design.

After the protected run, an uninterrupted reference run proves loss-curve
continuity: rewind-and-replay from real checkpoints reproduces the clean
curve bit for bit.

    PYTHONPATH=src python examples/torch_fault_tolerant_training.py     # CUDA ranks
    PYTHONPATH=src python examples/torch_fault_tolerant_training.py --device cpu
    PYTHONPATH=src python examples/torch_fault_tolerant_training.py --substrate sim
    PYTHONPATH=src python examples/torch_fault_tolerant_training.py --no-verify

``--device`` is where the ranks train (process) or where the TOL burn-ins
run (sim). ``main`` returns the protected run's report, the clean run's
(or None) and whether their loss curves are identical.
"""
import argparse
from typing import Optional, Sequence

from repro_torch import resolve_device
from repro_torch.substrate import build_substrate
from repro_torch.substrate.driver import DriveConfig, KillSpec, run_protected


def build(mode: str, steps: int, device):
    if mode == "process":
        return build_substrate("process", n_ranks=2, n_spares=2, seed=0,
                               total_steps=steps, batch=4, seq=32, device=device)
    return build_substrate("sim", n_nodes=4, n_spares=4, device=device)


def drive(mode: str, steps: int, ckpt_every: int, kills=(), device=None):
    sub = build(mode, steps, device)
    try:
        return run_protected(
            sub, DriveConfig(total_steps=steps, ckpt_every=ckpt_every,
                             scenario=f"example_{mode}"), kills)
    finally:
        sub.close()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--substrate", default="process",
                    choices=("process", "sim"))
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--ckpt-every", type=int, default=6)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the uninterrupted reference run")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    kills = (KillSpec(args.steps * 3 // 8, 1),
             KillSpec(args.steps * 5 // 7, 0, "network"))
    what = (f"2 real PyTorch rank processes on {device} (SIGKILL faults)"
            if args.substrate == "process"
            else f"4 modelled nodes, burn-ins on {device} (failed-node faults)")
    print(f"substrate: {args.substrate} — {what}")
    print(f"kills scripted at steps {[k.step for k in kills]}; "
          f"checkpoints every {args.ckpt_every} steps\n")

    rep = drive(args.substrate, args.steps, args.ckpt_every, kills, device)

    print(f"completed={rep['completed']} steps={rep['steps_done']} "
          f"lost_steps={rep['lost_steps']}")
    print(f"restarts: in-place={rep['restarts']['inplace']} "
          f"rescheduled={rep['restarts']['resched']} "
          f"evicted={rep['evicted_nodes']}")
    print(f"planner decisions: {rep['decisions']['by_decision']}")
    print(f"modeled downtime: {rep['modeled']['downtime_s']:.0f} s "
          f"({rep['modeled']['downtime_s']/60:.1f} min; paper: ~12 min/restart)")
    print(f"final loss: {rep['final_loss']}")
    print("\nFSM history:")
    for _t, s, r in rep["state_history"]:
        print(f"  {s:>16s}  {r[:60]}")

    clean, same = None, None
    if not args.no_verify:
        print("\nuninterrupted reference run (loss-continuity check) ...")
        clean = drive(args.substrate, args.steps, args.ckpt_every, device=device)
        same = clean["losses"] == rep["losses"]
        print(f"loss curves identical: {same} "
              f"(clean final loss: {clean['final_loss']})")
        if not same:
            raise SystemExit("continuity check FAILED")
    return {"report": rep, "clean": clean, "continuity": same}


if __name__ == "__main__":
    main()
