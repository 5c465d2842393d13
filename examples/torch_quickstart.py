"""Quickstart on the PyTorch port: train a reduced llama3 with asynchronous
TCE checkpoints, kill the "job", and resume from the freshest recoverable
checkpoint. The counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py                # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

``main`` returns what it prints, plus whether the restored leaves equal the
saved ones byte for byte (the raw codec stores them as they are).
"""
import argparse
import math
import tempfile
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.tce import DiskStore, TCEConfig, TCEngine
from repro_torch.core.tce.engine import flatten_pytree, unflatten_like
from repro_torch.data import SyntheticLMData
from repro_torch.train import (AdamConfig, TrainConfig, init_train_state,
                               make_train_step)


def _same_bytes(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = resolve_device(ap.parse_args(argv).device)

    cfg = get_config("llama3-8b").reduced()
    opt = AdamConfig(lr=1e-3, warmup_steps=5, decay_steps=60)
    print(f"model: {cfg.name} ({cfg.n_params():,} params) on {device}")

    state = init_train_state(cfg, opt, seed=0, device=device)
    data = SyntheticLMData(cfg.vocab_size, seq_len=64, global_batch=8)
    step_fn = make_train_step(cfg, opt, TrainConfig())

    def batch_at(step):
        return {k: torch.from_numpy(v).to(device) for k, v in data.batch_at(step).items()}

    save_losses = []
    with tempfile.TemporaryDirectory(prefix="transom_quickstart_") as ckpt_dir:
        tce = TCEngine(TCEConfig(n_nodes=4), DiskStore(ckpt_dir, device=device))
        try:
            for step in range(30):
                state, metrics = step_fn(state, batch_at(step))
                if (step + 1) % 10 == 0:
                    h = tce.save(step + 1, state)     # async: training is not stalled
                    save_losses.append(float(metrics["loss"]))
                    print(f"step {step+1:3d}  loss={save_losses[-1]:.4f}  "
                          f"[tce cache write: {h.cache_wall_s*1e3:.1f} ms]")
            saved = flatten_pytree(state)          # the state the step-30 save holds

            # --- simulate a crash + resume -------------------------------- #
            print("\n-- job killed; new process restores --")
            if not tce.reconciler.quiesce(30) or tce.reconciler.errors:
                raise SystemExit(f"checkpoints not durable: {tce.reconciler.errors}")
            ck_step, flat = tce.restore()
            sources = dict(tce.stats["restore_sources"])
            bit_exact = (flat.keys() == saved.keys()
                         and all(_same_bytes(flat[k], saved[k]) for k in saved))
            state2 = unflatten_like(state, flat)
            print(f"restored step {ck_step} from {sources} (memory-first waterfall)")
            resumed_losses = []
            for step in range(ck_step, ck_step + 10):
                state2, metrics = step_fn(state2, batch_at(step))
                resumed_losses.append(float(metrics["loss"]))
            print(f"resumed training to step {int(state2.step)}  "
                  f"loss={resumed_losses[-1]:.4f}")
        finally:
            tce.close()
    return {"arch": cfg.name, "n_params": cfg.n_params(), "device": str(device),
            "save_losses": save_losses, "restored_step": int(ck_step),
            "restore_sources": sources, "restored_bit_exact": bit_exact,
            "resumed_step": int(state2.step), "resumed_losses": resumed_losses,
            "resumed_finite": all(math.isfinite(x) for x in resumed_losses)}


if __name__ == "__main__":
    main()
