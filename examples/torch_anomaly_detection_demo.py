"""TEE demo on the PyTorch port: train the detector ensemble offline,
register it (test-gated), then detect + localise every fault category
online. The counterpart of ``examples/anomaly_detection_demo.py``; the TEE is
the same numpy code, so it prints the same table.

    PYTHONPATH=src python examples/torch_anomaly_detection_demo.py
    PYTHONPATH=src python examples/torch_anomaly_detection_demo.py --device cpu

The TEE computes on the host. ``--device`` follows the port's rule for every
entry point (the card unless the CPU is asked for): without a card, the
default refuses to run.
"""
import argparse
import tempfile
from typing import Optional, Sequence

from repro_torch import resolve_device
from repro_torch.core.tee import (FAULT_CATEGORIES, ModelRegistry, OfflineTrainer,
                                  TEEService, TraceGenerator)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    resolve_device(ap.parse_args(argv).device)

    gen = TraceGenerator(n_ranks=8, seed=7)
    print("generating 13 normal traces; fitting LOF + NeighborProfile ...")
    normal = [gen.normal() for _ in range(13)]
    trainer = OfflineTrainer()
    models = trainer.fit(normal[:10])

    # evaluation gate + versioned registry
    labeled = normal[10:] + [gen.faulty(gen.sample_category()) for _ in range(11)]
    metrics = trainer.evaluate(models, labeled)
    print(f"offline eval: accuracy={metrics['accuracy']:.2f} "
          f"precision={metrics['precision']:.2f} recall={metrics['recall']:.2f}")
    with tempfile.TemporaryDirectory(prefix="tee_registry_") as root:
        reg = ModelRegistry(root)
        version = reg.register(models, metrics)
        print(f"registered model version v{version}\n")
        svc = TEEService(reg.load())

    table = [f"{'category':12s} {'detected':9s} {'votes':38s} {'bad ranks (true)'}"]
    print(table[0])
    for cat in FAULT_CATEGORIES:
        t = gen.faulty(cat, n_bad=1)
        v = svc.detect_task(t)
        votes = ",".join(k for k, on in v.votes.items() if on)
        table.append(f"{cat:12s} {str(v.anomalous):9s} {votes:38s} "
                     f"{v.bad_ranks} ({t.bad_ranks})")
        print(table[-1])
    return {"eval": {k: metrics[k] for k in ("accuracy", "precision", "recall")},
            "version": version, "table": table}


if __name__ == "__main__":
    main()
