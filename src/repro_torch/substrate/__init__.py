"""repro_torch.substrate — one Substrate API for simulated and real training
(``repro.substrate`` is the reference).

The fault-tolerance stack (TOL orchestration, TEE attribution, the shared
RecoveryPlanner) drives a *substrate* through one protocol
(:class:`~repro_torch.substrate.base.Substrate`):

    start_ranks / health / kill / save_via_tce / restore_via_tce /
    step_metrics

with two interchangeable implementations:

* ``SimSubstrate``     — the modelled cluster (one SimClock/Topology), whose
                         TOL burn-ins run on its ``device``;
* ``ProcessSubstrate`` — real multi-process ranks
                         (``repro_torch.substrate.worker`` subprocesses on
                         the card or the CPU), real train states through the
                         TCE DiskStore datapath, faults injected by SIGKILL.

``build_substrate(mode=...)`` is the one front door; the shared recovery
driver is :func:`repro_torch.substrate.driver.run_protected`.
"""
from __future__ import annotations

from .base import FaultNotice, RankHealth, StepSlice, Substrate
from .sim import SimSubstrate, build_sim_substrate

__all__ = [
    "Substrate", "RankHealth", "FaultNotice", "StepSlice",
    "SimSubstrate", "ProcessSubstrate",
    "build_sim_substrate", "build_substrate",
]


def __getattr__(name: str):
    # process imports .worker: importing it here would put the worker in
    # sys.modules before ``python -m repro_torch.substrate.worker`` runs it
    if name == "ProcessSubstrate":
        from .process import ProcessSubstrate
        return ProcessSubstrate
    raise AttributeError(name)


def build_substrate(mode: str = "sim", **kwargs):
    """One front door for both substrates.

    ``mode="sim"``     -> :func:`build_sim_substrate` kwargs (n_nodes,
                          n_spares, nodes_per_rack, store_root, with_tee,
                          verbose, nas_bw, device).
    ``mode="process"`` -> :class:`ProcessSubstrate` kwargs (n_ranks,
                          n_spares, ckpt_dir, seed, device, ...).
    """
    if mode == "sim":
        return build_sim_substrate(**kwargs)
    if mode == "process":
        from .process import ProcessSubstrate
        return ProcessSubstrate(**kwargs)
    raise ValueError(f"unknown substrate mode {mode!r} "
                     f"(expected 'sim' or 'process')")
