"""repro_torch.substrate — the Substrate API over real PyTorch ranks
(``repro.substrate`` is the reference).

The fault-tolerance stack (TOL error checks, the shared RecoveryPlanner)
drives a *substrate* through one protocol
(:class:`~repro_torch.substrate.base.Substrate`):

    start_ranks / health / kill / save_via_tce / restore_via_tce /
    step_metrics

The port has one implementation so far, ``ProcessSubstrate``: real
multi-process ranks (``repro_torch.substrate.worker`` subprocesses on the
card or the CPU), real train states through the TCE DiskStore datapath,
faults injected by SIGKILL. The modelled cluster (``SimSubstrate``) comes with
the TCE engine and the TEE (ROADMAP queue 1, item 3).

``build_substrate(mode=...)`` is the one front door; the shared recovery
driver is :func:`repro_torch.substrate.driver.run_protected`.
"""
from __future__ import annotations

from .base import FaultNotice, RankHealth, StepSlice, Substrate

__all__ = [
    "Substrate", "RankHealth", "FaultNotice", "StepSlice",
    "ProcessSubstrate", "build_substrate",
]


def __getattr__(name: str):
    # process imports .worker: importing it here would put the worker in
    # sys.modules before ``python -m repro_torch.substrate.worker`` runs it
    if name == "ProcessSubstrate":
        from .process import ProcessSubstrate
        return ProcessSubstrate
    raise AttributeError(name)


def build_substrate(mode: str = "process", **kwargs):
    """One front door for the substrates.

    ``mode="process"`` -> :class:`ProcessSubstrate` kwargs (n_ranks,
                          n_spares, ckpt_dir, seed, device, ...).
    ``mode="sim"``     -> not ported yet (ROADMAP queue 1, item 3).
    """
    if mode == "process":
        from .process import ProcessSubstrate
        return ProcessSubstrate(**kwargs)
    if mode == "sim":
        raise NotImplementedError(
            "the sim substrate is not ported yet: it needs the TCE engine "
            "and the TEE (ROADMAP queue 1, item 3)")
    raise ValueError(f"unknown substrate mode {mode!r} "
                     f"(expected 'sim' or 'process')")
