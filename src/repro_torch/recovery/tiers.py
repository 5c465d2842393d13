"""The N-tier checkpoint hierarchy model (TierCheck-style).

A :class:`Tier` is one rung of the checkpoint ladder — device HBM, host
DRAM, the peer ring, a rack-local SSD burst buffer, the shared NAS, a cold
object store — with a modelled bandwidth, a capacity budget, a failure
domain it is correlated with, and a durability bit. A :class:`TierTable`
is the ordered hierarchy (hottest first) one engine run plans against.

This module is a dependency-free leaf on purpose: the planner
(`repro.recovery.planner`), the TCE store/engine (`repro.core.tce`) and
the simulators all import it, so it must not import any of them back.

Failure-domain semantics (who dies together):

=========  ==============================================================
``node``   lives on the victim machine itself (HBM arena, host DRAM) —
           gone the instant the node is, useless for evicted restores
``rack``   rack-scoped (the peer ring neighbourhood, the rack burst
           buffer) — a rack outage takes out BOTH peer and ssd copies
``site``   site-durable (NAS, cold store) — survives node/rack loss
=========  ==============================================================
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

# canonical tier names (the grep-able vocabulary of plans and reports)
TIER_DEVICE = "device"
TIER_DRAM = "dram"
TIER_PEER = "peer"
TIER_SSD = "ssd"
TIER_NAS = "nas"
TIER_COLD = "cold"

# failure-domain labels
DOMAIN_NODE = "node"
DOMAIN_RACK = "rack"
DOMAIN_SITE = "site"

# paper §IV-C: 71.1 MB/s effective NAS bandwidth per rank (keep in sync
# with repro.core.tce.store.NAS_BW_PER_RANK — duplicated here so this
# module stays import-free)
_NAS_BW = 71.1e6


@dataclass(frozen=True)
class Tier:
    """One rung of the checkpoint hierarchy."""
    name: str
    read_bw: float                  # bytes/s a restore streams at
    write_bw: float                 # bytes/s a save/demotion streams at
    failure_domain: str             # node | rack | site
    durable: bool                   # survives process death on this node
    capacity_bytes: int = 0         # per-rank budget; 0 = unbounded
    shared: bool = False            # contended across jobs (arbiter-worthy)

    def read_s(self, nbytes: float) -> float:
        return nbytes / self.read_bw if self.read_bw > 0 else 0.0

    def write_s(self, nbytes: float) -> float:
        return nbytes / self.write_bw if self.write_bw > 0 else 0.0


class TierTable:
    """An ordered checkpoint hierarchy, hottest (fastest) tier first."""

    def __init__(self, tiers: Iterable[Tier]):
        self.tiers: Tuple[Tier, ...] = tuple(tiers)
        if not self.tiers:
            raise ValueError("a TierTable needs at least one tier")
        self._by_name: Dict[str, Tier] = {t.name: t for t in self.tiers}
        if len(self._by_name) != len(self.tiers):
            raise ValueError("duplicate tier names in TierTable")

    def names(self) -> Tuple[str, ...]:
        return tuple(t.name for t in self.tiers)

    def get(self, name: str) -> Tier:
        return self._by_name[name]

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def correlated(self, domain: str) -> Tuple[str, ...]:
        """Tier names lost together when ``domain`` fails. A rack outage
        takes out the rack tiers AND the node tiers of its machines."""
        hit = {DOMAIN_NODE: (DOMAIN_NODE,),
               DOMAIN_RACK: (DOMAIN_NODE, DOMAIN_RACK),
               DOMAIN_SITE: (DOMAIN_NODE, DOMAIN_RACK, DOMAIN_SITE),
               }.get(domain, (domain,))
        return tuple(t.name for t in self.tiers if t.failure_domain in hit)

    def coldest(self) -> Tier:
        return self.tiers[-1]


def default_tiers(*, ssd_capacity_bytes: int = 0,
                  nas_capacity_bytes: int = 0) -> TierTable:
    """The full six-rung hierarchy (TierCheck's ladder on TRANSOM's
    numbers). Device/DRAM die with the node; the peer ring and the
    rack burst-buffer SSD die with the rack; NAS and the cold object
    store are site-durable. Capacities default to unbounded; pass
    per-rank byte budgets to exercise demotion."""
    return TierTable((
        Tier(TIER_DEVICE, 200e9, 200e9, DOMAIN_NODE, durable=False),
        Tier(TIER_DRAM, 10e9, 10e9, DOMAIN_NODE, durable=False),
        Tier(TIER_PEER, 100e9, 100e9, DOMAIN_RACK, durable=False),
        Tier(TIER_SSD, 2e9, 1.2e9, DOMAIN_RACK, durable=True,
             capacity_bytes=ssd_capacity_bytes),
        Tier(TIER_NAS, _NAS_BW, _NAS_BW, DOMAIN_SITE, durable=True,
             capacity_bytes=nas_capacity_bytes, shared=True),
        Tier(TIER_COLD, 20e6, 20e6, DOMAIN_SITE, durable=True, shared=True),
    ))


def three_leg_tiers() -> TierTable:
    """The legacy cache→ring-backup→NAS waterfall expressed as a
    TierTable — planning against it reproduces the historical
    ``choose_restore_source`` decisions verbatim."""
    full = default_tiers()
    return TierTable((full.get(TIER_DRAM), full.get(TIER_PEER),
                      full.get(TIER_NAS)))


# legacy restore-source names for each tier (what the decision logs and
# SoakPolicy cost tables call the legs of the 3-leg waterfall)
LEGACY_SOURCE_BY_TIER = {
    TIER_DEVICE: "cache",
    TIER_DRAM: "cache",
    TIER_PEER: "backup",
    TIER_SSD: "store_full",
    TIER_NAS: "store_full",
    TIER_COLD: "store_full",
}


def tiers_down_for(table: TierTable, *, node_lost: bool,
                   rack_lost: bool = False,
                   extra_down: Iterable[str] = ()) -> Tuple[str, ...]:
    """Convenience: tier names unavailable after an incident."""
    down = set(extra_down)
    if rack_lost:
        down.update(table.correlated(DOMAIN_RACK))
    elif node_lost:
        down.update(table.correlated(DOMAIN_NODE))
    return tuple(t for t in table.names() if t in down)
