"""Eagle Eye at fleet scale — streaming, cross-job, confidence-weighted TEE.

The batch TEE (:mod:`repro.core.tee`) rescans whole traces per task; this
package turns the same detector ensemble into an always-on service:

* :mod:`.ring` — ring-buffered per-job metric/log windows (no rescans);
* :mod:`.batch` — one vectorized numpy pass scores jobs x ranks x metrics
  per window stride (plus the per-rank Python loop it is gated against);
* :mod:`.stream` — the single-job exact scorer (pinned equivalent to batch
  ``detect_task``), the fleet-scale batch scorer, attribution confidence,
  and the stream-derived per-category detection-latency model;
* :mod:`.correlator` — joins anomalies sharing a ``Topology`` failure
  domain into ONE :class:`~.correlator.DomainIncident`, handled once.
"""
from .batch import (BatchVerdicts, batch_score_windows, loop_score_windows,
                    to_verdicts)
from .correlator import CrossJobCorrelator, DomainIncident
from .ring import LogRing, MetricRing
from .stream import (CONFIDENCE_FLOOR, SAMPLE_PERIOD_S, FleetStreamTEE,
                     JobAnomaly, StreamLatencyModel, StreamObservation, StreamScorer,
                     StreamVerdict, attribution_confidence,
                     combine_confidences, fitted_models)

__all__ = [
    "BatchVerdicts", "batch_score_windows", "loop_score_windows",
    "to_verdicts", "CrossJobCorrelator", "DomainIncident", "LogRing",
    "MetricRing", "CONFIDENCE_FLOOR", "SAMPLE_PERIOD_S", "FleetStreamTEE",
    "JobAnomaly", "StreamLatencyModel", "StreamObservation", "StreamScorer", "StreamVerdict",
    "attribution_confidence", "combine_confidences", "fitted_models",
]
