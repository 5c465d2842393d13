"""Eagle Eye — the streaming TEE scoring paths.

Two scorers share one contract (score windows on the batch detector's exact
schedule, fire once per anomaly, attach an attribution confidence):

* :class:`StreamScorer` — the single-job ONLINE path: per-rank metric/log
  columns are ingested into ring buffers and every ``stride`` samples the
  newest window is scored with the *exact* ``TEEService.score_window`` math
  (including the DTW cluster vote). Pinned equivalent to batch
  ``detect_task`` on the same trace (tests/test_tee.py).
* :class:`FleetStreamTEE` — the fleet-scale path: every job observed at one
  timestamp is scored in a single vectorized pass per window stride
  (:func:`repro.tee_stream.batch.batch_score_windows`), and per-job
  verdicts carry a confidence the cross-job correlator and the
  RecoveryPlanner consume.

Confidence (Unicron: weigh detection confidence against recovery cost) is a
deterministic [0, 1] blend of detector agreement, score margin over the
fitted thresholds, and attribution strength (a log-confirmed first-error
rank is the paper's strongest signal).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.tee.detectors import LogDetector
from repro_torch.core.tee.service import TEEService, TEEVerdict
from repro_torch.core.tee.trainer import OfflineTrainer, TEEModels
from repro_torch.core.tee.traces import TaskTrace, TraceGenerator
from repro_torch.recovery.planner import CONFIDENCE_FLOOR  # noqa: F401 (re-export)

from .batch import batch_score_windows, to_verdicts
from .ring import LogRing, MetricRing

# one modelled second per metric sample: detection latency in samples maps
# 1:1 onto modelled seconds on the shared SimClock
SAMPLE_PERIOD_S = 1.0


@functools.lru_cache(maxsize=8)
def fitted_models(n_ranks: int, seed: int = 1) -> TEEModels:
    """A fitted TEE ensemble for gangs of ``n_ranks`` (cached: the fleet
    reuses one ensemble per gang size across every job)."""
    gen = TraceGenerator(n_ranks=n_ranks, seed=seed)
    return OfflineTrainer().fit([gen.normal() for _ in range(8)])


# --------------------------------------------------------------------------- #
# confidence
# --------------------------------------------------------------------------- #
def attribution_confidence(verdict: TEEVerdict,
                           models: Optional[TEEModels] = None) -> float:
    """Deterministic [0, 1] attribution confidence for one verdict."""
    if not verdict.anomalous:
        return 0.0
    votes = verdict.votes
    n_active = sum(bool(votes.get(k))
                   for k in ("log", "lof", "nprofile", "cluster"))
    vote_part = n_active / 4.0
    lof_m = min(verdict.detail.get("lof_frac", 0.0) / 0.2, 2.0) / 2.0
    np_m = 0.0
    if models is not None and models.np_thresh > 0:
        np_m = min(verdict.detail.get("np_max", 0.0) / models.np_thresh,
                   2.0) / 2.0
    margin_part = (lof_m + np_m) / 2.0
    if not verdict.bad_ranks:
        attr_part = 0.0           # fired, but nobody to blame: weak evidence
    elif votes.get("log"):
        attr_part = 1.0           # log-confirmed first-error rank
    else:
        attr_part = 0.75          # metric-only attribution
    conf = 0.35 * vote_part + 0.25 * margin_part + 0.40 * attr_part
    return round(min(max(conf, 0.0), 1.0), 4)


def combine_confidences(confs: Sequence[float]) -> float:
    """Independent-evidence combination across jobs observing the same
    failure domain: 1 - prod(1 - c_i)."""
    miss = 1.0
    for c in confs:
        miss *= 1.0 - min(max(c, 0.0), 1.0)
    return round(1.0 - miss, 4)


# --------------------------------------------------------------------------- #
# single-job streaming scorer (exact batch-equivalent path)
# --------------------------------------------------------------------------- #
@dataclass
class StreamVerdict:
    """A firing (or final quiet) streaming verdict plus its provenance."""
    verdict: TEEVerdict
    confidence: float
    latency: Optional[int] = None    # samples from onset to window close
    windows_scored: int = 0


class StreamScorer:
    """Online single-job TEE: ingest columns, score every ``stride``.

    Uses the exact ``TEEService.score_window`` ensemble (LOF +
    NeighborProfile + DTW cluster + logs) over ring-buffered windows, on
    the exact window schedule of batch ``detect_task`` — so on the same
    trace it fires on the same window with the same verdict.
    """

    def __init__(self, models: TEEModels, log_threshold: int = 3,
                 cluster=None, stride: Optional[int] = None,
                 n_ranks: Optional[int] = None,
                 n_metrics: Optional[int] = None):
        self.svc = TEEService(models, log_threshold, cluster)
        self.m = models
        self.stride = stride or models.window // 2
        self._n_ranks = n_ranks
        self._n_metrics = n_metrics
        self._ring: Optional[MetricRing] = None
        self._logs = LogRing(horizon=4 * models.window)
        self._init_len = 0
        self._next_t0 = 0
        self._fired: Optional[TEEVerdict] = None
        self._last: Optional[TEEVerdict] = None
        self.windows_scored = 0

    # ------------------------------------------------------------------ #
    def reset(self, init_len: int = 0) -> None:
        self._ring = None
        self._logs = LogRing(horizon=4 * self.m.window)
        self._init_len = init_len
        self._next_t0 = init_len
        self._fired = None
        self._last = None
        self.windows_scored = 0

    @property
    def count(self) -> int:
        return self._ring.count if self._ring is not None else 0

    def ingest(self, cols: np.ndarray,
               logs: Sequence[Tuple[int, int, str, str]] = ()
               ) -> Optional[TEEVerdict]:
        """Feed new per-rank samples (and any log lines); returns the
        firing verdict the first time a window fires, else None."""
        cols = np.asarray(cols, np.float64)
        if cols.ndim == 2:
            cols = cols[:, None, :]
        if self._ring is None:
            self._ring = MetricRing(cols.shape[0], cols.shape[2],
                                    capacity=2 * self.m.window)
        self._ring.push(cols)
        if logs:
            self._logs.push(list(logs))
        return self._poll()

    def _score(self, t0: int, t1: int) -> TEEVerdict:
        w = t1 - t0
        win = self._ring.window(self.count - t0)[:, :w, :]
        self.windows_scored += 1
        return self.svc.score_window(win, self._logs.window(t0, t1), t0, t1)

    def _poll(self) -> Optional[TEEVerdict]:
        """Score every full window whose samples have all arrived."""
        if self._fired is not None or self._ring is None:
            return None
        w = self.m.window
        while self._next_t0 + w <= self.count:
            v = self._score(self._next_t0, self._next_t0 + w)
            self._next_t0 += self.stride
            if v.anomalous:
                self._fired = v
                return v
            self._last = v
        return None

    def finish(self) -> TEEVerdict:
        """End of stream: the firing verdict, the last quiet one, or (for
        streams shorter than one window) the single clipped window batch
        ``detect_task`` would have scored."""
        if self._fired is not None:
            return self._fired
        if self._last is not None:
            return self._last
        T = self.count
        if self._ring is None or T <= self._init_len:
            return TEEVerdict(False, {}, (), (0, 0))
        v = self._score(self._init_len, T)     # clipped short-trace window
        if v.anomalous:
            self._fired = v
        else:
            self._last = v
        return v

    # ------------------------------------------------------------------ #
    def score_trace(self, trace: TaskTrace, chunk: int = 16) -> StreamVerdict:
        """Stream a whole trace through the ring in ``chunk``-sample
        increments; returns the verdict ``detect_task`` would return, plus
        confidence and detection latency (samples from trace onset to the
        close of the firing window)."""
        self.reset(trace.init_len)
        T = trace.metrics.shape[1]
        fired: Optional[TEEVerdict] = None
        for c0 in range(0, T, chunk):
            c1 = min(c0 + chunk, T)
            logs = [e for e in trace.logs if c0 <= e[0] < c1]
            v = self.ingest(trace.metrics[:, c0:c1, :], logs)
            if v is not None:
                fired = v
                break
        verdict = fired if fired is not None else self.finish()
        latency = None
        if verdict.anomalous and trace.onset is not None:
            latency = max(verdict.window[1] - trace.onset, 0)
        return StreamVerdict(verdict,
                             attribution_confidence(verdict, self.m),
                             latency, self.windows_scored)


# --------------------------------------------------------------------------- #
# per-category streamed detection latency (soak's stream-derived detect time)
# --------------------------------------------------------------------------- #
class StreamLatencyModel:
    """Detection latency per fault category, measured by actually streaming
    one synthesized signature per category through the scorer (instead of
    drawing a detect time from an exponential). Deterministic and cached."""

    def __init__(self, n_ranks: int = 8, seed: int = 7,
                 sample_period_s: float = SAMPLE_PERIOD_S):
        self.n_ranks = n_ranks
        self.seed = seed
        self.sample_period_s = sample_period_s
        self._cache: Dict[Tuple[str, bool], float] = {}

    def latency_s(self, category: str, degrades_only: bool = False) -> float:
        key = (category, degrades_only)
        if key not in self._cache:
            gen = TraceGenerator(n_ranks=self.n_ranks, seed=self.seed)
            tr = gen.for_fault(category, bad_rank=0, T=240, onset=120,
                               degrades_only=degrades_only)
            sv = StreamScorer(fitted_models(self.n_ranks)).score_trace(tr)
            lat = sv.latency if sv.latency is not None else 120
            self._cache[key] = float(lat) * self.sample_period_s
        return self._cache[key]


# --------------------------------------------------------------------------- #
# fleet-scale streaming service
# --------------------------------------------------------------------------- #
@dataclass
class JobAnomaly:
    """One job's streamed verdict, ready for cross-job correlation."""
    t_detect: float                  # modelled seconds when the window fired
    job: str
    domain: str                      # failure domain shared by the victims
    victims: Tuple[str, ...]         # attributed node names
    confidence: float
    category: str
    latency_s: float
    window: Tuple[int, int] = (0, 0)


@dataclass
class StreamObservation:
    job: str
    n_ranks: int
    rank: int
    node: str
    domain: str
    category: str
    degrades_only: bool


class FleetStreamTEE:
    """The always-on fleet service: per-job rings, one vectorized scoring
    pass per window stride across every job observed at a timestamp.

    The fleet engine is a DES, so "the stream" for a job materialises when
    a degradation event touches it: the job's per-rank signature columns
    (shared Table-I fault model) are pushed through its MetricRing and the
    stacked windows of all touched jobs are scored per stride in one
    :func:`batch_score_windows` call. The firing stride gives each job a
    deterministic detection latency; the verdict rolls up into a
    :class:`JobAnomaly` with attribution confidence.
    """

    def __init__(self, seed: int = 0, window: Optional[int] = None,
                 sample_period_s: float = SAMPLE_PERIOD_S,
                 onset: int = 120, trace_len: int = 240):
        self.seed = seed
        self.sample_period_s = sample_period_s
        self.onset = onset
        self.trace_len = trace_len
        self.log_det = LogDetector()
        self.stats = dict(observations=0, batch_passes=0, windows_scored=0,
                          verdicts=0, quiet=0)

    # ------------------------------------------------------------------ #
    def _job_trace(self, obs: StreamObservation) -> TaskTrace:
        # deterministic per-job stream: seeded by the fleet seed + job name
        import zlib
        jseed = (self.seed * 1000003 + zlib.crc32(obs.job.encode())) % (2**31)
        gen = TraceGenerator(n_ranks=obs.n_ranks, seed=jseed)
        return gen.for_fault(obs.category, bad_rank=obs.rank,
                             T=self.trace_len, onset=self.onset,
                             degrades_only=obs.degrades_only)

    def observe(self, t: float, observations: List[StreamObservation]
                ) -> List[JobAnomaly]:
        """Stream every observed job's metrics through its ring, scoring
        all of them together — one vectorized pass per window stride."""
        if not observations:
            return []
        self.stats["observations"] += len(observations)
        out: List[JobAnomaly] = []
        # group by gang size: one batch tensor per group
        by_ranks: Dict[int, List[StreamObservation]] = {}
        for obs in observations:
            by_ranks.setdefault(obs.n_ranks, []).append(obs)
        for n_ranks, group in sorted(by_ranks.items()):
            out.extend(self._observe_group(t, n_ranks, group))
        return out

    def _observe_group(self, t: float, n_ranks: int,
                       group: List[StreamObservation]) -> List[JobAnomaly]:
        models = fitted_models(n_ranks)
        w = models.window
        stride = w // 2
        traces = [self._job_trace(o) for o in group]
        # stride batching across only the still-quiet jobs: the group's
        # traces share one (jobs, ranks, T, metrics) tensor and each stride
        # slices the current window for every live job in one indexing op —
        # no per-job ring allocation or push loop on the hot path, and jobs
        # leave the batch the stride they fire
        stack = np.stack([tr.metrics for tr in traces])
        T = self.trace_len
        init_len = traces[0].init_len
        fired: Dict[int, TEEVerdict] = {}
        live = list(range(len(group)))
        for t0 in TEEService.window_starts(T, init_len, w, stride):
            t1 = t0 + w
            if t1 > T or not live:
                break
            windows = stack[np.asarray(live), :, t0:t1, :]
            bv = batch_score_windows(models, windows)
            lvs = [self.log_det.detect(traces[j].logs, t0, t1) for j in live]
            verdicts = to_verdicts(bv, t0, t1, lvs)
            self.stats["batch_passes"] += 1
            self.stats["windows_scored"] += len(live)
            for j, v in zip(tuple(live), verdicts):
                if v.anomalous:
                    fired[j] = v
                    live.remove(j)
        out: List[JobAnomaly] = []
        for j, obs in enumerate(group):
            v = fired.get(j)
            if v is None:
                self.stats["quiet"] += 1
                continue
            self.stats["verdicts"] += 1
            lat_s = max(v.window[1] - self.onset, 0) * self.sample_period_s
            out.append(JobAnomaly(
                t_detect=t + lat_s, job=obs.job, domain=obs.domain,
                victims=(obs.node,),
                confidence=attribution_confidence(v, models),
                category=obs.category, latency_s=lat_s, window=v.window))
        return out
