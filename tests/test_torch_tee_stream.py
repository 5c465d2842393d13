"""The port's streaming TEE (``repro_torch.tee_stream``) against the
reference's: every test of ``tests/test_tee_stream.py`` run on the port but
``test_degrading_switch_folds_to_one_domain_incident``, which needs
``fleet.presets`` (not ported yet), then the fleet scoring pass of both
packages on the same windows.

Tolerances: the mirrors keep the reference tests' own (``rtol=1e-12`` for the
vectorised pass against its loop, exact elsewhere); the cross-package check
is exact.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.tee_stream import batch_score_windows as ref_batch_score_windows  # noqa: E402
from repro.tee_stream import fitted_models as ref_fitted_models  # noqa: E402
from repro_torch.core.tee import TraceGenerator  # noqa: E402
from repro_torch.tee_stream import (CrossJobCorrelator, JobAnomaly,  # noqa: E402
                                    LogRing, MetricRing, StreamLatencyModel,
                                    batch_score_windows, combine_confidences,
                                    fitted_models, loop_score_windows,
                                    to_verdicts)


# --------------------------------------------------------------------------- #
# ring buffers
# --------------------------------------------------------------------------- #
def _cols(lo, hi, n_ranks=2, n_metrics=3):
    """Columns whose value encodes their absolute sample index."""
    idx = np.arange(lo, hi, dtype=np.float64)
    return np.broadcast_to(idx[None, :, None],
                           (n_ranks, hi - lo, n_metrics)).copy()


def test_metric_ring_window_tracks_absolute_indices():
    ring = MetricRing(n_ranks=2, n_metrics=3, capacity=8)
    ring.push(_cols(0, 5))
    assert ring.count == 5
    np.testing.assert_array_equal(ring.window(3)[:, :, 0],
                                  [[2, 3, 4], [2, 3, 4]])
    # wrap around the capacity boundary: latest w samples still contiguous
    ring.push(_cols(5, 12))
    assert ring.count == 12
    np.testing.assert_array_equal(ring.window(6)[0, :, 0],
                                  [6, 7, 8, 9, 10, 11])
    # single-column push (2-D input) appends one sample
    ring.push(np.full((2, 3), 12.0))
    assert ring.count == 13
    assert ring.window(1)[0, 0, 0] == 12.0


def test_metric_ring_oversize_push_keeps_tail():
    ring = MetricRing(n_ranks=2, n_metrics=1, capacity=4)
    ring.push(_cols(0, 10, n_metrics=1))       # 10 samples into capacity 4
    assert ring.count == 10
    np.testing.assert_array_equal(ring.window(4)[0, :, 0], [6, 7, 8, 9])
    # window requests beyond capacity are clamped to what survived
    assert ring.window(99).shape[1] == 4


def test_log_ring_horizon_and_window():
    ring = LogRing(horizon=10)
    ring.push([(t, 0, "INFO", f"m{t}") for t in (1, 3, 5)])
    assert [e[0] for e in ring.window(0, 6)] == [1, 3, 5]
    assert ring.window(2, 5) == [(3, 0, "INFO", "m3")]
    # entries older than newest - horizon are pruned on push
    ring.push([(20, 1, "ERROR", "late")])
    assert [e[0] for e in ring.window(0, 30)] == [20]


# --------------------------------------------------------------------------- #
# vectorized fleet pass == per-rank reference loop
# --------------------------------------------------------------------------- #
def test_batch_score_windows_equals_reference_loop():
    models = fitted_models(4, seed=1)
    gen = TraceGenerator(n_ranks=4, seed=11)
    w = models.window
    traces = [gen.normal(T=w + 40, init_len=40),
              gen.faulty("network", T=w + 40, init_len=40, onset=40),
              gen.faulty("straggler", T=w + 40, init_len=40, onset=40)]
    windows = np.stack([tr.metrics[:, 40:, :] for tr in traces])
    bv = batch_score_windows(models, windows)
    lv = loop_score_windows(models, windows)
    np.testing.assert_allclose(bv.lof_frac, lv.lof_frac, rtol=1e-12)
    np.testing.assert_allclose(bv.np_max, lv.np_max, rtol=1e-12)
    np.testing.assert_array_equal(bv.outlier_mask, lv.outlier_mask)
    np.testing.assert_array_equal(bv.flat_mask, lv.flat_mask)
    np.testing.assert_array_equal(bv.lof_vote, lv.lof_vote)
    np.testing.assert_array_equal(bv.np_vote, lv.np_vote)
    np.testing.assert_array_equal(bv.cluster_vote, lv.cluster_vote)
    # and the rolled-up verdicts agree row for row
    for a, b in zip(to_verdicts(bv, 0, w), to_verdicts(lv, 0, w)):
        assert a.anomalous == b.anomalous
        assert a.bad_ranks == b.bad_ranks


# --------------------------------------------------------------------------- #
# cross-job correlator
# --------------------------------------------------------------------------- #
def _anom(t, job, domain="switch00", victims=("n1",), conf=0.8):
    return JobAnomaly(t_detect=t, job=job, domain=domain, victims=victims,
                      confidence=conf, category="network", latency_s=40.0)


def test_correlator_folds_same_domain_into_one_incident():
    corr = CrossJobCorrelator(window_s=900.0)
    deadline = corr.add(_anom(100.0, "jobA", victims=("n1",), conf=0.8))
    assert deadline == 1000.0                 # first member opens the group
    assert corr.add(_anom(150.0, "jobB", victims=("n2",), conf=0.7)) is None
    assert corr.add(_anom(900.0, "jobC", victims=("n1",), conf=0.6)) is None
    inc = corr.flush("switch00")
    assert inc is not None and corr.incidents == [inc]
    assert inc.jobs == ("jobA", "jobB", "jobC")
    assert inc.victims == ("n1", "n2")        # union, first-seen order
    assert inc.n_anomalies == 3
    assert inc.confidence == combine_confidences([0.8, 0.7, 0.6])
    assert inc.confidence > 0.8               # more witnesses, more certain
    # flushing an empty/unknown domain is a no-op
    assert corr.flush("switch00") is None


def test_correlator_separates_domains_and_stale_groups():
    corr = CrossJobCorrelator(window_s=100.0)
    corr.add(_anom(0.0, "jobA", domain="switch00"))
    corr.add(_anom(10.0, "jobB", domain="switch01"))
    # an anomaly past the open group's deadline closes it and opens anew
    corr.add(_anom(500.0, "jobC", domain="switch00"))
    assert len(corr.incidents) == 1           # stale switch00 group flushed
    assert corr.incidents[0].jobs == ("jobA",)
    assert corr.flush("switch01").jobs == ("jobB",)
    assert corr.flush("switch00").jobs == ("jobC",)


# --------------------------------------------------------------------------- #
# stream-derived detection latency (soak's tee_stream mode)
# --------------------------------------------------------------------------- #
def test_stream_latency_model_is_deterministic_and_cached():
    m = StreamLatencyModel()
    lat = m.latency_s("network", degrades_only=True)
    assert lat > 0
    assert m.latency_s("network", degrades_only=True) == lat   # cached
    assert StreamLatencyModel().latency_s("network", True) == lat
    # every Table-I category yields a finite positive latency
    from repro_torch.core.tee import FAULT_CATEGORIES
    for cat in FAULT_CATEGORIES:
        assert 0 < m.latency_s(cat) <= 240 * m.sample_period_s


# --------------------------------------------------------------------------- #
# the fleet scoring pass of both packages (exact)
# --------------------------------------------------------------------------- #
def test_batch_score_windows_matches_the_reference():
    from repro.core.tee import TraceGenerator as RefTraceGenerator

    models, ref_models = fitted_models(4, seed=1), ref_fitted_models(4, seed=1)
    w = models.window
    gens = (TraceGenerator(n_ranks=4, seed=11), RefTraceGenerator(n_ranks=4, seed=11))
    windows = []
    for gen in gens:
        traces = [gen.normal(T=w + 40, init_len=40)]
        traces += [gen.faulty(c, T=w + 40, init_len=40, onset=40)
                   for c in ("network", "straggler", "node_hw", "storage")]
        windows.append(np.stack([tr.metrics[:, 40:, :] for tr in traces]))
    np.testing.assert_array_equal(windows[0], windows[1])
    got, want = batch_score_windows(models, windows[0]), ref_batch_score_windows(ref_models, windows[1])
    for name in ("lof_frac", "np_max", "outlier_mask", "flat_mask", "lof_vote",
                 "np_vote", "cluster_vote"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
