"""The port's TEE (``repro_torch.core.tee``, ``repro_torch.tee_stream``)
against the reference's: every test of ``tests/test_tee.py`` run on the
port, then the two packages side by side on the same seeds: equal traces,
equal fitted models, equal verdicts for each fault category and equal
streaming scores.

Tolerances: the mirrors keep the reference tests' own bounds; the
cross-package checks are exact (``assert_array_equal``, ``==``), since both
packages run the same numpy code on the same inputs.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.tee import FAULT_CATEGORIES as REF_CATEGORIES  # noqa: E402
from repro.core.tee import OfflineTrainer as RefTrainer  # noqa: E402
from repro.core.tee import TEEService as RefService  # noqa: E402
from repro.core.tee import TraceGenerator as RefTraceGenerator  # noqa: E402
from repro.tee_stream import StreamScorer as RefStreamScorer  # noqa: E402
from repro_torch.core.tee import (FAULT_CATEGORIES, LOF, DTWKNNCluster,  # noqa: E402
                                  LogDetector, NeighborProfile, OfflineTrainer,
                                  TEEService, TraceGenerator)
from repro_torch.core.tee.detectors import dtw_distance  # noqa: E402
from repro_torch.core.tee.preprocess import Preprocessor, median_filter  # noqa: E402
from repro_torch.core.tee.trainer import ModelRegistry  # noqa: E402
from repro_torch.sim.faults import SIGNATURES  # noqa: E402
from repro_torch.tee_stream import (StreamScorer, attribution_confidence,  # noqa: E402
                                    combine_confidences)


# --------------------------------------------------------------------------- #
# mirrors of tests/test_tee.py
# --------------------------------------------------------------------------- #
def test_lof_flags_planted_outliers():
    rng = np.random.default_rng(0)
    normal = rng.normal(0, 1, (300, 4))
    lof = LOF(k=10).fit(normal)
    inliers = rng.normal(0, 1, (50, 4))
    outliers = rng.normal(8, 0.5, (10, 4))
    si, so = lof.score(inliers), lof.score(outliers)
    assert np.median(si) < 1.3
    assert np.min(so) > 2.0


def test_nprofile_flags_period_break():
    t = np.arange(1200, dtype=np.float64)
    train = [np.sin(2 * np.pi * t / 20) + 0.05 * np.random.default_rng(i).normal(size=1200)
             for i in range(3)]
    np_det = NeighborProfile(m=40, k=5).fit(train)
    good = np.sin(2 * np.pi * np.arange(300) / 20)
    broken = good.copy()
    broken[150:220] = 0.0   # flatline = periodicity break
    assert np_det.score(good).max() < np_det.score(broken).max()
    assert np_det.score(broken).max() > 2 * np_det.score(good).max()


def test_dtw_basic_properties():
    a = np.sin(np.linspace(0, 6, 50))
    assert dtw_distance(a, a) == pytest.approx(0.0, abs=1e-9)
    b = np.sin(np.linspace(0.3, 6.3, 50))   # phase shift: small DTW
    c = np.zeros(50)
    assert dtw_distance(a, b, window=8) < dtw_distance(a, c, window=8)


def test_dtw_cluster_finds_outlier_rank():
    rng = np.random.default_rng(1)
    t = np.arange(200)
    series = np.stack([np.sin(2 * np.pi * t / 20 + 0.1 * r)
                       + 0.05 * rng.normal(size=200) for r in range(8)])
    series[3] = 0.02 * rng.normal(size=200)   # dead rank
    assert DTWKNNCluster().outlier_ranks(series) == [3]


def test_log_detector_threshold_and_attribution():
    det = LogDetector(threshold=3)
    logs = [(5, 0, "INFO", "step ok"),
            (10, 2, "ERROR", "NET/IB: Got completion"),
            (11, 1, "ERROR", "socket timeout"),
            (12, 3, "ERROR", "socket timeout")]
    v = det.detect(logs, 0, 20)
    assert v.anomalous and v.err_count == 3
    assert v.first_error_rank == 2    # earliest error names the culprit
    assert not det.detect(logs, 0, 11).anomalous


def test_median_filter_kills_flapping():
    x = np.array([1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 1, 0, 1], np.float64)
    y = median_filter(x[None, :], 5)[0]
    assert y.std() < 0.5 * x.std()
    assert y.mean() > 0.9


def test_preprocessor_drops_constant_and_duplicate_metrics():
    rng = np.random.default_rng(0)
    base = rng.random((2, 100, 1))
    const = np.full((2, 100, 1), 0.5)
    dup = base * 2.0 + 0.1          # perfectly correlated
    m = np.concatenate([base, const, dup], -1)
    pre = Preprocessor().fit([m])
    assert 1 not in pre.keep        # constant dropped
    assert len(pre.keep) == 1       # duplicate dropped


@pytest.fixture(scope="module")
def fitted():
    """The reference fixture's traces and fit, on both packages: the port's
    generator and trainer, and the reference's on the same seed."""
    gen, ref_gen = TraceGenerator(n_ranks=8, seed=42), RefTraceGenerator(n_ranks=8, seed=42)
    normal = [gen.normal() for _ in range(13)]
    ref_normal = [ref_gen.normal() for _ in range(13)]
    trainer = OfflineTrainer()
    models = trainer.fit(normal[:10])
    ref_models = RefTrainer().fit(ref_normal[:10])
    return gen, trainer, models, normal, ref_gen, ref_models, ref_normal


def test_tee_detects_all_11_erroneous_tasks(fitted):
    gen, trainer, models, normal = fitted[:4]
    svc = TEEService(models)
    bad = [gen.faulty(gen.sample_category()) for _ in range(11)]
    assert sum(svc.detect_task(t).anomalous for t in bad) == 11


def test_tee_error_category_coverage(fitted):
    gen, trainer, models, _ = fitted[:4]
    svc = TEEService(models)
    for cat in FAULT_CATEGORIES:
        assert svc.detect_task(gen.faulty(cat)).anomalous, f"missed category {cat}"


def test_tee_low_false_positives(fitted):
    gen, trainer, models, normal = fitted[:4]
    svc = TEEService(models)
    assert sum(svc.detect_task(t).anomalous for t in normal[10:]) <= 1


def test_registry_gate_rejects_bad_models(tmp_path, fitted):
    gen, trainer, models, normal = fitted[:4]
    reg = ModelRegistry(str(tmp_path), min_recall=0.9, min_precision=0.8)
    assert reg.register(models, {"recall": 0.5, "precision": 0.9}) is None
    assert reg.register(models, {"recall": 1.0, "precision": 0.9}) == 1
    loaded = reg.load()
    assert loaded.window == models.window
    # a registry's pickle names the port's classes: it loads in the port only
    assert type(loaded).__module__ == "repro_torch.core.tee.trainer"


def test_tee_detects_straggler_and_localises(fitted):
    gen, trainer, models, _ = fitted[:4]
    svc = TEEService(models)
    hits = attrib = 0
    for _ in range(3):
        t = gen.faulty("straggler", n_bad=1)
        v = svc.detect_task(t)
        hits += v.anomalous
        attrib += any(r in t.bad_ranks for r in v.bad_ranks)
        assert not v.votes.get("log", False)   # no logs: metrics-only detection
    assert hits == 3
    assert attrib >= 2


def test_streaming_scorer_equals_batch_detect_per_category(fitted):
    models = fitted[2]
    gen = TraceGenerator(n_ranks=8, seed=123)
    svc = TEEService(models)
    traces = [gen.faulty(cat, T=400) for cat in FAULT_CATEGORIES]
    traces.append(gen.normal(T=400))
    for tr in traces:
        sv = StreamScorer(models).score_trace(tr)
        bv = svc.detect_task(tr)
        label = tr.label or "normal"
        assert sv.verdict.anomalous == bv.anomalous, label
        assert tuple(sv.verdict.window) == tuple(bv.window), label
        assert tuple(sv.verdict.bad_ranks) == tuple(bv.bad_ranks), label
        assert sv.verdict.votes == bv.votes, label


def test_streaming_golden_precision_recall(fitted):
    models = fitted[2]
    gen = TraceGenerator(n_ranks=8, seed=321)
    faulty = [gen.faulty(cat, T=400) for cat in FAULT_CATEGORIES]
    normal = [gen.normal(T=400) for _ in range(4)]
    tp = fp = 0
    for tr in faulty:
        sv = StreamScorer(models).score_trace(tr)
        tp += int(sv.verdict.anomalous)
        assert sv.latency is not None and sv.latency >= 0
        assert 0.0 < sv.confidence <= 1.0
    for tr in normal:
        fp += int(StreamScorer(models).score_trace(tr).verdict.anomalous)
    assert tp / len(faulty) == 1.0
    assert fp <= 1
    assert tp / max(tp + fp, 1) >= 0.8


def test_attribution_confidence_bounds(fitted):
    models = fitted[2]
    gen = TraceGenerator(n_ranks=8, seed=9)
    quiet = TEEService(models).detect_task(gen.normal(T=400))
    if not quiet.anomalous:
        assert attribution_confidence(quiet, models) == 0.0
    confs = []
    for cat in FAULT_CATEGORIES:
        sv = StreamScorer(models).score_trace(gen.faulty(cat, T=400))
        assert sv.confidence == attribution_confidence(sv.verdict, models)
        confs.append(sv.confidence)
    assert all(0.0 < c <= 1.0 for c in confs)
    assert combine_confidences([]) == 0.0
    assert combine_confidences([0.6]) == 0.6
    assert combine_confidences([0.6, 0.6]) > 0.6
    assert combine_confidences(confs) <= 1.0
    assert combine_confidences(confs) >= max(confs)


# --------------------------------------------------------------------------- #
# the two packages side by side (exact)
# --------------------------------------------------------------------------- #
def _trace_fields(tr):
    return (tr.metrics, tr.logs, tr.label, tr.bad_ranks, tr.onset, tr.init_len)


def _assert_same_tree(a, b, path="models"):
    """Walk two objects of mirrored classes: arrays equal, numbers equal."""
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            if k != "fit_time":            # a wall-clock stamp
                _assert_same_tree(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}[{i}]")
    elif hasattr(a, "__dict__"):
        assert type(a).__name__ == type(b).__name__, path
        _assert_same_tree(vars(a), vars(b), path)
    else:
        assert a == b, path


def test_trace_generator_matches_the_reference(fitted):
    normal, ref_normal = fitted[3], fitted[6]
    gen, ref_gen = TraceGenerator(n_ranks=4, seed=7), RefTraceGenerator(n_ranks=4, seed=7)
    pairs = list(zip(normal, ref_normal))
    pairs += [(gen.faulty(c, T=300), ref_gen.faulty(c, T=300)) for c in FAULT_CATEGORIES]
    pairs += [(gen.for_fault("network", 2, T=240, onset=120, degrades_only=True),
               ref_gen.for_fault("network", 2, T=240, onset=120, degrades_only=True))]
    assert list(FAULT_CATEGORIES) == list(REF_CATEGORIES)
    for tr, ref in pairs:
        for a, b in zip(_trace_fields(tr), _trace_fields(ref)):
            _assert_same_tree(a, b, "trace")


def test_offline_fit_matches_the_reference(fitted):
    models, ref_models = fitted[2], fitted[5]
    _assert_same_tree(models, ref_models)


def test_verdicts_match_the_reference_per_category(fitted):
    """The 11 erroneous tasks of paper Fig. 7 (categories drawn as the
    reference test draws them), then one trace of every signature."""
    models, ref_models = fitted[2], fitted[5]
    svc, ref_svc = TEEService(models), RefService(ref_models)
    gen, ref_gen = TraceGenerator(n_ranks=8, seed=5), RefTraceGenerator(n_ranks=8, seed=5)
    cats = [gen.sample_category() for _ in range(11)]
    assert cats == [ref_gen.sample_category() for _ in range(11)]
    cats += sorted(SIGNATURES)
    for cat in cats:
        v, rv = svc.detect_task(gen.faulty(cat)), ref_svc.detect_task(ref_gen.faulty(cat))
        assert v.anomalous, cat
        assert (v.anomalous, v.votes, v.bad_ranks, v.window) == \
            (rv.anomalous, rv.votes, rv.bad_ranks, rv.window), cat
        _assert_same_tree(v.detail, rv.detail, cat)


def test_stream_scores_match_the_reference(fitted):
    models, ref_models = fitted[2], fitted[5]
    gen, ref_gen = TraceGenerator(n_ranks=8, seed=17), RefTraceGenerator(n_ranks=8, seed=17)
    for cat in list(FAULT_CATEGORIES) + [None]:
        tr = gen.faulty(cat, T=400) if cat else gen.normal(T=400)
        ref = ref_gen.faulty(cat, T=400) if cat else ref_gen.normal(T=400)
        sv = StreamScorer(models).score_trace(tr)
        rv = RefStreamScorer(ref_models).score_trace(ref)
        assert (sv.verdict.anomalous, sv.verdict.votes, sv.verdict.bad_ranks,
                sv.verdict.window, sv.confidence, sv.latency, sv.windows_scored) == \
            (rv.verdict.anomalous, rv.verdict.votes, rv.verdict.bad_ranks,
             rv.verdict.window, rv.confidence, rv.latency, rv.windows_scored), cat
