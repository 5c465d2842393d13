"""The DeepSeek-V2-Lite cell (``dsv2lite-train``) at a tiny size on the CPU:
the port's first training steps against the plain reference
(``reference/mla_moe.py``), the reference's YaRN against the port's, the
operation count against a hand count, whole runs through the harness with
and without the trace, and each planted fault read as ``correct`` false
against the cell's own limits: YaRN left out, the top-k gates renormalised,
half the batch, a state left unchanged."""
import dataclasses
import json
import time

import pytest
import torch

from perfbench import mla_faults
from perfbench.counts import flops, mla_moe
from perfbench.drivers import train
from perfbench.lib import harness, program, program_spans, spec
from perfbench.test_perfbench_faults import TRAIN_FAULTS
from perfbench.test_perfbench_reference import BF16_STEP, program_steps
from perfbench.test_perfbench_run import check_schema
from perfbench.tiny import SEED

CELL = "dsv2lite-train"
# every width and count cut; one dense layer and two expert layers, as the
# cell's one and four; the file's YaRN settings kept (at a rope dim of 8 it
# blends rotary indices 1..3 of 4)
TINY = {"n_layers": 3, "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_head": 16, "d_ff": 96,
        "vocab_size": 128,
        "mla": {"q_lora_rank": 0, "kv_lora_rank": 16, "qk_nope_dim": 16, "qk_rope_dim": 8,
                "v_head_dim": 16},
        "moe": {"n_experts": 8, "top_k": 3, "d_ff_expert": 32, "n_shared": 2, "d_ff_shared": 16,
                "first_k_dense": 1, "capacity_factor": 1.25, "aux_loss_weight": 0.001,
                "impl": "shard_map", "norm_topk_prob": False}}
TRAFFIC = {"batch": 2, "seq": 64, "trace_steps": 2}
MLA_SPANS = ("mla.project", "mla.attend", "mla.out")


def job(trace: bool = False, seed: int = SEED, seconds: float = 0.6):
    bench = spec.benchmark()
    return bench, harness.make_job(bench, CELL, seed, seconds, trace, torch.device("cpu"),
                                   time.perf_counter(), TINY, TRAFFIC)


def run(trace: bool = False, **kw) -> dict:
    bench, j = job(trace, **kw)
    return harness.run_cell(bench, j)


def test_the_port_section_is_the_registered_config_cut_to_five_layers():
    from repro_torch.configs import get_config

    doc = spec.config(spec.benchmark(), "deepseek-v2-lite-16b")
    cfg = program.model_config(doc["port"])
    assert cfg == dataclasses.replace(get_config("deepseek-v2-lite-16b"), n_layers=5)
    leaves = spec.reference("mla_moe").param_spec(doc["port"])
    assert sum(torch.Size(shape).numel() for _p, shape, *_ in leaves) == 2_839_831_040


def test_training_steps_match_the_reference():
    _bench, j = job()
    gaps = train.compare(program_steps(j), train.reference_steps(j))
    assert max(gaps.values()) <= BF16_STEP, gaps


def test_reference_yarn_is_the_ports():
    """The reference's frequencies and softmax scale, written from
    DeepSeek-V2's code, against the port's, at the cell's rope dim."""
    from repro_torch.models import layers, mla

    doc = spec.config(spec.benchmark(), "deepseek-v2-lite-16b")
    m, ref = doc["port"], spec.reference("mla_moe")
    cfg = program.model_config(m)
    want = layers.rope_frequencies(64, 10000.0, scaling=cfg.rope_scaling)
    got = ref.rope_inv_freq(64, 10000.0, m["rope_scaling"], "cpu")
    assert torch.equal(got, want)
    assert ref.softmax_scale(m["mla"], m["rope_scaling"]) == pytest.approx(mla.softmax_scale(cfg),
                                                                           rel=1e-12)


def test_operation_count_by_hand():
    m = json.loads((spec.BENCH_DIR / "configs" / "deepseek-v2-lite-16b.json").read_text())["port"]
    # per layer, MLA: w_q 2048 x 3072, w_dkv 2048 x 512, w_kr 2048 x 64, w_uk
    # and w_uv 512 x 2048 each, w_o 2048 x 2048 = 13,762,560; the dense
    # layer 3 x 2048 x 10,944 = 67,239,936; an expert layer: router 2048 x 64,
    # 6 experts x 3 x 2048 x 1408, shared 3 x 2048 x 2816 = 69,337,088; the
    # head 2048 x 102,400 = 209,715,200
    assert mla_moe.matmul_params(m) == (5 * 13_762_560 + 67_239_936 + 4 * 69_337_088
                                        + 209_715_200) == 623_116_288
    # causal attention: 5 layers x 3 x 2048 x 16 heads x (192 + 128)
    assert mla_moe.train_flops_per_token(m, 2048) == 6 * 623_116_288 + 5 * 960 * 2048 * 16
    assert mla_moe.train_flops_per_token(m, 2048) == 3_895_984_128


def test_mfu_reader_counts_the_window_with_the_mla_count():
    """The whole step's share recounts the window's tokens (taken back from
    the run's ``flops.py`` count) with ``counts/mla_moe.py``."""
    m = spec.config(spec.benchmark(), "deepseek-v2-lite-16b")["port"]
    tokens, seconds = 7 * 4096, 2.5
    ctx = {"kind": "train", "mfu_flops": flops.train_flops_per_token(m, 2048) * tokens,
           "mfu_seconds": seconds, "peaks": flops.PEAKS}
    got = spec.metric_reader("train_mfu.dsv2").read(ctx)
    assert got == pytest.approx(100 * 3_895_984_128 * tokens / seconds / 989e12, rel=1e-12)
    assert spec.metric_reader("train_mfu.dsv2").read({**ctx, "kind": "prefill"}) is None


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_line_schema_and_a_correct_run(trace, monkeypatch):
    seen = {}
    real = harness.per_layer

    def spy(metrics, ctx):
        seen["ctx"] = ctx
        return real(metrics, ctx)

    monkeypatch.setattr(harness, "per_layer", spy)
    line = run(trace)
    check_schema(line, CELL, trace)
    assert line["failed"] == 0 and set(line["checks"]) == set(spec.limits(CELL))
    assert line["correct"], line["checks"]
    if trace:
        ctx = seen["ctx"]
        trace_ = ctx["trace"]
        tid = trace_.main_tid("bench_step")
        n_moe = TINY["n_layers"] - TINY["moe"]["first_k_dense"]
        for name, per_step in [*((s, TINY["n_layers"]) for s in MLA_SPANS),
                               ("moe.shared", n_moe), ("moe.route", n_moe)]:
            mine = [s for s in trace_.spans[name] if s[2] == tid]
            assert len(mine) == ctx["profiled"] * per_step, name
        assert program_spans.run_spans(ctx) is not None
        # no device kernels on the CPU: the span readers have nothing to read
        assert "mla_ms.dsv2" not in line["metrics"]
        assert "train_mfu.dsv2" in line["metrics"]


def yarn_left_out(monkeypatch):
    """The port's MLA with the plain rope frequencies and 1 / sqrt(qk dim)."""
    import math

    from repro_torch.models import mla

    rope = mla.apply_rope
    monkeypatch.setattr(mla, "apply_rope", lambda *a, scaling=None, **kw: rope(*a, **kw))
    monkeypatch.setattr(mla, "softmax_scale",
                        lambda cfg: 1 / math.sqrt(cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim))


def gates_renormalised(monkeypatch):
    """The port's router with its top-k gates renormalised to sum to 1."""
    from repro_torch.models import moe

    gate = moe._gate
    monkeypatch.setattr(moe, "_gate", lambda p, x, cfg: gate(
        p, x, dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, norm_topk_prob=True))))


def train_fault(name):
    def plant(monkeypatch):
        import repro_torch.train as train_pkg

        monkeypatch.setattr(train_pkg, "make_train_step",
                            TRAIN_FAULTS[name](train_pkg.make_train_step))
    return plant


FAULTS = {"yarn_left_out": yarn_left_out, "gates_renormalised": gates_renormalised,
          **{name: train_fault(name) for name in TRAIN_FAULTS}}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    line = run()
    assert not line["correct"], line["checks"]


def test_reference_faults_and_control_read_over_a_limit():
    """What sets the limits' upper end on the card, here at the tiny size:
    the float8 control and the two mechanism faults planted in the
    reference, each over at least one of the cell's limits."""
    from perfbench import control

    limits = spec.limits(CELL)
    _bench, j = job()
    got = {**mla_faults.readings(j), **control.readings(j)}
    assert set(got) == {"no_yarn", "renormalised_gates", "control", "half_batch"}
    for name, numbers in got.items():
        assert not control.verdict(numbers, limits)["correct"], (name, numbers)
