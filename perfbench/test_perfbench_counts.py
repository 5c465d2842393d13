"""The yardstick's operation and byte counts at each cell's shapes, against
values worked out by hand."""
import json
from pathlib import Path

from perfbench.counts import flops

CONFIGS = Path(__file__).parent / "configs"


def port(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["port"]


def test_peaks_are_the_data_sheets():
    assert flops.PEAKS["bf16_flops_s"] == 989e12
    assert flops.PEAKS["hbm_bytes_s"] == 3.35e12


def test_olmoe_train_counts():
    m = port("olmoe-1b-7b-4l")
    # per layer: q, k, v, o 4 x 2048^2 = 16,777,216; router 2048 x 64 =
    # 131,072; 8 experts x 3 x 2048 x 1024 = 50,331,648; four layers, then
    # the head 2048 x 50,304 = 103,022,592
    assert flops.matmul_params(m) == 4 * (16_777_216 + 131_072 + 50_331_648) + 103_022_592
    assert flops.matmul_params(m) == 371_982_336
    # 6 x 371,982,336 + causal attention 6 x 4 x 4096 x 2048
    assert flops.train_flops_per_token(m, 4096) == 2_231_894_016 + 201_326_592


def test_mamba2_counts():
    m = port("mamba2-130m")
    # per layer: in_proj 768 x (2 x 1536 + 2 x 128 + 24) = 2,574,336, out_proj
    # 1536 x 768 = 1,179,648; 24 layers, then the head 768 x 50,280
    assert flops.matmul_params(m) == 24 * (2_574_336 + 1_179_648) + 38_615_040
    # one 2048-token row, 8 chunks of 256: per chunk n pairs 128 x 32,896,
    # heads x p x pairs 1536 x 32,896, states and inter-chunk 2 x 24 x 256 x
    # 64 x 128; two operations a multiply-add
    per_chunk = 128 * 32_896 + 1536 * 32_896 + 2 * 24 * 256 * 64 * 128
    assert flops.ssd_ops(1, 2048, 24, 64, 1, 128, 256) == 2 * 8 * per_chunk == 2_486_435_840
    assert flops.train_flops_per_token(m, 2048) == 6 * 128_710_656 + 3 * 24 * 2_486_435_840 / 2048


def test_mamba2_prefill_counts():
    m = port("mamba2-130m")
    head = 38_615_040
    per_token = 2 * (128_710_656 - head) + 24 * 2 * 2 * 16 * (
        128 * 32_896 + 1536 * 32_896 + 2 * 24 * 256 * 64 * 128) / (2 * 4096)
    assert flops.prefill_flops(m, 8, 4096) == 8 * 4096 * per_token + 8 * 2 * head


def test_ssd_bound_at_the_prefill_shape():
    # x and y (8 x 4096 x 24 x 64) and B, C (8 x 4096 x 128) in bf16; dt
    # (8 x 4096 x 24), A (24) and the final state (8 x 24 x 64 x 128) in f32
    nbytes = (2 * 8 * 4096 * 1536 + 2 * 8 * 4096 * 128) * 2 + 4 * (786_432 + 24 + 1_572_864)
    assert flops.ssd_bytes(8, 4096, 24, 64, 1, 128, 2) == nbytes == 227_541_088
    # bound by bytes: 67.9 us at 3.35 TB/s (operations: 19.9 us at 989 TFLOP/s)
    assert flops.ssd_bound_s(8, 4096, 24, 64, 1, 128, 256, 2) == nbytes / 3.35e12
    assert flops.ssd_ops(8, 4096, 24, 64, 1, 128, 256) / 989e12 < nbytes / 3.35e12
