"""The port's TCE checkpoint datapath (codec, sharding, DiskStore, flat
train-state paths) against the JAX reference, and checkpoints that cross
between the two packages.

Arrays are made with numpy from fixed seeds. Everything here is compared
exactly: the codecs are byte transforms, and the int8 codec is the same
float32 arithmetic in both packages (see tests/test_torch_quant.py).
"""
import dataclasses
import json

import jax
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.tce import codec as jax_codec  # noqa: E402
from repro.core.tce import sharding as jax_sharding  # noqa: E402
from repro.core.tce.engine import flatten_pytree as jax_flatten  # noqa: E402
from repro.core.tce.engine import unflatten_like as jax_unflatten  # noqa: E402
from repro.core.tce.store import DiskStore as JaxDiskStore  # noqa: E402
from repro.train import AdamConfig as JaxAdamConfig  # noqa: E402
from repro.train import init_train_state as jax_init_state  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tce import DiskStore, codec, sharding  # noqa: E402
from repro_torch.core.tce.engine import flatten_pytree, unflatten_like  # noqa: E402
from repro_torch.substrate.worker import LOSSLESS_PATHS  # noqa: E402
from repro_torch.train import AdamConfig, init_train_state  # noqa: E402


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


ARRAYS = {
    "f32": _rand((7, 129), 1),
    "f32_blocks": _rand((4, 4, 100), 2, 3.0),
    "f32_many": _rand((200, 256), 3),                         # 200 blocks
    "f64": _rand((33,), 4).astype(np.float64),
    "f16": _rand((5, 64), 5).astype(np.float16),
    "sparse": np.where(_rand((64, 64), 6) > 1.5, 1.0, 0.0).astype(np.float32),
    "noise": np.random.default_rng(7).integers(0, 1 << 32, 999, dtype=np.uint32).view(np.float32),
    "int32": np.arange(1000, dtype=np.int32),
    "scalar": np.array(3, np.int32),
    "empty": np.zeros((0, 4), np.float32),
}


@pytest.mark.parametrize("codec_name", ["raw", "zlib", "int8"])
@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_encode_payload_is_the_reference_bytes(codec_name, name):
    data = ARRAYS[name]
    enc, payload, meta = codec.encode_shard(data, codec_name, device="cpu")
    jenc, jpayload, jmeta = jax_codec.encode_shard(data, codec_name)
    assert (enc, meta) == (jenc, jmeta)
    assert payload.dtype == np.uint8
    if enc == "int8" and not np.isfinite(data).all():
        # a NaN scale is NaN on both sides, but the bits of a NaN are not
        # kept by every library (nor by the card's arithmetic)
        nq = meta["n_blocks"] * meta["block"]
        assert payload[:nq].tobytes() == np.asarray(jpayload)[:nq].tobytes()
        assert np.array_equal(payload[nq:].view(np.float32),
                              np.asarray(jpayload)[nq:].view(np.float32), equal_nan=True)
    else:
        assert payload.tobytes() == np.asarray(jpayload).tobytes()
    # the port decodes the reference's payload as the reference does
    got = codec.decode_shard(jenc, np.asarray(jpayload), str(data.dtype), data.shape, jmeta,
                             device="cpu")
    want = jax_codec.decode_shard(jenc, jpayload, str(data.dtype), data.shape, jmeta)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=True)
    if enc in ("raw", "zlib"):
        assert got.tobytes() == data.tobytes()


@pytest.mark.parametrize("name,codec_name,lossless,want", [
    ("f32", "int8", True, "zlib"),       # allowlisted: lossless route
    ("int32", "int8", False, "zlib"),    # not a float: lossless route
    ("sparse", "int8", True, "zlib"),
    ("noise", "zlib", False, "raw"),     # incompressible bytes stay raw
    ("sparse", "zlib", False, "zlib"),
    ("f32", "int8", False, "int8"),
])
def test_demotions_match_the_reference(name, codec_name, lossless, want):
    data = ARRAYS[name]
    enc, _, _ = codec.encode_shard(data, codec_name, lossless=lossless, device="cpu")
    jenc, _, _ = jax_codec.encode_shard(data, codec_name, lossless=lossless)
    assert enc == jenc == want


def test_lossless_allowlist():
    for path in ("opt/m/tok/table", "step", "rng", "params/norm_f/scale",
                 "params/segments/stack/l0/norm1/scale"):
        assert codec.is_lossless_path(path, LOSSLESS_PATHS)
        assert jax_codec.is_lossless_path(path, LOSSLESS_PATHS)
    for path in ("params/tok/table", "params/segments/stack/l0/mix/wq"):
        assert not codec.is_lossless_path(path, LOSSLESS_PATHS)


def test_raw_and_zlib_need_no_card_but_int8_does(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = ARRAYS["f32"]
    for name in ("raw", "zlib"):
        enc, payload, meta = codec.encode_shard(data, name)          # default device
        assert np.array_equal(codec.decode_shard(enc, payload, "float32", data.shape, meta), data)
        assert codec.encode_shard(data, "int8", lossless=True)[0] == "zlib"
    with pytest.raises(repro_torch.DeviceUnavailable):
        codec.encode_shard(data, "int8")


@pytest.mark.parametrize("n_nodes", [1, 3, 8])
def test_shard_and_unshard_match_the_reference(n_nodes):
    state = {k: v for k, v in ARRAYS.items() if k != "empty"}
    got = sharding.shard_state(state, n_nodes)
    want = jax_sharding.shard_state(state, n_nodes)
    for g, w in zip(got, want):
        assert {p: s.to_dict() for p, (s, _) in g.items()} == \
               {p: s.to_dict() for p, (s, _) in w.items()}
        assert all(g[p][1].tobytes() == w[p][1].tobytes() for p in g)
    back = sharding.unshard_state(got)
    assert set(back) == set(state)
    assert all(back[k].tobytes() == state[k].tobytes() for k in state)


# --------------------------------------------------------------------------- #
# Flat train-state paths
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("moment_dtype", ["float32", "int8", "bfloat16"])
def test_flat_train_state_paths_are_the_reference_paths(moment_dtype):
    jflat = jax_flatten(jax_init_state(jax_get_config("llama3-8b").reduced(),
                                       JaxAdamConfig(moment_dtype=moment_dtype),
                                       jax.random.key(0)))
    pstate = init_train_state(get_config("llama3-8b").reduced(),
                              AdamConfig(moment_dtype=moment_dtype), seed=0, device="cpu")
    pflat = flatten_pytree(pstate)
    assert list(pflat) == list(jflat)
    for path in jflat:
        assert (codec.dtype_name(pflat[path].dtype), pflat[path].shape) == \
               (str(jflat[path].dtype), jflat[path].shape), path
    back = unflatten_like(pstate, pflat)
    assert type(back) is type(pstate)
    assert all(np.array_equal(flatten_pytree(back)[p], pflat[p]) for p in pflat)


def test_bf16_leaves_round_trip_as_their_bits():
    tree = {"a": torch.randn(3, 5).bfloat16(), "b": [torch.arange(4)]}
    flat = flatten_pytree(tree)
    assert list(flat) == ["a", "b/0"] and flat["a"].dtype == codec.BF16
    assert codec.dtype_name(flat["a"].dtype) == "bfloat16"
    back = unflatten_like(tree, flat)
    assert torch.equal(back["a"], tree["a"]) and torch.equal(back["b"][0], tree["b"][0])


def _bf16(shape, seed):
    """The same bf16 values as the reference's ml_dtypes array and the
    port's carrier."""
    ml = _rand(shape, seed).astype(ml_dtypes.bfloat16)
    return ml, ml.view(np.uint16).view(codec.BF16)


@pytest.mark.parametrize("shape", [(7, 129), (200, 256)], ids=str)
def test_bf16_leaf_is_int8_quantised_as_the_reference(shape):
    ml, carried = _bf16(shape, seed=8)
    enc, payload, meta = codec.encode_shard(carried, "int8", device="cpu")
    jenc, jpayload, jmeta = jax_codec.encode_shard(ml, "int8")
    assert (enc, meta) == (jenc, jmeta) == ("int8", jmeta)
    assert payload.tobytes() == np.asarray(jpayload).tobytes()
    got = codec.decode_shard(enc, payload, "bfloat16", shape, meta, device="cpu")
    want = jax_codec.decode_shard(jenc, jpayload, "bfloat16", shape, jmeta)
    assert got.dtype == codec.BF16 and got.tobytes() == want.tobytes()
    for name in ("raw", "zlib"):      # lossless: the bits come back
        enc, payload, meta = codec.encode_shard(carried, name, device="cpu")
        assert codec.decode_shard(enc, payload, "bfloat16", shape, meta).tobytes() == \
            carried.tobytes()


# --------------------------------------------------------------------------- #
# Checkpoints across the two packages
# --------------------------------------------------------------------------- #
N_RANKS = 2


def _write(store, flat, step, codec_name):
    for rank, shards in enumerate(sharding.shard_state(flat, N_RANKS)):
        store.write_rank(step, rank, shards, codec=codec_name, lossless_paths=LOSSLESS_PATHS)
    store.commit(step, N_RANKS)


def _states():
    jstate = jax_init_state(jax_get_config("llama3-8b").reduced(), JaxAdamConfig(),
                            jax.random.key(0))
    template = init_train_state(get_config("llama3-8b").reduced(), AdamConfig(), seed=1,
                                device="cpu")
    return jstate, template


def _index(root, step, rank):
    return json.loads((root / f"step_{step:08d}" / f"rank_{rank:05d}" / "index.json").read_text())


@pytest.mark.parametrize("codec_name", ["raw", "zlib", "int8"])
def test_checkpoints_cross_between_packages(codec_name, tmp_path):
    jstate, template = _states()
    jflat = {k: np.asarray(v) for k, v in jax_flatten(jstate).items()}

    # written by the reference, restored by the port
    _write(JaxDiskStore(str(tmp_path / "jax")), jflat, 3, codec_name)
    port_store = DiskStore(str(tmp_path / "jax"), device="cpu")
    assert port_store.latest_step() == 3
    restored = unflatten_like(template, sharding.unshard_state(port_store.read_all(3)))
    pflat = flatten_pytree(restored)
    jread = jax_sharding.unshard_state(JaxDiskStore(str(tmp_path / "jax")).read_all(3))
    assert list(pflat) == list(jflat)
    for path in jflat:
        assert np.array_equal(pflat[path], jread[path]), path
        if codec_name != "int8" or codec.is_lossless_path(path, LOSSLESS_PATHS):
            assert pflat[path].tobytes() == jflat[path].tobytes(), path

    # the port's state holding the same values, written by the port: the
    # same files and index entries as the reference wrote, int8 included,
    # and the reference restores them as it restores its own
    own = flatten_pytree(unflatten_like(template, jflat))
    _write(DiskStore(str(tmp_path / "port"), device="cpu"), own, 3, codec_name)
    for rank in range(N_RANKS):
        j_idx, p_idx = _index(tmp_path / "jax", 3, rank), _index(tmp_path / "port", 3, rank)
        assert p_idx == j_idx
        rdir = f"step_{3:08d}/rank_{rank:05d}/"
        for ent in p_idx:
            assert (tmp_path / "port" / rdir / ent["file"]).read_bytes() == \
                   (tmp_path / "jax" / rdir / ent["file"]).read_bytes(), ent["spec"]["path"]
        encs = {e["spec"]["path"]: e["enc"] for e in p_idx}
        if codec_name == "int8":
            for path, enc in encs.items():
                quantised = path.startswith("params/") and \
                    not codec.is_lossless_path(path, LOSSLESS_PATHS)
                assert (enc == "int8") == quantised, path
    jback = jax_unflatten(jstate, jax_sharding.unshard_state(
        JaxDiskStore(str(tmp_path / "port")).read_all(3)))
    for path, arr in jax_flatten(jback).items():
        assert np.array_equal(np.asarray(arr), jread[path]), path


def test_port_store_writes_the_reference_layout(tmp_path):
    _, template = _states()
    flat = flatten_pytree(template)
    _write(DiskStore(str(tmp_path / "p"), device="cpu"), flat, 5, "zlib")
    _write(JaxDiskStore(str(tmp_path / "j")), flat, 5, "zlib")
    for rank in range(N_RANKS):
        p_idx, j_idx = _index(tmp_path / "p", 5, rank), _index(tmp_path / "j", 5, rank)
        assert p_idx == j_idx
    assert sorted(p.name for p in (tmp_path / "p" / "step_00000005").iterdir()) == \
           sorted(p.name for p in (tmp_path / "j" / "step_00000005").iterdir())


@pytest.mark.parametrize("codec_name", ["raw", "zlib", "int8"])
def test_bf16_checkpoint_restores_in_the_reference(codec_name, tmp_path):
    # bf16 params and moments: the reference cannot write this state (its
    # streaming crc takes no ml_dtypes buffer), but it reads the port's
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), param_dtype="bfloat16")
    pstate = init_train_state(cfg, AdamConfig(moment_dtype="bfloat16"), seed=2, device="cpu")
    flat = flatten_pytree(pstate)
    _write(DiskStore(str(tmp_path), device="cpu"), flat, 3, codec_name)
    ours = sharding.unshard_state(DiskStore(str(tmp_path), device="cpu").read_all(3))
    theirs = jax_sharding.unshard_state(JaxDiskStore(str(tmp_path)).read_all(3))
    n_int8 = 0
    for path, arr in flat.items():
        ent = next(e for r in range(N_RANKS) for e in _index(tmp_path, 3, r)
                   if e["spec"]["path"] == path)
        assert ent["dtype"] == codec.dtype_name(arr.dtype) == str(theirs[path].dtype), path
        assert ours[path].tobytes() == np.asarray(theirs[path]).tobytes(), path
        if ent.get("enc") == "int8":
            n_int8 += 1
        else:
            assert ours[path].tobytes() == arr.tobytes(), path
    quantised = [p for p in flat if p.startswith("params/")
                 and not codec.is_lossless_path(p, LOSSLESS_PATHS)]
    assert quantised and n_int8 == (len(quantised) if codec_name == "int8" else 0)
    back = unflatten_like(pstate, ours)
    assert all(t.dtype == torch.bfloat16 for t in back.params["tok"].values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_int8_codec_matches_the_cpu_codec(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    data = ARRAYS["f32_many"] if dtype == "float32" else _bf16((200, 256), seed=9)[1]
    enc, payload, meta = codec.encode_shard(data, "int8", device="cuda")
    cenc, cpayload, cmeta = codec.encode_shard(data, "int8", device="cpu")
    assert (enc, meta) == (cenc, cmeta) == ("int8", cmeta)
    assert payload.tobytes() == cpayload.tobytes()
    got = codec.decode_shard(enc, payload, dtype, data.shape, meta, device="cuda")
    want = codec.decode_shard(enc, payload, dtype, data.shape, meta, device="cpu")
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
