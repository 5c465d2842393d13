"""DeepSeek-V2-Lite on the port (``configs/deepseek_v2_lite_16b.py``, a
model the reference does not register): the registry and the parameter
count, YaRN's frequencies and softmax scale against values worked out by
hand, MLA without query compression through prefill and decode against the
port's own forward, and the router's unnormalised gates."""
import dataclasses

import pytest
import torch

from repro_torch.configs import ARCHS, PORT_ARCHS, get_config
from repro_torch.models import layers, mla, model, moe
from repro_torch.models.params import ParamBuilder
from repro_torch.serve.engine import decode_fn, pad_cache, prefill_fn

ARCH = "deepseek-v2-lite-16b"


def test_registry_resolves_the_port_arch_and_keeps_the_references():
    from repro.configs import ARCHS as JAX_ARCHS

    assert ARCHS == JAX_ARCHS and ARCH not in ARCHS and PORT_ARCHS == (ARCH,)
    cfg = get_config(ARCH)
    assert cfg.name == ARCH and cfg.n_layers == 27
    assert cfg.n_params() == 15_706_468_352
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("deepseek-v2-16b")


def test_yarn_by_hand():
    """Rope dim 64, theta 10,000, factor 40 over 4,096 positions, beta 32 / 1:
    the ramp runs over rotary indices 10..23 (64 ln(4096 / (2 pi b)) /
    (2 ln 10^4) is 10.47 at b = 32 and 22.51 at b = 1); mscale(40, 0.707) =
    0.0707 ln 40 + 1 = 1.26081, so the softmax scale is 192^-0.5 x 1.26081^2."""
    rs = get_config(ARCH).rope_scaling
    assert layers.yarn_correction_range(64, 10000.0, rs) == (10, 23)
    assert layers.yarn_mscale(40.0, 0.707) == pytest.approx(1.26081, abs=1e-5)
    assert layers.yarn_mscale(1.0, 0.707) == 1.0
    assert mla.softmax_scale(get_config(ARCH)) == pytest.approx(0.114722, abs=1e-6)
    plain = layers.rope_frequencies(64, 10000.0)
    yarn = layers.rope_frequencies(64, 10000.0, scaling=rs)
    assert torch.equal(yarn[:11], plain[:11])
    torch.testing.assert_close(yarn[23:], plain[23:] / 40, rtol=1e-6, atol=0)
    mid = yarn[11:23]
    assert bool(((mid < plain[11:23]) & (mid > plain[11:23] / 40)).all())
    # index 16: a ramp of 6/13 toward the interpolated frequency
    torch.testing.assert_close(yarn[16], plain[16] * (6 / 13 / 40 + 7 / 13), rtol=1e-6, atol=0)


def test_yarn_rotation_gain_is_the_mscale_ratio():
    """cos and sin times mscale(f, mscale) / mscale(f, mscale_all_dim): 1 for
    DeepSeek-V2-Lite (both 0.707), a norm gain where the two differ."""
    rs = get_config(ARCH).rope_scaling
    x = torch.randn(2, 5, 3, 8, generator=torch.Generator().manual_seed(4))
    pos = torch.arange(5)[None].expand(2, 5)
    norm = torch.linalg.vector_norm(layers.apply_rope(x, pos, 10000.0, scaling=rs), dim=-1)
    torch.testing.assert_close(norm, torch.linalg.vector_norm(x, dim=-1))
    other = dataclasses.replace(rs, mscale=1.0)
    gain = layers.yarn_mscale(40.0, 1.0) / layers.yarn_mscale(40.0, 0.707)
    norm = torch.linalg.vector_norm(layers.apply_rope(x, pos, 10000.0, scaling=other), dim=-1)
    torch.testing.assert_close(norm, gain * torch.linalg.vector_norm(x, dim=-1))


def test_no_query_compression_means_one_query_product():
    cfg = get_config(ARCH)
    p = mla.mla_params(ParamBuilder("shape"), cfg)
    assert "w_q" in p and not {"w_dq", "q_scale", "w_uq"} & set(p)
    assert tuple(p["w_q"].shape) == (2048, 16 * 192)
    assert cfg.reduced().mla.q_lora_rank == 0
    # the reference archs' compressed query keeps its reduced rank
    assert get_config("deepseek-v3-671b").reduced().mla.q_lora_rank == 32


def test_rope_scaling_without_mla_is_refused():
    with pytest.raises(ValueError, match="MLA"):
        dataclasses.replace(get_config("olmoe-1b-7b"), rope_scaling=get_config(ARCH).rope_scaling)


def test_prefill_then_decode_equals_the_forward():
    """The reduced config in float32 (YaRN, no query compression, shared
    experts, every expert on every token): a prefill of 9 tokens, then 5
    absorbed decode steps through the latent cache, against the
    reconstructing forward over all 14."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), compute_dtype="float32")
    params = model.init_params(cfg, seed=3, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 14), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        full, *_ = model.forward(params, cfg, {"tokens": tokens}, mode="train")
        logits, cache = prefill_fn(params, cfg, {"tokens": tokens[:, :9]}, attn_impl="chunked")
        got = [logits]
        cache = pad_cache(cfg, cache, 2, 16)
        for t in range(9, 14):
            logits, cache = decode_fn(params, cfg, tokens[:, t], cache,
                                      torch.full((2,), t, dtype=torch.long))
            got.append(logits)
    want = full[:, 8:14]
    scale = float(want.abs().max())
    # the absorbed form reassociates the products: a few float32 roundings
    torch.testing.assert_close(torch.stack(got, dim=1), want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("norm", [False, True])
def test_gates_are_the_top_k_probabilities_unless_renormalised(norm):
    cfg = get_config(ARCH).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, norm_topk_prob=norm))
    router = 0.02 * torch.randn(cfg.d_model, cfg.moe.n_experts,
                                generator=torch.Generator().manual_seed(1))
    x = torch.randn(3, 7, cfg.d_model, generator=torch.Generator().manual_seed(2))
    probs, gate, idx = moe._gate({"router": router}, x, cfg)
    picked = torch.gather(probs, -1, idx)
    if norm:
        torch.testing.assert_close(gate.sum(-1), torch.ones(3, 7))
        torch.testing.assert_close(gate, picked / (picked.sum(-1, keepdim=True) + 1e-9))
    else:
        # top 2 of 4 near-even probabilities: each token's gates sum to about a half
        assert torch.equal(gate, picked)
        assert bool((gate.sum(-1) < 0.9).all())
