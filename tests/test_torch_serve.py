"""The port's serving path against the JAX reference on reduced llama3-8b:
greedy generation, decode-vs-forward consistency, and the serve CLI."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.tce.engine import flatten_pytree  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serve.engine import greedy_generate as jax_greedy_generate  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.params import params_from_flat  # noqa: E402
from repro_torch.serve.engine import (decode_fn, greedy_generate, pad_cache,  # noqa: E402
                                      prefill_fn)

def _both(seed, **kw):
    jcfg = dataclasses.replace(jax_get_config("llama3-8b").reduced(), **kw)
    pcfg = dataclasses.replace(get_config("llama3-8b").reduced(), **kw)
    jparams = jax_model.init_params(jcfg, jax.random.key(seed))
    return jcfg, jparams, pcfg, params_from_flat(flatten_pytree(jparams), pcfg, "cpu")


def test_greedy_generate_matches_jax_f32():
    jcfg, jparams, pcfg, params = _both(1, compute_dtype="float32")
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 16))
    gen = jax.jit(lambda p, t: jax_greedy_generate(p, jcfg, {"tokens": t}, steps=5))
    want = gen(jparams, jnp.asarray(tokens, jnp.int32))
    got = greedy_generate(params, pcfg, {"tokens": torch.from_numpy(tokens)}, steps=5)
    assert got.shape == (2, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_matches_forward():
    """Mirror of tests/test_models.py::test_decode_matches_forward for llama3:
    decoded next-token logits == full-forward logits at that position."""
    _, _, cfg, params = _both(2, compute_dtype="float32")
    b, s = 2, 17
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (b, s)))
    with torch.no_grad():
        logits_full, _, _, _ = model.forward(params, cfg, {"tokens": tokens}, mode="train")
        _, cache = prefill_fn(params, cfg, {"tokens": tokens[:, :s - 1]})
        cache = pad_cache(cfg, cache, b, s + 4)
        pos = torch.full((b,), s - 1, dtype=torch.long)
        logits_dec, _ = decode_fn(params, cfg, tokens[:, s - 1], cache, pos)
    np.testing.assert_allclose(logits_dec.numpy(), logits_full[:, s - 1].numpy(),
                               rtol=2e-4, atol=2e-4)


def test_plain_and_kernel_impls_agree_on_cpu():
    # On the CPU both impls are the plain version: this pins the switch itself.
    _, _, cfg, params = _both(3)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 8)))
    with torch.no_grad():
        a, _ = prefill_fn(params, cfg, {"tokens": tokens}, attn_impl="kernel")
        b, _ = prefill_fn(params, cfg, {"tokens": tokens}, attn_impl="plain")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        prefill_fn(params, cfg, {"tokens": tokens}, attn_impl="pallas")


def test_serve_cli_runs_on_cpu(capsys):
    res = serve_cli.main(["--arch", "llama3-8b", "--reduced", "--device", "cpu",
                          "--requests", "2", "--prompt-len", "16", "--gen", "4"])
    assert res["tokens"].shape == (2, 4)
    toks = res["tokens"].numpy()
    assert ((toks >= 0) & (toks < res["cfg"].vocab_size)).all()
    assert torch.isfinite(res["prefill_logits"].float()).all()
    assert "prefill:" in capsys.readouterr().out


def test_serve_cli_without_card_fails_instead_of_running_on_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    with pytest.raises(SystemExit) as exc:
        serve_cli.cli(["--reduced", "--gen", "2", "--prompt-len", "4"])
    assert exc.value.code not in (0, None)          # a message exits with status 1
    assert "--device cpu" in str(exc.value.code)
    assert "prefill:" not in capsys.readouterr().out
