"""Serving entry point: one wave of requests through batched prefill + decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --requests 8 --prompt-len 1024 --gen 32            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
        --requests 8 --prompt-len 4096 --gen 32            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --requests 8 --prompt-len 1024 --gen 32            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
        --requests 8 --prompt-len 384 --gen 64             # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-2b \
        --requests 8 --prompt-len 2048 --gen 32            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

Counterpart of ``repro.launch.serve``, with the same flags plus ``--device``
(default ``cuda``; without a card the CLI fails rather than run on the CPU).
The wave is prefilled as one batch, its cache padded to prompt + gen
positions, and decoded greedily in lockstep. Weights are random, made on the
device from ``--seed``; prompts are drawn from ``--seed + 1``, and so are the
stub frontends' inputs, as in the reference: whisper's encoder frames
(``enc_embeds``, ``enc_len`` of them) and qwen2-vl's patch embeddings
(``vision_embeds``, in place of the first ``n_vision_tokens`` prompt tokens).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch import DeviceUnavailable, resolve_device
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import zero_extras
from repro_torch.serve.engine import decode_fn, pad_cache, prefill_fn, serve_params_cast


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def check_prompt_len(cfg: ModelConfig, prompt_len: int) -> None:
    """An SSM prefill scans chunks of min(chunk, prompt) tokens, so a prompt
    longer than one chunk must be a whole number of chunks (the reference
    asserts ``s % chunk == 0``). Raises ValueError before any weight is made."""
    if cfg.ssm is not None:
        chunk = cfg.ssm.chunk
        if prompt_len > chunk and prompt_len % chunk:
            raise ValueError(f"{cfg.name}: a prompt of {prompt_len} tokens is longer than "
                             f"one SSD chunk ({chunk}) but not a multiple of it")


def make_prompts(cfg: ModelConfig, requests: int, prompt_len: int, seed: int,
                 device) -> torch.Tensor:
    """(requests, prompt_len) token ids, the same for a seed on any device."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (requests, prompt_len),
                         generator=gen).to(device)


def make_extras(cfg: ModelConfig, requests: int, prompt_len: int, seed: int,
                device) -> Dict[str, torch.Tensor]:
    """The stub frontends' outputs of the reference's serve loop, standard
    normal float32 from ``seed``, the same on any device, in the shapes of
    the training batch's zeros (:func:`zero_extras`)."""
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=gen).to(device)
            for k, v in zero_extras(cfg, requests, prompt_len, "meta").items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve_wave(params, cfg: ModelConfig, tokens: torch.Tensor, gen: int,
               extras: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """Prefill ``tokens`` (with the batch ``extras``, :func:`make_extras`)
    and decode ``gen`` tokens. Returns tokens and times."""
    device = tokens.device
    b, s = tokens.shape
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill_fn(params, cfg, {"tokens": tokens, **(extras or {})})
    cache = pad_cache(cfg, cache, b, s + gen)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    prefill_logits = logits
    tok = torch.argmax(logits, dim=-1)
    pos = torch.full((b,), s, dtype=torch.long, device=device)
    out = [tok]
    t1 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = decode_fn(params, cfg, tok, cache, pos)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
        pos = pos + 1
    _sync(device)
    t_decode = time.perf_counter() - t1
    return {
        "tokens": torch.stack(out, dim=1),
        "prefill_logits": prefill_logits,
        "last_logits": logits,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
    }


def serve(cfg: ModelConfig, requests: int, prompt_len: int, gen: int, seed: int,
          device) -> Dict[str, Any]:
    """One wave of ``cfg``: weights made on ``device`` from ``seed``, prompts
    from ``seed + 1`` (and the batch extras, :func:`make_extras`),
    prefilled and decoded by ``serve_wave``. Returns the wave's result with
    the config, weights, prompts and extras."""
    check_prompt_len(cfg, prompt_len)
    params = serve_params_cast(init_params(cfg, seed, device, dtype=cfg.compute_dtype), cfg)
    print(f"serving {cfg.name} ({cfg.n_params():,} params) on {device}, "
          f"{requests} requests, prompt {prompt_len}, gen {gen}")

    b, s = requests, prompt_len
    tokens = make_prompts(cfg, b, s, seed + 1, device)
    extras = make_extras(cfg, b, s, seed + 1, device)
    res = serve_wave(params, cfg, tokens, gen, extras)
    t_prefill, t_decode = res["prefill_s"], res["decode_s"]
    steps = max(gen - 1, 1)
    sample = res["tokens"].cpu().numpy()
    print(f"prefill: {t_prefill*1e3:8.1f} ms  ({b*s/t_prefill:,.0f} tok/s)")
    print(f"decode : {t_decode*1e3:8.1f} ms  "
          f"({b*(gen-1)/max(t_decode,1e-9):,.0f} tok/s, "
          f"{t_decode/steps*1e3:.1f} ms/step)")
    print(f"sample : {sample[0, :12].tolist()}")
    return {"cfg": cfg, "params": params, "prompts": tokens, "extras": extras, **res}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    return serve(cfg, args.requests, args.prompt_len, args.gen, args.seed, device)


def cli(argv: Optional[Sequence[str]] = None) -> None:
    """``main`` for the command line: a missing device exits with status 1."""
    try:
        main(argv)
    except DeviceUnavailable as e:
        raise SystemExit(f"error: {e}")


if __name__ == "__main__":
    cli()
