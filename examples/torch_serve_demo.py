"""Batched serving demo on the PyTorch port: prefill + greedy decode with
per-family caches (KV for attention, latent for MLA, O(1) conv+SSM state for
mamba2). The counterpart of ``examples/serve_demo.py``.

    PYTHONPATH=src python examples/torch_serve_demo.py [arch ...]     # on the card
    PYTHONPATH=src python examples/torch_serve_demo.py --device cpu

On the card the prefill runs the hand-written kernels (``attn_impl="kernel"``):
reduced llama3's attention at head dim 16 on the CUDA-core flash attention,
reduced mamba2's scan on the CUDA-core SSD kernel. ``main`` returns each
arch's generated tokens and wall time.
"""
import argparse
import time
from typing import Optional, Sequence

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch.serve import make_extras, make_prompts
from repro_torch.models import init_params
from repro_torch.serve.engine import greedy_generate, serve_params_cast

ARCHS = ("llama3-8b", "mamba2-130m", "deepseek-v3-671b")
BATCH, PROMPT, STEPS = 4, 32, 16


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("archs", nargs="*", default=list(ARCHS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {}
    for arch in args.archs:
        cfg = get_config(arch).reduced()
        params = serve_params_cast(init_params(cfg, seed=0, device=device), cfg)
        batch = {"tokens": make_prompts(cfg, BATCH, PROMPT, 1, device),
                 **make_extras(cfg, BATCH, PROMPT, 1, device)}
        t0 = time.perf_counter()
        tokens = greedy_generate(params, cfg, batch, steps=STEPS).cpu()
        dt = time.perf_counter() - t0
        print(f"{arch:20s} batch={BATCH} prompt={PROMPT} generated={STEPS} tokens/seq "
              f"in {dt:.2f}s -> {tokens[0, :8].tolist()} ...")
        out[arch] = {"tokens": tokens.tolist(), "seconds": dt}
    return out


if __name__ == "__main__":
    main()
