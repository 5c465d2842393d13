from .engine import decode_fn, greedy_generate, prefill_fn, serve_params_cast

__all__ = ["prefill_fn", "decode_fn", "greedy_generate", "serve_params_cast"]
