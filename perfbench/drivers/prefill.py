"""Prefill traffic: a closed loop of clients whose prompts go to the prefill
pool together, one wave at a time, as the serving entry point
(``launch/serve.py``'s ``serve``) runs a wave: weights in the compute dtype,
``prefill_fn`` over the wave's prompts, then one greedy token per prompt,
read on the host. The cache the wave returns is handed on (a prefill pool
hands it to decode), so nothing here decodes.

Once the window has closed, the plain reference runs a sample of the waves
that were served, drawn from the seed: the gap by which each served token's
logit lies below the reference's best, and, for a few waves of the window's
start drawn from the seed too, the cache each layer handed on (the
convolution's tail and the scan's final state) against the reference's.
"""
from __future__ import annotations

import gc
import random
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench.counts import flops
from perfbench.lib import inputs, program
from perfbench.lib.trace import Profile
from perfbench.reference.common import Precision

WARM_BASE = 1 << 40      # wave indices of the warm-up, apart from the window's


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    b = b.float()
    norm = torch.linalg.vector_norm
    return float(norm(a.float() - b) / norm(b).clamp(min=1e-30))


def reference_gaps(job, served: Dict[int, torch.Tensor], caches: Dict[int, dict],
                   stand_in: Optional[Callable] = None) -> Dict[str, float]:
    """The numbers compared, against the plain reference in bfloat16.
    ``stand_in(params, m, tokens)``, where given, stands where the program
    stood and gives (logits, conv tails, final states) for each wave, its
    top tokens served: the reference in float8 (the control) or with a
    planted fault."""
    t, m, dev = job.traffic, job.port, job.device
    rows, seq = t["clients"], t["prompt"]
    ref = job.ref
    params = inputs.weight_dict(ref.param_spec(m), job.seed, dev, torch.bfloat16)
    lp = Precision("bf16")
    logit_gap, state_gap, conv_gap = 0.0, 0.0, 0.0
    with torch.inference_mode():
        for w in sorted(set(served) | set(caches)):
            tokens = inputs.wave(job.seed, w, rows, seq, m["vocab_size"], dev)
            logits, tails, states = ref.prefill(params, m, tokens, lp)
            if stand_in is not None:
                c_logits, c_tails, c_states = stand_in(params, m, tokens)
                got = {"tok": torch.argmax(c_logits, dim=-1), "conv": c_tails, "state": c_states}
            else:
                got = {"tok": served.get(w), **(caches.get(w) or {})}
            if w in served:
                tok = got["tok"].to(dev).long()
                lf = logits.float()
                gap = lf.max(dim=-1).values - lf.gather(-1, tok[:, None])[:, 0]
                logit_gap = max(logit_gap, float(gap.max()))
            if w in caches:
                for i in range(m["n_layers"]):
                    state_gap = max(state_gap, _rel(got["state"][i], states[i]))
                    conv_gap = max(conv_gap, _rel(got["conv"][i], tails[i]))
            del logits, tails, states, got
    return {"logit_gap": logit_gap, "state_gap": state_gap, "conv_gap": conv_gap}


def run(job) -> dict:
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.serve import check_prompt_len
    from repro_torch.serve.engine import prefill_fn

    t, m, dev = job.traffic, job.port, job.device
    rows, seq, impl = t["clients"], t["prompt"], t["attn_impl"]
    check_prompt_len(job.cfg, seq)
    spec = job.ref.param_spec(m)
    params = program.param_tree(job.cfg, inputs.weight_dict(spec, job.seed, dev, torch.bfloat16))

    ssd_calls: List[tuple] = []
    tracing = {"on": False}
    if job.trace:
        orig = ssd_ops.ssd_scan

        def traced_scan(*a, **kw):
            with torch.profiler.record_function("ssd_scan"):
                if tracing["on"]:
                    x, B = a[0], a[3]
                    b, s, nh, p = x.shape
                    ssd_calls.append((b, s, nh, p, B.shape[2], B.shape[3], kw["chunk"],
                                      x.element_size()))
                return orig(*a, **kw)

        ssd_ops.ssd_scan = traced_scan

    bad = torch.zeros((), dtype=torch.long, device=dev)

    @torch.inference_mode()
    def serve_wave(w: int):
        tokens = inputs.wave(job.seed, w, rows, seq, m["vocab_size"], dev)
        t_in = time.perf_counter()
        with torch.profiler.record_function("bench_wave"):
            logits, cache = prefill_fn(params, job.cfg, {"tokens": tokens}, attn_impl=impl)
            tok = torch.argmax(logits, dim=-1).cpu()
        ttft = time.perf_counter() - t_in
        bad.add_((~torch.isfinite(logits).all(dim=-1)).sum())
        return tok, cache, ttft

    for i in range(t["warm_waves"]):
        serve_wave(WARM_BASE + i)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - job.t_start

    rng = random.Random(inputs.sub_seed(job.seed, inputs.SAMPLE))
    keep_cache = set(rng.sample(range(t["cache_from_first"]), t["cache_waves"]))
    prof = Profile() if job.trace else None
    prof_state, prof_left, prof_overhead = "idle", 0, 0.0
    served: List[torch.Tensor] = []
    caches: Dict[int, dict] = {}
    ttfts: List[float] = []
    t0 = time.perf_counter()
    deadline = t0 + job.seconds
    w = 0
    while True:
        if (prof is not None and prof_state == "idle"
                and time.perf_counter() - t0 >= t["trace_at"] * job.seconds):
            p0 = time.perf_counter()
            prof.start()
            prof_overhead += time.perf_counter() - p0
            prof_state, prof_left, tracing["on"] = "on", t["trace_waves"], True
        tok, cache, ttft = serve_wave(w)
        served.append(tok)
        ttfts.append(ttft)
        if w in keep_cache:
            seg = cache["stack"]["l0"]
            caches[w] = {"conv": seg["conv"], "state": seg["state"]}
        del cache
        w += 1
        if prof_state == "on":
            prof_left -= 1
            if prof_left == 0:
                p0 = time.perf_counter()
                prof.stop()
                prof_overhead += time.perf_counter() - p0
                prof_state, tracing["on"] = "done", False
        # the window closes at the first wave past its end once the waves
        # whose caches are compared and the traced waves (if any) are in
        if (time.perf_counter() >= deadline and w > max(keep_cache)
                and (prof is None or prof_state == "done")):
            break
    t1 = time.perf_counter()
    window_s = t1 - t0
    mem_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = int(bad)

    ctx = {"kind": "prefill", "profiled": t["trace_waves"] if prof is not None else 0,
           "mfu_flops": flops.prefill_flops(m, rows, seq) * w,
           "mfu_seconds": window_s - prof_overhead, "ssd_calls": ssd_calls,
           "trace": prof.read() if prof is not None else None}
    sample = sorted(rng.sample(range(w), min(t["sample_waves"], w)))
    picked = {i: served[i] for i in sample}
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = reference_gaps(job, picked, caches)
    per_request = np.repeat(np.array(ttfts) * 1e3, rows)
    names = t["end_to_end"]
    return {"e2e": {names["tok_s"]: w * rows * seq / window_s,
                    names["ttft_ms_p95"]: float(np.percentile(per_request, 95))},
            "setup_s": setup_s, "numbers": numbers, "attempted": w * rows, "failed": failed,
            "memory_peak_bytes": mem_peak, "ctx": ctx}
