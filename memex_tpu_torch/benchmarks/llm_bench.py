"""Local-LLM decode throughput (port of memex_tpu/benchmarks/llm_bench.py).

Measures prefill latency and decode tokens/sec for the port's Llama stack
(llm/local/model.py) at a published model geometry with random weights
drawn on the device from a seed — compute cost is weight-value-independent,
so these numbers transfer to real checkpoints of the same shape.
Reference comparison point: GGML q4 CPU decode, typically ~10 tok/s for
7B-class models.

Usage:
  python -m memex_tpu_torch.benchmarks.llm_bench [--geometry tinyllama-1.1b]
      [--device cuda | cpu]

The decoder has no kernel of its own to build, so `compile_s` is the first
call's seconds (the first use of each PyTorch op on the device).
"""

from __future__ import annotations

import argparse
import json
import time


def _wait(t) -> None:
    """Block until the device has computed `t`."""
    import torch

    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _to_host(t):
    """Start `t`'s copy to the host: (host tensor, event or None). On a card
    the copy lands in pinned memory behind an event, so waiting for it does
    not wait for work enqueued later (`.cpu()` would)."""
    import torch

    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def stream_decode_bench(cfg, params, prompt, prompt_len, sc, max_new, gen,
                        *, prefill_fn=None, decode_fn=None,
                        first_chunk=4, chunk=16):
    """Timed streaming decode (one-chunk-lookahead pipeline, mirroring
    LocalLLM._stream: chunk i+1 is enqueued before chunk i's tokens are
    read back, so the read overlaps the next chunk's work; the first chunk
    is the 4-token ramp, so first visible token = prefill + 4 tokens + one
    read). `gen` is the sampler's torch.Generator.

    DONATION CONTRACT: decode_fn spends its carry (the port's decode_chunk
    writes the KV cache in place, as memex_tpu's donates it) — a carry that
    has been passed to decode_fn is DEAD and must never be passed again.
    This function chains every carry exactly once;
    tests/test_torch_benchmarks.py wraps decode_fn with a tracker to
    enforce it."""
    if prefill_fn is None or decode_fn is None:
        from ..llm.local.model import decode_chunk as _dc, prefill as _pf

        prefill_fn = prefill_fn or _pf
        decode_fn = decode_fn or _dc

    # Warm the path, carries chained (each consumed exactly once).
    carry = prefill_fn(cfg, params, prompt, prompt_len, sc)
    _wait(carry[1])
    carry, toks, _ = decode_fn(cfg, params, carry, sc, chunk, gen, eos_id=-1)
    _wait(toks)
    carry, toks, _ = decode_fn(cfg, params, carry, sc, first_chunk, gen, eos_id=-1)
    _wait(toks)
    del carry  # consumed by the warmup chain; the timed run re-prefills

    # Timed prefill: a FRESH carry for the timed stream.
    t0 = time.perf_counter()
    carry = prefill_fn(cfg, params, prompt, prompt_len, sc)
    float(carry[1][0])
    prefill_s = time.perf_counter() - t0

    def enqueue(carry, n):
        carry, toks, _ = decode_fn(cfg, params, carry, sc, n, gen, eos_id=-1)
        return (carry, *_to_host(toks))

    t0 = time.perf_counter()
    n_stream = 0
    first_tok_s = None
    pending = enqueue(carry, first_chunk)
    dispatched = first_chunk
    while n_stream < max_new:
        next_carry, toks, ready = pending
        if dispatched < max_new:
            pending = enqueue(next_carry, chunk)
            dispatched += chunk
        if ready is not None:
            ready.synchronize()
        toks = toks.tolist()  # host read per chunk, like real streaming
        if first_tok_s is None:
            first_tok_s = time.perf_counter() - t0
        n_stream += len(toks)
    stream_s = time.perf_counter() - t0
    return {
        "prefill_s": prefill_s,
        "stream_s": stream_s,
        "n_stream": n_stream,
        "first_tok_s": first_tok_s,
    }


GEOMETRIES = {
    # TinyLlama-1.1B (hidden 2048, 22 layers, 32 heads / 4 kv, inter 5632)
    "tinyllama-1.1b": dict(vocab_size=32000, hidden_size=2048, num_layers=22,
                           num_heads=32, num_kv_heads=4, intermediate_size=5632,
                           max_context=2048),
    # Llama-2-7B geometry (bf16 params ~13.5 GB)
    "llama-2-7b": dict(vocab_size=32000, hidden_size=4096, num_layers=32,
                       num_heads=32, num_kv_heads=32, intermediate_size=11008,
                       max_context=2048),
    "tiny": dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
                 num_kv_heads=2, intermediate_size=256, max_context=256),
}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--geometry", default="tinyllama-1.1b", choices=GEOMETRIES)
    parser.add_argument("--prompt-len", type=int, default=128)
    parser.add_argument("--max-new", type=int, default=128)
    parser.add_argument("--param-dtype", default="bfloat16",
                        choices=["float32", "bfloat16", "int8"])
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model (default cuda)")
    args = parser.parse_args(argv)

    from ..runtime import require_device

    device = require_device(args.device, "benchmarks.llm_bench")
    if device is None:
        return 2

    import numpy as np
    import torch

    from ..llm.local.model import (
        LlamaConfig, SamplerConfig, convert_params, decode_chunk, generate,
        init_params, prefill,
    )

    cfg = LlamaConfig(**GEOMETRIES[args.geometry])
    params = convert_params(init_params(cfg, seed=0, device=device), args.param_dtype)
    n_params = sum(t.numel() for t in _leaves(params))
    sc = SamplerConfig()
    rng = np.random.default_rng(0)
    P = args.prompt_len
    prompt = torch.from_numpy(rng.integers(5, cfg.vocab_size, (1, P))).to(device)
    gen = torch.Generator(device=device).manual_seed(0)

    # -- single-call generation (batch path) ----------------------------------
    t0 = time.perf_counter()
    toks, _ = generate(cfg, params, prompt, P, sc, args.max_new, gen, eos_id=-1)
    _wait(toks)
    compile_s = time.perf_counter() - t0
    # Best of 3: one sample can catch a stall of the host.
    batch_s = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        toks, _ = generate(cfg, params, prompt, P, sc, args.max_new, gen, eos_id=-1)
        float(toks[-1])
        batch_s = min(batch_s, time.perf_counter() - t0)

    # -- streaming path (prefill + chunked decode) -----------------------------
    # stream_decode_bench owns the carry lifecycle: decode_chunk spends its
    # carry.
    stream = stream_decode_bench(
        cfg, params, prompt, P, sc, args.max_new, gen,
        prefill_fn=prefill, decode_fn=decode_chunk)
    prefill_s = stream["prefill_s"]
    stream_s = stream["stream_s"]
    n_stream = stream["n_stream"]
    first_tok_s = stream["first_tok_s"]

    print(json.dumps({
        "geometry": args.geometry,
        "params_m": round(n_params / 1e6, 1),
        "param_dtype": args.param_dtype,
        "prompt_len": P,
        "max_new": args.max_new,
        "compile_s": round(compile_s, 1),
        "batch_tok_per_s": round(args.max_new / batch_s, 1),
        "prefill_ms": round(prefill_s * 1e3, 1),
        "stream_tok_per_s": round(n_stream / stream_s, 1),
        # Time to the first VISIBLE token: prefill + first chunk + read.
        "first_token_ms": round((prefill_s + (first_tok_s or 0.0)) * 1e3, 1),
        "backend": device.type,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
