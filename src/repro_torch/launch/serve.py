"""Serving CLI: batched generation with the port's ServeEngine, on the
card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 \
        --prompt-len 2048 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-medium --reduced --device cpu

``--arch`` takes any ported architecture (``configs.base.PORTED``); a
codebook model's prompts are (prompt_len, n_codebooks), as in the
reference CLI, and a VLM's prompts must be at least its
``n_vision_tokens`` long.  Flags and defaults are the reference CLI's (``repro.launch.serve``), plus
``--device`` (``cpu`` switches the configuration to float32, as the
reference does on a CPU backend) and ``--profile``.  Prints the
reference's ``[serve]`` line, then prefill and decode times (host clock
between ``torch.cuda.synchronize()`` fences) with prompt and decode
tokens per second.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs.base import get_config, get_reduced
from repro_torch.device import resolve_device, synchronize
from repro_torch.profiling import print_profile
from repro_torch.serve.engine import Request, ServeEngine


def _requests(args, cfg) -> list[Request]:
    rng = np.random.default_rng(args.seed)
    shape = (args.prompt_len,) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    return [
        Request(
            prompt=rng.integers(0, cfg.vocab, shape).astype(np.int32),
            max_new_tokens=args.new_tokens,
            temperature=args.temperature,
        )
        for _ in range(args.requests)
    ]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs float32 "
                         "through the plain PyTorch versions)")
    ap.add_argument("--profile", action="store_true",
                    help="generate again under torch.profiler and print host "
                         "and device time of prefill and decode per kernel")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if device.type == "cpu":
        cfg = dataclasses.replace(cfg, dtype="float32")

    reqs = _requests(args, cfg)
    eng = ServeEngine(cfg, max_len=args.prompt_len + args.new_tokens + 8,
                      max_batch=args.max_batch, seed=args.seed, device=device)
    synchronize(device)
    t0 = time.perf_counter()
    eng.generate(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in reqs)
    st = eng.stats
    print(f"[serve] {len(reqs)} requests, {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s)")
    print(f"[serve] device={device} arch={cfg.name} dtype={cfg.dtype} "
          f"prefill {st.prefill_s} s ({st.prompt_tokens} prompt tokens, "
          f"{st.prompt_tokens / st.prefill_s} prompt tok/s, "
          f"{st.prefill_batches} batches); decode {st.decode_s} s "
          f"({st.decode_tokens} tokens, {st.decode_tokens / st.decode_s if st.decode_s else 0.0} "
          f"decode tok/s, {st.decode_steps} steps)")
    for i, r in enumerate(reqs[:4]):
        print(f"  req{i}: {r.out_tokens[:8]}...")
    if args.profile:
        print_profile(lambda: eng.generate(_requests(args, cfg)), prefix="serve.")


if __name__ == "__main__":
    main()
