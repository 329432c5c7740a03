"""Batched serving engine: prefill + decode with generational batching.

The port of the reference's ``repro.serve.engine``, with its semantics:

* requests arrive with a prompt and a max_new_tokens budget;
* the engine takes up to ``max_batch`` waiting requests, left-pads their
  prompts with token 0 to a common length (positions stay dense), runs one
  prefill, then single-token decode steps over the whole batch;
* finished rows (EOS or budget) are retired at the end of their batch and
  the next batch is formed from the queue (generational batching);
* sampling happens on the host in numpy, greedy or with temperature from
  ``np.random.default_rng(seed)``, so greedy tokens match the reference's;
* a codebook model (musicgen) takes (S, n_cb) prompts, samples each
  codebook of a row, and appends a list of n_cb tokens a step to
  ``out_tokens``; a VLM batch gets zero ``vision_embeds`` over its first
  ``n_vision_tokens`` positions, as in the reference.

The decode step updates the KV cache in place (the reference donates it to
XLA for the same effect).  ``stats`` keeps the time spent in prefill and in
decode, each between ``torch.cuda.synchronize()`` fences, and the tokens
each produced; ``serve.prefill`` / ``serve.decode`` are
``torch.profiler.record_function`` ranges.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.device import resolve_device, synchronize
from repro_torch.models.transformer import (
    check_supported,
    decode_step,
    init_params,
    param_dtype,
    prefill,
)

__all__ = ["ServeEngine", "Request", "ServeStats"]


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # (S,) int32, or (S, n_cb) for codebook models
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: int | None = None
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class ServeStats:
    """Host-clock seconds between device fences, and token counts."""

    prefill_s: float = 0.0
    decode_s: float = 0.0
    prompt_tokens: int = 0  # real prompt tokens prefilled (padding excluded)
    decode_tokens: int = 0  # tokens appended by decode steps
    prefill_batches: int = 0
    decode_steps: int = 0


class ServeEngine:
    def __init__(self, cfg, params=None, *, max_len: int = 4096,
                 max_batch: int = 8, seed: int = 0, device=None):
        check_supported(cfg)
        self.cfg = cfg
        self.max_len = max_len
        self.max_batch = max_batch
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(gen, cfg)
        elif params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params are on {params['embed'].device}, the engine on {self.device}"
            )
        self.params = params
        self._rng = np.random.default_rng(seed)
        self.stats = ServeStats()

    # -- sampling -----------------------------------------------------------
    def _sample(self, logits: np.ndarray, temps: np.ndarray) -> np.ndarray:
        """logits (B, V) or (B, n_cb, V), a row's temperature for each of
        its codebooks; rows (and codebooks) drawn in order."""
        out = np.empty(logits.shape[:-1], np.int32)
        flat = out.reshape(-1)
        tf = np.broadcast_to(temps.reshape(-1, *([1] * (logits.ndim - 2))),
                             logits.shape[:-1]).reshape(-1)
        for i, (row, t) in enumerate(zip(logits.reshape(-1, logits.shape[-1]), tf)):
            if t <= 0:
                flat[i] = int(np.argmax(row))
            else:
                p = np.exp((row - row.max()) / t)
                p /= p.sum()
                flat[i] = int(self._rng.choice(len(row), p=p))
        return out

    @staticmethod
    def _host(logits: torch.Tensor) -> np.ndarray:
        return logits.float().cpu().numpy()

    # -- one generation batch -------------------------------------------------
    def generate(self, requests: list[Request]) -> list[Request]:
        """Run a list of requests to completion (batched, generational)."""
        queue = list(requests)
        while any(not r.done for r in queue):
            batch = [r for r in queue if not r.done][: self.max_batch]
            self._run_batch(batch)
        return requests

    @torch.inference_mode()
    def _run_batch(self, batch: list[Request]):
        cfg, dev, st = self.cfg, self.device, self.stats
        B = len(batch)
        S = max(max(len(r.prompt) for r in batch), 2)
        # left-pad prompts to a common length (pads attend causally but
        # positions stay dense, as in the reference)
        toks = np.zeros((B, S) + ((cfg.n_codebooks,) if cfg.n_codebooks else ()), np.int32)
        for i, r in enumerate(batch):
            toks[i, S - len(r.prompt):] = r.prompt
        temps = np.array([r.temperature for r in batch])
        budget = max(r.max_new_tokens for r in batch)

        synchronize(dev)
        t0 = time.perf_counter()
        with record_function("serve.prefill"):
            feed = {"tokens": torch.as_tensor(toks, device=dev).long()}
            if cfg.n_vision_tokens:
                feed["vision_embeds"] = torch.zeros((B, cfg.n_vision_tokens, cfg.d_model),
                                                    dtype=param_dtype(cfg), device=dev)
            logits, state = prefill(self.params, feed, cfg, max_len=self.max_len)
            cur = self._sample(self._host(logits), temps)
        t1 = time.perf_counter()
        st.prefill_s += t1 - t0
        st.prompt_tokens += sum(len(r.prompt) for r in batch)
        st.prefill_batches += 1
        for i, r in enumerate(batch):
            r.out_tokens.append(cur[i].tolist())

        pos = S
        with record_function("serve.decode"):
            for _ in range(budget - 1):
                tok = torch.as_tensor(cur.reshape((B, 1) + cur.shape[1:]), device=dev).long()
                logits, state = decode_step(self.params, tok, state, pos, cfg)
                pos += 1
                cur = self._sample(self._host(logits), temps)
                st.decode_steps += 1
                for i, r in enumerate(batch):
                    if r.done:
                        continue
                    t = cur[i].tolist()
                    r.out_tokens.append(t)
                    st.decode_tokens += 1
                    if len(r.out_tokens) >= r.max_new_tokens or (
                        r.eos_id is not None and t == r.eos_id
                    ):
                        r.done = True
                if all(r.done for r in batch):
                    break
        synchronize(dev)
        st.decode_s += time.perf_counter() - t1
        for r in batch:
            r.done = True
