"""Deterministic, shard-aware synthetic token pipeline, copied from the
reference's ``repro.data.pipeline`` (numpy only).

Every batch is a pure function of ``(seed, step, shard_index)``: the
pipeline is *stateless*, so checkpoint/restart needs to persist only the
step counter, and a restarted job regenerates byte-identical data for any
step.  Tokens follow a mixed zipfian/bigram distribution so the loss curve
is non-trivial.  The batches are bitwise the reference's.

:func:`batch_shapes` gives the (shape, numpy dtype) of each entry of a
batch; it stands where the reference's ``batch_spec`` returns
``jax.ShapeDtypeStruct``s for its dry-run.  :func:`make_batch`
materializes a batch on the host; :class:`TokenPipeline` wraps it in a
prefetching iterator.  The VLM stub's batches also carry ``vision_embeds``
(B, n_vision_tokens, d_model); numpy has no bfloat16, so a bfloat16
configuration gets them as float32 arrays that hold the reference's
bfloat16 values exactly (round to nearest, ties to even).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

__all__ = ["batch_shapes", "make_batch", "TokenPipeline"]


def batch_shapes(cfg, shape) -> dict[str, tuple[tuple[int, ...], np.dtype]]:
    """Shapes/dtypes of one global batch for (arch cfg, ShapeConfig)."""
    B, S = shape.global_batch, shape.seq_len
    tok_shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    out = {
        "tokens": (tok_shape, np.dtype(np.int32)),
        "labels": (tok_shape, np.dtype(np.int32)),
    }
    if cfg.n_vision_tokens:
        dtype = np.dtype(np.float32 if cfg.dtype == "bfloat16" else cfg.dtype)
        out["vision_embeds"] = ((B, cfg.n_vision_tokens, cfg.d_model), dtype)
    return out


def _round_to_bfloat16(a: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bfloat16 value (ties to even), as float32;
    finite inputs."""
    bits = a.view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))) & np.uint32(
        0xFFFF0000)
    return bits.view(np.float32)


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    """Zipf-ish token draw: rank ~ floor(vocab * u^3) biases low ids."""
    u = rng.random(shape)
    toks = (vocab * u**3).astype(np.int64)
    return np.minimum(toks, vocab - 1).astype(np.int32)


def make_batch(cfg, shape, step: int, seed: int = 0, shard=None) -> dict[str, np.ndarray]:
    """Materialize the (optionally sharded) batch for ``step``.

    shard: None for the full global batch, or (index, count) to produce
    rows [index*B/count, (index+1)*B/count); each shard's rows depend only
    on their global row id, so any shard layout yields the same global
    batch.
    """
    B = shape.global_batch
    rows = np.arange(B)
    if shard is not None:
        idx, count = shard
        if B % count:
            raise ValueError(f"global batch {B} does not split into {count} shards")
        rows = rows[idx * (B // count) : (idx + 1) * (B // count)]

    shapes = batch_shapes(cfg, shape)
    tok_shape, _ = shapes["tokens"]
    per_row = tok_shape[1:]
    toks = np.empty((len(rows),) + per_row, np.int32)
    for i, r in enumerate(rows):
        rng = np.random.default_rng(np.random.SeedSequence([seed, step, int(r)]))
        t = _zipf_tokens(rng, per_row, cfg.vocab)
        # learnable bigram structure: even positions repeat a row-constant
        # "topic" token 25% of the time.
        topic = int(rng.integers(cfg.vocab))
        mask = (rng.random(per_row) < 0.25) & (
            (np.arange(per_row[0]) % 2 == 0)[(...,) + (None,) * (len(per_row) - 1)]
        )
        toks[i] = np.where(mask, topic, t)

    # next-token labels; -1 masks the last position (and the vision prefix).
    labels = np.concatenate([toks[:, 1:], np.full_like(toks[:, :1], -1)], axis=1)
    out = {"tokens": toks}
    if cfg.n_vision_tokens:
        labels[:, : cfg.n_vision_tokens] = -1
        rng = np.random.default_rng(np.random.SeedSequence([seed, step, 1 << 20]))
        v = rng.standard_normal((len(rows), cfg.n_vision_tokens, cfg.d_model), np.float32)
        out["vision_embeds"] = (_round_to_bfloat16(v) if cfg.dtype == "bfloat16"
                                else v.astype(shapes["vision_embeds"][1]))
    out["labels"] = labels
    return out


class TokenPipeline:
    """Prefetching iterator over deterministic batches.

    State = the step counter alone; ``state_dict()``/``load_state_dict``
    are what a checkpoint persists.
    """

    def __init__(self, cfg, shape, seed: int = 0, start_step: int = 0,
                 shard=None, prefetch: int = 2):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.shard = shard
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            batch = make_batch(self.cfg, self.shape, step, self.seed, self.shard)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)

    # -- checkpointable state -------------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, d: dict):
        self.close()
        self.__init__(self.cfg, self.shape, d["seed"], d["step"], self.shard)
