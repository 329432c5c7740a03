"""The port's ServeEngine vs the reference's, and the port's serve CLI.

Reduced qwen3-1.7b in float32 with the reference's parameters carried
across (``lm_params``): 5 requests of mixed prompt lengths through
``max_batch`` 4 (two generational batches), greedy.  The two engines must
produce identical tokens.  Equality is meaningful only where no step's
choice is a near tie: the test records the port's logits at every step
and asserts that the top-2 margin of every live row exceeds twice the
port-vs-reference logit tolerance (1e-4 of max |logit|, test_torch_lm.py).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models.transformer import init_params as ref_init_params
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch.configs import base
from repro_torch.convert import lm_params
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve as serve_cli
from repro_torch.serve.engine import Request, ServeEngine

REL = 1e-4
PROMPT_LENS = (5, 9, 3, 12, 7)
NEW_TOKENS = (6, 4, 6, 3, 5)


def _cfg():
    return dataclasses.replace(base.get_reduced("qwen3-1.7b"), dtype="float32")


def _prompts(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, (n,)).astype(np.int32) for n in PROMPT_LENS]


def test_greedy_tokens_match_reference():
    cfg = _cfg()
    rcfg = ref_base.ArchConfig(**dataclasses.asdict(cfg))
    ref_params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    prompts = _prompts(cfg)

    ref_eng = RefServeEngine(rcfg, params=ref_params, max_len=32, max_batch=4)
    ref_reqs = [RefRequest(prompt=p.copy(), max_new_tokens=n) for p, n in zip(prompts, NEW_TOKENS)]
    ref_eng.generate(ref_reqs)

    port = lm_params(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    eng = ServeEngine(cfg, params=port, max_len=32, max_batch=4, device="cpu")
    seen = []
    sample = eng._sample

    def recording_sample(logits, temps):
        seen.append(logits.copy())
        return sample(logits, temps)

    eng._sample = recording_sample
    flash_ops.reset_counts()
    reqs = [Request(prompt=p.copy(), max_new_tokens=n) for p, n in zip(prompts, NEW_TOKENS)]
    assert eng.generate(reqs) is reqs

    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]
    assert all(r.done and len(r.out_tokens) == n for r, n in zip(reqs, NEW_TOKENS))
    # two batches (4 + 1 requests), each one prefill through the plain flash
    # version per layer
    assert eng.stats.prefill_batches == 2
    assert flash_ops.counts["flash_attention"].plain_calls == 2 * cfg.n_layers
    assert eng.stats.prompt_tokens == sum(PROMPT_LENS)
    assert eng.stats.decode_tokens == sum(n - 1 for n in NEW_TOKENS)
    for logits in seen:
        top2 = np.sort(logits, axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        assert (margin > 2 * REL * np.abs(logits).max(axis=-1)).all(), margin


@pytest.mark.parametrize("arch", [a for a in base.PORTED if a != "qwen3_17b"])
def test_greedy_tokens_match_reference_every_arch(arch):
    """Every other ported architecture's reduced configuration through both
    engines (two batches, greedy): the same tokens, with the same top-2
    margin check on every live row.  qwen2-vl-7b's batches get zero vision
    embeddings over their first 8 positions (its prompts are at least 8
    long); musicgen-medium's prompts are (S, 4) and each step appends a
    list of 4 tokens."""
    cfg = dataclasses.replace(base.get_reduced(arch), dtype="float32")
    rcfg = ref_base.ArchConfig(**dataclasses.asdict(cfg))
    ref_params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    rng = np.random.default_rng(1)
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    prompts = [rng.integers(0, cfg.vocab, (n + 4,) + cb).astype(np.int32) for n in PROMPT_LENS]
    ref_eng = RefServeEngine(rcfg, params=ref_params, max_len=32, max_batch=4)
    ref_reqs = [RefRequest(prompt=p.copy(), max_new_tokens=n) for p, n in zip(prompts, NEW_TOKENS)]
    ref_eng.generate(ref_reqs)
    eng = ServeEngine(cfg, params=lm_params(jax.tree.map(np.asarray, ref_params), cfg,
                                            device="cpu"), max_len=32, max_batch=4, device="cpu")
    seen = []
    sample = eng._sample
    eng._sample = lambda logits, temps: (seen.append(logits.copy()), sample(logits, temps))[1]
    reqs = [Request(prompt=p.copy(), max_new_tokens=n) for p, n in zip(prompts, NEW_TOKENS)]
    eng.generate(reqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]
    if cb:
        assert all(len(t) == cfg.n_codebooks for r in reqs for t in r.out_tokens)
    for logits in seen:
        assert logits.shape[1:] == cb + (cfg.vocab,)
        top2 = np.sort(logits, axis=-1)[..., -2:]
        margin = top2[..., 1] - top2[..., 0]
        assert (margin > 2 * REL * np.abs(logits).max(axis=-1)).all(), margin


def test_temperature_sampling_is_seeded():
    cfg = _cfg()
    params = lm_params(
        jax.tree.map(np.asarray, ref_init_params(jax.random.PRNGKey(1),
                                                 ref_base.ArchConfig(**dataclasses.asdict(cfg)))),
        cfg, device="cpu")
    outs = []
    for _ in range(2):
        eng = ServeEngine(cfg, params=params, max_len=32, max_batch=2, seed=7, device="cpu")
        reqs = [Request(prompt=p, max_new_tokens=4, temperature=1.0) for p in _prompts(cfg)[:3]]
        eng.generate(reqs)
        outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1]
    assert all(0 <= t < cfg.vocab for row in outs[0] for t in row)


def test_eos_retires_a_request():
    cfg = _cfg()
    eng = ServeEngine(cfg, max_len=32, max_batch=4, device="cpu")
    prompt = _prompts(cfg)[1]
    probe = Request(prompt=prompt.copy(), max_new_tokens=5)
    eng.generate([probe])
    eos = probe.out_tokens[2]
    r = Request(prompt=prompt.copy(), max_new_tokens=5, eos_id=eos)
    eng.generate([r])
    assert r.out_tokens == probe.out_tokens[: probe.out_tokens.index(eos) + 1]


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--reduced"])


def test_engine_rejects_params_on_another_device():
    cfg = _cfg()
    params = {"embed": torch.zeros((cfg.vocab, cfg.d_model), device="meta")}
    with pytest.raises(ValueError, match="params are on meta"):
        ServeEngine(cfg, params=params, device="cpu")


def test_cli_runs_on_cpu(capsys):
    serve_cli.main(["--reduced", "--device", "cpu", "--requests", "3", "--prompt-len", "8",
                    "--new-tokens", "4", "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 12 tokens in" in out
    assert "dtype=float32" in out and "prompt tok/s" in out and "decode tok/s" in out
    assert "2 batches" in out
