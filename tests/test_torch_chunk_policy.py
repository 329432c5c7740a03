"""The port's chunk policies (``repro_torch.serve.chunk_policy``) and
scenario row map (``repro_torch.distributed.sharding``) against the
reference's: the same cadence traces give the same decisions and
summaries, and bad bounds the same errors."""

from __future__ import annotations

import dataclasses
import json
import pathlib

import pytest
import torch

from repro.distributed.sharding import scenario_row_devices as ref_row_devices
from repro.serve import chunk_policy as ref_cp
from repro_torch.distributed.sharding import normalize_scenario_mesh, scenario_row_devices
from repro_torch.serve import chunk_policy as cp

TRACE_DIR = pathlib.Path(__file__).parent / "data" / "sched_traces"
TRACES = sorted(p.name for p in TRACE_DIR.glob("*.json"))
POLICIES = {
    "fixed": lambda m: m.FixedChunkPolicy(8),
    "adaptive": lambda m: m.AdaptiveChunkPolicy(1, 32, default_chunk=8),
    "shard-adaptive": lambda m: m.ShardAdaptiveChunkPolicy(1, 32, default_chunk=8),
    "adaptive-clamped": lambda m: m.AdaptiveChunkPolicy(8, 8, default_chunk=8),
}


def _decision(d) -> tuple:
    """A decision as plain data (the two packages' dataclasses differ in
    type only)."""
    return (d.step, d.key, d.policy, d.bucket, dataclasses.astuple(d.observation),
            d.chunk, tuple(dataclasses.astuple(r) for r in d.refills),
            d.live_slots, d.consumed, d.wasted)


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("name", TRACES)
def test_trace_decisions_match_reference(name, policy):
    trace = json.loads((TRACE_DIR / name).read_text())
    got = cp.simulate_cadence_trace(POLICIES[policy](cp), trace)
    want = ref_cp.simulate_cadence_trace(POLICIES[policy](ref_cp), trace)
    assert [_decision(d) for d in got.decisions] == [_decision(d) for d in want.decisions]
    assert got.summary() == want.summary()
    assert got.chunks() == want.chunks()
    assert got.replay(POLICIES[policy](cp)) == got.chunks()


@pytest.mark.parametrize("spec, kw", [
    ("adaptive", {"chunk_iters": 4}),
    ("adaptive", {"chunk_iters": 4, "min_chunk": 2, "max_chunk": 5}),
    ("shard-adaptive", {"chunk_iters": 3, "max_chunk": 7}),
    (None, {"chunk_iters": 6}),
    ("fixed", {}),
])
def test_make_chunk_policy_matches_reference(spec, kw):
    got, want = cp.make_chunk_policy(spec, **kw), ref_cp.make_chunk_policy(spec, **kw)
    assert (got.name, got.min_chunk, got.max_chunk) == (want.name, want.min_chunk, want.max_chunk)
    obs = dict(live_iters=(3, 0, 11), live_devices=(0, 0, 0), history=(9, 12, 9),
               bucket=4, n_devices=1)
    assert got.chunk_for(cp.ChunkObservation(**obs)) == want.chunk_for(
        ref_cp.ChunkObservation(**obs))
    assert got.placement([1, 3], [0, 0, 1, 1], [0, 1]) == want.placement(
        [1, 3], [0, 0, 1, 1], [0, 1])


BAD_BOUNDS = [
    lambda m: m.AdaptiveChunkPolicy(0, 8),
    lambda m: m.AdaptiveChunkPolicy(1, -3),
    lambda m: m.ShardAdaptiveChunkPolicy(9, 4),
    lambda m: m.AdaptiveChunkPolicy(2.5, 8),
    lambda m: m.AdaptiveChunkPolicy(1, True),
    lambda m: m.FixedChunkPolicy(0),
    lambda m: m.FixedChunkPolicy("8"),
    lambda m: m.AdaptiveChunkPolicy(1, 8, default_chunk=0),
    lambda m: m.make_chunk_policy("adaptive", chunk_iters=-2),
    lambda m: m.make_chunk_policy("shard-adaptive", chunk_iters=2.5),
    lambda m: m.make_chunk_policy("greedy"),
    lambda m: m.make_chunk_policy("fixed", max_chunk=2),
    lambda m: m.make_chunk_policy(m.AdaptiveChunkPolicy(1, 8), min_chunk=2),
    lambda m: m.make_chunk_policy(m.FixedChunkPolicy(8), chunk_iters=0),
    lambda m: m.simulate_cadence_trace(m.FixedChunkPolicy(8), {"bucket": 6, "n_devices": 4,
                                                               "requests": []}),
]


@pytest.mark.parametrize("i", range(len(BAD_BOUNDS)))
def test_bad_bounds_raise_the_reference_messages(i):
    with pytest.raises((ValueError, TypeError)) as want:
        BAD_BOUNDS[i](ref_cp)
    with pytest.raises(type(want.value)) as got:
        BAD_BOUNDS[i](cp)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("s, n", [(8, 1), (8, 2), (8, 4), (6, 3), (1, 1)])
def test_scenario_row_devices_match_reference(s, n):
    assert scenario_row_devices(s, n).tolist() == ref_row_devices(s, n).tolist()


def test_scenario_mesh_is_one_card():
    """Meshes of virtual CPU devices; a card mesh longer than the host's
    cards raises (an int never repeats a card), naming the count."""
    cpu = torch.device("cpu")
    assert normalize_scenario_mesh(None) == (None, 1)
    assert normalize_scenario_mesh(1, "cpu") == ((cpu,), 1)
    assert normalize_scenario_mesh(2, "cpu") == ((cpu, cpu), 2)
    assert normalize_scenario_mesh(["cpu"] * 3) == ((cpu,) * 3, 3)
    n_cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"the host has {n_cards}"):
        normalize_scenario_mesh(n_cards + 1, "cuda")
    with pytest.raises(ValueError, match=f"the host has {n_cards} CUDA card"):
        normalize_scenario_mesh([f"cuda:{n_cards}"])
    for bad in ((8, 3), (4, 0)):
        with pytest.raises(ValueError) as want:
            ref_row_devices(*bad)
        with pytest.raises(ValueError) as got:
            scenario_row_devices(*bad)
        assert str(got.value) == str(want.value)
