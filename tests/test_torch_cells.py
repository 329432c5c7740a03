"""The dry-run cells, the cost model, the collectives' tally and the kernel
wrappers' meta paths against the reference (``repro.launch.cells``,
``jaxpr_cost``, ``roofline.collective_bytes``).

Tolerances:

* ``cell_ids`` and ``skip_reason``: equal to the reference's;
* ``cost_of_fn`` on plain functions: equal to the reference's, every
  field; a Python loop of 10 mat-vecs: 10x one;
* a reduced qwen3 prefill cell on a (1, 1) mesh: ``dot_flops`` equal to
  the reference's prefill less the attention pairs above the diagonal,
  4 B H hd L (S^2 - S(S+1)/2), to 1e-12 relative: the flash kernel charges
  its causal pairs, the reference's attention scores all S^2;
* the tally: the reference parser's ``operand_bytes`` and ``link_bytes``
  on ``test_roofline_collective_parser``'s HLO, to 1e-12;
* ``argument_bytes`` of qwen3-32b on both production meshes: exactly the
  bytes reckoned from the reference's ``param_pspecs`` and batch layout.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.distributed import sharding as ref_sharding
from repro.launch import cells as ref_cells
from repro.launch.jaxpr_cost import cost_of_fn as ref_cost_of_fn
from repro.launch.roofline import collective_bytes
from repro.models import transformer as ref_tf
from repro_torch.configs import base
from repro_torch.configs.elasticity import ElasticityShape
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import P, Sharded, act_pspec
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.pa_elasticity import ops as pa_ops
from repro_torch.launch import cells, dryrun, report
from repro_torch.launch.jaxpr_cost import cost_of_fn
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import transformer as tf

S_ = jax.ShapeDtypeStruct
ARCHS = [a for a in base.ARCH_IDS if a != "elasticity"]
SHAPE_NAMES = list(base.SHAPES)


def _meta_mesh(data=2, model=2):
    return make_local_mesh(model, devices=("meta",) * (data * model))


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------
def test_cell_ids_match_reference():
    got = cells.cell_ids()
    assert got == ref_cells.cell_ids()
    assert sum(a != "elasticity" for a, _ in got) == 33 and len(got) == 36


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_skip_reason_matches_reference(arch, shape):
    assert cells.skip_reason(arch, shape) == ref_cells.skip_reason(arch, shape)


def _all_tensors(tree):
    return [t for _, t in dryrun._by_device(tree, _meta_mesh())]


@pytest.mark.parametrize("arch,shape", cells.cell_ids())
def test_build_cell_on_meta_mesh_allocates_nothing(arch, shape):
    mesh = _meta_mesh()
    cell = cells.build_cell(arch, shape, mesh)
    ts = _all_tensors(cell.args)
    assert ts and all(t.device.type == "meta" for t in ts)
    assert cell.meta["kind"] in ("train", "prefill", "decode", "addmult")
    if cell.meta["kind"] == "train":
        # the specs the step computes: sequence parallel but for the xLSTM
        # and pure DP, the CE vocab parallel but for pure DP
        dp, pure_dp = cell.meta["act_spec"][0], cell.meta["pure_dp"]
        sp = not pure_dp and base.get_config(arch).block_pattern != "xlstm"
        assert cell.meta["act_spec"] == (act_pspec(mesh.axis_names) if sp else P(dp, None, None))
        assert cell.meta["logits_spec"] == P(dp, None, None if pure_dp else "model")
        assert ("block of positions" in cell.meta["act_layout"]) == sp
    elif arch != "elasticity":
        assert "act_spec" not in cell.meta and cell.meta["act_layout"]


def _reduced(arch, shape):
    if arch == "elasticity":
        return None, ElasticityShape(shape, "operator", p=2, n_h_refine=0)
    s = base.SHAPES[shape]
    return base.get_reduced(arch), base.ShapeConfig(shape, s.kind, 16, 4)


@pytest.mark.parametrize("arch,shape", cells.cell_ids() + [("elasticity", "beam_p8_51m:dd")])
def test_reduced_cell_traces_on_meta_mesh(arch, shape, tmp_path):
    cfg, sh = _reduced(arch, shape)
    rec = dryrun.run_cell(arch, shape, "local", str(tmp_path), mesh=_meta_mesh(), cfg=cfg,
                          shape_cfg=sh)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["cost"]["flops_per_dev"] > 0 and rec["cost"]["bytes_per_dev"] > 0
    assert rec["memory"]["argument_bytes"] > 0 and rec["memory"]["temp_bytes"] > 0
    assert rec["collectives"]["link_bytes"] > 0  # every cell moves data on (2, 2)
    assert rec["model_flops"] > 0
    t = report.terms_of(rec)
    assert t.bound_s > 0 and t.dominant in ("compute", "memory", "collective")


def test_dryrun_cli_and_report_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``--mesh single`` on a reduced grid: one ok JSON a cell with the
    per-device keys, and both tables rendered (the production mesh is cut
    to (2, 2) here; the CLI itself is run at full size on the chip host)."""
    monkeypatch.setattr(dryrun, "run_cell", _reduced_run_cell(dryrun.run_cell))
    monkeypatch.setattr("sys.argv", ["dryrun", "--cells",
                                     "qwen3_17b:train_4k,elasticity:beam_p8_51m",
                                     "--mesh", "single", "--out", str(tmp_path)])
    dryrun.main()
    recs = report.load_records(str(tmp_path))
    assert [(r["arch"], r["status"]) for r in recs] == [("elasticity", "ok"),
                                                       ("qwen3_17b", "ok")]
    for r in recs:
        assert {"flops_per_dev", "bytes_per_dev"} <= set(r["cost"])
        assert {"link_bytes", "operand_bytes", "per_op"} <= set(r["collectives"])
        assert {"argument_bytes", "output_bytes", "temp_bytes",
                "peak_bytes_per_device"} <= set(r["memory"])
    recs[0]["measured_s"] = 1e-3
    table = report.render_roofline(recs, "single")
    assert table.count("\n") == 3
    assert report.measured_fraction(recs[0]) > 0
    monkeypatch.setattr("sys.argv", ["report", "--dir", str(tmp_path)])
    report.main()
    assert "Dry-run (2/2 cells ok)" in capsys.readouterr().out


def _reduced_run_cell(run_cell):
    def run(arch, shape, mesh_kind, out_dir, **kw):
        cfg, sh = _reduced(arch, shape)
        return run_cell(arch, shape, mesh_kind, out_dir, mesh=_meta_mesh(), cfg=cfg,
                        shape_cfg=sh, **kw)
    return run


@pytest.mark.parametrize("multi", [False, True])
def test_argument_bytes_of_qwen3_32b_match_reference_layout(multi):
    """The prefill cell's arguments on a production mesh: each device's
    block of every parameter by the reference's ``param_pspecs`` (bf16) and
    its data row's tokens (int32)."""
    mesh = make_production_mesh(multi_pod=multi)
    cell = cells.build_cell("qwen3_32b", "prefill_32k", mesh)
    # the reference's parameter tree as ShapeDtypeStructs (its layout is the
    # port's; jax.eval_shape of its init_params takes a second at this size)
    shapes = tf._tree_map(lambda t: S_(tuple(t.shape), jnp.dtype(str(t.dtype)[6:])),
                          tf.abstract_params(base.get_config("qwen3_32b")))

    class _Shape:  # the reference's rules read the mesh's axis sizes only
        shape = mesh.shape

    specs = ref_sharding.param_pspecs(shapes, _Shape())
    want = 0
    for leaf, spec in zip(jax.tree.leaves(shapes), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
        n = math.prod(leaf.shape)
        for part in spec:
            for a in ((part,) if isinstance(part, str) else part or ()):
                n //= mesh.shape[a]
        want += n * leaf.dtype.itemsize
    sh = base.SHAPES["prefill_32k"]
    dp = math.prod(mesh.shape[a] for a in mesh.axis_names if a != "model")
    want += sh.global_batch // dp * sh.seq_len * 4
    assert dryrun._fullest(cell.args, mesh) == want


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------
def test_cost_of_a_python_loop_counts_every_trip():
    w, x = torch.empty(64, 64), torch.empty(64)

    def once(w, x):
        return w @ x

    def looped(w, x):
        for _ in range(10):
            x = w @ x
        return x

    c1, c10 = cost_of_fn(once, w, x), cost_of_fn(looped, w, x)
    assert c1.flops == 2 * 64 * 64 and c10.flops == 10 * c1.flops
    assert c10.bytes == 10 * c1.bytes and not c10.has_dynamic_loop


def _chain(a, b, c):
    return (a @ b) @ c


def _gather(x, i):
    return x[i]


PLAIN = {
    "matmul_chain": (_chain, _chain, [((32, 64), "float32"), ((64, 48), "float32"),
                                      ((48, 16), "float32")]),
    "gather": (_gather, _gather, [((100, 8), "float32"), ((30,), "int32")]),
    "elementwise_chain": (
        lambda x, y: jnp.sum(jnp.tanh(x) * y + jnp.exp(y), axis=0),
        lambda x, y: torch.sum(torch.tanh(x) * y + torch.exp(y), dim=0),
        [((16, 32), "float32"), ((16, 32), "float32")]),
}


@pytest.mark.parametrize("name", list(PLAIN))
def test_cost_of_plain_functions_equals_reference(name):
    jfn, tfn, specs = PLAIN[name]
    want = ref_cost_of_fn(jfn, *(S_(s, getattr(jnp, d)) for s, d in specs))
    got = cost_of_fn(tfn, *(torch.empty(s, dtype=getattr(torch, d)) for s, d in specs))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_prefill_dot_flops_against_reference():
    """A reduced qwen3 prefill cell on a (1, 1) mesh: the dot FLOPs are the
    reference's but for the attention pairs above the diagonal."""
    cfg = dataclasses.replace(base.get_reduced("qwen3_17b"), dtype="float32")
    B, S = 2, 64
    cell = cells.build_cell("qwen3_17b", "prefill_32k", _meta_mesh(1, 1), cfg=cfg,
                            shape=base.ShapeConfig("prefill_32k", "prefill", S, B))
    got = dryrun.trace_cell(cell)["cost"]["dot_flops_global"]
    rcfg = ref_base.ArchConfig(**dataclasses.asdict(cfg))
    params = jax.eval_shape(lambda k: ref_tf.init_params(k, rcfg), jax.random.PRNGKey(0))
    want = ref_cost_of_fn(
        lambda p, tok: ref_tf.prefill(p, {"tokens": tok}, rcfg, max_len=S, attn_impl="chunked"),
        params, S_((B, S), jnp.int32)).dot_flops
    H, hd, L = cfg.n_heads, cfg.head_dim_, cfg.n_layers
    above_diagonal = 4 * B * H * hd * L * (S * S - S * (S + 1) // 2)
    assert got == pytest.approx(want - above_diagonal, rel=1e-12)


# ---------------------------------------------------------------------------
# the collectives' tally
# ---------------------------------------------------------------------------
def test_tally_matches_reference_parser():
    hlo = """
  %ag = f32[4,256]{1,0} all-gather(%x), replica_groups=[8,4]<=[32], dimensions={1}
  %ar = (f32[128]{0}) all-reduce(%y), replica_groups={{0,1,2,3}}, to_apply=%add
  %cp = bf16[64,64]{1,0} collective-permute(%z), source_target_pairs={{0,1}}
"""
    want = collective_bytes(hlo)
    with collectives.tally() as t:
        collectives.all_gather([torch.zeros(4, 64) for _ in range(4)], 1)
        collectives.all_reduce([torch.zeros(128) for _ in range(4)])
        collectives.ppermute([torch.zeros(64, 64, dtype=torch.bfloat16) for _ in range(4)],
                             [(i, (i + 1) % 4) for i in range(4)])
    got = t.per_device(4)
    assert got["operand_bytes"] == pytest.approx(want["operand_bytes"], rel=1e-12)
    assert got["link_bytes"] == pytest.approx(want["link_bytes"], rel=1e-12)
    assert got["per_op"].keys() == want["per_op"].keys()


def test_tally_counts_backward_duals_and_ordered_sums():
    xs = [torch.ones(8, 4, requires_grad=True) for _ in range(2)]
    with collectives.tally() as t:
        ys = collectives.all_gather(xs, 0)
        loss = collectives.ordered_sum([y.sum() for y in ys], torch.device("cpu"))
        loss.backward()
    got = t.per_device(2)["per_op"]
    r = 16 * 4 * 4  # the gathered (16, 4) f32
    assert got["all-gather"] == r / 2 and got["reduce-scatter"] == r / 2 * 1
    assert got["ordered-sum"] == 4 / 2
    assert torch.equal(xs[0].grad, torch.full((8, 4), 2.0))


# ---------------------------------------------------------------------------
# the kernel wrappers' meta paths
# ---------------------------------------------------------------------------
def test_flash_meta_path_shapes_and_counts():
    flash_ops.reset_counts()
    B, S, H, K, D = 2, 33, 4, 2, 16
    q = torch.empty(B, S, H, D, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, S, K, D, dtype=torch.bfloat16, device="meta")
    o, lse = flash_ops._forward(q, k, k, None, lse=True)
    assert (o.shape, o.dtype, o.device.type) == (q.shape, q.dtype, "meta")
    assert (lse.shape, lse.dtype) == ((B, H, S), torch.float32)
    dq, dk, dv = flash_ops.flash_attention_bwd(q, k, k, o, o, lse=lse)
    assert [t.shape for t in (dq, dk, dv)] == [q.shape, k.shape, k.shape]
    c = flash_ops.counts
    assert (c["flash_attention"].meta_calls, c["flash_attention_bwd"].meta_calls) == (1, 1)
    assert c["flash_attention"].plain_calls == c["flash_attention"].launches == 0
    f, b = flash_ops.work(q, k)
    assert f == 4 * B * H * D * S * (S + 1) // 2 and b == 2 * (q.numel() + k.numel()) * 2
    assert cost_of_fn(lambda q, k: flash_ops.flash_attention(q, k, k), q, k).flops == f
    # a CPU tensor still takes the plain version
    x = torch.randn(1, 5, 2, 8)
    flash_ops.flash_attention(x, x, x)
    assert flash_ops.counts["flash_attention"].plain_calls == 1


def test_paop_meta_path_shapes_and_counts():
    pa_ops.reset_counts()
    p, ne = 2, 5
    D, Q = p + 1, p + 2
    args = [torch.empty(s, device="meta") for s in
            [(ne, 3, D, D, D), (ne, Q, Q, Q), (ne, Q, Q, Q), (3, 3), (Q, D), (Q, D)]]
    y = pa_ops.pa_elasticity(*args)
    assert (y.shape, y.device.type) == (args[0].shape, "meta")
    assert pa_ops.counts["pa_elasticity"].meta_calls == 1
    assert pa_ops.counts["pa_elasticity"].plain_calls == 0
    from repro_torch.core.flops import paop_flops_per_elem

    assert cost_of_fn(pa_ops.pa_elasticity, *args).flops == paop_flops_per_elem(p) * ne
    real = [torch.randn(a.shape, dtype=torch.float64) for a in args]
    pa_ops.pa_elasticity(*real)
    assert pa_ops.counts["pa_elasticity"].plain_calls == 1


def test_sharded_zeros_on_meta_mesh():
    mesh = _meta_mesh()
    sh = cells.sharded_zeros({"w": torch.empty(8, 6, device="meta")},
                             {"w": P("data", "model")}, mesh)["w"]
    assert isinstance(sh, Sharded) and [tuple(b.shape) for b in sh.blocks] == [(4, 3)] * 4
    assert all(b.device.type == "meta" for b in sh.blocks)
