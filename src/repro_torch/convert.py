"""Carry the reference's state across to this package.

The solver has no learned weights.  Its state is the mesh, the material
fields, the basis tables and the power iterations' start vectors, all of
which the reference keeps as numpy arrays (or can hand over as such).
The LM's state is its parameter pytree (:func:`lm_params`) and, in
training, the optimizer's moments and step (:func:`train_state`).  These
helpers rebuild them here, on a given device and dtype, so that both
packages compute the same thing on the same inputs.  Nothing here imports
the reference: a mesh is read by its attributes, parameters are numpy
arrays in nested dicts.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.fem.mesh import HexMesh
from repro_torch.models.transformer import leaf_dtype, param_dtype, param_shapes

__all__ = ["hex_mesh", "lm_params", "operator_data", "start_vectors", "train_state"]


def hex_mesh(mesh) -> HexMesh:
    """This package's :class:`HexMesh` from any object with the reference
    mesh's attributes (``nx``, ``ny``, ``nz``, ``lengths``, ``elem_attr``,
    ``linear_map``)."""
    elem_attr = getattr(mesh, "elem_attr", None)
    linear_map = getattr(mesh, "linear_map", None)
    return HexMesh(
        int(mesh.nx),
        int(mesh.ny),
        int(mesh.nz),
        tuple(float(v) for v in mesh.lengths),
        None if elem_attr is None else np.array(elem_attr, dtype=np.int32),
        None if linear_map is None else np.array(linear_map, dtype=np.float64),
    )


def operator_data(
    lam_w, mu_w, jinv, B, G, *, device, dtype: torch.dtype
) -> dict[str, torch.Tensor]:
    """The PAop inputs ``lam_w``/``mu_w`` (nelem, Q, Q, Q), ``jinv`` (3, 3),
    ``B``/``G`` (Q, D) from numpy arrays, contiguous on ``device``."""
    arrays = {"lam_w": lam_w, "mu_w": mu_w, "jinv": jinv, "B": B, "G": G}
    out = {
        k: torch.as_tensor(np.ascontiguousarray(v), dtype=dtype, device=device)
        for k, v in arrays.items()
    }
    q = out["B"].shape[0]
    if out["lam_w"].shape[1:] != (q, q, q) or out["mu_w"].shape != out["lam_w"].shape:
        raise ValueError(
            f"lam_w {tuple(out['lam_w'].shape)} / mu_w "
            f"{tuple(out['mu_w'].shape)} do not match Q1D={q}"
        )
    if out["G"].shape != out["B"].shape or out["jinv"].shape[-2:] != (3, 3):
        raise ValueError("B/G must share a shape and jinv must be (..., 3, 3)")
    return out


def start_vectors(
    arrays: Sequence, *, device, dtype: torch.dtype
) -> list[torch.Tensor]:
    """Power-iteration start vectors (one (nscalar, 3) array per smoothed
    level, coarse -> fine) as tensors on ``device``."""
    return [torch.as_tensor(np.array(a), dtype=dtype, device=device) for a in arrays]


def lm_params(params, cfg, *, device, dtype: torch.dtype | None = None) -> dict:
    """The reference's ``init_params`` pytree for ``cfg`` (nested dicts of
    arrays, e.g. ``jax.tree.map(np.asarray, params)``), as this package's
    parameters on ``device`` in ``dtype`` (default: ``cfg.dtype``, with a
    Mamba2 mixer's ``a_log``, ``d_skip`` and ``dt_bias`` in float32, as the
    reference keeps them).

    Covers the stacked ``blocks`` (leading layer axis; the xLSTM's list of
    per-layer blocks, walked in index order), zamba2's unstacked ``shared``
    block, ``embed``, ``final_norm`` and, when the embeddings are not tied,
    ``lm_head``.  Every key, length and shape is checked against
    :func:`param_shapes`.  bfloat16 arrays (numpy's ``ml_dtypes`` extension)
    pass through float32, which holds them exactly.
    """

    def convert(tree, shapes, path):
        if isinstance(shapes, dict):
            if not isinstance(tree, Mapping) or set(tree) != set(shapes):
                keys = sorted(tree) if isinstance(tree, Mapping) else type(tree).__name__
                raise ValueError(f"lm_params: {path or 'params'} has {keys}, expected {sorted(shapes)}")
            return {k: convert(tree[k], shapes[k], f"{path}/{k}".lstrip("/")) for k in shapes}
        if isinstance(shapes, list):
            if not isinstance(tree, Sequence) or len(tree) != len(shapes):
                got = len(tree) if isinstance(tree, Sequence) else type(tree).__name__
                raise ValueError(f"lm_params: {path} has {got} blocks, expected {len(shapes)}")
            return [convert(t, sh, f"{path}/{i}") for i, (t, sh) in enumerate(zip(tree, shapes))]
        a = np.array(tree)  # a writable copy for torch.from_numpy
        if a.shape != shapes:
            raise ValueError(f"lm_params: {path} has shape {a.shape}, expected {shapes}")
        if a.dtype.kind != "f":
            a = a.astype(np.float32)
        return torch.from_numpy(a).to(device=device, dtype=dtype or leaf_dtype(
            path.rsplit("/", 1)[-1], param_dtype(cfg)))

    return convert(params, param_shapes(cfg), "")


def train_state(state, cfg, *, device, dtype: torch.dtype | None = None):
    """The reference's ``TrainState`` (any object with ``params``,
    ``opt_state`` = {"m", "v", "step"} and ``step``, leaves as numpy arrays,
    e.g. ``jax.tree.map(np.asarray, state)``) as this package's
    :class:`~repro_torch.train.trainer.TrainState` on ``device``: parameters
    in ``dtype`` (default ``cfg.dtype``) and requiring grad, moments in
    float32, steps as 0-d int32 tensors."""
    from repro_torch.train.trainer import TrainState, _requires_grad

    def step(a):
        return torch.tensor(int(np.asarray(a)), dtype=torch.int32, device=device)

    opt = state.opt_state
    return TrainState(
        params=_requires_grad(lm_params(state.params, cfg, device=device, dtype=dtype)),
        opt_state={
            "m": lm_params(opt["m"], cfg, device=device, dtype=torch.float32),
            "v": lm_params(opt["v"], cfg, device=device, dtype=torch.float32),
            "step": step(opt["step"]),
        },
        step=step(state.step),
    )
