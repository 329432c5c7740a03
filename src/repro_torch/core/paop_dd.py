"""Domain-decomposed PAop AddMult: per-shard element applies and a
nearest-neighbour halo exchange over a list of devices.

A 2D (x, y) pencil decomposition of the structured beam's element grid:
shard ``s = sx * gy + sy`` owns a contiguous block of bx x by x nz elements
and the node planes that bound it, so neighbouring shards share one node
plane.  An apply runs, on every shard's device, the local gather, the
fused PAop element apply (the CUDA kernel of
:mod:`repro_torch.kernels.pa_elasticity` on the card, its plain version
on the CPU) and the local fixed-order scatter; then two halo rounds,
x first and then y on the x-completed planes (which completes the
corners), in which both copies of each shared plane add the neighbour's
partial sum.  The exchange copies a boundary plane to the neighbour's
device and adds it: no atomics and no collective library.  Both copies of
a shared plane compute ``a + b`` in floating point, so they stay bitwise
equal, which the block format requires.  Inside a
:func:`~repro_torch.distributed.collectives.tally` the planes count as
collective permutes.

The block format carries consistent (duplicated) values on shared planes;
:meth:`SlabDecomposition.to_blocks` and
:meth:`SlabDecomposition.from_blocks` convert at the boundary of the hot
loop.  A mesh of repeated devices (``("cuda:0",) * 4``) runs every shard
on one card: the shards then queue one after another, and the halo copies
are views.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.basis import basis_tables
from repro_torch.core.geometry import MATERIALS_BEAM, material_fields, quadrature_geometry
from repro_torch.core.paop import paop_apply
from repro_torch.distributed.collectives import record
from repro_torch.distributed.sharding import normalize_scenario_mesh
from repro_torch.fem.mesh import HexMesh
from repro_torch.fem.space import H1Space
from repro_torch.kernels.pa_elasticity import ops as _kops

__all__ = ["SlabDecomposition", "choose_grid"]


def choose_grid(nx: int, ny: int, n_shards: int) -> tuple[int, int]:
    """(gx, gy) with gx*gy == n_shards, gx | nx, gy | ny; prefers square-ish."""
    best = None
    for gx in range(1, n_shards + 1):
        if n_shards % gx or nx % gx:
            continue
        gy = n_shards // gx
        if ny % gy:
            continue
        score = abs(np.log(gx / gy))
        if best is None or score < best[0]:
            best = (score, gx, gy)
    if best is None:
        raise ValueError(f"no (gx, gy) grid for nx={nx} ny={ny} n={n_shards}")
    return best[1], best[2]


class SlabDecomposition:
    """2D-pencil DD of the PAop operator on a structured beam mesh.

    ``mesh`` is a scenario-style device list (a sequence, repeats allowed,
    or an int: the first n cards); shard k's data lives on ``mesh[k]``.
    The block format is a tuple of (LN, 3) tensors, one per shard on its
    device."""

    def __init__(self, space: H1Space, mesh, dtype=torch.float32, materials=None):
        if mesh is None:
            raise ValueError("SlabDecomposition needs a device mesh")
        self.space = space
        self.mesh, self.n_shards = normalize_scenario_mesh(mesh)
        self.dtype = dtype
        m = space.mesh
        p = space.p
        self.gx, self.gy = choose_grid(m.nx, m.ny, self.n_shards)
        self.bx, self.by = m.nx // self.gx, m.ny // self.gy
        self.lnx, self.lny, self.lnz = self.bx * p + 1, self.by * p + 1, m.nz * p + 1

        # local structured space (identical on every shard)
        self.local_space = H1Space(HexMesh(self.bx, self.by, m.nz), p)

        # global<->block node index map: (n_shards, local_nscalar)
        Nx, Ny, _ = space.node_grid
        ids, eids = [], []
        for s in range(self.n_shards):
            sx, sy = divmod(s, self.gy)
            ix = np.arange(self.lnx) + sx * self.bx * p
            iy = np.arange(self.lny) + sy * self.by * p
            IZ, IY, IX = np.meshgrid(np.arange(self.lnz), iy, ix, indexing="ij")
            ids.append((IX + Nx * (IY + Ny * IZ)).reshape(-1))
            ex = np.arange(self.bx) + sx * self.bx
            ey = np.arange(self.by) + sy * self.by
            EZ, EY, EX = np.meshgrid(np.arange(m.nz), ey, ex, indexing="ij")
            eids.append((EX + m.nx * (EY + m.ny * EZ)).reshape(-1))
        self.block_ids = np.stack(ids)  # (n_shards, LN)

        # per-shard quadrature data, each on its shard's device, weighted
        # as the global operator weights them (w det(J) times the field)
        tb = basis_tables(p)
        geom = quadrature_geometry(m, tb)
        if np.ndim(geom.jinv) != 2:
            raise ValueError("SlabDecomposition needs a uniform affine mesh (one J^-1)")
        lam_e, mu_e = material_fields(m, materials or MATERIALS_BEAM)
        on = lambda a, d: torch.as_tensor(a, dtype=dtype, device=d)  # noqa: E731
        self.lam_blocks = tuple(
            on(lam_e[e], d)[:, None, None, None] * on(geom.w_detj, d)
            for e, d in zip(eids, self.mesh)
        )
        self.mu_blocks = tuple(
            on(mu_e[e], d)[:, None, None, None] * on(geom.w_detj, d)
            for e, d in zip(eids, self.mesh)
        )
        self.jinv = tuple(on(geom.jinv, d) for d in self.mesh)
        self.B = tuple(on(tb.B, d) for d in self.mesh)
        self.G = tuple(on(tb.G, d) for d in self.mesh)
        for d in dict.fromkeys(self.mesh):
            if d.type == "cuda":
                _kops.check_probe(d)

    # -- format conversion (outside the hot loop) ---------------------------
    def to_blocks(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """(nscalar, 3) -> one (LN, 3) overlapping node block per shard, on
        its device."""
        return tuple(
            x[torch.as_tensor(ids, device=x.device)].to(d)
            for ids, d in zip(self.block_ids, self.mesh)
        )

    def from_blocks(self, xb) -> torch.Tensor:
        """Inverse of :meth:`to_blocks` (shared planes carry identical
        values), on the first shard's device."""
        dev = xb[0].device
        out = torch.zeros((self.space.nscalar, 3), dtype=xb[0].dtype, device=dev)
        for ids, b in zip(self.block_ids, xb):
            out[torch.as_tensor(ids, device=dev)] = b.to(dev)
        return out

    # -- the DD AddMult -------------------------------------------------------
    def local_apply(self, k: int, x: torch.Tensor) -> torch.Tensor:
        """Shard ``k``'s partial y on its block: local gather, PAop,
        local fixed-order scatter; (lnz, lny, lnx, 3)."""
        x_e = self.local_space.to_evec(x)  # (lne, 3, D, D, D)
        args = (x_e, self.lam_blocks[k], self.mu_blocks[k], self.jinv[k], self.B[k], self.G[k])
        # the kernel on the card; its analytic count on meta stand-ins (dry-run)
        y_e = _kops.pa_elasticity(*args) if x.device.type != "cpu" else paop_apply(*args)
        return self.local_space.scatter_add(y_e).reshape(self.lnz, self.lny, self.lnx, 3)

    def halo_exchange(self, ys: list[torch.Tensor]) -> list[torch.Tensor]:
        """The two halo rounds on the shards' partial sums, in place: x
        planes first, then y planes of the x-completed blocks."""
        gx, gy = self.gx, self.gy
        x_pairs = [(sx * gy + sy, (sx + 1) * gy + sy) for sx in range(gx - 1) for sy in range(gy)]
        y_pairs = [(sx * gy + sy, sx * gy + sy + 1) for sx in range(gx) for sy in range(gy - 1)]
        for pairs, axis in ((x_pairs, 2), (y_pairs, 1)):
            if pairs:  # each pair's two planes cross, one each way
                plane = ys[pairs[0][0]].select(axis, -1)
                record("collective-permute", plane.numel() * plane.element_size(), 2,
                       2 * len(pairs))
            for a, b in pairs:
                hi = ys[a].select(axis, -1)  # a's upper plane == b's lower
                lo = ys[b].select(axis, 0)
                sum_a = hi + lo.to(hi.device, non_blocking=True)
                sum_b = lo + hi.to(lo.device, non_blocking=True)
                hi.copy_(sum_a)
                lo.copy_(sum_b)
        return ys

    def apply_blocks(self, xb) -> tuple[torch.Tensor, ...]:
        """y_blocks = A x_blocks: every shard's local apply, then the halo
        exchange."""
        ys = [self.local_apply(k, x) for k, x in enumerate(xb)]
        return tuple(y.reshape(-1, 3) for y in self.halo_exchange(ys))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Global-interface convenience wrapper (block roundtrip)."""
        return self.from_blocks(self.apply_blocks(self.to_blocks(x)))
