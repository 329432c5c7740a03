"""Precision policies for the GMG-PCG stack.

A :class:`PrecisionPolicy` names which dtype each tier of the solve runs
in:

* ``solve_dtype`` — the outer Krylov iteration: its vectors, the operator
  apply inside the CG recurrence, and the residual norms and tolerance
  test;
* ``precond_dtype`` — everything inside the GMG V-cycle: the per-level
  weighted material fields the element kernel streams, the Chebyshev
  smoother and the inter-grid transfers;
* ``coarse_dtype`` — the coarsest-level probe and dense Cholesky factor.

==============  ===========  =============  ============
name            solve_dtype  precond_dtype  coarse_dtype
==============  ===========  =============  ============
``f64``         float64      float64        float64
``f32``         float32      float32        float32
``mixed``       float64      float32        float32
``mixed-bf16``  float64      bfloat16       float32
==============  ===========  =============  ============

``mixed-bf16`` halves the bytes every V-cycle apply of the PAop kernel
streams (its bfloat16 instantiation reads x, lambda_w and mu_w and writes
y in bfloat16, and computes in float32).  The coarse tier stays float32:
bfloat16 has too few mantissa bits to factor even a well-conditioned
coarse matrix, and torch has no bfloat16 Cholesky.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["PrecisionPolicy", "PRECISION_POLICIES", "resolve_precision"]


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Dtype assignment for the tiers of one GMG-PCG solve."""

    name: str
    solve_dtype: torch.dtype
    precond_dtype: torch.dtype
    coarse_dtype: torch.dtype

    @property
    def uniform(self) -> bool:
        """True when every tier runs one dtype (no cast boundaries)."""
        return self.solve_dtype == self.precond_dtype == self.coarse_dtype

    @property
    def reduced(self) -> bool:
        """True when any tier runs below float64: exactly the policies the
        batched solver's stagnation detector and f64 fallback cover."""
        return not (
            self.solve_dtype == self.precond_dtype == self.coarse_dtype == torch.float64
        )


PRECISION_POLICIES: dict[str, PrecisionPolicy] = {
    "f64": PrecisionPolicy("f64", torch.float64, torch.float64, torch.float64),
    "f32": PrecisionPolicy("f32", torch.float32, torch.float32, torch.float32),
    "mixed": PrecisionPolicy("mixed", torch.float64, torch.float32, torch.float32),
    "mixed-bf16": PrecisionPolicy(
        "mixed-bf16", torch.float64, torch.bfloat16, torch.float32
    ),
}


def resolve_precision(
    precision: str | PrecisionPolicy | None, dtype: torch.dtype | None = None
) -> PrecisionPolicy:
    """Resolve a precision request to a :class:`PrecisionPolicy`.

    ``precision`` is a policy name, an explicit policy object, or None —
    meaning "derive from ``dtype``": f64 (or no dtype) resolves to
    ``f64``, f32 to ``f32``.  Passing both a policy and a conflicting
    ``dtype`` is an error."""
    if isinstance(precision, PrecisionPolicy):
        pol = precision
    elif precision is None:
        if dtype is None or dtype == torch.float64:
            return PRECISION_POLICIES["f64"]
        for pol in PRECISION_POLICIES.values():
            if pol.uniform and pol.solve_dtype == dtype:
                return pol
        raise ValueError(f"no precision policy runs uniformly in {dtype}")
    else:
        try:
            pol = PRECISION_POLICIES[precision]
        except KeyError:
            raise ValueError(
                f"unknown precision policy {precision!r}; expected one "
                f"of {tuple(PRECISION_POLICIES)} or a PrecisionPolicy"
            ) from None
    if dtype is not None and dtype != pol.solve_dtype:
        raise ValueError(
            f"precision policy {pol.name!r} solves in {pol.solve_dtype} but "
            f"dtype={dtype} was also requested; pass one or the other"
        )
    return pol
