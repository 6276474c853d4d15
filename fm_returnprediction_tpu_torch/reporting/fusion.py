"""Fusion policy of the stacked-QR reporting route.

On the stacked route (``FMRP_SPECGRID_ROUTE=stacked``) Table 2
(``table2._fm_sweep``) and the figure/decile family
(``figure1._subset_sweep_stacked``) can solve every subset in one batched
call over a stacked mask tensor, or one subset (cell) at a time. The
batched call holds the subset-stacked augmented design
``n_subsets · T · N · (P + 2)`` elements at once (with the QR's working
copy beside it): about 2.5 GB for Table 2 at 600 months × 22,000 firms in
float32. On the card this budget bounds that device memory, the largest
transient of the route; fusing saves only a few kernel launches, so the
default splits the real shape and fuses the small ones.

The policy is one byte threshold on that footprint. Below it, fuse; above
it, split. ``FMRP_FUSE_SUBSETS_MB`` overrides the default 512 MB budget; a
malformed value warns and keeps the default, a negative one clamps to 0,
and 0 forces the split everywhere (the parity tests run both branches).
"""

from __future__ import annotations

import os
import warnings

__all__ = ["fuse_budget_bytes", "fuse_over_subsets", "stacked_design_bytes"]

# 512 MB fuses every test shape and the 600 × 800 toy panel (≈ 92 MB) and
# splits the real 600 × 22,000 shape (≈ 2.5 GB for Table 2, ≈ 1.3 GB for
# the figure family).
_DEFAULT_BUDGET_MB = 512.0


def stacked_design_bytes(n_subsets: int, t: int, n: int, p: int,
                         itemsize: int) -> int:
    """Bytes of the subset-stacked augmented design ``[1 | X | y]``. Table 2
    prices its three models as one design of width ``Σ(p_i + 2)``, as the
    reference does (its fused program holds them all), so both packages
    take the same branch at the same shape; here the models run one after
    another, so that sum overstates the peak."""
    return n_subsets * t * n * (p + 2) * itemsize


def fuse_budget_bytes() -> float:
    """The fusion byte budget (``FMRP_FUSE_SUBSETS_MB`` override). A
    malformed override warns and falls back to the default; negative
    values clamp to 0, which like an explicit 0 forces the split."""
    raw = os.environ.get("FMRP_FUSE_SUBSETS_MB")
    if raw is None:
        mb = _DEFAULT_BUDGET_MB
    else:
        try:
            mb = max(float(raw), 0.0)
        except ValueError:
            warnings.warn(
                f"FMRP_FUSE_SUBSETS_MB={raw!r} is not a number; using the "
                f"default {_DEFAULT_BUDGET_MB:g} MB",
                RuntimeWarning,
                stacklevel=2,
            )
            mb = _DEFAULT_BUDGET_MB
    return mb * 2**20


def fuse_over_subsets(n_subsets: int, t: int, n: int, p: int,
                      itemsize: int) -> bool:
    """True → one batched call over the subsets; False → one per cell."""
    return stacked_design_bytes(n_subsets, t, n, p, itemsize) <= fuse_budget_bytes()
