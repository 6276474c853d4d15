"""The estimator value type of the spec grid: which estimator a cell runs.

``Estimator`` names a kind (``"ols"`` per-month OLS, ``"fwl"``
Frisch-Waugh-Lovell partialling-out, ``"absorb"`` absorbed fixed effects,
``"iv"`` two-stage least squares, ``"pooled"`` pooled OLS) with its columns
and SE family; ``EST_OLS`` is the incumbent every ``CellSpace`` carries.
``parse_estimator`` reads the command-line grammar and
``resolve_estimator`` the ``FMRP_SPECGRID_ESTIMATOR`` knob.
``masked_psd_solve`` solves the selected block of batched PSD systems with
the grid solve's numerics; the FWL and IV transforms and the pooled fit are
built on it.

SE families (``Estimator.se``): the FM kinds take ``"nw"`` (Newey-West, the
incumbent), ``"iid"`` (lag 0) and ``"cluster"`` (by-year clustered SE of the
FM mean); the pooled kind takes ``"iid"``, ``"white"``, ``"cluster_month"``,
``"cluster_firm"`` and ``"cluster_twoway"``. Estimator cells are never
re-solved by the OLS QR referee (that would splice two estimators into one
number): rank and conditioning flags are disclosed per cell instead.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch

from fm_returnprediction_tpu_torch.specgrid.solve import _eigh

__all__ = [
    "ESTIMATOR_KINDS",
    "FM_SE_FAMILIES",
    "POOLED_SE_FAMILIES",
    "Estimator",
    "EST_OLS",
    "parse_estimator",
    "resolve_estimator",
    "masked_psd_solve",
]

ESTIMATOR_KINDS = ("ols", "fwl", "absorb", "iv", "pooled")

#: SE families for the Fama-MacBeth kinds (per-month solve → aggregation)
FM_SE_FAMILIES = ("nw", "iid", "cluster")

#: SE families for the pooled kind (one β per cell → sandwich variance)
POOLED_SE_FAMILIES = ("iid", "white", "cluster_month", "cluster_firm",
                      "cluster_twoway")


@dataclasses.dataclass(frozen=True)
class Estimator:
    """One estimator configuration — a solve-level cell dimension, hashable
    so a ``CellSpace`` can carry a tuple of them (like ``weights``).

    ``controls``/``endog``/``instruments`` name UNION predictor columns;
    ``absorb`` names FE code arrays (supplied to the engine as
    ``fe_codes[name] -> (T, N) int``). ``se`` selects the SE family for
    the kind (see module docstring). ``absorb_tol``/``absorb_iters``
    bound the alternating-projection demeaning (one-way FE converges in
    a single projection regardless)."""

    kind: str = "ols"
    controls: Tuple[str, ...] = ()
    absorb: Tuple[str, ...] = ()
    endog: Tuple[str, ...] = ()
    instruments: Tuple[str, ...] = ()
    se: str = "nw"
    absorb_tol: float = 1e-10
    absorb_iters: int = 50

    def __post_init__(self):
        if self.kind not in ESTIMATOR_KINDS:
            raise ValueError(
                f"estimator kind must be one of {ESTIMATOR_KINDS}, "
                f"got {self.kind!r}"
            )
        if self.kind == "fwl" and not self.controls:
            raise ValueError("fwl needs at least one control column")
        if self.kind == "absorb" and not 1 <= len(self.absorb) <= 2:
            raise ValueError(
                "absorb takes one or two FE code names (multi-way beyond "
                f"two-way is not implemented), got {self.absorb}"
            )
        if self.kind == "iv":
            if not self.endog or not self.instruments:
                raise ValueError("iv needs endog and instruments columns")
            if len(self.instruments) < len(self.endog):
                raise ValueError(
                    f"iv is underidentified: {len(self.endog)} endogenous "
                    f"columns but only {len(self.instruments)} instruments"
                )
        families = (POOLED_SE_FAMILIES if self.kind == "pooled"
                    else FM_SE_FAMILIES)
        if self.se not in families:
            raise ValueError(
                f"se={self.se!r} is not a {self.kind} family "
                f"(allowed: {families})"
            )
        for field, vals in (("controls", self.controls),
                            ("endog", self.endog),
                            ("instruments", self.instruments)):
            if len(set(vals)) != len(vals):
                raise ValueError(f"estimator repeats a {field} column: {vals}")

    @property
    def label(self) -> str:
        """Short disclosure label for result-frame columns."""
        if self.kind == "fwl":
            return f"fwl[{'+'.join(self.controls)}]"
        if self.kind == "absorb":
            return f"absorb[{'+'.join(self.absorb)}]"
        if self.kind == "iv":
            return (f"iv[{'+'.join(self.endog)}~"
                    f"{'+'.join(self.instruments)}]")
        return self.kind


#: the incumbent — plain per-month OLS → FM, the default estimator
#: dimension of every CellSpace
EST_OLS = Estimator()


def parse_estimator(text: str) -> Estimator:
    """Parse the CLI/env estimator grammar into an :class:`Estimator`.

    - ``"ols"``
    - ``"fwl:ctrl1+ctrl2"`` — partial out the named control columns
    - ``"absorb:fe1"`` / ``"absorb:fe1+fe2"`` — absorb the named FE codes
    - ``"iv:endog1~inst1+inst2"`` — instrument the endogenous columns
    - ``"pooled"`` / ``"pooled:cluster_month"`` — pooled OLS, optionally
      naming the sandwich SE family

    An ``@se`` suffix selects the SE family for the FM kinds
    (``"fwl:ctrl@iid"``)."""
    text = (text or "ols").strip()
    se = None
    if "@" in text:
        text, se = text.rsplit("@", 1)
    kind, _, arg = text.partition(":")
    kind = kind.strip().lower()
    if kind == "ols":
        return Estimator(se=se or "nw")
    if kind == "fwl":
        return Estimator(kind="fwl",
                         controls=tuple(a for a in arg.split("+") if a),
                         se=se or "nw")
    if kind == "absorb":
        return Estimator(kind="absorb",
                         absorb=tuple(a for a in arg.split("+") if a),
                         se=se or "nw")
    if kind == "iv":
        endog, _, inst = arg.partition("~")
        return Estimator(
            kind="iv",
            endog=tuple(a for a in endog.split("+") if a),
            instruments=tuple(a for a in inst.split("+") if a),
            se=se or "nw",
        )
    if kind == "pooled":
        return Estimator(kind="pooled", se=(arg.strip() or se or "iid"))
    raise ValueError(
        f"estimator kind must be one of {ESTIMATOR_KINDS}, got {kind!r} "
        f"(from {text!r})"
    )


def resolve_estimator(
    estimator=None,
    default: str = "ols",
    allowed: Optional[Tuple[str, ...]] = None,
) -> Estimator:
    """The estimator knob: explicit argument (an :class:`Estimator` or a
    grammar string) wins, then the ``FMRP_SPECGRID_ESTIMATOR`` env var,
    then ``default``, with a loud rejection: a caller that must stay on OLS passes
    ``allowed=("ols",)``, so an estimator knob leaking in from a
    scenario-sweep environment fails instead of silently publishing
    partialled/absorbed/instrumented numbers as the reference's."""
    if estimator is None:
        estimator = os.environ.get("FMRP_SPECGRID_ESTIMATOR", default)
    if isinstance(estimator, str):
        estimator = parse_estimator(estimator)
    if not isinstance(estimator, Estimator):
        raise TypeError(
            f"estimator must be an Estimator or a grammar string, "
            f"got {type(estimator).__name__}"
        )
    if allowed is not None and estimator.kind not in allowed:
        raise ValueError(
            f"estimator kind {estimator.kind!r} is not available here "
            f"(allowed: {allowed}) — the estimator family is a scenario "
            "dimension of the spec-grid engine, not the parity reporting paths"
        )
    return estimator


def masked_psd_solve(gram: torch.Tensor, mask: torch.Tensor, rhs: torch.Tensor,
                     data_eps: float):
    """Solve the SELECTED block of a batched PSD system with the grid
    solve's numerics: identity-pad the unselected rows/columns,
    Jacobi-equilibrate, eigendecompose (``solve._eigh``, in slices cuSOLVER
    takes), and apply a pinv-style eigenvalue cutoff at ``q·eps·λmax``.

    ``gram`` (..., Q, Q), ``mask`` (..., Q) bool (the block to invert),
    ``rhs`` (..., Q, R) with rows outside ``mask`` ignored. Returns
    ``(x, deficient)``: ``x`` (..., Q, R) is zero outside the masked rows,
    ``deficient`` (...) flags systems whose masked block lost rank at the
    cutoff. A system with a non-finite entry decomposes the identity in its
    place and gets NaN eigenpairs, as in ``solve.solve_spec_stats`` (torch's
    eigh raises on such input where the reference's returns NaN): its
    ``x`` is NaN and it is deficient."""
    dtype = gram.dtype
    q = gram.shape[-1]
    eps = float(data_eps)
    eye = torch.eye(q, dtype=dtype, device=gram.device)
    m2 = mask[..., :, None] & mask[..., None, :]
    a = torch.where(m2, gram, eye)
    dg = torch.diagonal(a, dim1=-2, dim2=-1)
    scale = torch.where(dg > 0, torch.rsqrt(torch.clamp_min(dg, eps)), torch.ones_like(dg))
    a_s = a * scale[..., :, None] * scale[..., None, :]
    broken = ~torch.isfinite(a_s).all(dim=-1).all(dim=-1)
    w, v = _eigh(torch.where(broken[..., None, None], eye, a_s))
    w = torch.where(broken[..., None], float("nan"), w)
    v = torch.where(broken[..., None, None], float("nan"), v)
    cutoff = q * eps * w[..., -1]
    keep = w > cutoff[..., None]
    winv = torch.where(keep, 1.0 / torch.clamp_min(w, eps), torch.zeros_like(w))
    r = torch.where(mask[..., :, None], rhs, torch.zeros_like(rhs)) * scale[..., :, None]
    t1 = torch.einsum("...qk,...qr->...kr", v, r)
    x = scale[..., :, None] * torch.einsum("...qk,...kr->...qr", v, t1 * winv[..., :, None])
    x = torch.where(mask[..., :, None], x, torch.zeros_like(x))
    q_m = mask.sum(-1)
    rank = keep.sum(-1) - (q - q_m)
    return x, rank < q_m
