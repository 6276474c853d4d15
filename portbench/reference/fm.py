"""Plain Fama-MacBeth regressions: the benchmark's reference.

Written from the method (Fama & MacBeth 1973; Lewellen 2015, Table 2) and
the reference package's conventions, with plain PyTorch operations in the
caller's dtype, and independent of the program under test:

- a month's regression takes the firms of its universe whose return and
  every predictor are finite (complete case) and runs when it has at least
  P + 1 of them; a month outside the spec's window does not run;
- the slopes come from the centred normal equations (one batched matrix
  product a block of months, then a solve), the intercept from the means;
- R² = 1 − SSE/SST over the month's rows (0 where SST is 0);
- the FM coefficient is the mean of the valid months' slopes (NaN below
  ``min_months`` months); its Newey-West standard error uses the weight
  1 − k/T over the months that ran, adjacent in the compacted series;
- a month is suspect where it is exactly determined (n = P + 1) or its
  equilibrated normal matrix is singular to 1e-12.

``dtype=torch.float64`` is the reference; ``torch.float32`` with TF32
matrix products switched on (``tf32_products``) is the control.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional

import torch


class MonthlyCS(NamedTuple):
    slopes: torch.Tensor       # (T, P)
    intercept: torch.Tensor    # (T,)
    r2: torch.Tensor           # (T,)
    n_obs: torch.Tensor        # (T,) int64
    month_valid: torch.Tensor  # (T,) bool
    suspect: torch.Tensor      # (T,) bool


class FMSummary(NamedTuple):
    coef: torch.Tensor     # (P,)
    tstat: torch.Tensor    # (P,)
    nw_se: torch.Tensor    # (P,)
    iid_se: torch.Tensor   # (P,) the standard error with no lag terms
    mean_r2: float
    mean_n: float
    n_months: int
    n_obs: int             # Σ n over the months that ran
    suspect_months: int


@contextlib.contextmanager
def tf32_products(on: bool):
    """Run matrix products in TF32 (``on``) or at the dtype's full precision."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(on)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def monthly_cs(y: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
               dtype=torch.float64, block: int = 60) -> MonthlyCS:
    """Per-month OLS of ``y`` (T, N) on ``x`` (T, N, P) over ``mask`` (T, N),
    computed in ``dtype`` a block of months at a time."""
    t, n, p = x.shape
    q = p + 1
    out = {k: [] for k in MonthlyCS._fields}
    for t0 in range(0, t, block):
        t1 = min(t0 + block, t)
        yb = y[t0:t1].to(dtype)
        xb = x[t0:t1].to(dtype)
        ok = mask[t0:t1] & torch.isfinite(yb) & torch.isfinite(xb).all(dim=-1)
        cnt = ok.sum(dim=1)
        cf = cnt.to(dtype).clamp_min(1.0)
        okf = ok.to(dtype)
        yz = torch.where(ok, yb, 0.0)
        xz = torch.where(ok[..., None], xb, 0.0)
        ybar = yz.sum(dim=1) / cf
        xbar = xz.sum(dim=1) / cf[:, None]
        yc = (yz - ybar[:, None]) * okf
        xc = (xz - xbar[:, None, :]) * okf[..., None]
        gram = torch.bmm(xc.transpose(1, 2), xc)                  # (B, P, P)
        rhs = torch.bmm(xc.transpose(1, 2), yc[..., None])[..., 0]  # (B, P)
        valid = cnt >= q
        d = torch.sqrt(torch.diagonal(gram, dim1=1, dim2=2).clamp_min(torch.finfo(dtype).tiny))
        corr = gram / (d[:, :, None] * d[:, None, :])
        eye = torch.eye(p, dtype=dtype, device=x.device)
        corr = torch.where(valid[:, None, None], corr, eye)
        ev = torch.linalg.eigvalsh(corr)
        singular = ev[:, 0] <= 1e-12 * ev[:, -1]
        safe = torch.where((valid & ~singular)[:, None, None], corr, eye)
        beta_e = torch.linalg.solve(safe, (rhs / d)[..., None])[..., 0]
        beta = beta_e / d
        resid = yc - torch.bmm(xc, beta[..., None])[..., 0]
        sse = (resid * resid * okf).sum(dim=1)
        sst = (yc * yc).sum(dim=1)
        r2 = torch.where(sst > 0, 1.0 - sse / torch.where(sst > 0, sst, 1.0), 0.0)
        nan = torch.full_like(ybar, float("nan"))
        out["slopes"].append(torch.where(valid[:, None], beta, nan[:, None]))
        out["intercept"].append(torch.where(valid, ybar - (xbar * beta).sum(dim=1), nan))
        out["r2"].append(torch.where(valid, r2, 0.0))
        out["n_obs"].append(cnt)
        out["month_valid"].append(valid)
        out["suspect"].append(valid & (singular | (cnt == q)))
    return MonthlyCS(*(torch.cat(out[k]) for k in MonthlyCS._fields))


def nw_se(series: torch.Tensor, valid: torch.Tensor, lags: int = 4) -> torch.Tensor:
    """Newey-West standard error of the mean of each column's valid entries
    (``series`` (T, P), ``valid`` (T, P)), with the weight 1 − k/T over the
    compacted valid entries; NaN below 2 entries."""
    out = []
    for j in range(series.shape[1]):
        v = series[valid[:, j], j]
        m = v.numel()
        if m < 2:
            out.append(torch.tensor(float("nan"), dtype=series.dtype, device=series.device))
            continue
        u = v - v.mean()
        acc = (u * u).sum()
        for k in range(1, lags + 1):
            if k < m:
                acc = acc + 2.0 * max(1.0 - k / m, 0.0) * (u[k:] * u[:-k]).sum()
        out.append(torch.sqrt(acc / m ** 2))
    return torch.stack(out)


def fm_summary(cs: MonthlyCS, window: Optional[torch.Tensor] = None, nw_lags: int = 4,
               min_months: int = 10) -> FMSummary:
    """The FM aggregation of ``cs`` over the months in ``window`` (T,) bool
    (all months when None)."""
    mv = cs.month_valid if window is None else cs.month_valid & window
    sv = mv[:, None] & torch.isfinite(cs.slopes)
    count = sv.sum(dim=0)
    mean = torch.where(sv, cs.slopes, 0.0).sum(dim=0) / count.clamp_min(1).to(cs.slopes.dtype)
    se = nw_se(cs.slopes, sv, nw_lags)
    iid = nw_se(cs.slopes, sv, 0)
    enough = count >= min_months
    nan = torch.full_like(mean, float("nan"))
    n_months = int(mv.sum())
    r2v = mv & torch.isfinite(cs.r2)
    mean_r2 = float(cs.r2[r2v].sum() / r2v.sum()) if bool(r2v.any()) else float("nan")
    n_obs = int(cs.n_obs[mv].sum())
    return FMSummary(
        coef=torch.where(enough, mean, nan), tstat=torch.where(enough, mean / se, nan),
        nw_se=se, iid_se=iid, mean_r2=mean_r2,
        mean_n=n_obs / n_months if n_months else float("nan"),
        n_months=n_months, n_obs=n_obs, suspect_months=int((cs.suspect & mv).sum()))


def spec_table(y, x, universes: Dict[str, torch.Tensor], specs, dtype=torch.float64,
               nw_lags: int = 4, min_months: int = 10) -> list:
    """FM summaries of ``specs``, each ``(column indices, universe name,
    window (T,) bool or None)``; one cross-section per distinct (columns,
    universe) pair, its windows taken from the monthly series (a month's
    regression does not depend on the window)."""
    cache = {}
    out = []
    for cols, uni, window in specs:
        key = (tuple(cols), uni)
        if key not in cache:
            cache[key] = monthly_cs(y, x[:, :, list(cols)], universes[uni], dtype=dtype)
        out.append(fm_summary(cache[key], window, nw_lags, min_months))
    return out
