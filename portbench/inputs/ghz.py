"""Green, Hand & Zhang (2017) inputs: 94 characteristics over 420 months.

Firm lifetimes, ``retx``, market equity and the NYSE flag come from the
frozen Lewellen generator's monthly panel (no daily rows), drawn over 600
months that end in December 2014 and cut to the last 420 (1980-2014). The
94 characteristics are made on the card from the seed, in a few large calls:
each is a persistent firm component (8 common latent factors with seeded
loadings, plus a firm-specific part) mixed with a monthly shock, then
standardized cross-sectionally over the firms alive that month, as GHZ
rank-standardize theirs. Missing values are filled, so a row drops only where
the firm is not alive. The return carries a small loading on the first eight
characteristics, so slopes are not pure noise.

The universes are Lewellen's NYSE breakpoints on the month's market equity
(all stocks; all-but-tiny, at or above the 20th NYSE percentile; large, at or
above the 50th), computed here in float64 and handed to the program and the
reference alike.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.inputs.lewellen import BASE_COLUMNS, make_lewellen_inputs

UNIVERSES = ("All stocks", "All-but-tiny stocks", "Large stocks")


def nyse_universes(me: torch.Tensor, alive: torch.Tensor, nyse: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """(T, N) masks of the three universes from ``me`` (T, N), ``alive``
    (T, N) bool and ``nyse`` (T, N) bool; breakpoints by linear
    interpolation over each month's NYSE firms, in float64."""
    me64 = me.to(torch.float64)
    ok = alive & nyse & torch.isfinite(me64)
    srt = torch.sort(torch.where(ok, me64, torch.inf), dim=1).values
    n = ok.sum(dim=1)
    out = {UNIVERSES[0]: alive}
    for name, q in ((UNIVERSES[1], 0.2), (UNIVERSES[2], 0.5)):
        rank = q * (n - 1).clamp_min(0).to(torch.float64)
        lo = torch.floor(rank).to(torch.int64)
        hi = torch.minimum(lo + 1, (n - 1).clamp_min(0))
        frac = rank - lo.to(torch.float64)
        bp = (srt.gather(1, lo[:, None])[:, 0] * (1.0 - frac)
              + srt.gather(1, hi[:, None])[:, 0] * frac)
        bp = torch.where(n > 0, bp, torch.nan)
        out[name] = alive & (me64 >= bp[:, None])
    return out


def make_ghz_inputs(seed: int, device, n_firms: int = 22000, n_months: int = 420,
                    n_chars: int = 94, dtype=torch.float32) -> Dict[str, object]:
    """``y`` (T, N), ``x`` (T, N, P) on ``device`` in ``dtype``, NaN where
    the firm is not alive; ``masks`` (universe → (T, N) bool) and
    ``n_months``."""
    lead = max(600 - n_months, 0)
    base = make_lewellen_inputs(seed, n_firms=n_firms, n_months=n_months + lead,
                                start="1965-01-31" if lead == 180 else "1980-01-31",
                                daily=False, device=device)
    vals = base["values"][lead:]
    alive = torch.as_tensor(np.ascontiguousarray(base["mask"][lead:]), device=device)
    col = {n: k for k, n in enumerate(BASE_COLUMNS)}
    retx = torch.as_tensor(np.ascontiguousarray(vals[:, :, col["retx"]]), device=device)
    me = torch.as_tensor(np.ascontiguousarray(vals[:, :, col["me"]]), device=device)
    nyse = torch.as_tensor(np.ascontiguousarray(vals[:, :, col["is_nyse"]]), device=device) > 0
    del vals, base

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    t, n, p = alive.shape[0], alive.shape[1], n_chars
    loadings = torch.randn((8, p), generator=gen, device=device, dtype=dtype) * 0.5
    firm = (torch.randn((n, 8), generator=gen, device=device, dtype=dtype) @ loadings
            + torch.randn((n, p), generator=gen, device=device, dtype=dtype))
    persist = torch.rand((p,), generator=gen, device=device, dtype=dtype) * 0.6 + 0.3
    x = torch.empty((t, n, p), device=device, dtype=dtype)
    nan = torch.tensor(float("nan"), device=device, dtype=dtype)
    step = 60
    for t0 in range(0, t, step):
        t1 = min(t0 + step, t)
        shock = torch.randn((t1 - t0, n, p), generator=gen, device=device, dtype=dtype)
        blk = persist * firm[None] + (1.0 - persist) * shock
        a = alive[t0:t1, :, None]
        cnt = a.sum(dim=1, keepdim=True).clamp_min(2).to(dtype)
        mean = torch.where(a, blk, 0.0).sum(dim=1, keepdim=True) / cnt
        dev = torch.where(a, blk - mean, 0.0)
        std = torch.sqrt((dev * dev).sum(dim=1, keepdim=True) / (cnt - 1.0))
        x[t0:t1] = torch.where(a, dev / std, nan)
        del shock, blk, dev
    signal = torch.tensor([0.004, -0.003, 0.002, 0.002, -0.002, 0.001, 0.001, -0.001],
                          device=device, dtype=dtype)
    k = min(8, p)
    y = retx + torch.nan_to_num(x[:, :, :k]) @ signal[:k]
    y = torch.where(alive, y, nan)
    masks = nyse_universes(me, alive, nyse)
    return {"y": y.contiguous(), "x": x, "masks": masks, "n_months": t}
