"""CRSP market-data transforms (host-side relational step).

Behavioral port of the reference's ``src/transform_crsp.py:64-90``. These
relational joins/aggregations are I/O-bound host work, not the compute
bottleneck (SURVEY §7.3), so they stay in pandas; the output feeds the dense
device panel.
"""

from __future__ import annotations

import pandas as pd

__all__ = ["calculate_market_equity"]


def calculate_market_equity(crsp: pd.DataFrame) -> pd.DataFrame:
    """Firm-level market equity with one representative security per firm.

    Per (permno, jdate): security ME = |prc| · shrout. Per (permco, jdate):
    firm ME = sum of security MEs, assigned to the permno with the largest
    security ME (ties broken by ascending permno); all other permnos of the
    firm-date are dropped. Rows missing prc or shrout are dropped first.
    (Reference ``src/transform_crsp.py:64-90``.)
    """
    df = crsp.dropna(subset=["prc", "shrout"]).copy()
    df["permno_me"] = df["prc"].abs() * df["shrout"]
    df["me"] = df.groupby(["permco", "jdate"])["permno_me"].transform("sum")
    df = df.sort_values(
        ["permco", "jdate", "permno_me", "permno"],
        ascending=[True, True, False, True],
    )
    df = df.drop_duplicates(subset=["permco", "jdate"], keep="first").copy()
    df["permco"] = df["permco"].astype("int64")
    return df.drop(columns=["permno_me"])
