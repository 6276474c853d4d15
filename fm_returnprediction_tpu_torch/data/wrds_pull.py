"""The CRSP share-class universe filter (host pandas).

The part of the reference package's WRDS layer that the raw-data route
needs: the CIZ flag columns and the US common-stock NYSE/AMEX/NASDAQ
universe (reference ``src/pull_crsp.py:255-295``). The port pulls nothing
from WRDS; it reads the cached frames the pullers wrote.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import pandas as pd

__all__ = ["FLAG_COLUMNS", "UNIVERSE_FLAGS", "subset_to_common_stock_and_exchanges"]

# The CIZ share-class flag columns the universe filter reads (also the
# columns the pipeline's pruned daily read keeps).
FLAG_COLUMNS = [
    "sharetype", "securitytype", "securitysubtype", "usincflg",
    "issuertype", "primaryexch", "conditionaltype", "tradingstatusflg",
]

# The admitted values per flag column — the definition of the US
# common-stock NYSE/AMEX/NASDAQ universe.
UNIVERSE_FLAGS = {
    "conditionaltype": ("RW",),
    "tradingstatusflg": ("A",),
    "sharetype": ("NS",),
    "securitytype": ("EQTY",),
    "securitysubtype": ("COM",),
    "usincflg": ("Y",),
    "issuertype": ("ACOR", "CORP"),
    "primaryexch": ("N", "A", "Q"),
}


def subset_to_common_stock_and_exchanges(
    crsp: pd.DataFrame, columns: Optional[List[str]] = None
) -> pd.DataFrame:
    """US common-stock universe on NYSE/AMEX/NASDAQ (CIZ flags).

    sharetype NS ∧ securitytype EQTY ∧ securitysubtype COM ∧ usincflg Y ∧
    issuertype ∈ {ACOR, CORP} ∧ conditionaltype RW ∧ tradingstatusflg A ∧
    primaryexch ∈ {N, A, Q}. ``columns`` limits the RESULT to the named
    columns: at full CRSP daily scale the row-filter copy of every column
    costs far more than the three the daily stage reads.
    """

    def flag_in(name, values):
        col = crsp[name]
        if isinstance(col.dtype, pd.CategoricalDtype):
            # compare int8 category codes, not millions of string rows
            wanted = [col.cat.categories.get_loc(v) for v in values
                      if v in col.cat.categories]
            code = col.cat.codes.to_numpy()
            keep = np.zeros(len(col), dtype=bool)
            for w in wanted:
                keep |= code == w
            return keep
        return col.isin(values).to_numpy()

    keep = None
    for name, values in UNIVERSE_FLAGS.items():
        m = flag_in(name, list(values))
        keep = m if keep is None else keep & m
    out = crsp if columns is None else crsp[columns]
    return out[keep]
