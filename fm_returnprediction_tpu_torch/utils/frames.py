"""DataFrame shaping helpers (host pandas).

The reference package's utility surface, off the main pipeline path:
Series/list → DataFrame coercion, date-index normalization, and
case-insensitive substring filtering of rows and columns. Dropping rows
drops the matching rows (the original utility's drop-indexes branch
filtered by the keep pattern instead).
"""

from __future__ import annotations

import datetime
import re
from typing import List, Optional, Sequence, Union

import pandas as pd

__all__ = ["time_series_to_df", "fix_dates_index", "filter_columns_and_indexes"]


def time_series_to_df(
    returns: Union[pd.DataFrame, pd.Series, List[pd.Series]],
    name: str = "Returns",
) -> pd.DataFrame:
    """Coerce a Series or list of Series into a float DataFrame (columns
    that do not convert keep their type)."""
    if isinstance(returns, pd.DataFrame):
        out = returns.copy()
    elif isinstance(returns, pd.Series):
        out = returns.to_frame()
    elif isinstance(returns, list):
        for series in returns:
            if not isinstance(series, pd.Series):
                raise TypeError(
                    f"{name} must be a DataFrame, a Series, or a list of Series"
                )
        out = pd.concat(returns, axis=1, join="outer")
    else:
        raise TypeError(
            f"{name} must be a DataFrame, a Series, or a list of Series"
        )
    try:
        out = out.astype(float)
    except (ValueError, TypeError):
        pass  # keep non-numeric columns as they are
    return out


def fix_dates_index(returns: pd.DataFrame) -> pd.DataFrame:
    """Normalize a frame so its index is datetime named ``date`` and values
    are floats: promotes a ``date``/``datetime`` column to the index when present, and
    drops the time-of-day when every timestamp is at midnight."""
    out = returns.copy()

    if out.index.name is not None:
        if str(out.index.name).lower() in ("date", "dates", "datetime"):
            out.index.name = "date"
    elif len(out) and isinstance(
        out.index[0], (datetime.date, datetime.datetime, pd.Timestamp)
    ):
        out.index.name = "date"
    else:
        lowered = {str(c).lower(): c for c in out.columns}
        for key in ("date", "datetime"):
            if key in lowered:
                out = out.set_index(lowered[key])
                out.index.name = "date"
                break

    try:
        idx = pd.to_datetime(out.index)
        if isinstance(idx, pd.DatetimeIndex) and len(idx) and (idx.hour == 0).all():
            idx = idx.normalize()
        out.index = idx
    except (ValueError, TypeError):
        pass

    try:
        out = out.astype(float)
    except (ValueError, TypeError):
        pass
    return out


def _regex_union(patterns: Union[Sequence[str], str]) -> str:
    if isinstance(patterns, str):
        patterns = [patterns]
    return "(?i).*(" + "|".join(re.escape(p) for p in patterns) + ").*"


def filter_columns_and_indexes(
    df: pd.DataFrame,
    keep_columns: Optional[Union[Sequence[str], str]] = None,
    drop_columns: Optional[Union[Sequence[str], str]] = None,
    keep_indexes: Optional[Union[Sequence[str], str]] = None,
    drop_indexes: Optional[Union[Sequence[str], str]] = None,
) -> pd.DataFrame:
    """Case-insensitive substring filtering of columns and index labels.
    ``keep_*`` wins over ``drop_*`` when both are given. A Series has no
    columns, so only the index filters apply to one."""
    if not isinstance(df, (pd.DataFrame, pd.Series)):
        return df
    out = df.copy()

    if isinstance(out, pd.DataFrame):
        if keep_columns is not None:
            out = out.filter(regex=_regex_union(keep_columns))
        elif drop_columns is not None:
            out = out.drop(
                columns=out.filter(regex=_regex_union(drop_columns)).columns
            )

    if keep_indexes is not None:
        out = out.filter(regex=_regex_union(keep_indexes), axis=0)
    elif drop_indexes is not None:
        drop = out.filter(regex=_regex_union(drop_indexes), axis=0).index
        out = out.drop(index=drop)

    return out
