"""The published Lewellen (2015) Table 1, the statistical parity oracle.

The numbers of Table 1 of Lewellen, "The Cross-Section of Expected Stock
Returns", Critical Finance Review 2015 (sample 1964-2013), as a
machine-readable table: per size universe, the time-series average of the
monthly cross-sectional mean (Avg), the cross-sectional Std, and the
average month's cross-section size (N). ``compare_table_1`` diffs a
produced Table 1 against it, and ``run_parity_check`` builds Table 1 from
real WRDS caches through the port's pipeline and asserts the diff.

The ``Turnover (-1,-12)`` row is in the published table, but the pipeline
computes it only with ``INCLUDE_TURNOVER=1``: it is flagged
``computed=False`` and compared only when the produced table has it.

    python -m fm_returnprediction_tpu_torch.reporting.published [raw_dir] [--device cpu]
"""

from __future__ import annotations

from typing import Dict, Optional

import pandas as pd

__all__ = [
    "PUBLISHED_TABLE_1",
    "PARITY_LABEL_MAP",
    "published_table_1",
    "compare_table_1",
    "run_parity_check",
]

SUBSETS = ("All stocks", "All-but-tiny stocks", "Large stocks")
STATS = ("Avg", "Std", "N")

# variable → (computed-by-pipeline?, {subset: (avg, std, n)})
PUBLISHED_TABLE_1: Dict[str, tuple] = {
    "Return (%)": (True, {
        "All stocks": (1.27, 14.79, 3955),
        "All-but-tiny stocks": (1.12, 9.84, 1706),
        "Large stocks": (1.03, 8.43, 876),
    }),
    "LogSize_{-1}": (True, {
        "All stocks": (4.63, 1.93, 3955),
        "All-but-tiny stocks": (6.38, 1.18, 1706),
        "Large stocks": (7.30, 0.90, 876),
    }),
    "LogB/M_{-1}": (True, {
        "All stocks": (-0.51, 0.84, 3955),
        "All-but-tiny stocks": (-0.73, 0.73, 1706),
        "Large stocks": (-0.81, 0.71, 876),
    }),
    "Return_{-2,-12}": (True, {
        "All stocks": (0.13, 0.48, 3955),
        "All-but-tiny stocks": (0.20, 0.41, 1706),
        "Large stocks": (0.19, 0.36, 876),
    }),
    "LogIssues_{-1,-36}": (True, {
        "All stocks": (0.11, 0.25, 3519),
        "All-but-tiny stocks": (0.10, 0.22, 1583),
        "Large stocks": (0.09, 0.21, 837),
    }),
    "Accruals_{yr-1}": (True, {
        "All stocks": (-0.02, 0.10, 3656),
        "All-but-tiny stocks": (-0.02, 0.08, 1517),
        "Large stocks": (-0.03, 0.07, 778),
    }),
    "ROA_{yr-1}": (True, {
        "All stocks": (0.01, 0.14, 3896),
        "All-but-tiny stocks": (0.05, 0.08, 1679),
        "Large stocks": (0.06, 0.07, 865),
    }),
    "LogAG_{yr-1}": (True, {
        "All stocks": (0.12, 0.26, 3900),
        "All-but-tiny stocks": (0.15, 0.22, 1680),
        "Large stocks": (0.14, 0.20, 865),
    }),
    "DY_{-1,-12}": (True, {
        "All stocks": (0.02, 0.02, 3934),
        "All-but-tiny stocks": (0.02, 0.02, 1702),
        "Large stocks": (0.03, 0.02, 875),
    }),
    "LogReturn_{-13,-36}": (True, {
        "All stocks": (0.24, 0.58, 3417),
        "All-but-tiny stocks": (0.23, 0.46, 1556),
        "Large stocks": (0.25, 0.41, 828),
    }),
    "LogIssues_{-1,-12}": (True, {
        "All stocks": (0.04, 0.12, 3953),
        "All-but-tiny stocks": (0.03, 0.10, 1706),
        "Large stocks": (0.03, 0.10, 876),
    }),
    "Beta_{-1,-36}": (True, {
        "All stocks": (0.96, 0.55, 3720),
        "All-but-tiny stocks": (1.06, 0.50, 1639),
        "Large stocks": (1.05, 0.46, 854),
    }),
    "StdDev_{-1,-12}": (True, {
        "All stocks": (0.15, 0.08, 3954),
        "All-but-tiny stocks": (0.11, 0.04, 1706),
        "Large stocks": (0.09, 0.03, 876),
    }),
    "Turnover_{-1,-12}": (False, {
        "All stocks": (0.08, 0.08, 3666),
        "All-but-tiny stocks": (0.10, 0.08, 1635),
        "Large stocks": (0.09, 0.08, 857),
    }),
    "Debt/Price_{yr-1}": (True, {
        "All stocks": (0.83, 1.59, 3908),
        "All-but-tiny stocks": (0.64, 1.16, 1677),
        "Large stocks": (0.61, 1.09, 864),
    }),
    "Sales/Price_{yr-1}": (True, {
        "All stocks": (2.53, 3.56, 3905),
        "All-but-tiny stocks": (1.59, 1.95, 1677),
        "Large stocks": (1.37, 1.52, 865),
    }),
}


# Pipeline display names (panel.characteristics.FACTORS_DICT, the working
# notebook mapping) → published row labels. The canonical map for parity
# runs so every caller agrees on row identity.
PARITY_LABEL_MAP: Dict[str, str] = {
    "Return (%)": "Return (%)",
    "Log Size (-1)": "LogSize_{-1}",
    "Log B/M (-1)": "LogB/M_{-1}",
    "Return (-2, -12)": "Return_{-2,-12}",
    "Log Issues (-1,-36)": "LogIssues_{-1,-36}",
    "Accruals (-1)": "Accruals_{yr-1}",
    "ROA (-1)": "ROA_{yr-1}",
    "Log Assets Growth (-1)": "LogAG_{yr-1}",
    "Dividend Yield (-1,-12)": "DY_{-1,-12}",
    "Log Return (-13,-36)": "LogReturn_{-13,-36}",
    "Log Issues (-1,-12)": "LogIssues_{-1,-12}",
    "Beta (-1,-36)": "Beta_{-1,-36}",
    "Std Dev (-1,-12)": "StdDev_{-1,-12}",
    "Debt/Price (-1)": "Debt/Price_{yr-1}",
    "Sales/Price (-1)": "Sales/Price_{yr-1}",
    "Turnover (-1,-12)": "Turnover_{-1,-12}",  # opt-in, INCLUDE_TURNOVER=1
}


def published_table_1(computed_only: bool = False) -> pd.DataFrame:
    """The published table: rows in publication order, columns a
    (Subset, Statistic) MultiIndex."""
    rows = {
        label: [entry[1][s][i] for s in SUBSETS for i in range(3)]
        for label, entry in PUBLISHED_TABLE_1.items()
        if entry[0] or not computed_only
    }
    columns = pd.MultiIndex.from_product(
        [SUBSETS, STATS], names=["Subset", "Statistic"]
    )
    return pd.DataFrame.from_dict(rows, orient="index", columns=columns)


def compare_table_1(
    table_1: pd.DataFrame,
    label_map: Optional[Dict[str, str]] = None,
    atol_avg: float = 0.05,
    atol_n_frac: float = 0.05,
) -> pd.DataFrame:
    """Diff a produced Table 1 against the published oracle.

    ``label_map`` maps produced row labels → published row labels when the
    caller's display names differ. Returns a long frame with one row per
    (variable, subset, statistic): produced, published, abs diff, and an
    ``ok`` flag (Avg/Std within ``atol_avg``; N within ``atol_n_frac``
    relative). The caller asserts on ``ok`` — published values are rounded
    to 2 decimals, so tolerance is bounded below by rounding.
    """
    # Compare against the FULL published table: rows the produced table
    # lacks are skipped below, so the 15 computed variables compare, and a
    # pipeline run with INCLUDE_TURNOVER=1 also gets its Turnover row
    # checked against the published values.
    oracle = published_table_1(computed_only=False)
    label_map = label_map or {}
    records = []
    for row in oracle.index:
        produced_label = next(
            (k for k, v in label_map.items() if v == row), row
        )
        if produced_label not in table_1.index:
            continue
        for subset in SUBSETS:
            for stat in STATS:
                got = float(table_1.loc[produced_label, (subset, stat)])
                want = float(oracle.loc[row, (subset, stat)])
                diff = abs(got - want)
                ok = (
                    diff <= atol_n_frac * max(abs(want), 1.0)
                    if stat == "N"
                    else diff <= atol_avg
                )
                records.append(
                    {"variable": row, "subset": subset, "stat": stat,
                     "produced": got, "published": want, "abs_diff": diff,
                     "ok": bool(ok)}
                )
    return pd.DataFrame.from_records(records)


def real_cache_present(raw_data_dir=None) -> bool:
    """True when all five real-cache parquet files exist AND the directory
    is not marked as synthetic-backed (``taskgraph.tasks.BACKEND_MARKER``)."""
    from pathlib import Path

    from fm_returnprediction_tpu_torch.pipeline import RAW_FILE_NAMES

    if raw_data_dir is None:
        from fm_returnprediction_tpu_torch.settings import config

        raw_data_dir = config("RAW_DATA_DIR")
    raw = Path(raw_data_dir)
    if not all((raw / name).exists() for name in RAW_FILE_NAMES.values()):
        return False
    marker = raw / "_data_backend.txt"
    return not (marker.exists() and marker.read_text().strip() == "synthetic")


def run_parity_check(raw_data_dir=None, strict: bool = True, device=None) -> pd.DataFrame:
    """Real caches → Table 1 → asserted diff against the published oracle.

    Builds the panel from ``raw_data_dir`` (default: the ``RAW_DATA_DIR``
    setting) through ``load_or_build_panel`` on ``device`` (default the
    GPU; raises without one), assembles Table 1, and compares every
    computed row. ``strict=True`` raises ``AssertionError`` listing the
    failing cells; either way the full diff frame is returned."""
    from fm_returnprediction_tpu_torch.panel.subsets import compute_subset_masks
    from fm_returnprediction_tpu_torch.pipeline import load_or_build_panel
    from fm_returnprediction_tpu_torch.reporting.table1 import build_table_1

    if raw_data_dir is None:
        from fm_returnprediction_tpu_torch.settings import config

        raw_data_dir = config("RAW_DATA_DIR")
    # the prepared-inputs slot and the dtype resolve inside the shared
    # entry, so pipeline and parity runs land on the same slot
    panel, factors_dict = load_or_build_panel(raw_data_dir, device=device)
    masks = compute_subset_masks(panel)
    table_1 = build_table_1(panel, masks, factors_dict)
    diff = compare_table_1(table_1, label_map=PARITY_LABEL_MAP)
    if strict and not diff["ok"].all():
        bad = diff[~diff["ok"]]
        raise AssertionError(
            f"Table 1 parity failed on {len(bad)} of {len(diff)} cells:\n"
            + bad.to_string(index=False)
        )
    return diff


def _main(argv=None) -> int:
    """One-command parity verdict against the published Lewellen Table 1.

    Exits 0 with the full diff table on parity; exits 1 listing the failing
    cells otherwise; exits 2 when no real WRDS cache is present (synthetic
    caches cannot prove parity)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="fm_returnprediction_tpu_torch.reporting.published",
        description="Table 1 from real WRDS caches against the published table")
    parser.add_argument("raw_dir", nargs="?", default=None)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="compute device (default cuda; raises without a GPU)")
    args = parser.parse_args(argv)
    if not real_cache_present(args.raw_dir):
        print(
            "No real WRDS cache found (or the cache is synthetic-backed). "
            "Populate RAW_DATA_DIR via the pullers, then re-run."
        )
        return 2
    try:
        diff = run_parity_check(args.raw_dir, strict=True, device=args.device)
    except AssertionError as exc:
        print(exc)
        return 1
    print(diff.to_string(index=False))
    print(f"\nPARITY OK: all {len(diff)} cells within tolerance.")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
