"""End-to-end Lewellen pipeline of the port, and its command line.

Raw WRDS-shaped frames (a synthetic universe or a cached raw directory) →
universe filter and relational transforms (host pandas) → dense monthly
base panel and compact daily strips (host numpy) → characteristics →
universes → Table 1 → Table 2 → the figure/decile sweep → Figure 1's
rolling slopes → the decile table → the serving state → (optionally) the
spec-grid scenario sweep, the rolling-origin backtest and the bootstrap-SE
table → artifacts, with the guard layer (``guard``)
checking every stage boundary. Everything after the host ingest runs on
the compute device.

    from fm_returnprediction_tpu_torch.pipeline import run_pipeline
    res = run_pipeline(synthetic=True)                       # on the GPU
    res = run_pipeline(raw_data_dir="_data/raw", device="cpu")
    res = run_pipeline(dense_base=base, compact_daily=daily)  # prepared inputs

    python -m fm_returnprediction_tpu_torch.pipeline --synthetic --output-dir _output
    python -m fm_returnprediction_tpu_torch.pipeline --raw-data-dir _data/raw \
        --checkpoint-dir _ckpt --device cpu
    python -m fm_returnprediction_tpu_torch.pipeline --synthetic --specgrid \
        --specgrid-cells 200 --specgrid-sink topk
    python -m fm_returnprediction_tpu_torch.pipeline --synthetic --bootstrap 10000
    python -m fm_returnprediction_tpu_torch.pipeline --synthetic --backtest \
        --backtest-schemes expanding,rolling60 --backtest-sink metrics
    python -m fm_returnprediction_tpu_torch.pipeline --synthetic \
        --trace-dir _trace --profile-dir _profile

A raw directory is read by the columnar route (``panel.columnar``;
``FMRP_PANEL_ROUTE=legacy`` selects the pandas route) and its host products
are kept in a prepared-inputs slot (``data.prepared``, ``<raw>/_prepared``;
``PREPARED_CACHE=0`` disables it), which a warm run maps and takes straight
to the device stages (``load_or_build_panel``). ``checkpoint_dir`` keeps
each completed reporting stage (``resilience.checkpoint``), so a crashed
run resumes at its last completed stage. The dtype comes from ``dtype=``
or the ``DTYPE`` environment variable (default ``float32``); the guard
switch from ``guard=`` or ``FMRP_GUARD`` (default on); Table 2 and the
figure/decile sweep take their route from ``FMRP_SPECGRID_ROUTE`` ("gram",
the default, or "stacked", split by ``FMRP_FUSE_SUBSETS_MB``). Figure 1 is
returned as the rolling-slope frames it plots (``PipelineResult.figure_1``);
it is drawn only to write ``figure_1.pdf`` under ``output_dir``, which
needs matplotlib.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import warnings
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from fm_returnprediction_tpu_torch import telemetry as _telemetry
from fm_returnprediction_tpu_torch.backtest import run_backtest_scenarios
from fm_returnprediction_tpu_torch.backtest.paths import BACKTEST_ROUTES
from fm_returnprediction_tpu_torch.backtest.sinks import (
    BACKTEST_SINK_NAMES,
    resolve_backtest_sink_name,
)
from fm_returnprediction_tpu_torch.data import prepared as _prepared
from fm_returnprediction_tpu_torch.data.columnar import ColumnarIngestError
from fm_returnprediction_tpu_torch.data.synthetic import (
    FILE_NAMES,
    SyntheticConfig,
    generate_synthetic_wrds,
)
from fm_returnprediction_tpu_torch.data.wrds_pull import (
    FLAG_COLUMNS,
    subset_to_common_stock_and_exchanges,
)
from fm_returnprediction_tpu_torch.device import resolve_device, resolve_dtype
from fm_returnprediction_tpu_torch.guard import checks as _guard_checks
from fm_returnprediction_tpu_torch.guard import contracts as _contracts
from fm_returnprediction_tpu_torch.panel.characteristics import get_factors
from fm_returnprediction_tpu_torch.panel.columnar import build_panel_columnar
from fm_returnprediction_tpu_torch.panel.daily import CompactDaily, build_compact_daily
from fm_returnprediction_tpu_torch.panel.dense import DensePanel
from fm_returnprediction_tpu_torch.panel.subsets import compute_subset_masks
from fm_returnprediction_tpu_torch.panel.transform_compustat import (
    add_report_date,
    calc_book_equity,
    expand_compustat_annual_to_monthly,
    merge_CRSP_and_Compustat,
)
from fm_returnprediction_tpu_torch.panel.transform_crsp import calculate_market_equity
from fm_returnprediction_tpu_torch.reporting.bootstrap_table import (
    build_bootstrap_table,
    save_bootstrap_table,
)
from fm_returnprediction_tpu_torch.reporting.deciles import (
    build_decile_table,
    save_decile_table,
)
from fm_returnprediction_tpu_torch.reporting.figure1 import (
    SubsetSweepEntry,
    draw_figure_1,
    figure_frames,
    subset_sweep,
)
from fm_returnprediction_tpu_torch.reporting.latex import (
    compile_latex_document,
    create_latex_document,
    save_data,
)
from fm_returnprediction_tpu_torch.reporting.table1 import build_table_1
from fm_returnprediction_tpu_torch.reporting.table2 import (
    format_table_2,
    table_2_cells,
)
from fm_returnprediction_tpu_torch.resilience.checkpoint import StageCheckpointer
from fm_returnprediction_tpu_torch.resilience.faults import fault_site
from fm_returnprediction_tpu_torch.settings import config
from fm_returnprediction_tpu_torch.serving.state import (
    ServingState,
    build_serving_state_from_panel,
)
from fm_returnprediction_tpu_torch.specgrid.estimators import resolve_estimator
from fm_returnprediction_tpu_torch.specgrid.scenarios import run_scenarios
from fm_returnprediction_tpu_torch.specgrid.sinks import SINK_NAMES, resolve_sink_name
from fm_returnprediction_tpu_torch.utils.cache import load_cache_data
from fm_returnprediction_tpu_torch.utils.timing import StageTimer

__all__ = [
    "PipelineResult",
    "RAW_FILE_NAMES",
    "load_raw_data",
    "build_panel",
    "build_panel_prepared",
    "load_or_build_panel",
    "panel_route",
    "resolve_dtype",
    "run_pipeline",
]

RAW_FILE_NAMES = dict(FILE_NAMES)

# The daily stage reads only (permno, dlycaldt, retx) and the universe
# filter the CIZ flag columns; the rest of the daily file is pruned at the
# read.
_CRSP_D_COLUMNS = ["permno", "dlycaldt", "retx"] + FLAG_COLUMNS

def panel_route() -> str:
    """The ingest route of a raw-directory build: ``"columnar"`` (default;
    chunked Arrow reads + vectorized numpy joins, ``panel.columnar``) or
    ``"legacy"`` (pandas frames + relational merges). Read from
    ``FMRP_PANEL_ROUTE`` at each call; the two routes give bit-identical
    panels."""
    route = os.environ.get("FMRP_PANEL_ROUTE", "columnar").strip().lower()
    if route not in ("columnar", "legacy"):
        raise ValueError(f"FMRP_PANEL_ROUTE must be 'columnar' or 'legacy', got {route!r}")
    return route


def _resolve_turnover(include_turnover: Optional[bool]) -> bool:
    """``include_turnover``, else the ``INCLUDE_TURNOVER`` setting (default
    0): the opt-in 16th characteristic."""
    if include_turnover is None:
        return bool(config("INCLUDE_TURNOVER"))
    return bool(include_turnover)


def _default_raw_data_dir() -> Path:
    """The ``RAW_DATA_DIR`` setting: ``<DATA_DIR>/raw``, ``DATA_DIR``
    (default ``_data``) taken relative to the repository root unless
    absolute."""
    return config("RAW_DATA_DIR")


def _pipeline_fingerprint(panel, dtype, salt: str = "") -> str:
    """The key of the stage checkpoints and the drift sentinel: the panel's
    identity axes (months, ids, variables, shape) + compute dtype + a
    data-provenance salt. The same definition as the reference package's,
    so both packages key the same panel alike."""
    h = hashlib.sha256()
    h.update(f"{_contracts.numpy_dtype(dtype).str}|{salt}|"
             f"{tuple(panel.values.shape)}|".encode())
    h.update(np.asarray(panel.months).astype("datetime64[ns]")
             .astype(np.int64).tobytes())
    h.update(np.ascontiguousarray(panel.ids).tobytes())
    h.update("|".join(panel.var_names).encode())
    return h.hexdigest()


@dataclasses.dataclass
class PipelineResult:
    panel: DensePanel                       # enriched panel, values on device
    factors_dict: Dict[str, str]
    subset_masks: Dict[str, torch.Tensor]
    table_1: pd.DataFrame                   # (subset, {Avg, Std, N}) columns
    table_2: pd.DataFrame                   # formatted reference layout
    table_2_cells: Dict[Tuple[str, str], dict]  # coef/tstat/mean_r2/mean_n
    sweep: Dict[str, SubsetSweepEntry]      # the figure/decile sweep's subsets
    figure_1: Optional[Dict[str, pd.DataFrame]]  # subset → rolling slopes
    decile_table: Optional[pd.DataFrame]
    serving_state: Optional[ServingState]
    stage_seconds: Dict[str, float]         # device-synchronized wall time
    timer: StageTimer                       # stage_seconds, the skipped stages, report()
    # the guard ledger: contract violations, numerical sentinel counters
    # and quarantined artifacts (empty when clean or guards disabled)
    audit: _contracts.AuditRecord
    # the spec-grid scenario sweep (specgrid.run_scenarios): the sink's
    # frame, or None when not requested
    specgrid_scenarios: Optional[pd.DataFrame] = None
    # the bootstrap-SE table (reporting.bootstrap_table), or None when not
    # requested
    bootstrap_table: Optional[pd.DataFrame] = None
    # the rolling-origin backtest sweep (backtest.run_backtest_scenarios):
    # the sink's frame, one row per cell, or None when not requested
    backtest_table: Optional[pd.DataFrame] = None


def load_raw_data(raw_data_dir) -> Dict[str, pd.DataFrame]:
    """Load the five cached raw datasets by their canonical file names; the
    daily file is column-pruned to what the pipeline reads."""
    out = {}
    for key, name in RAW_FILE_NAMES.items():
        if key != "crsp_d":
            out[key] = load_cache_data(raw_data_dir, name)
            continue
        try:
            out[key] = load_cache_data(raw_data_dir, name, columns=_CRSP_D_COLUMNS)
        except (ValueError, KeyError):
            # a cache written by another producer may lack pruned columns:
            # read it whole
            out[key] = load_cache_data(raw_data_dir, name)
    return out


def build_panel(
    data: Dict[str, pd.DataFrame],
    dtype=torch.float64,
    mesh=None,
    timer: Optional[StageTimer] = None,
    include_turnover: Optional[bool] = None,
    capture: Optional[dict] = None,
    *,
    device=None,
) -> Tuple[DensePanel, Dict[str, str]]:
    """Raw frames → merged monthly panel → enriched characteristic panel
    (the legacy pandas route).

    The common-stock/exchange universe filter is applied to both the
    monthly and the daily rows. The host ingest (filter, market equity,
    Compustat expansion, CCM merge, daily compaction, then ``get_factors``'
    ``long_to_dense``) runs in ``dtype``'s numpy dtype (a torch or numpy
    dtype, default float64 as the reference's); ``get_factors`` computes the
    characteristics on ``device``, the daily strips sharded over ``mesh``
    when one is given. ``include_turnover=None`` follows
    ``INCLUDE_TURNOVER``. ``capture``, when a dict, receives the two host
    products, ``dense_base`` and ``compact_daily``, for the prepared-inputs
    slot."""
    device = resolve_device(device)
    timer = timer or StageTimer(device)
    np_dtype = _contracts.numpy_dtype(dtype)
    with timer.ensure_stage("build_panel"):
        with timer.stage("panel/universe_filter"):
            crsp_m = subset_to_common_stock_and_exchanges(data["crsp_m"])
            crsp_d = subset_to_common_stock_and_exchanges(
                data["crsp_d"], columns=["permno", "dlycaldt", "retx"])
        with timer.stage("panel/market_equity"):
            crsp = calculate_market_equity(crsp_m)
        with timer.stage("panel/compustat"):
            comp = add_report_date(data["comp"].copy())
            comp = calc_book_equity(comp)
            comp = expand_compustat_annual_to_monthly(comp)
        with timer.stage("panel/ccm_merge"):
            merged = merge_CRSP_and_Compustat(crsp, comp, data["ccm"])
        with timer.stage("factors/daily_ingest"):
            # the month vocabulary long_to_dense derives from ``merged``
            months = np.unique(merged["jdate"].to_numpy())
            daily = build_compact_daily(crsp_d, data["crsp_index_d"], months,
                                        dtype=np_dtype)
        if capture is not None:
            capture["compact_daily"] = daily
        return get_factors(merged, None, None, dtype, mesh, timer=timer,
                           include_turnover=include_turnover, compact_daily=daily,
                           capture=capture, device=device)


def build_panel_prepared(
    dense_base: DensePanel,
    compact_daily: CompactDaily,
    dtype=torch.float64,
    mesh=None,
    timer: Optional[StageTimer] = None,
    include_turnover: Optional[bool] = None,
    *,
    device=None,
) -> Tuple[DensePanel, Dict[str, str]]:
    """The enriched characteristic panel from the prepared inputs (the
    daily strips sharded over ``mesh`` when one is given;
    ``include_turnover=None`` follows ``INCLUDE_TURNOVER``)."""
    timer = timer or StageTimer(resolve_device(device))
    with timer.ensure_stage("build_panel"):
        return get_factors(None, None, None, dtype, mesh, timer=timer,
                           include_turnover=include_turnover, compact_daily=compact_daily,
                           dense_base=dense_base, device=device)


def load_or_build_panel(
    raw_data_dir,
    dtype=None,
    mesh=None,
    timer: Optional[StageTimer] = None,
    include_turnover: Optional[bool] = None,
    *,
    device=None,
) -> Tuple[DensePanel, Dict[str, str]]:
    """The enriched panel from a raw cache directory, through its
    prepared-inputs slot (the daily strips sharded over ``mesh`` when one is
    given).

    A slot valid for the current raw files (``data.prepared``) is mapped
    and taken straight to the device stages (``load_prepared``, then
    ``build_panel``; ``load_raw_data`` is marked skipped). Otherwise the
    raw parquet is ingested by the route ``panel_route()`` names — the
    columnar route streams its reads inside ``build_panel``
    (``panel/monthly_ingest`` … ``factors/daily_ingest``) and marks
    ``load_raw_data`` skipped; a :class:`ColumnarIngestError` warns and
    falls back to the legacy route — and the slot is written
    (``build_panel/save_prepared``). ``dtype=None`` follows ``DTYPE`` and
    ``include_turnover=None`` follows ``INCLUDE_TURNOVER``, resolved here so
    every caller lands on the same slot."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    include_turnover = _resolve_turnover(include_turnover)
    timer = timer or StageTimer(device)

    prepared = prepared_dir = fingerprint = None
    if _prepared.prepared_enabled():
        candidates = _prepared.prepared_candidates(raw_data_dir)
        prepared_dir = candidates[0]
        # the turnover flag changes the base column set, so it is in the key
        fingerprint = _prepared.raw_fingerprint(
            raw_data_dir, dtype, salt=f"turnover={int(include_turnover)}")
        with timer.stage("load_prepared"):
            for candidate in candidates:
                prepared = _prepared.load_prepared(candidate, fingerprint)
                if prepared is not None:
                    break
    if prepared is not None:
        base, daily = prepared
        timer.mark_skipped("load_raw_data", "prepared checkpoint hit")
        with timer.stage("build_panel"):
            return build_panel_prepared(base, daily, dtype=dtype, device=device,
                                        include_turnover=include_turnover, timer=timer,
                                        mesh=mesh)

    capture = {} if prepared_dir is not None else None

    def save_slot():
        if capture is not None:
            # nested name: this runs inside the build_panel stage
            with timer.stage("build_panel/save_prepared"):
                _prepared.save_prepared(prepared_dir, fingerprint,
                                        capture["dense_base"], capture["compact_daily"])

    if panel_route() == "columnar":
        # the raw reads stream inside build_panel: no load_raw_data stage
        timer.mark_skipped("load_raw_data", "columnar route streams raw parquet in-stage")
        try:
            with timer.stage("build_panel"):
                panel, factors_dict = build_panel_columnar(
                    raw_data_dir, dtype=dtype, device=device,
                    include_turnover=include_turnover, timer=timer, capture=capture,
                    mesh=mesh)
                save_slot()
            return panel, factors_dict
        except ColumnarIngestError as exc:
            # a cache the columnar reader cannot service (csv, columns of
            # another layout) goes through the pandas route instead
            warnings.warn(f"columnar panel route unavailable ({exc}); falling back to "
                          "the legacy pandas ingest", stacklevel=2)
    with timer.stage("load_raw_data"):
        data = load_raw_data(raw_data_dir)
    with timer.stage("build_panel"):
        panel, factors_dict = build_panel(data, dtype=dtype, device=device,
                                          include_turnover=include_turnover, timer=timer,
                                          capture=capture, mesh=mesh)
        # the raw frames are dead once the panel exists
        del data
        save_slot()
    return panel, factors_dict


def run_pipeline(
    raw_data_dir=None,
    output_dir=None,
    synthetic: bool = False,
    synthetic_config: Optional[SyntheticConfig] = None,
    dtype=None,
    make_figure: bool = True,
    compile_pdf: bool = True,
    make_deciles: bool = True,
    make_bootstrap: bool = False,
    make_serving: bool = True,
    make_specgrid: bool = False,
    specgrid_cells: Optional[int] = None,
    specgrid_sink: Optional[str] = None,
    specgrid_estimator: Optional[str] = None,
    make_backtest: bool = False,
    backtest_schemes: Optional[str] = None,
    backtest_route: Optional[str] = None,
    backtest_quantiles: Optional[int] = None,
    backtest_sink: Optional[str] = None,
    bootstrap_replicates: int = 10_000,
    use_mesh: Optional[bool] = None,
    checkpoint_dir=None,
    guard: Optional[bool] = None,
    audit_dir=None,
    trace_dir=None,
    profile_dir=None,
    registry_dir=None,
    *,
    device=None,
    include_turnover: Optional[bool] = None,
    dense_base: Optional[DensePanel] = None,
    compact_daily: Optional[CompactDaily] = None,
) -> PipelineResult:
    """Raw data or prepared inputs → characteristics → NYSE-breakpoint
    universes → Table 1 → Table 2 → Figure 1 / deciles → serving state →
    artifacts, on ``device`` (default the GPU; raises when there is none
    and the CPU was not asked for).

    The panel comes from the prepared inputs when ``dense_base`` and
    ``compact_daily`` are given, else from a synthetic universe
    (``synthetic=True``, ``synthetic_config``), else from the cached raw
    frames in ``raw_data_dir`` (default ``<DATA_DIR>/raw``) through
    ``load_or_build_panel`` (the columnar route and the prepared-inputs
    slot). ``dtype=None`` follows ``DTYPE`` (default float32),
    ``include_turnover=None`` follows ``INCLUDE_TURNOVER`` (default off).

    ``checkpoint_dir`` keeps each completed reporting stage (Table 1, Table
    2, the decile table, the serving state) there, keyed by the panel's
    identity, the dtype and the data's provenance (the raw directory's
    fingerprint, or the synthetic config): a rerun after a crash loads the
    completed stages and recomputes from the failure on; a stale or
    corrupt stage file is recomputed. The prepared-inputs entry has no
    provenance to key on, so it refuses ``checkpoint_dir``.

    ``guard`` arms the guard layer (``None`` follows ``FMRP_GUARD``,
    default on): the panel contract after the build, the frame contracts
    on Table 1 and Table 2, the quarantine screen on the decile table and
    the serving state, and the numerical sentinels of the OLS, FM and
    spec-grid solves, all folded into ``PipelineResult.audit``. Guards
    change no number: the tables are bit-identical with them on or off.

    ``audit_dir`` arms the drift sentinel (``guard.drift``): this run's
    artifact summaries are held against the previous same-fingerprint run's
    ``audit.json`` there — drift beyond the band raises
    ``DriftDetectedError`` (after the artifacts are saved, without
    rewriting the trusted manifest) — then the manifest is updated.

    ``make_specgrid`` runs the scenario sweep on the spec-grid tile engine
    (``specgrid.run_scenarios``: 3 models × the universes × the full sample
    and two halves) after the serving state: ``specgrid_cells`` scales it
    to at least that many cells (the bootstrap-draw dimension grows;
    memory stays one tile), ``specgrid_sink`` picks the streaming sink
    (default ``FMRP_SPECGRID_SINK``, else the full frame), and
    ``FMRP_GRAM_PRECISION=bf16`` contracts it in bfloat16.
    ``specgrid_estimator`` (grammar ``"fwl:c1+c2[@se]"``,
    ``"absorb:fe1+fe2"``, ``"iv:endog~z1+z2"``, ``"pooled[:se]"``; default
    ``FMRP_SPECGRID_ESTIMATOR``, else OLS) runs every cell under that
    estimator, resolved loudly before the sweep so a typo fails first (an
    absorb estimator raises: the pipeline has no FE codes to pass). Table 2
    and the figure sweep stay on OLS: a non-OLS estimator leaking in
    through ``FMRP_SPECGRID_ESTIMATOR`` stops the run at ``table_2``. The
    guard screens the full frame at quarantine severity.

    ``make_bootstrap`` builds the bootstrap-SE table
    (``reporting.bootstrap_table``: per Table 2 cell and predictor the
    moving-block bootstrap SE of the mean slope from
    ``bootstrap_replicates`` replicates, seed 0) in the stage
    ``bootstrap_table``.

    ``make_backtest`` runs the rolling-origin backtest sweep
    (``backtest.run_backtest_scenarios``) in the stage ``backtest``: the
    scenario panel is contracted once into an in-memory Gram bank and every
    cell (window scheme × model × universe × EW/VW weighting) answers from
    it — coefficient paths by the prefix-sum scan route
    (``backtest_route``, default ``FMRP_BACKTEST_ROUTE`` or ``auto``),
    out-of-sample forecasts, OOS R², IC, ``backtest_quantiles``-bucket
    portfolio spreads and turnover, streamed through ``backtest_sink``.
    ``backtest_schemes`` is the comma list (default ``FMRP_BACKTEST_SCHEMES``
    or ``"expanding,rolling120"``). The backtest runs under
    ``specgrid_estimator`` too (OLS or FWL: the kinds with a per-month slope
    path; the others raise there); the guard screens the full frame with
    ``guard.contracts.backtest_rules`` at quarantine severity.

    ``output_dir`` writes the artifacts: ``table_{1,2}.{pkl,tex}``,
    ``figure_1.pdf`` (matplotlib), ``decile_sorts.{pkl,tex}``,
    ``serving_state.npz``, ``specgrid_scenarios.csv`` (with the sweep),
    ``backtest.csv`` (with the backtest), ``bootstrap_se.{pkl,tex}`` (with
    the bootstrap table), ``data_saved.marker`` and ``research_report.tex`` (compiled when
    ``pdflatex`` exists and ``compile_pdf``).

    ``trace_dir`` arms the telemetry layer for the run (``None`` follows
    ``FMRP_TRACE_DIR``, default off): the run is a ``run_pipeline`` span,
    each stage a child span, and the exports land in
    ``<trace_dir>/events.jsonl`` (the structured event log) and
    ``<trace_dir>/trace.json`` (Chrome trace-event format, for Perfetto).
    Spans are host records only: a traced run's artifacts are bit-identical
    to an untraced run's, with the same kernel launches.

    ``profile_dir`` wraps the run in a ``torch.profiler`` capture (CPU
    activities and, on the card, CUDA's) written to
    ``<profile_dir>/profile_trace.json``; every stage span also names its
    interval in the profile (``telemetry.profiling``).

    ``registry_dir`` arms the registry for the run (``None`` follows
    ``FMRP_REGISTRY_DIR``, default off): the prepared-inputs slot lives
    under its root, a kernel library the run needs is fetched from it
    before nvcc runs, and the stage ``registry_publish`` publishes the
    serving state, the sweep and backtest CSVs, the audit manifest and the
    kernel libraries the run loaded, then warms the serving buckets on the
    device. Unlike the reference, a publish that leaves the registry
    without this run's serving-state entry raises: the run does not end
    as a success with its artifacts missing from the registry it armed.

    ``use_mesh`` shards the run over a device mesh
    (``parallel.mesh.pipeline_mesh``): None follows the policy (a months ×
    firms hierarchy in a run across processes, else ``MESH_DEVICES``,
    default 1 = no mesh); True takes the policy's mesh or every local
    device, raising when there is only one; False never shards. On a mesh
    the daily strips shard over firms, Table 2 runs distributed TSQR per
    cell (``reporting.table2.run_model_fm``; a 2-D mesh the hierarchy) and
    the bootstrap table shards its replicates over the mesh's devices
    flattened (``as_flat_mesh``); the other stages run on ``device``."""
    from fm_returnprediction_tpu_torch.registry.store import using_registry

    if guard is None:
        guard = _guard_checks.guard_active()
    with using_registry(registry_dir), _telemetry.tracing(trace_dir), _telemetry.profiling(
        profile_dir, device=device
    ), _telemetry.span("run_pipeline", cat="pipeline"), _guard_checks.guards(bool(guard)):
        return _run_pipeline_guarded(
            dense_base, compact_daily, raw_data_dir=raw_data_dir,
            output_dir=output_dir, synthetic=synthetic,
            synthetic_config=synthetic_config, device=device, dtype=dtype,
            include_turnover=include_turnover, make_figure=make_figure,
            make_deciles=make_deciles, make_serving=make_serving,
            compile_pdf=compile_pdf, checkpoint_dir=checkpoint_dir,
            guard=bool(guard), audit_dir=audit_dir, make_specgrid=make_specgrid,
            specgrid_cells=specgrid_cells, specgrid_sink=specgrid_sink,
            specgrid_estimator=specgrid_estimator,
            make_bootstrap=make_bootstrap, bootstrap_replicates=bootstrap_replicates,
            make_backtest=make_backtest, backtest_schemes=backtest_schemes,
            backtest_route=backtest_route, backtest_quantiles=backtest_quantiles,
            backtest_sink=backtest_sink, use_mesh=use_mesh,
        )


def _run_pipeline_guarded(
    dense_base, compact_daily, *, raw_data_dir, output_dir, synthetic,
    synthetic_config, device, dtype, include_turnover, make_figure,
    make_deciles, make_serving, compile_pdf, checkpoint_dir, guard, audit_dir,
    make_specgrid, specgrid_cells, specgrid_sink, specgrid_estimator, make_bootstrap,
    bootstrap_replicates, make_backtest, backtest_schemes, backtest_route,
    backtest_quantiles, backtest_sink, use_mesh,
) -> PipelineResult:
    """``run_pipeline``'s body, entered with the sentinel switch already
    pinned to ``guard`` for the whole run."""
    device = resolve_device(device)
    mesh = None
    if use_mesh or use_mesh is None:
        from fm_returnprediction_tpu_torch.parallel.mesh import (
            local_devices,
            make_mesh,
            pipeline_mesh,
        )

        mesh = pipeline_mesh(device=device.type)
        if use_mesh and mesh is None:
            if len(local_devices(device.type)) <= 1:
                raise RuntimeError("use_mesh=True but only one device is available")
            mesh = make_mesh(axis_name="firms", device=device.type)
    dtype = resolve_dtype(dtype)
    include_turnover = _resolve_turnover(include_turnover)
    audit = _contracts.AuditRecord()
    counters_before = _guard_checks.drain() if guard else {}
    timer = StageTimer(device)

    prepared = dense_base is not None or compact_daily is not None
    if prepared:
        if dense_base is None or compact_daily is None:
            raise ValueError("the prepared-inputs entry needs both dense_base "
                             "and compact_daily")
        if synthetic or raw_data_dir is not None:
            raise ValueError("pass prepared inputs, synthetic=True or "
                             "raw_data_dir, not several")
        if checkpoint_dir is not None:
            raise ValueError(
                "checkpoint_dir needs the data's provenance to key its stages on "
                "(a raw directory or a synthetic config); prepared inputs carry "
                "none, and a checkpoint of other data with the same axes would "
                "load silently")
        with timer.stage("build_panel"):
            panel, factors_dict = build_panel_prepared(
                dense_base, compact_daily, dtype=dtype, device=device,
                include_turnover=include_turnover, timer=timer, mesh=mesh)
    elif synthetic:
        with timer.stage("load_raw_data"):
            data = generate_synthetic_wrds(synthetic_config)
        with timer.stage("build_panel"):
            panel, factors_dict = build_panel(
                data, dtype=dtype, device=device,
                include_turnover=include_turnover, timer=timer, mesh=mesh)
        # the raw frames are dead once the panel exists
        del data
    else:
        if raw_data_dir is None:
            raw_data_dir = _default_raw_data_dir()
        if not Path(raw_data_dir).is_dir():
            raise FileNotFoundError(
                f"Raw data directory {str(raw_data_dir)!r} does not exist. "
                "Pass --raw-data-dir pointing at the cached WRDS parquet "
                f"files ({', '.join(RAW_FILE_NAMES.values())}), or use "
                "--synthetic."
            )
        panel, factors_dict = load_or_build_panel(
            raw_data_dir, dtype=dtype, device=device,
            include_turnover=include_turnover, timer=timer, mesh=mesh)

    # a fault plan can hand back a corrupted panel here; the contract right
    # below must catch it at its declared severity
    panel = fault_site("pipeline.panel", payload=panel)

    panel_stats = None
    if guard:
        with timer.stage("guard_panel_contracts"):
            # the probe doubles as the drift sentinel's panel_stats artifact
            panel_stats = _contracts.check_panel(panel, dtype=dtype, audit=audit)

    with timer.stage("subset_masks"):
        masks = compute_subset_masks(panel)

    salt_memo = {}

    def provenance_salt() -> str:
        """The data-provenance salt the stage checkpointer and the drift
        sentinel share: the raw directory's fingerprint, or the synthetic
        config. Computed once (it stats the raw files)."""
        if "salt" not in salt_memo:
            if prepared:
                salt_memo["salt"] = "prepared"
            elif synthetic:
                salt_memo["salt"] = json.dumps(vars(synthetic_config or SyntheticConfig()),
                                               sort_keys=True, default=str)
            else:
                salt_memo["salt"] = _prepared.raw_fingerprint(raw_data_dir, dtype)
        return salt_memo["salt"]

    ckpt = None
    if checkpoint_dir is not None:
        ckpt = StageCheckpointer(
            checkpoint_dir, _pipeline_fingerprint(panel, dtype, provenance_salt()))

    def frame_stage(name, compute):
        """One checkpointable stage with its fault site
        ``pipeline.<name>``; without a checkpoint directory it computes."""

        def compute_with_fault():
            fault_site(f"pipeline.{name}")
            return compute()

        if ckpt is None:
            return compute_with_fault()
        return ckpt.frame(name, compute_with_fault)

    with timer.stage("table_1"):
        table_1 = frame_stage("table_1", lambda: build_table_1(panel, masks, factors_dict))
        if guard:  # checkpoint-loaded frames too
            _contracts.check_frame(table_1, "table_1", audit)
    with timer.stage("table_2"):
        # the stage keeps the per-cell numbers; the formatted frame follows
        # from them
        cells = frame_stage("table_2", lambda: table_2_cells(panel, masks, factors_dict,
                                                             mesh=mesh))
        table_2 = format_table_2(cells, list(masks))
        if guard:
            _contracts.check_frame(table_2, "table_2", audit)

    # The figure, the decile table and the serving state share one sweep:
    # one Gram contraction gives every subset's figure cross-sections.
    # Without the decile table only the figure's two subsets are swept. The
    # decile checkpoint is loaded (and verified) before the sweep: a loaded
    # table drops the sweep's decile legs but not its subsets, since the
    # Gram kernel's firm grouping follows the number of specs and the same
    # subsets keep the figure and the serving state bit-identical to a
    # fresh run's on the card; a missing or corrupt one is swept as in a
    # fresh run.
    decile_table = None
    if make_deciles and ckpt is not None:
        decile_table = ckpt.load_frame("decile_table")
    decile_fresh = make_deciles and decile_table is None
    sweep = {}
    if make_figure or make_deciles:
        with timer.stage("figure_cs"):
            needed = set(masks) if make_deciles else {"All stocks", "Large stocks"}
            sweep = subset_sweep(panel, masks, [n for n in masks if n in needed],
                                 make_deciles=decile_fresh)
    figure_1 = None
    if make_figure:
        with timer.stage("figure_1"):
            figure_1 = figure_frames(panel, masks, sweep)
    if make_deciles:
        with timer.stage("decile_table"):
            if decile_fresh:
                fault_site("pipeline.decile_table")
                decile_table = build_decile_table(panel, masks, cs_cache=sweep)
                if ckpt is not None:
                    ckpt.save_frame("decile_table", decile_table)
            if guard:  # checkpoint-loaded tables too
                decile_table = _contracts.screen_artifact(
                    "decile_table", decile_table,
                    _contracts.frame_rules("decile_table", blocking="quarantine"),
                    audit,
                )
    serving_state = None
    if make_serving and "All stocks" in masks:
        with timer.stage("serving_state"):
            def compute_serving():
                fault_site("pipeline.serving_state")
                entry = sweep.get("All stocks")
                return build_serving_state_from_panel(
                    panel, masks["All stocks"],
                    cs=entry.cs if entry is not None else None)

            if ckpt is None:
                serving_state = compute_serving()
            else:
                serving_state = ckpt.stage(
                    "serving_state", compute_serving,
                    saver=lambda st, path: st.save(path), loader=ServingState.load,
                    suffix=".npz")
            if guard:
                # optional artifact: a quarantine-severity violation drops
                # it and the run completes degraded
                serving_state = _contracts.screen_artifact(
                    "serving_state", serving_state,
                    _contracts.serving_state_rules(), audit,
                )

    specgrid_scenarios = None
    if make_specgrid:
        with timer.stage("specgrid"):
            # models × universes × subperiod halves on the tile engine, one
            # contraction per tile batch, streamed through the sink; the
            # estimator (argument > FMRP_SPECGRID_ESTIMATOR > OLS) is
            # resolved loudly here, so a typo fails before the sweep runs
            est = resolve_estimator(specgrid_estimator)
            estimators = None if (est.kind, est.se) == ("ols", "nw") else (est,)
            specgrid_scenarios = frame_stage(
                "specgrid_scenarios",
                lambda: run_scenarios(panel, masks, factors_dict, cells=specgrid_cells,
                                      sink=specgrid_sink, estimators=estimators,
                                      output_dir=output_dir))
            if guard and resolve_sink_name(specgrid_sink) == "frame":
                # the other sinks emit their own schema (leaderboard, moment
                # table, part manifest): the tidy-frame contract is the
                # full frame's
                specgrid_scenarios = _contracts.screen_artifact(
                    "specgrid_scenarios", specgrid_scenarios,
                    _contracts.frame_rules("specgrid_scenarios", blocking="quarantine"),
                    audit,
                )

    backtest_table = None
    if make_backtest:
        with timer.stage("backtest"):
            # the rolling-origin sweep on the banked Gram stats: the panel is
            # contracted once and every cell answers from the bank; knobs
            # resolve argument > FMRP_BACKTEST_* env > default
            backtest_table = frame_stage(
                "backtest",
                lambda: run_backtest_scenarios(
                    panel, masks, factors_dict, schemes=backtest_schemes,
                    route=backtest_route, n_quantiles=backtest_quantiles,
                    sink=backtest_sink, estimator=specgrid_estimator,
                    output_dir=output_dir, device=device))
            if guard and resolve_backtest_sink_name(backtest_sink) == "frame":
                # the other sinks emit their own schema: the backtest frame
                # contract is the full frame's
                backtest_table = _contracts.screen_artifact(
                    "backtest", backtest_table,
                    _contracts.backtest_rules(blocking="quarantine"), audit)

    bootstrap_table = None
    if make_bootstrap:
        with timer.stage("bootstrap_table"):
            boot_mesh = None
            if mesh is not None:
                from fm_returnprediction_tpu_torch.parallel.multihost import as_flat_mesh

                boot_mesh = as_flat_mesh(mesh, axis_name="boot")
            bootstrap_table = build_bootstrap_table(
                panel, masks, factors_dict, n_replicates=bootstrap_replicates,
                mesh=boot_mesh)

    if output_dir is not None:
        with timer.stage("save_artifacts"):
            figure = draw_figure_1(figure_1) if figure_1 is not None else None
            save_data(table_1, table_2, figure, output_dir)
            if figure is not None:
                import matplotlib.pyplot as plt

                plt.close(figure[0])
            if decile_table is not None:
                save_decile_table(decile_table, output_dir)
            if serving_state is not None:
                serving_state.save(Path(output_dir) / "serving_state.npz")
            if specgrid_scenarios is not None:
                specgrid_scenarios.to_csv(Path(output_dir) / "specgrid_scenarios.csv",
                                          index=False)
            if backtest_table is not None:
                backtest_table.to_csv(Path(output_dir) / "backtest.csv", index=False)
            if bootstrap_table is not None:
                save_bootstrap_table(bootstrap_table, output_dir)
            tex = create_latex_document(output_dir)
            if tex is not None and compile_pdf:
                compile_latex_document(tex)

    if guard:
        # fold this run's sentinel counters into the audit record; the
        # counters are process-wide, so diff against the pre-run snapshot
        ended = _guard_checks.drain()
        audit.record_counters({
            k: v - counters_before.get(k, 0) for k, v in ended.items()
        })

    if audit_dir is not None:
        # drift sentinel AFTER the artifacts are saved: a drifted run's
        # outputs stay on disk for inspection, the trusted manifest survives
        from fm_returnprediction_tpu_torch.guard.drift import (
            DriftSentinel,
            summarize_arrays,
            summarize_frame,
        )

        with timer.stage("guard_drift"):
            sentinel = DriftSentinel(audit_dir,
                                     _pipeline_fingerprint(panel, dtype, provenance_salt()))
            if panel_stats is None:
                panel_stats = _contracts.panel_probe(panel)
            sentinel.check("panel_stats", panel_stats)
            sentinel.check("table_1", summarize_frame(table_1))
            sentinel.check("table_2", summarize_frame(table_2))
            if decile_table is not None:
                sentinel.check("decile_table", summarize_frame(decile_table))
            if specgrid_scenarios is not None:
                sentinel.check("specgrid_scenarios", summarize_frame(specgrid_scenarios))
            if backtest_table is not None:
                sentinel.check("backtest", summarize_frame(backtest_table))
            if serving_state is not None:
                sentinel.check("serving_state", summarize_arrays({
                    "coef": serving_state.coef,
                    "slopes_bar": serving_state.slopes_bar,
                    "intercept_bar": serving_state.intercept_bar,
                    "gram": serving_state.gram,
                    "moment": serving_state.moment,
                    "n_obs": serving_state.n_obs,
                }))
            sentinel.raise_on_drift(audit)
            sentinel.commit(audit)

    from fm_returnprediction_tpu_torch.registry.store import active_registry

    registry = active_registry()
    if registry is not None:
        with timer.stage("registry_publish"):
            _registry_publish(
                registry, _pipeline_fingerprint(panel, dtype, provenance_salt()), device,
                output_dir=output_dir, audit_dir=audit_dir, serving_state=serving_state,
                specgrid_scenarios=specgrid_scenarios, backtest_table=backtest_table)

    return PipelineResult(
        panel=panel, factors_dict=factors_dict, subset_masks=masks,
        table_1=table_1, table_2=table_2, table_2_cells=cells, sweep=sweep,
        figure_1=figure_1, decile_table=decile_table,
        serving_state=serving_state, stage_seconds=dict(timer.durations),
        timer=timer, audit=audit, specgrid_scenarios=specgrid_scenarios,
        bootstrap_table=bootstrap_table, backtest_table=backtest_table,
    )


def _registry_publish(registry, fingerprint: str, device, *, output_dir, audit_dir,
                      serving_state, specgrid_scenarios, backtest_table) -> None:
    """The ``registry_publish`` stage: the serving state (the npz the
    artifact writer saved, else serialized here), the sweep and backtest
    CSVs and the audit manifest that this run wrote, and, on the card, the
    kernel libraries it loaded; then the serving buckets are warmed on the
    device (each captured once and freed), as the reference warms its
    bucket programs at publication. Raises when the registry holds no
    serving-state entry for this run afterwards (each ``put_*`` warns
    instead of raising)."""
    from fm_returnprediction_tpu_torch import cuda_build
    from fm_returnprediction_tpu_torch.guard.drift import MANIFEST_NAME
    from fm_returnprediction_tpu_torch.registry import artifacts as _rart
    from fm_returnprediction_tpu_torch.serving.executor import BucketedExecutor

    out = Path(output_dir) if output_dir is not None else None
    if serving_state is not None:
        saved = out / "serving_state.npz" if out is not None else None
        if saved is not None and saved.exists():
            _rart.put_files(_rart.SERVING_STATE_NAME, fingerprint, [saved], registry=registry,
                            meta={"n_months": int(serving_state.n_months),
                                  "n_predictors": int(serving_state.n_predictors)})
        else:
            _rart.put_serving_state(serving_state, fingerprint, registry=registry)
        if _rart.get_entry_dir(_rart.SERVING_STATE_NAME, fingerprint, registry=registry) is None:
            raise RuntimeError(
                f"registry_publish: the registry at {registry.root} holds no serving-state "
                f"entry for this run (fingerprint {fingerprint}) after the publish")
    for name, frame, file in (("specgrid_scenarios", specgrid_scenarios,
                               "specgrid_scenarios.csv"),
                              ("backtest", backtest_table, "backtest.csv")):
        if frame is not None and out is not None and (out / file).exists():
            _rart.put_files(name, fingerprint, [out / file], registry=registry)
    if audit_dir is not None and (Path(audit_dir) / MANIFEST_NAME).exists():
        _rart.put_files("audit_manifest", fingerprint, [Path(audit_dir) / MANIFEST_NAME],
                        registry=registry)
    if device.type == "cuda":
        cuda_build.publish_libraries(registry)
    if serving_state is not None:
        executor = BucketedExecutor(serving_state, device=device)
        executor.warmup()
        executor.release()


def _main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="Run the Lewellen FM pipeline (PyTorch port).")
    parser.add_argument("--raw-data-dir", default=None)
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--firms", type=int, default=None,
                        help="synthetic only (default 100)")
    parser.add_argument("--months", type=int, default=None,
                        help="synthetic only (default 120)")
    parser.add_argument(
        "--checkpoint-dir", default=None,
        help="per-stage checkpoint directory: a rerun after a crash resumes "
             "at the last completed reporting stage",
    )
    parser.add_argument(
        "--no-guard", action="store_true",
        help="disable the guard layer (stage-boundary contracts + numerical "
             "sentinels; default follows FMRP_GUARD, normally on)",
    )
    parser.add_argument(
        "--audit-dir", default=None,
        help="arm the drift sentinel: compare this run's artifact summaries "
             "(sha256 + per-column moments) against the previous run's audit "
             "manifest in this directory; drift beyond band fails loudly, a "
             "clean run updates the manifest",
    )
    parser.add_argument(
        "--specgrid", action="store_true",
        help="also run the spec-grid robustness sweep (subperiods × universes × "
             "models via Gram contraction) and save specgrid_scenarios.csv",
    )
    parser.add_argument(
        "--specgrid-cells", type=int, default=None, metavar="N",
        help="scale the spec-grid sweep to at least N cells (the bootstrap-draw "
             "dimension grows to cover it; cells stream tile by tile)",
    )
    parser.add_argument(
        "--specgrid-sink", default=None, choices=list(SINK_NAMES),
        help="spec-grid streaming sink: full tidy frame (default), top-k-by-|tstat| "
             "leaderboard, running summary moments, or parquet part spill "
             "(default follows FMRP_SPECGRID_SINK)",
    )
    parser.add_argument(
        "--specgrid-estimator", default=None, metavar="SPEC",
        help="run the spec-grid sweep (and the backtest) under an estimator cell instead "
             "of OLS@NW — grammar 'fwl:c1+c2[@se]' | 'absorb:fe1+fe2' | 'iv:endog~z1+z2' | "
             "'pooled[:se]' (default follows FMRP_SPECGRID_ESTIMATOR; Table 2 and the "
             "figure sweep keep rejecting non-OLS loudly)",
    )
    parser.add_argument(
        "--bootstrap", type=int, default=0, metavar="B",
        help="also build the bootstrap-SE table with B replicates",
    )
    parser.add_argument(
        "--backtest", action="store_true",
        help="also run the rolling-origin backtest sweep on the Gram bank (scheme × "
             "model × universe × weighting: OOS R², IC, quantile-portfolio spreads, "
             "turnover) and save backtest.csv",
    )
    parser.add_argument(
        "--backtest-schemes", default=None, metavar="LIST",
        help="comma list of estimation-path schemes, e.g. 'expanding,rolling120' "
             "(default follows FMRP_BACKTEST_SCHEMES)",
    )
    parser.add_argument(
        "--backtest-route", default=None, choices=list(BACKTEST_ROUTES),
        help="coefficient-path route: prefix-sum scan (auto/scan) or the per-origin "
             "full-refit differential oracle (default follows FMRP_BACKTEST_ROUTE)",
    )
    parser.add_argument(
        "--backtest-quantiles", type=int, default=None, metavar="D",
        help="portfolio sort buckets, >= 2 (default follows FMRP_BACKTEST_QUANTILES, "
             "normally 10)",
    )
    parser.add_argument(
        "--backtest-sink", default=None, choices=list(BACKTEST_SINK_NAMES),
        help="backtest streaming sink: full per-cell frame (default), "
             "top-k-by-|spread_tstat| leaderboard, running moments, parquet part "
             "spill, or the per-(scheme, weighting) metrics aggregate (default "
             "follows FMRP_BACKTEST_SINK)",
    )
    parser.add_argument(
        "--trace-dir", default=None,
        help="arm telemetry and export the run's host spans here: events.jsonl "
             "(structured event log) + trace.json (Chrome trace-event format, loads "
             "in Perfetto); default follows FMRP_TRACE_DIR",
    )
    parser.add_argument(
        "--profile-dir", default=None,
        help="also capture a torch.profiler trace of the run (CPU and, on the "
             "card, CUDA activities) into this directory as profile_trace.json; "
             "the stage spans name their intervals in it",
    )
    parser.add_argument(
        "--registry-dir", default=None,
        help="arm the registry at this root: the prepared-inputs slot, the kernel "
             "libraries and the fitted artifacts are fetched from (and published "
             "into) it, so a later process skips rebuilds; default follows "
             "FMRP_REGISTRY_DIR",
    )
    parser.add_argument(
        "--fleet-size", type=int, default=None, metavar="N",
        help="after the pipeline completes, stand up an N-replica serving fleet on "
             "the fitted serving state and run the admission-controlled query smoke; "
             "default follows FMRP_FLEET_SIZE when set (FMRP_FLEET_RATE/_BURST/"
             "_SHED_OCCUPANCY shape admission, FMRP_FLEET_JOURNAL arms the journal); "
             "a failed smoke exits nonzero",
    )
    parser.add_argument(
        "--replica-mode", choices=("thread", "process"), default=None,
        help="fleet smoke replica boundary: threads of this process or spawned "
             "child processes (each with its own CUDA context) behind the socket "
             "or shared-memory transport (FMRP_FLEET_TRANSPORT); default follows "
             "FMRP_FLEET_REPLICA_MODE (thread)",
    )
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="compute device (default cuda; raises without a "
                             "GPU); takes the place of the reference's --backend")
    args = parser.parse_args(argv)
    from fm_returnprediction_tpu_torch.parallel.distributed import initialize_distributed
    from fm_returnprediction_tpu_torch.parallel.multihost import initialize_multihost

    # join a multi-process run when FMRP_DIST_* is set (host exchange and
    # telemetry identity; torch.distributed too per FMRP_DIST_JAX), and the
    # torch.distributed group when FMRP_MULTIHOST=1; no-ops otherwise
    initialize_distributed()
    initialize_multihost()
    if not args.synthetic and (args.firms is not None or args.months is not None):
        parser.error("--firms/--months only apply with --synthetic")
    cfg = SyntheticConfig(
        n_firms=args.firms if args.firms is not None else 100,
        n_months=args.months if args.months is not None else 120,
    )
    result = run_pipeline(
        raw_data_dir=args.raw_data_dir,
        output_dir=args.output_dir,
        synthetic=args.synthetic,
        synthetic_config=cfg if args.synthetic else None,
        device=args.device,
        checkpoint_dir=args.checkpoint_dir,
        guard=False if args.no_guard else None,
        audit_dir=args.audit_dir,
        make_specgrid=(args.specgrid or args.specgrid_cells is not None
                       or args.specgrid_sink is not None
                       or args.specgrid_estimator is not None),
        specgrid_cells=args.specgrid_cells,
        specgrid_sink=args.specgrid_sink,
        specgrid_estimator=args.specgrid_estimator,
        make_bootstrap=args.bootstrap > 0,
        bootstrap_replicates=args.bootstrap or 10_000,
        make_backtest=(args.backtest or args.backtest_schemes is not None
                       or args.backtest_route is not None
                       or args.backtest_quantiles is not None
                       or args.backtest_sink is not None),
        backtest_schemes=args.backtest_schemes,
        backtest_route=args.backtest_route,
        backtest_quantiles=args.backtest_quantiles,
        backtest_sink=args.backtest_sink,
        trace_dir=args.trace_dir,
        profile_dir=args.profile_dir,
        registry_dir=args.registry_dir,
    )
    print(result.table_1.round(3).to_string())
    print()
    print(result.table_2.to_string())
    print()
    if result.specgrid_scenarios is not None:
        print(f"spec-grid scenarios: {len(result.specgrid_scenarios)} rows")
        print()
    if result.backtest_table is not None:
        print(f"backtest: {len(result.backtest_table)} rows")
        print()
    print(result.timer.report())
    fleet_size = args.fleet_size
    if fleet_size is None and os.environ.get("FMRP_FLEET_SIZE"):
        fleet_size = int(os.environ["FMRP_FLEET_SIZE"])
    if fleet_size:
        if result.serving_state is None:
            print("fleet smoke skipped: no serving state was built")
            return
        # unlike the reference, a failed smoke is not swallowed: the
        # exception ends the command with a nonzero exit
        from fm_returnprediction_tpu_torch.serving.fleet import fleet_smoke

        smoke = fleet_smoke(result.serving_state, fleet_size,
                            registry_dir=args.registry_dir,
                            replica_mode=args.replica_mode, device=args.device)
        print()
        print("serving fleet smoke: " + json.dumps(smoke, sort_keys=True))


if __name__ == "__main__":
    _main()
