"""The Lewellen pipeline as a task graph, on the port's modules.

The reference package's DAG (config → pull → panel checkpoint → reports,
serving state, sweeps) with the dense-panel checkpoint between the
panel build and the stages that read it, so each reads the panel from disk
instead of rebuilding it.

Stages (task name → targets):

- ``config``      → the ``_data``/``_output`` directory tree
  (``settings.create_dirs``), or the three directories the DAG was given
- ``pull_data``   → the five raw parquet files (WRDS when credentials are
  configured, the synthetic universe with ``synthetic=True``)
- ``build_panel`` → ``lewellen_panel.npz`` + ``factors_dict.json`` in the
  processed directory (the checkpoint; ``DensePanel.save``); launches K1
  (the characteristics' rolling reductions and the daily strips)
- ``reports``     → Table 1/2 pickles + ``.tex`` + ``figure_1.pdf`` +
  the decile table + ``data_saved.marker`` in the output directory;
  launches K2 (Table 2's and the figure grid's Gram contractions) and K1;
  drawing the figure needs matplotlib, and raises without it
- ``serve_state`` → ``serving_state.npz`` in the processed directory, the
  online-serving state, warmed once on the device, rebuilt only when the
  panel checkpoint changes
- ``specgrid``    → ``specgrid_scenarios.csv``, the scenario sweep
  (``specgrid.run_scenarios``; K2)
- ``backtest``    → ``backtest.csv``, the rolling-origin backtest sweep on
  the Gram bank (``backtest.run_backtest_scenarios``; K2)
- ``latex``       → the compiled report PDF (``pdflatex`` where it exists)
- ``parity``      → ``parity_report.csv``: real caches' Table 1 against the
  published table (not in a synthetic DAG)

Every compute task runs on ``device`` (``None`` = the GPU; raises without
one). Run: ``python -m fm_returnprediction_tpu_torch.taskgraph [task ...]``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Optional

from fm_returnprediction_tpu_torch.settings import config, create_dirs
from fm_returnprediction_tpu_torch.taskgraph.engine import Task, process_route

__all__ = [
    "build_tasks", "build_notebook_tasks",
    "PANEL_FILE", "FACTORS_FILE", "SERVING_FILE", "SPECGRID_FILE",
    "BACKTEST_FILE", "BACKEND_MARKER",
]

PANEL_FILE = "lewellen_panel.npz"
FACTORS_FILE = "factors_dict.json"
SERVING_FILE = "serving_state.npz"
SPECGRID_FILE = "specgrid_scenarios.csv"
BACKTEST_FILE = "backtest.csv"
BACKEND_MARKER = "_data_backend.txt"


def _raw_paths(raw_dir: Path) -> List[Path]:
    from fm_returnprediction_tpu_torch.pipeline import RAW_FILE_NAMES

    return [raw_dir / name for name in RAW_FILE_NAMES.values()]


def _is_primary() -> bool:
    """True on process 0 (or in a run of one process). Across processes
    every task runs on every process (compute is replicated), but only one
    may write the shared-filesystem artifacts (concurrent npz writes
    tear)."""
    route = process_route()
    if route == "exchange":
        from fm_returnprediction_tpu_torch.parallel import distributed as _dist

        return _dist.process_index() == 0
    if route == "torch":
        import torch.distributed as _tdist

        return _tdist.get_rank() == 0
    return True


def _sync_processes(tag: str) -> None:
    """Barrier after a primary-only write, so other processes cannot read a
    half-written artifact in the next task; nothing in a run of one
    process. The host exchange checks the tag, so a divergence of program
    order raises instead of hanging."""
    route = process_route()
    if route == "exchange":
        from fm_returnprediction_tpu_torch.parallel import distributed as _dist

        _dist.host_exchange().barrier(tag)
    elif route == "torch":
        import torch.distributed as _tdist

        _tdist.barrier()


def _primary_writes(tag: str, fn) -> None:
    """Run ``fn`` on process 0, then barrier everyone.

    The primary's exception is re-raised AFTER the barrier: raising before
    it would leave the other processes blocked in the barrier forever (a
    failed WRDS pull must fail the run, not deadlock it). Non-primaries
    then fail fast downstream on the missing artifact."""
    err = None
    if _is_primary():
        try:
            fn()
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            err = exc
    _sync_processes(tag)
    if err is not None:
        raise err


def _backend_name(synthetic: bool) -> str:
    return "synthetic" if synthetic else "wrds"


def _backend_matches(raw_dir: Path, synthetic: bool) -> bool:
    """Uptodate check: the cached raw data must come from the requested
    backend — without this, toggling ``--synthetic`` would silently reuse
    the other backend's parquet (targets exist, hashes unchanged)."""
    marker = raw_dir / BACKEND_MARKER
    return marker.exists() and marker.read_text().strip() == _backend_name(synthetic)


def _make_dirs(dirs, settings_tree: bool) -> None:
    """The ``config`` action: the directories the DAG was built on, and the
    settings' whole tree (``settings.create_dirs``) when they are its."""
    if settings_tree:
        create_dirs()
    for d in dirs:
        Path(d).mkdir(parents=True, exist_ok=True)


def _pull_data(raw_dir: Path, synthetic: bool, synthetic_config=None) -> None:
    """Process 0 writes the raw caches (one WRDS pull, no torn parquet);
    everyone barriers before ``build_panel`` reads them."""
    _primary_writes(
        "pull_data_saved",
        lambda: _pull_data_primary(raw_dir, synthetic, synthetic_config),
    )


def _pull_data_primary(raw_dir: Path, synthetic: bool, synthetic_config=None) -> None:
    from fm_returnprediction_tpu_torch.utils.cache import save_cache_data

    raw_dir.mkdir(parents=True, exist_ok=True)
    (raw_dir / BACKEND_MARKER).write_text(_backend_name(synthetic))
    if synthetic:
        from fm_returnprediction_tpu_torch.data.synthetic import generate_synthetic_wrds
        from fm_returnprediction_tpu_torch.pipeline import RAW_FILE_NAMES

        data = generate_synthetic_wrds(synthetic_config)
        for key, name in RAW_FILE_NAMES.items():
            save_cache_data(data[key], raw_dir, file_name=name)
        return

    from fm_returnprediction_tpu_torch.data.wrds_pull import (
        pull_Compustat,
        pull_CRSP_Comp_link_table,
        pull_CRSP_index,
        pull_CRSP_stock,
    )

    user = config("WRDS_USERNAME")
    start, end = config("START_DATE"), config("END_DATE")
    pull_CRSP_stock(freq="D", start_date=start, end_date=end, wrds_username=user,
                    data_dir=raw_dir, file_name="CRSP_stock_d.parquet")
    pull_CRSP_stock(freq="M", start_date=start, end_date=end, wrds_username=user,
                    data_dir=raw_dir, file_name="CRSP_stock_m.parquet")
    pull_Compustat(start_date=start, end_date=end, wrds_username=user,
                   data_dir=raw_dir, file_name="Compustat_fund.parquet")
    pull_CRSP_Comp_link_table(wrds_username=user, data_dir=raw_dir,
                              file_name="CRSP_Comp_Link_Table.parquet")
    pull_CRSP_index(freq="D", start_date=start, end_date=end, wrds_username=user,
                    data_dir=raw_dir, file_name="CRSP_index_d.parquet")


def _guard_panel(panel, context: str, expect_dtype: bool = False) -> None:
    """Stage-boundary panel contract (gated on ``FMRP_GUARD``): a
    fail-severity violation raises the typed ``ContractViolationError``,
    which the engine records like any other task failure.

    ``expect_dtype`` pins the configured compute dtype, only at BUILD time
    (a checkpoint may predate a dtype reconfiguration; the tasks that read
    it check structure, not provenance)."""
    from fm_returnprediction_tpu_torch.guard import checks, contracts

    if not checks.guard_active():
        return
    dtype = None
    if expect_dtype:
        from fm_returnprediction_tpu_torch.pipeline import resolve_dtype

        dtype = resolve_dtype()
    contracts.check_panel(panel, dtype=dtype, context=context)


def _load_panel(processed_dir: Path, device, context: str):
    """The panel checkpoint on ``device``, through its contract."""
    from fm_returnprediction_tpu_torch.panel.dense import DensePanel

    panel = DensePanel.load(processed_dir / PANEL_FILE, device=device)
    # the CONTRACT catches the semantic corruptions a file cannot (the
    # file faithfully stores duplicated permnos too)
    _guard_panel(panel, context)
    return panel


def _factors(processed_dir: Path) -> dict:
    with open(processed_dir / FACTORS_FILE) as f:
        return json.load(f)


def _build_panel(raw_dir: Path, processed_dir: Path, device) -> None:
    from fm_returnprediction_tpu_torch.pipeline import load_or_build_panel
    from fm_returnprediction_tpu_torch.utils.timing import trace

    # FMRP_TRACE=<dir> wraps the compute tasks in a torch.profiler capture.
    # load_or_build_panel goes through the prepared-inputs slot, so a rerun
    # whose task state was invalidated but whose raw files are unchanged
    # still skips the host ingest; the dtype resolves inside it.
    with trace(os.environ.get("FMRP_TRACE"), device=device):
        panel, factors_dict = load_or_build_panel(raw_dir, device=device)
    # contract boundary BEFORE the checkpoint write: a corrupted panel must
    # not become the trusted artifact every downstream task consumes
    _guard_panel(panel, "build_panel", expect_dtype=True)

    def save():
        panel.save(processed_dir / PANEL_FILE)
        with open(processed_dir / FACTORS_FILE, "w") as f:
            json.dump(factors_dict, f, indent=2)

    _primary_writes("build_panel_saved", save)


def _reports(processed_dir: Path, output_dir: Path, device) -> None:
    from fm_returnprediction_tpu_torch.utils.timing import trace

    with trace(os.environ.get("FMRP_TRACE"), device=device):
        _reports_traced(processed_dir, output_dir, device)


def _reports_traced(processed_dir: Path, output_dir: Path, device) -> None:
    from fm_returnprediction_tpu_torch.guard import checks as _guard_checks
    from fm_returnprediction_tpu_torch.guard import contracts as _contracts
    from fm_returnprediction_tpu_torch.panel.subsets import compute_subset_masks
    from fm_returnprediction_tpu_torch.parallel.mesh import pipeline_mesh
    from fm_returnprediction_tpu_torch.reporting.deciles import (
        build_decile_table,
        save_decile_table,
    )
    from fm_returnprediction_tpu_torch.reporting.figure1 import create_figure_1, subset_sweep
    from fm_returnprediction_tpu_torch.reporting.latex import save_data
    from fm_returnprediction_tpu_torch.reporting.table1 import build_table_1
    from fm_returnprediction_tpu_torch.reporting.table2 import build_table_2

    panel = _load_panel(processed_dir, device, "reports")
    factors_dict = _factors(processed_dir)
    masks = compute_subset_masks(panel)
    table_1 = build_table_1(panel, masks, factors_dict)
    # the mesh policy of run_pipeline: the months x firms hierarchy across
    # processes, MESH_DEVICES in one
    table_2 = build_table_2(panel, masks, factors_dict,
                            mesh=pipeline_mesh(device=panel.values.device.type))
    if _guard_checks.guard_active():
        _contracts.check_frame(table_1, "table_1")
        _contracts.check_frame(table_2, "table_2")
    # one sweep for the figure and the decile table, as run_pipeline's
    sweep = subset_sweep(panel, masks, list(masks))
    figure_1 = create_figure_1(panel, masks, cs_cache=sweep)
    decile_table = build_decile_table(panel, masks, cs_cache=sweep)

    def save():  # tables computed everywhere, written once
        import matplotlib.pyplot as plt

        save_data(table_1, table_2, figure_1, output_dir)
        plt.close(figure_1[0])
        save_decile_table(decile_table, output_dir)

    _primary_writes("reports_saved", save)


def _serve_state(processed_dir: Path, device) -> None:
    """Build the online-serving state from the panel checkpoint and warm it
    once on the device (every bucket captured, then released), so a state
    that cannot serve fails the task rather than the first service."""
    from fm_returnprediction_tpu_torch.guard import checks as _guard_checks
    from fm_returnprediction_tpu_torch.guard import contracts as _contracts
    from fm_returnprediction_tpu_torch.panel.subsets import compute_subset_masks
    from fm_returnprediction_tpu_torch.serving.executor import BucketedExecutor
    from fm_returnprediction_tpu_torch.serving.state import build_serving_state_from_panel

    panel = _load_panel(processed_dir, device, "serve_state")
    masks = compute_subset_masks(panel)
    state = build_serving_state_from_panel(panel, masks["All stocks"])
    if _guard_checks.guard_active():
        # fail the TASK (typed, ledgered, keep_going-compatible) rather
        # than persist a state the service would have to quarantine
        _contracts.enforce(
            _contracts.evaluate(_contracts.serving_state_rules(), state),
            context="serve_state",
        )
    executor = BucketedExecutor(state, device=panel.values.device)
    executor.warmup()
    executor.release()

    def _save() -> None:
        state.save(processed_dir / SERVING_FILE)
        from fm_returnprediction_tpu_torch.registry import artifacts as _rart
        from fm_returnprediction_tpu_torch.registry.store import active_registry

        if active_registry() is not None:
            # artifact-plane publish, keyed by the panel checkpoint's
            # content hash: the entry answers "the state FOR this panel".
            # The npz just saved is registered as it is.
            fp = _panel_content_fp(processed_dir / PANEL_FILE)
            _rart.put_files(
                _rart.SERVING_STATE_NAME, fp,
                [processed_dir / SERVING_FILE],
                meta={"n_months": int(state.n_months),
                      "n_predictors": int(state.n_predictors)},
            )

    _primary_writes("serve_state_saved", _save)


# (path, size, mtime_ns) → sha256[:32] of the panel checkpoint: the
# serve_state uptodate check and the publish both need the same content
# fingerprint, and the file is hundreds of MB at real shape — one hash
# per (file state, process), not one per consumer
_PANEL_FP_MEMO: dict = {}


def _panel_content_fp(panel: Path) -> str:
    from fm_returnprediction_tpu_torch.registry.integrity import file_sha256

    st = panel.stat()
    key = (str(panel), st.st_size, st.st_mtime_ns)
    hit = _PANEL_FP_MEMO.get(key)
    if hit is None:
        hit = file_sha256(panel)[:32]
        _PANEL_FP_MEMO.clear()  # one live panel per process is the shape
        _PANEL_FP_MEMO[key] = hit
    return hit


def _serve_state_registry_current(processed_dir: Path) -> bool:
    """``uptodate`` part of the serve_state task: with the registry armed,
    the task's targets also include the artifact-plane serving-state entry
    for the CURRENT panel checkpoint, so ``--registry-dir`` on an
    up-to-date DAG publishes instead of silently doing nothing. Registry
    off, or no panel checkpoint (the file_dep machinery owns that case):
    current."""
    from fm_returnprediction_tpu_torch.registry import artifacts as _rart
    from fm_returnprediction_tpu_torch.registry.store import active_registry

    reg = active_registry()
    panel = processed_dir / PANEL_FILE
    if reg is None or not panel.exists():
        return True
    return _rart.get_entry_dir(
        _rart.SERVING_STATE_NAME, _panel_content_fp(panel), registry=reg
    ) is not None


SPECGRID_KNOBS_FILE = "specgrid_scenarios.knobs.json"


def _specgrid_effective_knobs(cells: Optional[int], sink: Optional[str],
                              estimator: Optional[str] = None) -> dict:
    """The knobs that shape the artifact: the cell count, the RESOLVED sink
    (argument or ``FMRP_SPECGRID_SINK``) and the RESOLVED estimator cell
    (argument or ``FMRP_SPECGRID_ESTIMATOR``: a partialled/absorbed/IV
    frame must never be served as an OLS one). The tile width is not one:
    tiling is bit-identical on the frame."""
    from fm_returnprediction_tpu_torch.specgrid.estimators import resolve_estimator
    from fm_returnprediction_tpu_torch.specgrid.sinks import resolve_sink_name

    est = resolve_estimator(estimator)
    return {"cells": cells, "sink": resolve_sink_name(sink),
            "estimator": f"{est.label}@{est.se}"}


def _specgrid_knobs_unchanged(output_dir: Path, cells: Optional[int], sink: Optional[str],
                              estimator: Optional[str] = None) -> bool:
    """``uptodate`` check: the cached CSV counts as current only when the
    knobs it was BUILT under (the sidecar ``_specgrid`` writes) match this
    invocation's, so a knob change in either direction re-runs. A missing
    sidecar reads as a default-knob build."""
    want = _specgrid_effective_knobs(cells, sink, estimator)
    try:
        with open(Path(output_dir) / SPECGRID_KNOBS_FILE) as f:
            have = json.load(f)
    except (OSError, ValueError):
        have = {"cells": None, "sink": "frame"}
    have.setdefault("estimator", "ols@nw")
    return have == want


def _specgrid(processed_dir: Path, output_dir: Path, device,
              cells: Optional[int] = None,
              sink: Optional[str] = None,
              estimator: Optional[str] = None) -> None:
    """Panel checkpoint → the scenario sweep's CSV (subperiod halves × the
    three universes × the models, on the Gram tile engine). ``cells``
    scales the sweep by bootstrap draws, ``sink`` picks the streaming
    aggregation, ``estimator`` (the ``--specgrid-estimator`` grammar) runs
    the cells under an estimator other than OLS@NW. Compute is replicated
    on every process; only the primary writes."""
    from fm_returnprediction_tpu_torch.guard import checks as _guard_checks
    from fm_returnprediction_tpu_torch.guard import contracts as _contracts
    from fm_returnprediction_tpu_torch.panel.subsets import compute_subset_masks
    from fm_returnprediction_tpu_torch.specgrid.estimators import resolve_estimator
    from fm_returnprediction_tpu_torch.specgrid.scenarios import run_scenarios
    from fm_returnprediction_tpu_torch.specgrid.sinks import resolve_sink_name

    panel = _load_panel(processed_dir, device, "specgrid")
    factors_dict = _factors(processed_dir)
    masks = compute_subset_masks(panel)
    est = resolve_estimator(estimator)
    estimators = None if (est.kind == "ols" and est.se == "nw") else (est,)
    frame = run_scenarios(panel, masks, factors_dict, cells=cells, sink=sink,
                          output_dir=output_dir, estimators=estimators)
    if _guard_checks.guard_active() and resolve_sink_name(sink) == "frame":
        # the other sinks emit their own schema (leaderboard, moment table,
        # part manifest): only the tidy frame carries the contract
        _contracts.check_frame(frame, "specgrid_scenarios")
    output_dir.mkdir(parents=True, exist_ok=True)

    def _save() -> None:
        frame.to_csv(output_dir / SPECGRID_FILE, index=False)
        # sidecar: the knobs this artifact was built under
        with open(output_dir / SPECGRID_KNOBS_FILE, "w") as f:
            json.dump(_specgrid_effective_knobs(cells, sink, estimator), f)

    _primary_writes("specgrid_saved", _save)


BACKTEST_KNOBS_FILE = "backtest.knobs.json"


def _backtest_effective_knobs(schemes: Optional[str], route: Optional[str],
                              quantiles: Optional[int], sink: Optional[str]) -> dict:
    """The knobs that shape the backtest artifact, resolved as the sweep
    resolves them (argument > ``FMRP_BACKTEST_*`` > default). The tile
    width is not one (tiling is bit-identical)."""
    from fm_returnprediction_tpu_torch.backtest.paths import (
        resolve_backtest_route,
        resolve_quantiles,
        resolve_schemes,
    )
    from fm_returnprediction_tpu_torch.backtest.sinks import resolve_backtest_sink_name

    return {
        "schemes": [name for name, _ in resolve_schemes(schemes)],
        "route": resolve_backtest_route(route),
        "quantiles": resolve_quantiles(quantiles),
        "sink": resolve_backtest_sink_name(sink),
    }


def _default_backtest_knobs() -> dict:
    """What an artifact without a sidecar is taken to be: built under the
    library defaults, not under whatever the environment says now."""
    from fm_returnprediction_tpu_torch.backtest.paths import DEFAULT_QUANTILES, DEFAULT_SCHEMES

    return {
        "schemes": [s.strip() for s in DEFAULT_SCHEMES.split(",")],
        "route": "auto",
        "quantiles": DEFAULT_QUANTILES,
        "sink": "frame",
    }


def _backtest_knobs_unchanged(output_dir: Path, schemes: Optional[str], route: Optional[str],
                              quantiles: Optional[int], sink: Optional[str]) -> bool:
    """``uptodate`` check (the specgrid sidecar pattern)."""
    want = _backtest_effective_knobs(schemes, route, quantiles, sink)
    try:
        with open(Path(output_dir) / BACKTEST_KNOBS_FILE) as f:
            have = json.load(f)
    except (OSError, ValueError):
        have = _default_backtest_knobs()
    return have == want


def _backtest(processed_dir: Path, output_dir: Path, device,
              schemes: Optional[str] = None,
              route: Optional[str] = None,
              quantiles: Optional[int] = None,
              sink: Optional[str] = None) -> None:
    """Panel checkpoint → the rolling-origin backtest sweep's CSV: the
    scenario panel contracted once into a Gram bank, then the scheme ×
    model × universe × weighting product answered from it. Compute is
    replicated on every process; only the primary writes."""
    from fm_returnprediction_tpu_torch.backtest import run_backtest_scenarios
    from fm_returnprediction_tpu_torch.backtest.sinks import resolve_backtest_sink_name
    from fm_returnprediction_tpu_torch.guard import checks as _guard_checks
    from fm_returnprediction_tpu_torch.guard import contracts as _contracts
    from fm_returnprediction_tpu_torch.panel.subsets import compute_subset_masks

    panel = _load_panel(processed_dir, device, "backtest")
    factors_dict = _factors(processed_dir)
    masks = compute_subset_masks(panel)
    frame = run_backtest_scenarios(
        panel, masks, factors_dict, schemes=schemes, route=route,
        n_quantiles=quantiles, sink=sink, output_dir=output_dir,
        device=panel.values.device,
    )
    if _guard_checks.guard_active() and resolve_backtest_sink_name(sink) == "frame":
        _contracts.enforce(
            _contracts.evaluate(_contracts.backtest_rules(), frame),
            context="backtest",
        )
    output_dir.mkdir(parents=True, exist_ok=True)

    def _save() -> None:
        frame.to_csv(output_dir / BACKTEST_FILE, index=False)
        # sidecar: the knobs this artifact was built under
        with open(output_dir / BACKTEST_KNOBS_FILE, "w") as f:
            json.dump(_backtest_effective_knobs(schemes, route, quantiles, sink), f)

    _primary_writes("backtest_saved", _save)


def _parity(raw_dir: Path, output_dir: Path, device) -> None:
    """Real-cache Table 1 against the published table; records the full
    diff, then raises on any cell out of tolerance."""
    from fm_returnprediction_tpu_torch.reporting.published import run_parity_check

    output_dir.mkdir(parents=True, exist_ok=True)
    diff = run_parity_check(raw_dir, strict=False, device=device)
    # diff computed everywhere, report written once
    _primary_writes(
        "parity_saved",
        lambda: diff.to_csv(output_dir / "parity_report.csv", index=False),
    )
    bad = diff[~diff["ok"]]
    if len(bad):
        raise AssertionError(
            f"Table 1 parity failed on {len(bad)} of {len(diff)} cells "
            f"(see {output_dir / 'parity_report.csv'}):\n"
            + bad.to_string(index=False)
        )


def _latex(output_dir: Path) -> None:
    from fm_returnprediction_tpu_torch.reporting.latex import (
        compile_latex_document,
        create_latex_document,
    )

    if not _is_primary():  # one pdflatex, not one per process
        return
    tex = create_latex_document(output_dir)
    if tex is not None:
        compile_latex_document(tex)


def build_tasks(
    synthetic: bool = False,
    synthetic_config=None,
    raw_dir: Optional[Path] = None,
    processed_dir: Optional[Path] = None,
    output_dir: Optional[Path] = None,
    specgrid_cells: Optional[int] = None,
    specgrid_sink: Optional[str] = None,
    specgrid_estimator: Optional[str] = None,
    backtest_schemes: Optional[str] = None,
    backtest_route: Optional[str] = None,
    backtest_quantiles: Optional[int] = None,
    backtest_sink: Optional[str] = None,
    device=None,
) -> List[Task]:
    """Assemble the DAG against the given directories (default the
    settings' tree), its compute tasks on ``device`` (``None`` = the GPU,
    resolved when a task runs)."""
    settings_tree = raw_dir is None and processed_dir is None and output_dir is None
    raw_dir = Path(raw_dir or config("RAW_DATA_DIR"))
    processed_dir = Path(processed_dir or config("PROCESSED_DATA_DIR"))
    output_dir = Path(output_dir or config("OUTPUT_DIR"))
    raw = _raw_paths(raw_dir)
    dirs = (raw_dir, processed_dir, output_dir)

    return [
        Task(
            name="config",
            actions=[lambda: _make_dirs(dirs, settings_tree)],
            targets=list(dirs),
            doc="Create the _data/_output directory tree",
        ),
        Task(
            name="pull_data",
            actions=[lambda: _pull_data(raw_dir, synthetic, synthetic_config)],
            targets=raw,
            task_dep=["config"],
            uptodate=[lambda: _backend_matches(raw_dir, synthetic)],
            doc="Pull WRDS data (or generate the synthetic universe)",
        ),
        Task(
            name="build_panel",
            actions=[lambda: _build_panel(raw_dir, processed_dir, device)],
            file_dep=raw,
            targets=[processed_dir / PANEL_FILE, processed_dir / FACTORS_FILE],
            task_dep=["pull_data"],
            doc="Raw parquet → dense characteristic panel checkpoint",
        ),
        Task(
            name="reports",
            actions=[lambda: _reports(processed_dir, output_dir, device)],
            file_dep=[processed_dir / PANEL_FILE, processed_dir / FACTORS_FILE],
            targets=[
                output_dir / "table_1.pkl",
                output_dir / "table_2.pkl",
                output_dir / "figure_1.pdf",
                output_dir / "decile_sorts.pkl",
                output_dir / "data_saved.marker",
            ],
            task_dep=["build_panel"],
            doc="Panel checkpoint → Table 1/2, Figure 1, artifacts",
        ),
        Task(
            name="serve_state",
            actions=[lambda: _serve_state(processed_dir, device)],
            # the one fitted artifact it reads: a factors-only refresh must
            # not rebuild the state
            file_dep=[processed_dir / PANEL_FILE],
            targets=[processed_dir / SERVING_FILE],
            task_dep=["build_panel"],
            # an armed registry missing this panel's serving-state entry
            # re-runs the task (publish)
            uptodate=[lambda: _serve_state_registry_current(processed_dir)],
            doc="Panel checkpoint → warmed online-serving state",
        ),
        Task(
            name="specgrid",
            actions=[lambda: _specgrid(processed_dir, output_dir, device,
                                       cells=specgrid_cells, sink=specgrid_sink,
                                       estimator=specgrid_estimator)],
            # reads only the panel checkpoint: a reports-only refresh must
            # not re-run the sweep
            file_dep=[processed_dir / PANEL_FILE, processed_dir / FACTORS_FILE],
            targets=[output_dir / SPECGRID_FILE],
            task_dep=["build_panel"],
            # current only when built under this invocation's knobs
            uptodate=[lambda: _specgrid_knobs_unchanged(
                output_dir, specgrid_cells, specgrid_sink, specgrid_estimator)],
            doc="Panel checkpoint → Gram spec-grid robustness sweep CSV",
        ),
        Task(
            name="backtest",
            actions=[lambda: _backtest(processed_dir, output_dir, device,
                                       schemes=backtest_schemes, route=backtest_route,
                                       quantiles=backtest_quantiles, sink=backtest_sink)],
            file_dep=[processed_dir / PANEL_FILE, processed_dir / FACTORS_FILE],
            targets=[output_dir / BACKTEST_FILE],
            task_dep=["build_panel"],
            uptodate=[lambda: _backtest_knobs_unchanged(
                output_dir, backtest_schemes, backtest_route, backtest_quantiles,
                backtest_sink)],
            doc="Panel checkpoint → rolling-origin backtest sweep CSV",
        ),
        Task(
            name="latex",
            actions=[lambda: _latex(output_dir)],
            file_dep=[output_dir / "table_1.pkl", output_dir / "table_2.pkl"],
            task_dep=["reports"],
            doc="Generate + compile the LaTeX report",
        ),
    ] + (
        [] if synthetic else [
            Task(
                name="parity",
                actions=[lambda: _parity(raw_dir, output_dir, device)],
                file_dep=raw,
                targets=[output_dir / "parity_report.csv"],
                task_dep=["pull_data"],
                doc="Assert Table 1 parity against the published Lewellen table",
            ),
        ]
    )


def _notebook_paths(notebooks_dir: Path) -> List[Path]:
    """The driver notebooks of a directory."""
    return sorted(Path(notebooks_dir).glob("*.ipynb"))


def build_notebook_tasks(
    notebooks_dir: Optional[Path] = None,
    output_dir: Optional[Path] = None,
    docs_dir: Optional[Path] = None,
) -> List[Task]:
    """Notebook conversion/execution tasks, gated on nbconvert being
    importable (an empty list without it, or without notebooks):

    - ``convert_notebooks``: each notebook → a cleared ``.py`` script under
      ``<output_dir>/notebooks`` (the change-detection artifact);
    - ``run_notebooks``: execute each to HTML in ``output_dir``, copied
      into ``docs_dir`` (default ``docs/notebooks``);
    - ``docs_site``: the static site (``docs_site.build_docs_site``), where
      ``markdown`` imports.
    """
    try:
        import nbconvert  # noqa: F401
    except ImportError:  # pragma: no cover - environment-dependent
        return []

    notebooks_dir = Path(notebooks_dir or config("BASE_DIR") / "notebooks")
    output_dir = Path(output_dir or config("OUTPUT_DIR"))
    docs_dir = Path(docs_dir or config("BASE_DIR") / "docs" / "notebooks")
    notebooks = _notebook_paths(notebooks_dir)
    if not notebooks:
        return []

    script_dir = output_dir / "notebooks"
    scripts = [script_dir / f"{nb.stem}.py" for nb in notebooks]
    html = [output_dir / f"{nb.stem}.html" for nb in notebooks]

    import shlex

    q = shlex.quote
    convert_cmds = [
        f"jupyter nbconvert --to script --output-dir {q(str(script_dir))} {q(str(nb))}"
        for nb in notebooks
    ]
    run_cmds = [
        f"jupyter nbconvert --execute --to html --output-dir {q(str(output_dir))} {q(str(nb))}"
        for nb in notebooks
    ]

    def _copy_docs() -> None:
        import shutil

        docs_dir.mkdir(parents=True, exist_ok=True)
        for page in html:
            if page.exists():
                shutil.copy2(page, docs_dir / page.name)

    def _build_site() -> None:
        from fm_returnprediction_tpu_torch.taskgraph.docs_site import build_docs_site

        base = Path(config("BASE_DIR"))
        build_docs_site(base, base / "docs" / "site")

    base_dir = Path(config("BASE_DIR"))
    site_sources = [p for p in [base_dir / "README.md"] if p.is_file()]
    site_sources += sorted((base_dir / "docs").glob("*.md"))
    try:
        import markdown  # noqa: F401

        have_markdown = True
    except ImportError:  # pragma: no cover - environment-dependent
        have_markdown = False

    tasks = [
        Task(
            name="convert_notebooks",
            actions=convert_cmds,
            file_dep=notebooks,
            targets=scripts,
            doc="Notebooks → cleared scripts (change detection)",
        ),
        Task(
            name="run_notebooks",
            # depend on the CLEARED scripts, not the raw .ipynb: output and
            # metadata churn in a notebook must not re-trigger execution
            actions=run_cmds + [_copy_docs],
            file_dep=scripts,
            targets=html,
            task_dep=["convert_notebooks"],
            doc="Execute driver notebooks, render HTML into docs",
        ),
    ]
    if have_markdown:  # no site task where the renderer is absent
        tasks.append(
            Task(
                name="docs_site",
                actions=[_build_site],
                # the rendered sources too: an edited README rebuilds the site
                file_dep=html + site_sources,
                targets=[base_dir / "docs" / "site" / "index.html"],
                task_dep=["run_notebooks"],
                doc="Render markdown docs + notebook HTML into a static site",
            )
        )
    return tasks
