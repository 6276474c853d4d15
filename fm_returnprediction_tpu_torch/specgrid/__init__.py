"""Spec-grid estimation of the port: Gram-contracted many-spec Fama-MacBeth.

- ``specs``     — declarative ``Spec``/``SpecGrid``, the Table 2 / Figure 1
  presets, ``product_grid`` and the ``route`` flag resolver.
- ``grams``     — the panel → Gram contraction (the CUDA kernel and its
  plain version; row weights, bf16 operands, the factorized route).
- ``solve``     — padded batched Gram solve, FM/NW aggregation and the QR
  referee, for one or several weight schemes.
- ``cellspace`` — the lazy, index-addressable scenario cell product and its
  fixed-width tiling.
- ``engine``    — the tile driver, streaming tile rows into sinks.
- ``sinks``     — full frame, top-k, running summary, parquet spill.
- ``coreset``   — the sampled-and-reweighted approximation route.
- ``boot``      — month-resampled FM aggregation for bootstrap draws.
- ``scenarios`` — the robustness sweep (subperiods, universes, winsor
  levels, NW weights, bootstrap draws) → one tidy frame, and its banked
  twin.
- ``grambank``  — the in-memory Gram bank: per-month stats of one panel
  answering window, bootstrap, scenario and estimator queries without the
  panel.
- ``estimators`` — the estimator family as a sweep dimension: FWL,
  absorbed fixed effects, IV/2SLS, pooled OLS with its sandwich SE
  families, the clustered FM tail, and the streaming block bootstrap.

- ``multiproc`` — the grid across worker processes (``FMRP_SPECGRID_PROCS``,
  ``run_spec_grid_weights(procs=)``): firm shards contracted by K2 in every
  worker, merged over the host exchange.
- ``sharded``   — the grid on a device mesh (``FMRP_SPECGRID_MESH``,
  ``run_spec_grid_weights(mesh=)``): firm-sharded contraction with K2 on
  every shard, spec-sharded solve.
"""

from fm_returnprediction_tpu_torch.specgrid.cellspace import (
    Cell,
    CellSpace,
    CellTile,
    scenario_space,
)
from fm_returnprediction_tpu_torch.specgrid.coreset import CoresetPlan, coreset_plan
from fm_returnprediction_tpu_torch.specgrid.engine import (
    block_bootstrap_months,
    run_cellspace,
)
from fm_returnprediction_tpu_torch.specgrid.estimators import (
    BANK_POOLED_SE,
    EST_OLS,
    ESTIMATOR_KINDS,
    FM_SE_FAMILIES,
    POOLED_SE_FAMILIES,
    Estimator,
    StreamingBootstrap,
    parse_estimator,
    resolve_estimator,
    run_estimator_grid_weights,
)
from fm_returnprediction_tpu_torch.specgrid.grambank import (
    GramBank,
    bank_key,
    bootstrap_query,
    build_bank,
    estimator_query,
    ingest_month,
    load_bank,
    save_bank,
    scenario_query,
    window_query,
)
from fm_returnprediction_tpu_torch.specgrid.grams import (
    SpecGramStats,
    auto_firm_chunk,
    contract_spec_grams,
)
from fm_returnprediction_tpu_torch.specgrid.scenarios import (
    bank_for_scenarios,
    run_scenarios,
    run_scenarios_banked,
    scenario_grid,
    subperiod_windows,
    winsor_variant,
)
from fm_returnprediction_tpu_torch.specgrid.sinks import (
    FrameSink,
    ParquetSink,
    Sink,
    SummarySink,
    TopKSink,
    resolve_sink,
)
from fm_returnprediction_tpu_torch.specgrid.sharded import (
    resolve_specgrid_mesh,
    sharded_grid_parts,
    specgrid_mesh,
)
from fm_returnprediction_tpu_torch.specgrid.solve import (
    SpecGridResult,
    run_spec_grid,
    run_spec_grid_on_panel,
    run_spec_grid_weights,
    solve_spec_stats,
)
from fm_returnprediction_tpu_torch.specgrid.specs import (
    Spec,
    SpecGrid,
    figure1_grid,
    product_grid,
    resolve_route,
    table2_grid,
)

__all__ = [
    "BANK_POOLED_SE",
    "Cell",
    "CellSpace",
    "CellTile",
    "CoresetPlan",
    "EST_OLS",
    "ESTIMATOR_KINDS",
    "Estimator",
    "FM_SE_FAMILIES",
    "FrameSink",
    "GramBank",
    "POOLED_SE_FAMILIES",
    "ParquetSink",
    "Sink",
    "Spec",
    "SpecGrid",
    "SpecGramStats",
    "SpecGridResult",
    "StreamingBootstrap",
    "SummarySink",
    "TopKSink",
    "auto_firm_chunk",
    "bank_for_scenarios",
    "bank_key",
    "block_bootstrap_months",
    "bootstrap_query",
    "build_bank",
    "contract_spec_grams",
    "coreset_plan",
    "estimator_query",
    "figure1_grid",
    "ingest_month",
    "load_bank",
    "parse_estimator",
    "product_grid",
    "resolve_estimator",
    "resolve_route",
    "resolve_sink",
    "resolve_specgrid_mesh",
    "run_cellspace",
    "run_estimator_grid_weights",
    "run_scenarios",
    "run_scenarios_banked",
    "run_spec_grid",
    "run_spec_grid_on_panel",
    "run_spec_grid_weights",
    "save_bank",
    "scenario_grid",
    "scenario_query",
    "scenario_space",
    "sharded_grid_parts",
    "solve_spec_stats",
    "specgrid_mesh",
    "subperiod_windows",
    "table2_grid",
    "window_query",
    "winsor_variant",
]
