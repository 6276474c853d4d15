#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to their
plain PyTorch versions.

    python3 chip_smoke.py            # full run: build, kernel phases, main
                                     # path at real size, card-vs-CPU check
    python3 chip_smoke.py --kernels-only --ptxas   # build (nvcc's
                                     # register report, the SASS HMMA and
                                     # DMMA count of each Gram kernel) + one
                                     # checked launch per kernel, no timing

Phases (any failure exits non-zero without the final line):

1. the card's name and power limit (``nvidia-smi``), torch/CUDA versions,
   and ``torch.backends.cuda.matmul.allow_tf32`` (must be False);
2. build every kernel from ``fm_returnprediction_tpu_torch/csrc``;
3. each kernel against its plain version at the main path's shapes, float32
   and float64, with the tolerance printed beside the error, then CUDA-event
   timings of kernel, plain version and (where one exists) a library call;
   K2 also with coreset row weights (float32, float64, and 0/1 weights with
   exact counts), bfloat16 operands on the tensor cores (float32 sums, at
   Table 2's and the figure grid's shapes, with and without row weights:
   exact counts, two calls bit-identical, and the whole bf16
   ``contract_spec_grams`` call from float32 inputs timed), a 117-spec
   batch cut into two launches, and the estimator family's shapes (27 specs
   in one launch, with and without row weights; Table 2's in float64); past
   32 columns P = 40, 64 and 100 on every branch, each side of the reach of
   one launch of the wide kernels (424 float64 columns, 848 float32, 1,367
   bfloat16; 847 and 622 with row weights) and of the tile-pair kernel's
   crossover (``GRAM_TILE_FROM``; 921 columns, no 16-byte row stride), and
   the 920-column union (T = 60, N = 22,000, 3 specs) on every branch:
   every branch on the tile-pair kernel (bfloat16 also with coreset row
   weights, untimed; float32 also at 921 columns, untimed), with the
   pre-pass (``gram_fold_cuda``) timed beside them;
4. the main path at real size — 600 months, 22,000 firms, ~77M daily rows
   built from ``--seed`` by ``data.smoke_inputs`` — through
   ``run_pipeline(device="cuda", dtype=torch.float32)`` and all of its
   stages (characteristics, universes, Table 1, Table 2, the figure/decile
   sweep, Figure 1's rolling slopes, the decile table, the serving state),
   three times, with every kernel launch counter set to 0 just before each
   run and read just after: guarded with the drift sentinel armed (empty
   violations, counters only for conditioning), unguarded (every artifact
   bit-identical, the same launches: K1 17, K2 2, K3 0), and guarded again
   on the same audit directory (the drift check passes by sha);
4b. the online service over the first run's serving state
   (``serving_phase``): ``ERService(device="cuda", max_batch=256)`` warms
   one CUDA graph per bucket (9 captures, nothing built after); every
   universe row with a realized return of the last 12 months is quoted
   through ``submit_many`` in seeded mixed batch sizes (1..256) and through
   ``query_many``, held against the run's batch forecast
   (``rolling_er_forecast``) with the NaN pattern exact and
   ``|serve − batch| ≤ 8·eps32·(|ā| + Σ|x b̄|)``; the real rows bit-equal
   across every bucket and between graph replay and eager dispatch; p50/p99
   latency, qps, and each bucket's graph against eager dispatch time;
4c. tracing and profiling the main path (``trace_phase``,
   ``profile_phase``): ``run_pipeline(trace_dir=)`` against an untraced
   run (artifacts bit-identical, launches equal, ``events.jsonl`` and
   ``trace.json`` parse, a span for every stage; both walls), and
   ``run_pipeline(profile_dir=)``: the ``torch.profiler`` trace's kernel
   rows carry K1's and K2's names with the counters' launch counts, and the
   card's busy share inside ``factors/daily_kernels`` (and three other
   intervals) is read from it;
5. the same inputs through the prepared-inputs slot at real size:
   ``save_prepared``, the memory-mapped ``load_prepared`` (and one load with
   ``FMRP_PREPARED_VERIFY=1``), timed, then the main path from the mapped
   arrays with the registry armed (``registry_dir=``): bit-identical to the
   in-memory unarmed run, launches K1 17, K2 2, K3 0; the
   ``registry_publish`` stage's seconds, the published serving state's
   leaves sha256-equal to the in-memory run's, both kernel libraries
   stored, ``Registry.verify(deep=True)`` clean;
5a. the registry and the fleet (``registry_phase``, ``fleet_phase``): a
   fresh process with an empty build directory and the registry armed
   fetches K1's and K2's libraries (no nvcc build) and holds each against
   its plain version, its fetch beside the cold nvcc build;
   ``warm_from_registry`` over the published state (0 builds, 9
   captures); a ``ServingFleet`` of 1 and of 2 thread replicas
   (``max_batch=256``, a journal, the supervisor) quoting the first 16,384
   of the serving phase's rows in the same mixed batches, every quote
   bit-equal to the
   bare service's, p50/p99 and rows/s; the routed replica killed under load
   (``fleet_kill_routed``), one supervisor tick replacing it through the
   warm pool, the time from the kill to the replacement's first quote, the
   journal replayed clean; brownout on a tight token bucket (every degraded
   quote disclosed and within its bound of the full quote; the shed and
   degraded shares); ``hard_crash`` with a torn journal tail and
   ``ServingFleet.recover`` (the tail repaired, the in-flight closed out,
   the new fleet quoting the same bits); one ``LoadGen`` burst against
   ``capacity_model``; and the card's allocated memory after 5
   kill→replace cycles; then process replicas (``process_fleet_phase``):
   a fleet of 2 replica processes, each with its own CUDA context, over
   the socket and (where ``/dev/shm`` fits the rings) the shm transport,
   quoting the same first 16,384 rows (the socket fleet the first 4,096
   where the shm fleet runs) bit-equal to the bare service, p50/p99 and rows/s beside
   the thread fleets'; a journaled, traced fleet of 2 with one
   replica SIGKILLed under load (replaced by the supervisor, the journal
   clean, the quotes bit-equal, the card's free memory back within one
   replica's share), and the ``telemetry.timeline`` merge of the router's
   and the children's exports (exit 0, its hop table);
5b. the spec-grid scenario sweep at real size (27 cells): through
   ``run_pipeline(make_specgrid=True)`` guarded, again with
   ``FMRP_GRAM_PRECISION=bf16``, then ``run_scenarios`` on the coreset route
   in float32 and in bf16 and on a 12-subperiod unfactorized sweep (117
   specs, two launches), each run's launches pinned (``SPECGRID_LAUNCHES``);
   then the 27-cell sweep across 2 contraction worker processes
   (``multiproc_phase``, ``FMRP_SPECGRID_PROCS=2``) over ``shm`` (where
   ``/dev/shm`` fits the panel, else ``frames``), from an empty build
   directory: each worker launches K2 on its 11,000-firm shard (their
   launches, read from their reports, make the per-worker K2 row's
   count), at most one nvcc build over the pool, the parent launching no
   K2; cells held against the one-process sweep, and the merged stats
   against one-process K2 at 1e-5; after an shm sweep a 9-spec grid over
   ``frames`` from the warm build directory (no nvcc build), its merged
   stats bit-identical to the shm pool's; and ``run_spec_grid_on_panel``
   on the guarded run's resident panel with Table 2's grid: one K2
   launch, every leaf bit-equal to ``run_spec_grid`` on the same sliced
   tensors;
5c. the bootstrap-SE table at real size (B = 10,000, BASELINE.json
   configs[4]) through ``run_pipeline(make_bootstrap=True)``: the
   ``bootstrap_table`` stage and its peak device memory, launches as the
   main path's, a finite positive Boot SE in every Model 1 cell, and a
   second table with the same seed bit-identical;
5c'. the device mesh (``mesh_phase``) on 4 virtual shards of the card
   (``FMRP_VIRTUAL_DEVICES=4``; on one card they time the sharded
   programs' overhead, not a multi-card speedup): ``run_pipeline`` with
   ``MESH_DEVICES=4`` and the bootstrap at B = 10,000 — the daily strips
   launch K1 once per shard per strip, Table 2 runs distributed TSQR (K2
   only for the figure sweep), the bootstrap shards its replicates — held
   against the unsharded run of 5c (Table 2 against its QR route at 1.5e-3
   of ``max(|b|, nw_se)`` and of ``max(|t|, 1)``, its gap to the Gram route
   logged: in float32 the QR solver's ``eps·N`` cutoff truncates raw-unit
   columns; the daily vol/beta at 1e-4 of their scale and reported bit for
   bit, the Boot SEs at 1e-4 relative), and at float64 on
   240 × 2,000 at the reference's pins (coef rtol 1e-7, t-stat 1e-6); its
   wall, peak memory, launches and collective counts; the 27-cell sweep
   with ``FMRP_SPECGRID_MESH=4`` (4 K2 launches, one per shard, for its one
   contraction; cells at ``SUSPECT_TOL`` of the one-device sweep's); the
   time-sharded std and sum at w=252 over the tallest daily strip (13,312 ×
   2,432, 4 K3 launches a call, one gather and one permute) against K1 at
   K1's tolerance, over distinct cards too where there are several; and
   ``fama_macbeth_hier`` on Table 2's Model 1 across 2 fresh processes
   (gloo, 2 virtual shards each) against the one-process FM at 1e-4; plus
   the per-shard kernel rows (K1 at the mesh's strip shapes, K2 at 600 ×
   5,500, K3 at 3,328 × 2,432);
5d. the main path at real size with ``FMRP_SPECGRID_ROUTE=stacked`` (the
   split branch: one batched-QR Fama-MacBeth per cell): launches K1 17, K2
   0, K3 0; the ``table_2``/``figure_cs`` stages, peak memory and
   ``torch.linalg.qr`` at each model's design in float32 (its gap to the
   Gram route logged); in float64 Table 2 and the figure/decile frames
   within 1.5e-3 of the Gram route's; then one further month (its "All
   stocks" rows of 22,000 firm slots) ingested into a float64
   ``solver="normal"`` serving state on the card, held against the CPU's
   ingest and a full rebuild at the reference's pins, and into a float64
   Gram bank of the first 599 months (one K2 launch a call, timed), held
   against a bank of all 600 (leaves at 1e-13 of their max,
   ``window_query`` at 1e-11 of ``max(|coef|, 1)`` on the pairs without a
   suspect month); and through ``ERService.ingest_month`` on the card
   (``service_ingest_phase``): a ``poison_nan_flood`` at ``serving.ingest``
   quarantined with the quotes unchanged, then the clean month swapped in
   behind newly captured graphs while two client threads keep quoting,
   equal to the module's ingest;
5e. the rolling-origin backtest at real size (36 cells: expanding and
   rolling120 × 3 models × 3 universes × EW/VW) through
   ``run_pipeline(make_backtest=True)`` guarded (no violation, VW kept,
   launches ``BACKTEST_LAUNCHES``: the main path's plus the bank's one K2
   launch), the stage again on the resident panel (peak memory above it,
   the same bits), the bank alone (K2 once) and ``run_backtest`` over it
   with the counters at 0 (K2 never, ``panel_contractions`` 0), and the
   refit oracle's time beside the scan's;
5f. the estimator family at real size: ``run_pipeline(make_specgrid=True,
   make_backtest=True, specgrid_estimator="fwl:log_size")`` guarded (the
   sweep and the backtest under FWL, the control never reported), then on
   the resident panel ``run_scenarios`` under IV, one- and two-way absorbed
   fixed effects (seeded 12- and 10-level codes), pooled OLS with two-way
   clustered SEs, FWL with the clustered FM tail, FWL in bf16, and absorb on
   the coreset route; the pooled run again on a float64 copy of the panel
   (the float32 gap logged); each run's wall, peak memory above the panel
   and launches (pinned, ``ESTIMATOR_LAUNCHES``); the FE cell contraction
   twice (bit-identical); the Gram bank's ``estimator_query`` under
   ``ols@iid``, FWL, IV and ``pooled:cluster_month`` with K2 0 and no panel
   contraction after the bank, absorb refused, ``scenario_query`` under FWL,
   and a ``StreamingBootstrap`` of 1,000 draws over the bank's slopes in
   chunks, equal to two merged halves;
5g. the dense daily route at real size (``daily_dense_phase``): the
   (D, 22,000) float32 grid scattered from the main path's compact rows
   through ``ops.daily_chunked.daily_characteristics_chunked`` with the
   default budget (60% of the card: ``firm_chunk`` None, one call) and
   with 4 strips forced by ``FMRP_DAILY_BUDGET_BYTES`` (bit-equal; one K1
   launch a strip; seconds and peak memory printed), each vol/beta column
   bit-equal to the main path's compact route on the same rows, and K1
   std held against its plain version and timed at the grid's and
   the strips' shapes (the ``dense/`` kernel rows);
5h. ``dryrun_multichip(4)`` on the card (every sharding pattern on 4 mesh
   positions, each held against its one-device step; K1 and K3 launched)
   and ``entry()``'s FM step against the same step on the CPU;
6. K1 std at every daily-strip shape the main path launched it at (read
   from its counters), checked and timed, with the sum of launches × time;
7. the same path at a mid size (240 × 1,600) in float64 on the card and on the CPU (plain
   versions): Table 2's per-cell numbers (a coefficient at
   ``|d| <= 1e-8 * max(|b|, nw_se)``, its t-stat at ``1e-8 * max(|t|, 1)``,
   the rest at rtol 1e-8), Table 1, the decile table, the figure frames, the
   serving state, the scenario sweep from the card's panel (default,
   200 cells with bootstrap draws, coreset; rtol 1e-8), and the bootstrap
   (B = 2,000): one cell's replicate means and SEs from the same slope
   series and starts on both devices (rtol 1e-10), and each run's own table
   held as Table 2's cells are (1e-8); the backtest from the card's panel
   (the frame at rtol 1e-9 on cells without a suspect month and at
   ``SUSPECT_TOL`` on the others, placed by two CPU witnesses; bucket flips
   counted), the bank's ``bootstrap_query`` (200 draws), and on the card
   the scan route against the refit oracle (expanding and rolling120, OLS
   and FWL) at 1e-13 of ``max(|path|, 1)``; each estimator kind's sweep
   (FWL, IV, absorb one- and two-way, pooled two-way, FWL@cluster, absorb
   on the coreset route) at 1e-8, cells with a suspect month at
   ``SUSPECT_TOL`` between two CPU witnesses, integer disclosures exact;
   ``run_spec_grid`` over a 40-column union and an FWL cell with 20
   controls, and over a 920-column union (12 months × 2,000 seeded firms,
   3 specs: the tile-pair kernel) at the same pins;
8. the raw-frame route (a 250-firm × 130-month synthetic universe, float64)
   on the card and on the CPU: the enriched panel at rtol 1e-10, the tables
   as in phase 7, the audit records equal;
9. the command line, ``python -m fm_returnprediction_tpu_torch.pipeline
   --synthetic --firms 150 --months 130 --output-dir … --audit-dir …``, in
   a subprocess: exit code, artifacts, stage seconds and launches (without
   ``--output-dir`` when matplotlib or jinja2 does not import, said so);
   then ``--bootstrap 200 --backtest --backtest-sink metrics`` in one
   command (the ``bootstrap_table`` and ``backtest`` stages, K2 3;
   ``bootstrap_se.pkl``/``.tex`` and ``backtest.csv`` written, by
   ``run_pipeline(make_figure=False)`` where matplotlib does not import),
   ``--specgrid --specgrid-estimator iv:…`` (exit 0, K2 3) and
   ``--specgrid-estimator absorb:ind`` (exits non-zero, as the reference),
   and ``--trace-dir D --profile-dir P --registry-dir R --fleet-size 2
   --replica-mode process`` (both trace files and the profile written; the
   profile's kernel rows equal the launches; the fleet smoke on two
   replica processes);
10. a raw directory of 200 firms × 240 months (``write_synthetic_cache``)
   through the command line three times: cold (the columnar route ran and
   wrote the slot, no fallback warning), warm (the slot was mapped,
   ``load_raw_data`` skipped) and by the legacy route with the slot off;
   the sha256s of their tables and serving state in the drift manifests
   are equal, and their launches are K1 8, K2 2, K3 0; then ``--specgrid
   --specgrid-cells 200`` from the warm slot (216 cells, K2 3), with
   ``--output-dir`` where matplotlib imports, else ``specgrid_scenarios.csv``
   written by ``run_pipeline(make_figure=False, output_dir=…)`` on the same
   slot (the command line draws the figure into any output directory, and
   raises without matplotlib, as the reference does); then the host ingest of both
   routes in five alternating pairs, in process with the slot off (logged:
   medians, spreads, the pairs the columnar route won);
11. on the same directory in float64, a run crashed by a fault plan at
   ``pipeline.serving_state`` and resumed from its stage checkpoints (three
   hits, K2 once for the figure sweep), bit-identical to an uncheckpointed
   run; its artifact files (``make_figure=False``) held against a CPU
   run's, and every stage checkpoint reloaded into the object it holds;
12. the task graph: ``python -m fm_returnprediction_tpu_torch.taskgraph
   --synthetic`` twice on one state DB in subprocesses (the first run
   executes every task it names, launching K1 and K2 with no nvcc build;
   the rerun finds every task up to date: no launch, no build), then the
   DAG in process at 600 months of ``data.benchscale``'s real-scale
   universe with ``pull_data`` served by a stand-in ``wrds`` module: each
   task's seconds and launches, the panel checkpoint's bytes, the peak
   device memory, the up-to-date rerun, and the loaded
   ``lewellen_panel.npz`` held bit for bit against ``load_or_build_panel``
   on the same raw directory.

The topology controller rides on phase 5a's journaled process fleet: one
replica SIGKILLed, ``probe()`` saying ``killed``, ``repair()`` respawning
it (its seconds), quotes bit-equal to the bare service; then the fleet
hard-crashed and its declared shape rebuilt by
``TopologyController.recover`` from the journal, with no nvcc build.

The masked cumulative moments kernel's caller is the time-sharded rolling
family (phase 5c'), one launch per time shard: its per-shard row carries
those launches; its rows at the full shapes carry ``"launches": 0`` and
say so. Phase 3 holds it against its plain version like every other, also
on a ragged multi-chunk shape, checks that two launches give the same bits,
and prints each shape's chunk plan.

Each phase added with the telemetry layer and the service prints its
seconds (``phase <name>: s``). The last lines are a JSON object of
per-kernel numbers, the ``nvidia-smi`` line, and ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from fm_returnprediction_tpu_torch import telemetry
from fm_returnprediction_tpu_torch.backtest import (
    backtest_paths,
    backtest_space,
    quantile_sorts,
    run_backtest,
    run_backtest_scenarios,
)
from fm_returnprediction_tpu_torch.backtest.paths import _predict_pair
from fm_returnprediction_tpu_torch.cuda_build import build_kernels, library_path
from fm_returnprediction_tpu_torch.data import prepared
from fm_returnprediction_tpu_torch.data.smoke_inputs import make_smoke_inputs
from fm_returnprediction_tpu_torch.data.synthetic import SyntheticConfig, write_synthetic_cache
from fm_returnprediction_tpu_torch.dryrun import dryrun_multichip, entry
from fm_returnprediction_tpu_torch.ops import daily_chunked
from fm_returnprediction_tpu_torch.ops.compaction import compact, make_compaction
from fm_returnprediction_tpu_torch.ops.rolling import (
    masked_cumulative_moments_cuda,
    masked_cumulative_moments_plain,
    moments_chunk_plan,
    moments_chunk_rows,
    rolling_reduce_cuda,
    rolling_reduce_plain,
)
from fm_returnprediction_tpu_torch.models.forecast import rolling_er_forecast
from fm_returnprediction_tpu_torch.models.lewellen import FIGURE1_VARS, MODELS, model_columns
from fm_returnprediction_tpu_torch.ops.fama_macbeth import fama_macbeth
from fm_returnprediction_tpu_torch.ops.newey_west import compact_front
from fm_returnprediction_tpu_torch.ops.ols import CSRegressionResult
from fm_returnprediction_tpu_torch.parallel import mesh as mesh_mod
from fm_returnprediction_tpu_torch.parallel.bootstrap import (
    block_bootstrap_se,
    draw_block_starts,
    replicate_means_from_starts,
)
from fm_returnprediction_tpu_torch.parallel.mesh import make_mesh
from fm_returnprediction_tpu_torch.parallel.time_sharded import (
    rolling_std_time_sharded,
    rolling_sum_time_sharded,
)
from fm_returnprediction_tpu_torch.pipeline import load_or_build_panel, run_pipeline
from fm_returnprediction_tpu_torch.reporting.bootstrap_table import build_bootstrap_table
from fm_returnprediction_tpu_torch.reporting.table2 import table_2_cells
from fm_returnprediction_tpu_torch.registry import Registry, warm_from_registry
from fm_returnprediction_tpu_torch.registry import artifacts as registry_artifacts
from fm_returnprediction_tpu_torch.registry.integrity import array_bundle_digest
from fm_returnprediction_tpu_torch.resilience import checkpoint
from fm_returnprediction_tpu_torch.resilience.errors import InjectedFault, ServiceOverloadError
from fm_returnprediction_tpu_torch.resilience.faults import (
    FaultPlan,
    FaultSpec,
    fleet_hard_crash,
    fleet_kill_routed,
    poison_nan_flood,
    tear_journal_tail,
)
from fm_returnprediction_tpu_torch.serving import (
    AdmissionPolicy,
    BrownoutPolicy,
    DegradedQuote,
    ERService,
    LoadGen,
    LoadPhase,
    ServingFleet,
    capacity_model,
    replay_journal,
)
from fm_returnprediction_tpu_torch.serving.ingest import ingest_month
from fm_returnprediction_tpu_torch.serving.state import ServingState, build_serving_state
from fm_returnprediction_tpu_torch.specgrid.grams import (
    contract_spec_grams,
    contract_spec_grams_plain,
    gram_contract_cuda,
    gram_fold_cuda,
    gram_fold_plain,
    gram_spec_chunk,
    gram_tile_plan,
    GRAM_TILE_FROM,
    shared_center,
    split_stats,
)
from fm_returnprediction_tpu_torch.specgrid import (
    grambank,
    multiproc,
    run_spec_grid,
    run_spec_grid_on_panel,
    table2_grid,
)
from fm_returnprediction_tpu_torch.specgrid.cellspace import scenario_space
from fm_returnprediction_tpu_torch.specgrid.estimators import parse_estimator
from fm_returnprediction_tpu_torch.specgrid.scenarios import bank_for_scenarios, run_scenarios
from fm_returnprediction_tpu_torch.telemetry.perf import (
    DEVICE_CATEGORIES,
    PROFILE_TRACE_NAME,
    device_busy_share,
    profile_kernel_counts,
)
from fm_returnprediction_tpu_torch.utils.timing import StageTimer

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOPS = 67e12            # H100 SXM FP32 outside the tensor cores
FP64_FLOPS = 67e12            # H100 SXM FP64 on the tensor cores (DMMA)
BF16_FLOPS = 989e12           # H100 SXM bf16 dense on the tensor cores

K1_SOURCE = "fm_returnprediction_tpu_torch/csrc/rolling.cu"
K1_REPLACES = "fm_returnprediction_tpu/ops/pallas_kernels.py:216"
K2_SOURCE = "fm_returnprediction_tpu_torch/csrc/gram.cu"
K2_REPLACES = "fm_returnprediction_tpu/ops/gram_pallas.py:120"
# the tile-pair kernel's rows: the Pallas kernel's body, each (spec, month)
# block of [1 | x - c | y] that it computes
K2_TILES_REPLACES = "fm_returnprediction_tpu/ops/gram_pallas.py:56"
K3_SOURCE = "fm_returnprediction_tpu_torch/csrc/rolling.cu"
K3_REPLACES = "fm_returnprediction_tpu/ops/pallas_kernels.py:132"
K3_MAIN_PATH = ("not launched at this shape: the mesh path's time shards launch K3, "
                "once per shard (the mesh/moments row)")


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(*parts) -> None:
    print(*parts, flush=True)



class _env:
    """Set environment variables for a block (None unsets one) and restore
    every named variable after it, whatever the block set meanwhile."""

    def __init__(self, **values):
        self.values = {k: None if v is None else str(v) for k, v in values.items()}

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def worst_of(a: torch.Tensor) -> float:
    """The largest entry, a NaN counting as infinitely large (Python's
    ``max`` would pass over it)."""
    return float(torch.nan_to_num(a, nan=float("inf")).max())


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int = 7) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(bytes_moved: float, flops: float, dtype) -> tuple:
    peak = {torch.float64: FP64_FLOPS, torch.bfloat16: BF16_FLOPS}.get(dtype, FP32_FLOPS)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- K1: the rolling family ----------------------------------------------


def rolling_input(t: int, n: int, dtype, gen, scale: float, nan_frac: float):
    """A compacted-layout (T, N) input: each column's rows packed to the
    front (random lengths), NaN tail, scattered NaNs."""
    x = torch.randn((t, n), generator=gen, device="cuda", dtype=dtype) * scale
    counts = torch.randint(0, t + 1, (n,), generator=gen, device="cuda")
    tail = torch.arange(t, device="cuda")[:, None] >= counts[None, :]
    holes = torch.rand((t, n), generator=gen, device="cuda") < nan_frac
    return torch.where(tail | holes, torch.full_like(x, float("nan")), x)


def rolling_tolerance(x, kind: str, window: int, rel: float):
    """Per-element tolerance ``rel·|p| + atol``: both sides subtract two
    cumulative sums, so the absolute part scales with eps times the
    column's largest cumulative magnitude (C1 = Σ|x|, C2 = Σx²)."""
    eps = torch.finfo(x.dtype).eps
    fin = torch.isfinite(x)
    xz = torch.where(fin, x, torch.zeros_like(x))
    c1 = xz.abs().sum(0)[None, :]
    c2 = (xz * xz).sum(0)[None, :]
    cnt = rolling_reduce_plain(fin.to(x.dtype), window, 0, "sum")
    if kind == "sum":
        atol = 4 * eps * c1
    elif kind == "mean":
        atol = 4 * eps * c1 / torch.clamp_min(cnt, 1)
    else:
        w1 = rolling_reduce_plain(x, window, 0, "sum").abs()
        var_err = 4 * eps * (c2 + 2 * w1 * c1 / torch.clamp_min(cnt, 1))
        atol = torch.sqrt(var_err / torch.clamp_min(cnt - 1, 1))
    return atol, rel


def check_rolling(x, window: int, min_periods: int, kind: str, rel: float,
                  label: str) -> float:
    got = rolling_reduce_cuda(x, window, min_periods, kind)
    want = rolling_reduce_plain(x, window, min_periods, kind)
    torch.cuda.synchronize()
    atol, rel = rolling_tolerance(x, kind, window, rel)
    same_nan = bool((torch.isnan(got) == torch.isnan(want)).all())
    fin = torch.isfinite(want)
    diff = torch.where(fin, (got - want).abs(), torch.zeros_like(want))
    limit = (rel * want.abs() + atol).clamp_min(torch.finfo(x.dtype).tiny)
    ratio = float(torch.where(fin, diff / limit, torch.zeros_like(diff)).max())
    max_abs = float(diff.max())
    max_rel = float(torch.where(fin, diff / want.abs().clamp_min(torch.finfo(x.dtype).tiny),
                                torch.zeros_like(diff)).max())
    log(f"K1 {label}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
        f"tol=|d|<={rel:g}*|p|+{{4eps*C}} worst_ratio={ratio:.3f} "
        f"nan_pattern_equal={same_nan}")
    check(same_nan, f"K1 {label}: NaN pattern differs from the plain version")
    check(ratio <= 1.0, f"K1 {label}: error beyond tolerance")
    return max_abs


def k1_row(x, window: int, mp: int, kind: str, err: float, label: str) -> dict:
    """Time the rolling kernel and its plain version on ``x``; the kernel
    table row (launches filled in from the main path's counters)."""
    t, n = x.shape
    ms = time_ms(lambda: rolling_reduce_cuda(x, window, mp, kind))
    plain_ms = time_ms(lambda: rolling_reduce_plain(x, window, mp, kind))
    b_ms, b_by = bound(2 * x.numel() * x.element_size(), 12 * x.numel(), x.dtype)
    log(f"K1 {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    return dict(name=f"rolling_reduce[{kind},w={window}] {t}x{n} f32",
                key=f"{kind}/w={window},{t}x{n}", route="cuda", source=K1_SOURCE,
                replaces=K1_REPLACES, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def k1_phase(gen, timed: bool):
    cases = [  # (label, T, N, kind, window, min_periods, scale, nan_frac, timed)
        ("sum w=12 mp=1 (dy)", 600, 22000, "sum", 12, 1, 1.0, 0.02, True),
        ("sum w=24 mp=24 (log_return_13_36)", 600, 22000, "sum", 24, 24, 0.1, 0.02, True),
        ("mean w=12 mp=12 (turnover)", 600, 22000, "mean", 12, 12, 1.0, 0.02, False),
        # the daily strips are timed one by one after the main path, at the
        # shapes its counters show (strip_phase)
        ("std w=252 mp=100 (daily vol)", 13312, 2432, "std", 252, 100, 0.02, 0.005, False),
        # several chunks with window = chunk/2: every warm-up reaches back a
        # whole window into the chunk before
        ("std w=300 mp=2 (warm-up of a whole window)", 3000, 2432, "std", 300, 2, 0.02, 0.005,
         False),
        ("mean w=300 mp=2 (warm-up of a whole window)", 3000, 2432, "mean", 300, 2, 0.02, 0.005,
         False),
        # Figure 1's slope means of 3 subsets × 5 variables in one call, and
        # one subset's lagged [intercept, 5 slopes] forecast means
        ("mean w=120 mp=60 (figure slopes)", 600, 15, "mean", 120, 60, 0.01, 0.1, True),
        ("mean w=120 mp=60 (forecast coefs)", 600, 6, "mean", 120, 60, 0.01, 0.1, True),
    ]
    rows = []
    for label, t, n, kind, window, mp, scale, nan_frac, on_path in cases:
        for dtype, rel in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
            x = rolling_input(t, n, dtype, gen, scale, nan_frac)
            tag = f"{label} {t}x{n} {str(dtype)[6:]}"
            err = check_rolling(x, window, mp, kind, rel, tag)
            if dtype == torch.float32 and timed and on_path:
                rows.append(k1_row(x, window, mp, kind, err, tag))
            del x
    torch.cuda.empty_cache()
    return rows


STRIP_KEY = re.compile(r"^std/w=(\d+),(\d+)x(\d+)$")


def strip_phase(gen, by_shape: dict, mp: int = 100):
    """K1 std at every daily-strip shape the main path launched it at (read
    from its counters, so another seed's strip heights cannot break the
    launch check): checked against the plain version, timed, and summed as
    launches × time over the main path."""
    strips = []
    for key, count in by_shape.items():
        match = STRIP_KEY.match(key)
        if match:
            window, t, n = (int(v) for v in match.groups())
            strips.append((t, n, window, count))
    rows, total_ms, launches = [], 0.0, 0
    for t, n, window, count in sorted(strips, reverse=True):
        x = rolling_input(t, n, torch.float32, gen, 0.02, 0.005)
        label = f"std w={window} mp={mp} (daily strip) {t}x{n} float32"
        err = check_rolling(x, window, mp, "std", 1e-4, label)
        row = k1_row(x, window, mp, "std", err, label)
        total_ms += count * row["ms"]
        launches += count
        rows.append(row)
        del x
    torch.cuda.empty_cache()
    log(f"K1 std on the main path's daily strips: {launches} launches, "
        f"sum of launches × kernel time {total_ms:.4f} ms")
    return rows


# --- K2: the Gram contraction ----------------------------------------------


def gram_inputs(t: int, n: int, p: int, dtype, gen, figure: bool = False, specs: int = 9,
                widths=(3, 7, None), nan_frac: float = 0.05):
    """The contraction inputs: x (T, N, P) with NaNs (``nan_frac`` of the
    entries) and an all-NaN firm column, y with NaNs, 3 universes, valid =
    universe of each spec. Table 2's grid has 9 specs (3 nested models × 3
    universes: the first 3, 7 and every column, ``widths``); ``specs`` more
    cycle through the same models and universes, as the unfactorized
    scenario sweep's windows do, and 3 take one model each; the figure
    grid (``figure=True``) has 3, every column in each."""
    x = torch.randn((t, n, p), generator=gen, device="cuda", dtype=dtype)
    x = torch.where(torch.rand((t, n, p), generator=gen, device="cuda") < nan_frac,
                    torch.full_like(x, float("nan")), x)
    x[:, 7, 2] = float("nan")
    y = 0.1 * torch.randn((t, n), generator=gen, device="cuda", dtype=dtype)
    y = torch.where(torch.rand((t, n), generator=gen, device="cuda") < 0.1,
                    torch.full_like(y, float("nan")), y)
    universes = torch.rand((3, t, n), generator=gen, device="cuda") > \
        torch.tensor([0.1, 0.4, 0.7], device="cuda")[:, None, None]
    if figure:
        col_sel = torch.ones((3, p), dtype=torch.bool, device="cuda")
    else:
        col_sel = torch.zeros((specs, p), dtype=torch.bool, device="cuda")
        widths = [p if w is None else w for w in widths]
        for i in range(specs):
            col_sel[i, :widths[(i // 3) % 3 if specs > 3 else i]] = True
    uidx = torch.arange(col_sel.shape[0], device="cuda") % 3
    valid = universes[uidx].to(torch.uint8).contiguous()
    center = shared_center(x)
    return y, x, universes[uidx], valid, col_sel, center


def coreset_like_weights(t: int, n: int, dtype, gen, binary: bool):
    """Row weights as the coreset route makes them: most rows 0, sampled
    rows a positive importance weight (or 1 with ``binary``)."""
    u = torch.rand((t, n), generator=gen, device="cuda", dtype=torch.float64)
    w = torch.ones_like(u) if binary else 0.5 + 4.0 * u
    return torch.where(u < 0.3, w, torch.zeros_like(w)).to(dtype)


def gram_worst(got, want) -> tuple:
    """The worst difference of two split Gram stats, each block relative to
    the largest entry of its (spec, month) in ``want`` (at least 1), and
    the worst absolute difference."""
    scale = torch.stack([
        want[0].abs().amax((-1, -2)), want[1].abs().amax(-1),
        want[2].abs(), want[3].abs(), want[4].abs(),
    ]).amax(0).clamp_min(1.0)                                   # (S, T)
    worst, max_abs = 0.0, 0.0
    for g, w in zip(got, want):
        d = (g - w).abs()
        block_scale = scale.reshape(scale.shape + (1,) * (d.dim() - 2))
        worst = max(worst, worst_of(d / block_scale))
        max_abs = max(max_abs, worst_of(d))
    return worst, max_abs


def check_gram(t, n, p, dtype, rel, gen, timed, figure=False, weights=None,
               low=False, specs=9, key_prefix="gram", widths=(3, 7, None), nan_frac=0.05,
               reps=7):
    """K2 against its plain version on the same inputs; with ``timed`` the
    kernel table row. ``weights`` is None, "binary" (0/1: counts exact) or
    "coreset"; ``low`` runs bfloat16 operands (the float32 inputs rounded)
    into float32 sums. Both sides of a bfloat16 check sum in float32, and
    the plain version's own error is most of their gap, so the kernel is
    first held at ``rel`` against the plain version at float64 on the same
    bfloat16-rounded terms (``x − c`` rounded to bfloat16 as both form it),
    then against the float32 plain version at ``rel`` plus that plain
    version's own worst error against the float64 sums."""
    y, x, uni, valid, col_sel, center = gram_inputs(t, n, p, dtype, gen, figure, specs, widths,
                                                    nan_frac)
    rw = None
    if weights is not None:
        rw = coreset_like_weights(t, n, dtype, gen, binary=weights == "binary")
    y_in, x_in, rw_in = y, x, rw
    if low:
        y, x, center = (a.to(torch.bfloat16) for a in (y, x, center))
        rw = None if rw is None else rw.to(torch.bfloat16)
    s = col_sel.shape[0]
    window = torch.ones((s, t), dtype=torch.bool, device="cuda")
    out = gram_contract_cuda(y, x, valid, col_sel, center, rw)
    got = split_stats(out, p)
    want = contract_spec_grams_plain(y, x, uni, col_sel, window, center, row_weights=rw)
    torch.cuda.synchronize()
    counts_exact = bool((got[2] == want[2]).all())
    worst, max_abs = gram_worst(got, want)
    kind = "bf16" if low else str(dtype)[6:]
    chunk = gram_spec_chunk(p, dtype=x.dtype)
    tiles = gram_tile_plan(p, x.dtype, s)
    label = (f"T={t} N={n} P={p} S={s} {kind}" + (f" rw={weights}" if weights else "")
             + (f" ({-(-s // chunk)} launches)" if s > chunk else "")
             + (f" (tile pairs: one launch, {len(tiles.pairs)} pairs of {tiles.tiles} tiles, "
                f"{tiles.groups} spec group(s) of {tiles.spec_group})" if tiles else ""))
    tol = rel
    check(torch.equal(out, gram_contract_cuda(y, x, valid, col_sel, center, rw)),
          f"K2 {label}: two calls differ in their bits")
    if low:
        exact = contract_spec_grams_plain(
            y.double(), (x - center[:, None, :]).double(), uni, col_sel, window,
            torch.zeros(center.shape, dtype=torch.float64, device="cuda"),
            row_weights=None if rw is None else rw.double())
        worst_exact, _ = gram_worst(got, exact)
        plain_exact, _ = gram_worst(want, exact)
        del exact
        tol = rel + plain_exact
        log(f"K2 {label}: against the float64 sums of the same bf16 terms: kernel "
            f"worst_rel_to_block_max={worst_exact:.3e} tol={rel:g}, float32 plain version "
            f"{plain_exact:.3e}")
        check(worst_exact <= rel, f"K2 {label}: error against the float64 sums beyond tolerance")
    log(f"K2 {label}: max_abs={max_abs:.3e} worst_rel_to_block_max={worst:.3e} "
        f"tol={tol:g} counts_exact={counts_exact}")
    check(counts_exact or weights == "coreset",
          f"K2 {label}: counts differ from the plain version")
    check(worst <= tol, f"K2 {label}: error beyond tolerance")
    row = None
    if timed:
        ms = time_ms(lambda: gram_contract_cuda(y, x, valid, col_sel, center, rw), reps=reps)
        plain_ms = time_ms(lambda: contract_spec_grams_plain(
            y, x, uni, col_sel, window, center, row_weights=rw), reps=min(reps, 5))
        qe, isz = p + 2, x.element_size()
        torch.cuda.empty_cache()
        # yardstick: batched matmuls over the pre-weighted augmented
        # design. Every (spec, month) its own (QE, N) @ (N, QE) product in
        # one call where both operands fit under 24 GiB; past that, one
        # product a month, the specs' weighted rows stacked against the
        # month's design, (S·QE, N) @ (N, QE): the same sums, the weighted
        # operand the only large one, one call over as many months as half
        # the free memory holds, the calls' times summed
        per_spec = 2 * s * t * n * qe * isz < 24 * 2**30
        fin = torch.isfinite(x)
        xz = torch.where(fin, x - center[:, None, :], torch.zeros_like(x))
        finy = torch.isfinite(y)
        yz = torch.where(finy, y, torch.zeros_like(y))
        xa = torch.cat([torch.ones_like(y)[..., None], xz, yz[..., None]], -1)
        bad = torch.einsum("tnp,sp->stn", (~fin).float(), col_sel.float())
        w = (uni & finy[None] & (bad == 0)).to(x.dtype)
        if rw is not None:
            w = w * rw
        del fin, xz, yz, bad
        torch.cuda.empty_cache()
        # the bound counts the products of the (spec, month, firm) rows of
        # nonzero weight: a row of weight 0 adds nothing to the sums
        tri = (p + 2) * (p + 3) // 2
        taken = int((w != 0).sum())
        in_bytes = sum(a.numel() * a.element_size()
                       for a in (x, y, valid, col_sel, center, rw) if a is not None)
        out_bytes = s * t * (p + 2) ** 2 * got[0].element_size()
        b_ms, b_by = bound(in_bytes + out_bytes, 2.0 * taken * tri, x.dtype)
        if per_spec:
            lhs = (xa[None] * w[..., None]).reshape(-1, n, qe).transpose(1, 2)
            rhs = xa[None].expand(s, t, n, qe).reshape(-1, n, qe).contiguous()
            lib = torch.bmm(lhs, rhs).reshape(s, t, qe, qe).float()
            library_ms = time_ms(lambda: torch.bmm(lhs, rhs), reps=reps)
            layout = "one (QE, N) @ (N, QE) product a (spec, month)"
            del lhs, rhs
        else:
            months = max(1, int(0.5 * torch.cuda.mem_get_info()[0] // (s * qe * n * isz)))
            lib = torch.empty((s, t, qe, qe), dtype=torch.float32, device="cuda")
            library_ms = 0.0
            for t0 in range(0, t, months):
                t1 = min(t0 + months, t)
                lhs = torch.empty((t1 - t0, s, qe, n), dtype=x.dtype, device="cuda")
                for j in range(s):
                    lhs[:, j] = (xa[t0:t1] * w[j, t0:t1][..., None]).transpose(1, 2)
                lhs, rhs = lhs.view(t1 - t0, s * qe, n), xa[t0:t1]
                lib[:, t0:t1] = torch.bmm(lhs, rhs).view(t1 - t0, s, qe, qe).transpose(0, 1)
                library_ms += time_ms(lambda: torch.bmm(lhs, rhs), reps=reps)
                del lhs, rhs
            layout = (f"one (S·QE, N) @ (N, QE) product a month, {-(-t // months)} call(s) of "
                      f"up to {months} months, summed")
        lib_err = float((split_stats(lib, p)[0] - got[0].float()).abs().max())
        lib_note = (f"bmm {library_ms:.4f} ms ({layout}; |gram diff| {lib_err:.3e}; "
                    f"kernel/bmm {ms / library_ms:.3f})")
        del lib, w, xa
        log(f"K2 {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{lib_note}, bound {b_ms:.4f} ms ({b_by}; {taken:,} of {s * t * n:,} rows of "
            f"nonzero weight)")
        if low:
            # the whole call as Table 2 makes it from float32 inputs: the
            # center, the bf16 casts, the universe gather and the kernel
            uidx = torch.arange(s, device="cuda") % 3
            whole_ms = time_ms(lambda: contract_spec_grams(
                y_in, x_in, uni[:3], uidx, col_sel, window, row_weights=rw_in,
                precision="bf16"), reps=reps)
            log(f"K2 {label}: contract_spec_grams(precision='bf16') from float32 "
                f"inputs {whole_ms:.4f} ms, of which the kernel {ms:.4f} ms")
        # the wrapper's launch key ("P=14,S=9,f32[,rw]")
        key = (f"{key_prefix}/P={p},S={s},{'bf16' if low else {torch.float32: 'f32', torch.float64: 'f64'}[dtype]}"
               + (",rw" if rw is not None else ""))
        row = dict(name=f"{'gram_tiles' if tiles else 'gram_contract'} {label}", key=key,
                   route="cuda", source=K2_SOURCE,
                   replaces=K2_TILES_REPLACES if tiles else K2_REPLACES,
                   max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
    del y, x, uni, valid, col_sel, center, out, got, want, rw, y_in, x_in, rw_in
    torch.cuda.empty_cache()
    return row


# The scenario sweep's launches at real size (specgrid_phase): the default
# sweep contracts its 9 (model, universe) pairs in one launch; the
# 12-subperiod sweep with the factorization off contracts 117 specs, cut into
# two launches of at most 60 (gram_spec_chunk(14)).
SPLIT_SPECS = 117
# the absorb kind's per-spec contraction, and the multi-process sweep's
# unfactorized one (27 specs: 3 models × 3 universes × 3 windows)
ABSORB_SPECS = 27
# contraction worker processes of the multi-process sweep (multiproc_phase)
MP_PROCS = 2
# which real-size runs launch each K2 shape beyond the main path's: the
# scenario sweep's and ``run_spec_grid_on_panel``'s (specgrid_phase), the
# backtest's and the estimator
# family's (estimators_phase: absorb contracts per spec, 27 at a time; the
# pooled run on the float64 panel)
ROW_PATH = {"gram/P=14,S=9,bf16": ("bf16", "estimators"), "gram/P=5,S=3,bf16": ("bf16",),
            "gram/P=14,S=9,f32,rw": ("coreset",), "gram/P=14,S=9,bf16,rw": ("coreset_bf16",),
            f"gram/P=14,S={SPLIT_SPECS},f32": ("split",),
            "gram/P=14,S=9,f32": ("main", "backtest", "estimators", "on_panel"),
            "gram/P=14,S=27,f32": ("estimators",), "gram/P=14,S=27,f32,rw": ("estimators",),
            "gram/P=14,S=9,f64": ("estimators",),
            f"gram-worker/P=14,S={ABSORB_SPECS},f32": ("multiproc",)}


def k2_phase(gen, timed: bool):
    rows = [check_gram(600, 22000, 14, torch.float32, 1e-5, gen, timed),
            check_gram(600, 22000, 5, torch.float32, 1e-5, gen, timed, figure=True),
            check_gram(600, 22000, 14, torch.float32, 1e-5, gen, timed, weights="coreset"),
            check_gram(600, 22000, 14, torch.float32, 1e-5, gen, timed, low=True),
            check_gram(600, 22000, 5, torch.float32, 1e-5, gen, timed, figure=True, low=True),
            check_gram(600, 22000, 14, torch.float32, 1e-5, gen, timed, weights="coreset",
                       low=True),
            check_gram(600, 22000, 14, torch.float32, 1e-5, gen, timed, specs=SPLIT_SPECS),
            check_gram(600, 22000, 14, torch.float32, 1e-5, gen, timed, specs=ABSORB_SPECS),
            check_gram(600, 22000, 14, torch.float32, 1e-5, gen, timed, specs=ABSORB_SPECS,
                       weights="coreset"),
            check_gram(600, 22000, 14, torch.float64, 1e-12, gen, timed),
            # one contraction worker's shard of the multi-process sweep
            # (multiproc_phase): half the firms, the 27 specs unfactorized
            check_gram(600, 22000 // MP_PROCS, 14, torch.float32, 1e-5, gen, timed,
                       specs=ABSORB_SPECS, key_prefix="gram-worker")]
    check_gram(600, 22000, 5, torch.float32, 1e-5, gen, False, figure=True, weights="coreset",
               low=True)
    check_gram(600, 3000, 5, torch.float32, 1e-5, gen, False, figure=True, weights="binary",
               low=True)
    check_gram(600, 3000, 14, torch.float64, 1e-12, gen, False)
    check_gram(240, 3000, 5, torch.float64, 1e-12, gen, False, figure=True)
    check_gram(600, 3000, 14, torch.float64, 1e-12, gen, False, weights="coreset")
    check_gram(600, 3000, 14, torch.float64, 1e-12, gen, False, weights="binary")
    check_gram(600, 3000, 14, torch.float32, 1e-5, gen, False, weights="binary", low=True)
    check_gram(60, 3000, 14, torch.float64, 1e-12, gen, False, specs=SPLIT_SPECS)
    return [row for row in rows if row]


# K2 past 32 predictor columns: the full-width union (Table 2's 14 columns
# and 26 seeded ones, 600 × 22,000) and two wider unions at 4,096 firms,
# each on every branch (float32, float64, coreset row weights, bfloat16
# operands on the tensor cores); specs select the first 3, the first 7 and
# every column of the union, Table 2's three nested shapes widened
WIDE_P = 40
WIDE_SHAPES = ((WIDE_P, 22000), (64, 4096), (100, 4096))
# the months k2_wide_path_phase runs the 64- and 100-column unions over
WIDE_PATH_MONTHS = 120
# their launches on a path: k2_wide_path_phase's run_spec_grid runs
ROW_PATH.update({f"gram/P={p},S=9,{branch}": ("wide",) for p, _ in WIDE_SHAPES
                 for branch in ("f32", "f64", "f32,rw", "bf16")})


# K2 on wide unions: 920 columns (Gu, Kelly and Xiu's 94 characteristics
# × 9 plus 74 industry dummies), 60 months × 22,000 firms (depth cut for
# time), 3 specs (the first 3, 460 and every column), 1e-4 of the entries
# NaN (the widest spec keeps most rows), on every branch: float32 (with
# and without coreset row weights), float64 and bfloat16 operands on the
# tile-pair kernel (the pre-pass and one launch)
UNION_P, UNION_T, UNION_N = 920, 60, 22000
UNION_WIDTHS = (3, UNION_P // 2, UNION_P)
UNION_NAN = 1e-4
# the pre-pass's counterpart in the Pallas kernel: the selected columns'
# non-finite count and the weight of _gram_kernel
FOLD_REPLACES = "fm_returnprediction_tpu/ops/gram_pallas.py:89"
# their launches on a path: k2_wide_path_phase's run_spec_grid over 920
# columns on each branch
ROW_PATH.update({f"gram/P={UNION_P},S=3,{branch}": ("wide",)
                 for branch in ("f32", "f64", "f32,rw", "bf16")})
ROW_PATH.update({f"fold/P={UNION_P},S=3,{branch}": ("wide",) for branch in ("f32", "f64")})
# the reach of one launch of the wide kernels, 9 specs: (label, operands,
# bfloat16, row weights, the widest union); every operand type takes the
# tile-pair kernel on both sides of it
OLD_REACH = (("f64", torch.float64, False, None, 424),
             ("f64 rw", torch.float64, False, "binary", 423),
             ("f32", torch.float32, False, None, 848),
             ("f32 rw", torch.float32, False, "binary", 847),
             ("bf16", torch.float32, True, None, 1367),
             ("bf16 rw", torch.float32, True, "binary", 622))


def reach_checks(gen) -> None:
    """Each side of the reach of one launch of the wide kernels, 12 months
    × 1,001 firms, 9 specs: every operand type the pre-pass and one launch
    of the tile-pair kernel on both sides (each crossover lies within its
    one-launch kernel's reach); each held to its plain version as
    ``check_gram`` holds it (two calls, bit-identical)."""
    for label, dtype, low, weights, reach in OLD_REACH:
        operands = torch.bfloat16 if low else dtype
        for p in (reach, reach + 1):
            tiles = gram_tile_plan(p, operands, 9)
            check(tiles is not None, f"K2 {label} P={p}: not on the tile route")
            before = gram_contract_cuda.launches, gram_fold_cuda.launches
            check_gram(12, 1001, p, dtype, 1e-12 if dtype == torch.float64 else 1e-5, gen,
                       False, weights=weights, low=low, nan_frac=1e-3)
            got = (gram_contract_cuda.launches - before[0],
                   gram_fold_cuda.launches - before[1])
            log(f"K2 {label} P={p}: tile pairs, {len(tiles.pairs)} pairs of {tiles.tiles} "
                f"tiles; launches (K2, pre-pass) of two calls {got}")
            check(got == (2, 2), f"K2 {label} P={p}: launches {got}, not (2, 2)")


def tile_side_checks(gen) -> None:
    """The tile-pair kernel's edges, 12 months × 1,001 firms, 9 specs, in
    float32, float64 and bfloat16 (with 0/1 row weights too): one launch of the
    one-launch kernel one column below ``GRAM_TILE_FROM``, the pre-pass and
    one launch of the tile-pair kernel at it and at 921 columns (no
    16-byte row stride in either type), each held to its plain version as
    ``check_gram`` holds it (two calls, bit-identical)."""
    for dtype, low in ((torch.float32, False), (torch.float64, False), (torch.float32, True)):
        operands = torch.bfloat16 if low else dtype
        start = GRAM_TILE_FROM[operands]
        for p in (start - 1, start, 921):
            for weights in (None, "binary"):
                tiles = gram_tile_plan(p, operands, 9)
                check((tiles is not None) == (p >= start),
                      f"K2 {operands} P={p}: tile route {'' if tiles else 'not '}planned")
                before = gram_contract_cuda.launches, gram_fold_cuda.launches
                check_gram(12, 1001, p, dtype, 1e-12 if dtype == torch.float64 else 1e-5, gen,
                           False, weights=weights, low=low, nan_frac=1e-3)
                got = (gram_contract_cuda.launches - before[0],
                       gram_fold_cuda.launches - before[1])
                want = (2, 0 if tiles is None else 2)
                check(got == want, f"K2 {operands} P={p}: launches (K2, pre-pass) of two "
                      f"calls {got}, not {want}")


def fold_row(dtype, gen, timed):
    """The tile-pair kernel's pre-pass (``gram_fold_cuda``) at the 920-column
    shape against its plain version, bit for bit, two calls identical; with
    ``timed`` its kernel table row."""
    y, x, _, valid, col_sel, _ = gram_inputs(UNION_T, UNION_N, UNION_P, dtype, gen, specs=3,
                                             widths=UNION_WIDTHS, nan_frac=UNION_NAN)
    got = gram_fold_cuda(y, x, valid, col_sel)
    want = gram_fold_plain(y, x, valid, col_sel)
    kind = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    label = f"T={UNION_T} N={UNION_N} P={UNION_P} S=3 {kind}"
    wrong = int((got != want).sum())
    log(f"gram_fold {label}: {wrong} of {got.numel()} bytes differ from the plain version, "
        f"{int(got.sum())} rows valid")
    check(wrong == 0 and torch.equal(got, gram_fold_cuda(y, x, valid, col_sel)),
          f"gram_fold {label}: differs from the plain version or between calls")
    row = None
    if timed:
        ms = time_ms(lambda: gram_fold_cuda(y, x, valid, col_sel))
        plain_ms = time_ms(lambda: gram_fold_plain(y, x, valid, col_sel), reps=5)
        moved = sum(a.numel() * a.element_size() for a in (x, y, valid, col_sel)) + got.numel()
        b_ms, b_by = bound(moved, float(x.numel()), dtype)
        log(f"gram_fold {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library none, "
            f"bound {b_ms:.4f} ms ({b_by})")
        row = dict(name=f"gram_fold {label}", key=f"fold/P={UNION_P},S=3,{kind}", route="cuda",
                   source=K2_SOURCE, replaces=FOLD_REPLACES, max_abs_err=float(wrong), ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del y, x, valid, col_sel, got, want
    torch.cuda.empty_cache()
    return row


def k2_wide_phase(gen, timed: bool):
    """K2 at P = 40, 64 and 100 against its plain version on every branch
    (the timed rows of the kernel table), then untimed edge cases: P = 33
    in float64, float32 and bfloat16 with 0/1 weights on a ragged N,
    bfloat16 with coreset weights at P = 40, float32 with 61 specs at P =
    40, each side of the reach of one launch of the wide kernels
    (``reach_checks``) and of the tile-pair kernel's crossover
    (``tile_side_checks``), bfloat16 with coreset weights over 920 columns
    and float32 over 921 (no 16-byte row stride); then the 920-column union
    on every branch and the pre-pass (timed rows)."""
    rows = []
    for p, n in WIDE_SHAPES:
        rows += [check_gram(600, n, p, torch.float32, 1e-5, gen, timed),
                 check_gram(600, n, p, torch.float64, 1e-12, gen, timed),
                 check_gram(600, n, p, torch.float32, 1e-5, gen, timed, weights="coreset"),
                 check_gram(600, n, p, torch.float32, 1e-5, gen, timed, low=True)]
    check_gram(600, 4096, WIDE_P, torch.float32, 1e-5, gen, False, weights="coreset", low=True)
    check_gram(120, 3001, 33, torch.float64, 1e-12, gen, False)
    check_gram(120, 3001, 33, torch.float32, 1e-5, gen, False, weights="binary", low=True)
    check_gram(120, 3001, 33, torch.float32, 1e-5, gen, False, weights="binary")
    check_gram(120, 4096, WIDE_P, torch.float32, 1e-5, gen, False, specs=61)
    reach_checks(gen)
    tile_side_checks(gen)
    # a call of up to 0.5 s: median of 2 (the plain version's too)
    panel = dict(specs=3, widths=UNION_WIDTHS, nan_frac=UNION_NAN, reps=2)
    check_gram(UNION_T, UNION_N, UNION_P, torch.float32, 1e-5, gen, False, weights="coreset",
               low=True, **panel)
    check_gram(UNION_T, UNION_N, UNION_P + 1, torch.float32, 1e-5, gen, False,
               **dict(panel, widths=(3, UNION_P // 2, None)))
    rows += [check_gram(UNION_T, UNION_N, UNION_P, torch.float32, 1e-5, gen, timed, **panel),
             check_gram(UNION_T, UNION_N, UNION_P, torch.float64, 1e-12, gen, timed, **panel),
             check_gram(UNION_T, UNION_N, UNION_P, torch.float32, 1e-5, gen, timed,
                        weights="coreset", **panel),
             check_gram(UNION_T, UNION_N, UNION_P, torch.float32, 1e-5, gen, timed, low=True,
                        **panel),
             fold_row(torch.float32, gen, timed), fold_row(torch.float64, gen, timed)]
    return [row for row in rows if row]


def sass_hmma_phase() -> None:
    """Count the tensor-core instructions in the SASS of each Gram kernel
    of the built library (``cuobjdump -sass``): ``HMMA`` (bf16) and
    ``DMMA`` (float64). The bf16 kernels (the eight register classes, the
    four wide kernels past 32 columns: two chunk widths, with and without
    row weights, and the six tile-pair kernels: 1 to 3 specs a block, with
    and without row weights) must have ``HMMA`` and no ``DMMA``, the
    ten float64 kernels (three chunk widths, and the four tile-pair
    kernels: 2 and 3 specs a block) ``DMMA`` and no ``HMMA``, the ten
    float32 kernels (``gram_kernel`` up to 32 columns,
    ``gram_f32_wide_kernel`` past them and the six tile-pair kernels
    ``gram_f32_tiles_kernel``: 1 to 3 specs a block; each with and without
    row weights) and the tile-pair kernel's three pre-pass kernels
    (``gram_fold_kernel``, one an operand type) neither."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump") or os.path.join(cuda_home, "bin", "cuobjdump")
    if not os.path.exists(tool):
        log("SASS HMMA/DMMA count: cuobjdump is not in this toolkit; not counted")
        return
    sass = subprocess.run([tool, "-sass", str(library_path("gram"))], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"HMMA": 0, "DMMA": 0}
        elif name is not None:
            for op in re.findall(r"\b([HD]MMA)\b", line):
                counts[name][op] += 1
    filt = shutil.which("c++filt")
    if filt and counts:
        names = subprocess.run([filt], input="\n".join(counts), check=True,
                               capture_output=True, text=True, timeout=60).stdout.split("\n")
        short = (re.sub(r"\(.*$", "", nm.replace("(anonymous namespace)::", ""))
                 .removeprefix("void ") for nm in names)
        counts = dict(zip(short, counts.values()))
    log("SASS HMMA/DMMA count per Gram kernel: " + json.dumps(counts))
    tc = {k: v for k, v in counts.items() if k.startswith("gram_tc_")}
    dm = {k: v for k, v in counts.items() if k.startswith("gram_dmma_")}
    cc = {k: v for k, v in counts.items() if not k.startswith(("gram_tc_", "gram_dmma_"))}
    check(len(tc) == 18 and all(v["HMMA"] > 0 and v["DMMA"] == 0 for v in tc.values()),
          "bf16 Gram kernels without HMMA (or with DMMA)")
    check(len(dm) == 10 and all(v["DMMA"] > 0 and v["HMMA"] == 0 for v in dm.values()),
          "float64 Gram kernels without DMMA (or with HMMA)")
    check(len(cc) == 13 and sum(k.startswith("gram_f32_wide_kernel") for k in cc) == 2
          and sum(k.startswith("gram_f32_tiles_kernel") for k in cc) == 6
          and sum(k.startswith("gram_fold_kernel") for k in cc) == 3
          and all(v["HMMA"] == 0 and v["DMMA"] == 0 for v in cc.values()),
          "float32 Gram kernels or the pre-pass use the tensor cores (or are not the 13 "
          "expected)")


# --- K3: the masked cumulative moments --------------------------------------


def check_moments(x, rel: float, label: str, timed: bool):
    """The kernel against its plain version: counts exact, each sum within
    ``rel·|p| + 4·eps·C`` with C the cumulative Σ|x| (Σx² for the squares)
    through that row."""
    got = masked_cumulative_moments_cuda(x)
    want = masked_cumulative_moments_plain(x)
    torch.cuda.synchronize()
    eps = torch.finfo(x.dtype).eps
    c1, c2, _ = masked_cumulative_moments_plain(x.abs())
    counts_exact = bool(torch.equal(got[2], want[2]))
    worst, max_abs = 0.0, 0.0
    for g, w, c in zip(got[:2], want[:2], (c1, c2)):
        d = (g - w).abs()
        limit = (rel * w.abs() + 4 * eps * c).clamp_min(torch.finfo(x.dtype).tiny)
        worst = max(worst, worst_of(d / limit))
        max_abs = max(max_abs, worst_of(d))
    log(f"K3 {label}: max_abs={max_abs:.3e} tol=|d|<={rel:g}*|p|+4eps*C "
        f"worst_ratio={worst:.3f} counts_exact={counts_exact}")
    check(counts_exact, f"K3 {label}: counts differ from the plain version")
    check(worst <= 1.0, f"K3 {label}: error beyond tolerance")
    del got, want, c1, c2
    if not timed:
        return None
    ms = time_ms(lambda: masked_cumulative_moments_cuda(x))
    plain_ms = time_ms(lambda: masked_cumulative_moments_plain(x))
    # yardstick: ONE torch.cumsum over a pre-built masked (T, 3N) stack; it
    # skips the masking the kernel and the plain version do
    fin = torch.isfinite(x)
    xz = torch.where(fin, x, torch.zeros_like(x))
    stack = torch.cat([xz, xz * xz, fin.to(x.dtype)], dim=1)
    del fin, xz
    library_ms = time_ms(lambda: torch.cumsum(stack, dim=0))
    del stack
    b_ms, b_by = bound(4 * x.numel() * x.element_size(), 4 * x.numel(), x.dtype)
    log(f"K3 {label}: kernel {ms:.4f} ms ({b_ms / ms:.1%} of the bound), plain "
        f"{plain_ms:.4f} ms, library cumsum over a pre-masked (T, 3N) stack "
        f"{library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    t, n = x.shape
    return dict(name=f"masked_cumulative_moments {t}x{n} {str(x.dtype)[6:]}",
                key="moments", route="cuda", source=K3_SOURCE, replaces=K3_REPLACES,
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, main_path=K3_MAIN_PATH)


def check_moments_repeat(x, label: str) -> None:
    """Two launches on the same input give the same bits: the two-pass scan
    adds in a fixed order and uses no atomics."""
    first = masked_cumulative_moments_cuda(x)
    second = masked_cumulative_moments_cuda(x)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"K3 {label}: two launches bit-identical={same}")
    check(same, f"K3 {label}: two launches on the same input differ")


def k3_phase(gen, timed: bool):
    rows = []
    for t, n, dtype, rel, scale, on_table in (
            (13312, 2432, torch.float32, 1e-4, 0.02, True),
            (600, 22000, torch.float32, 1e-4, 1.0, True),
            (13312, 2432, torch.float64, 1e-10, 0.02, True),
            # ragged: T not a multiple of the chunk, N not of 32
            (3001, 2437, torch.float32, 1e-4, 1.0, False),
            (3001, 2437, torch.float64, 1e-10, 1.0, False)):
        x = rolling_input(t, n, dtype, gen, scale, 0.02)
        label = f"{t}x{n} {str(dtype)[6:]}"
        log(f"K3 {label}: {len(moments_chunk_plan(t))} chunks of "
            f"{moments_chunk_rows(t)} rows")
        row = check_moments(x, rel, label, timed and on_table)
        if (t, n, dtype) == (13312, 2432, torch.float32):
            check_moments_repeat(x, label)
        if row:
            rows.append(row)
        del x
    torch.cuda.empty_cache()
    return rows


# --- the main path ---------------------------------------------------------


def reset_counts() -> None:
    multiproc.WORKER_LAUNCHES.clear()
    rolling_reduce_cuda.launches = 0
    rolling_reduce_cuda.launches_by_key = {}
    gram_contract_cuda.launches = 0
    gram_contract_cuda.launches_by_key = {}
    gram_fold_cuda.launches = 0
    gram_fold_cuda.launches_by_key = {}
    masked_cumulative_moments_cuda.launches = 0


def launch_counts() -> dict:
    """The launch counters since ``reset_counts``: K1 per kind, window and
    shape ("mean/w=120,600x15") and per kind ("mean/w=120"), K2 per shape
    ("gram/P=14,S=9,f32", a call cut into chunks counting each launch), the
    tile-pair kernel's pre-pass per shape ("fold/P=920,S=3,f32"), and the
    totals."""
    by_shape = dict(rolling_reduce_cuda.launches_by_key)
    by_kind = {}
    for key, n in by_shape.items():
        kind = key.split(",")[0]
        by_kind[kind] = by_kind.get(kind, 0) + n
    counts = {"k1": rolling_reduce_cuda.launches,
              "k2": gram_contract_cuda.launches,
              "fold": gram_fold_cuda.launches,
              "moments": masked_cumulative_moments_cuda.launches}
    counts.update(by_shape)
    counts.update(by_kind)
    counts.update({f"gram/{k}": v for k, v in gram_contract_cuda.launches_by_key.items()})
    counts.update({f"fold/{k}": v for k, v in gram_fold_cuda.launches_by_key.items()})
    return counts


def counted_run(base, daily, **kw):
    """One real-size f32 run with every launch counter set to 0 just
    before and read just after: (result, wall s, counts)."""
    reset_counts()
    start = time.perf_counter()
    res = run_pipeline(dense_base=base, compact_daily=daily, device="cuda", dtype=torch.float32, **kw)
    return res, time.perf_counter() - start, launch_counts()


def check_main_path_result(res) -> None:
    t2 = res.table_2
    finite = sum(int(np.isfinite(c["coef"]).sum() + np.isfinite(c["tstat"]).sum())
                 for c in res.table_2_cells.values())
    total = sum(2 * len(c["coef"]) for c in res.table_2_cells.values())
    log(f"Table 2 shape {t2.shape}; finite coef/tstat entries {finite}/{total}")
    log(t2.to_string())
    check(tuple(res.panel.values.shape) == (600, 22000, 27),
          f"enriched panel shape {tuple(res.panel.values.shape)}")
    check(t2.shape == (27, 9), f"Table 2 shape {t2.shape}")
    check(finite == total, "Table 2 has non-finite cells")
    check(all(c["mean_n"] > 0 and np.isfinite(c["mean_r2"])
              for c in res.table_2_cells.values()), "Table 2 N/R² not finite")

    t1 = res.table_1
    log(f"Table 1 shape {t1.shape}")
    log(t1.to_string())
    check(t1.shape == (15, 9), f"Table 1 shape {t1.shape}")
    for subset in res.subset_masks:
        has_n = t1[(subset, "N")].to_numpy() > 0
        for stat in ("Avg", "Std"):
            check(bool(np.isfinite(t1[(subset, stat)].to_numpy()[has_n]).all()),
                  f"Table 1 {subset} {stat} not finite where N > 0")
    dec = res.decile_table
    log(f"decile table shape {dec.shape}")
    log(dec.to_string())
    check(dec.shape == (13, 3), f"decile table shape {dec.shape}")
    check(bool((dec.loc["Months"].to_numpy() > 0).all()), "decile table: a universe has no months")
    check(bool(np.isfinite(dec.to_numpy(dtype=float)).all()), "decile table has non-finite cells")
    check(set(res.figure_1) == {"All stocks", "Large stocks"}, "Figure 1 frames missing")
    for name, frame in res.figure_1.items():
        rolled = frame.to_numpy()
        log(f"Figure 1 {name}: {frame.shape[0]} months, {int(np.isfinite(rolled).all(1).sum())} "
            f"with all five rolling slopes")
        check(frame.shape[1] == 5 and np.isfinite(rolled).all(1).any(),
              f"Figure 1 {name}: no finite rolling slopes")
    st = res.serving_state
    log(f"serving state coef {st.coef.shape}, months with a lagged coefficient mean "
        f"{int(st.have_coef().sum())}")
    check(st.coef.shape == (600, 6), f"serving state coef shape {st.coef.shape}")
    check(int(st.have_coef().sum()) > 0, "serving state has no quotable month")


SERVING_LEAVES = ("coef", "slopes_bar", "intercept_bar", "x_lo", "x_hi", "gram", "moment",
                  "n_obs", "ysum", "yy", "month_valid")


def artifact_digests(res) -> dict:
    """A sha256 of each artifact of a run: each frame's CSV text (Table 1,
    Table 2, the decile table, Figure 1's frames; exact for floats, which
    print at round-trip precision), and the array-bundle digest of Table
    2's per-cell numbers and of the serving state's leaves."""
    frames = {name: getattr(res, name) for name in ("table_1", "table_2", "decile_table")}
    frames.update({f"figure_1/{name}": frame for name, frame in (res.figure_1 or {}).items()})
    out = {name: hashlib.sha256(frame.to_csv().encode()).hexdigest()
           for name, frame in frames.items() if frame is not None}
    out["table_2_cells"] = array_bundle_digest({
        f"{model}|{subset}|{k}": np.asarray(v)
        for (model, subset), cell in res.table_2_cells.items() for k, v in cell.items()})
    if res.serving_state is not None:
        out["serving_state"] = array_bundle_digest(
            {leaf: getattr(res.serving_state, leaf) for leaf in SERVING_LEAVES})
    return out


def bit_differences(a, b) -> list:
    """The artifacts of two runs that are not bit-identical."""
    da, db = artifact_digests(a), artifact_digests(b)
    return sorted(name for name in set(da) | set(db) if da.get(name) != db.get(name))


MAIN_PATH_LAUNCHES = {"k1": 17, "k2": 2, "moments": 0}


def main_path(base, daily, audit_dir: Path):
    """The main path at real size: guarded with the drift sentinel armed,
    then unguarded (bit-identical, same launches), then guarded again on
    the same audit directory (the drift check passes by sha). Returns the
    first run's launch counts, artifact digests, its Table 2, Figure 1
    and decile frames (the Gram route's, for ``stacked_phase``) and its
    ``serving_reference`` (for ``serving_phase``)."""
    torch.cuda.reset_peak_memory_stats()
    res, wall, counts = counted_run(base, daily, guard=True, audit_dir=audit_dir)
    stages = res.stage_seconds
    log(f"main path (guarded) wall {wall:.3f} s; stages (s): "
        + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    log(f"main path peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    by_kind = {k: v for k, v in counts.items() if "/" in k and "," not in k
               and not k.startswith("gram/")}
    by_shape = {k: v for k, v in counts.items() if "," in k and not k.startswith("gram/")}
    log(f"main path launches: K1 {counts['k1']} {by_kind} by shape {by_shape}, "
        f"K2 {counts['k2']} {dict(gram_contract_cuda.launches_by_key)}, "
        f"K3 {counts['moments']}")
    log(f"guard stages: guard_panel_contracts {stages['guard_panel_contracts']:.4f} s, "
        f"guard_drift {stages['guard_drift']:.4f} s")
    audit = res.audit
    log("audit report: " + audit.report().replace("\n", "; "))
    check(not audit.violations and not audit.quarantined,
          "guarded main path: contract violations or quarantined artifacts")
    check(all(k.endswith(".cond_exceeded_months") for k in audit.counters),
          f"guarded main path: sentinel counters beyond conditioning: {dict(audit.counters)}")
    check({k: counts[k] for k in MAIN_PATH_LAUNCHES} == MAIN_PATH_LAUNCHES,
          f"main path launched K1 {counts['k1']}, K2 {counts['k2']}, K3 "
          f"{counts['moments']} times, not 17, 2 and 0")
    check(by_kind.get("mean/w=120", 0) > 0,
          "main path never launched the rolling kernel's mean w=120 (Figure 1, forecasts)")
    check_main_path_result(res)
    first = json.loads((audit_dir / "audit.json").read_text())

    plain, wall_off, counts_off = counted_run(base, daily, guard=False)
    diffs = bit_differences(res, plain)
    log(f"main path unguarded wall {wall_off:.3f} s (guarded {wall:.3f} s); "
        f"launches equal {counts_off == counts}; artifacts that differ in bits {diffs}; "
        "stages (s): " + json.dumps({k: round(v, 4) for k, v in plain.stage_seconds.items()}))
    check(counts_off == counts, "guard on and off launched the kernels differently")
    check(not diffs, f"guard on and off differ in {diffs}")
    check(plain.audit.ok() and "guard_panel_contracts" not in plain.stage_seconds,
          "the unguarded run ran the guard layer")
    del plain

    again, wall_again, _ = counted_run(base, daily, guard=True, audit_dir=audit_dir)
    second = json.loads((audit_dir / "audit.json").read_text())
    by_sha = sorted(name for name, art in second["artifacts"].items()
                    if art.get("sha256") and art["sha256"] == first["artifacts"][name].get("sha256"))
    same_probe = second["artifacts"]["panel_stats"] == first["artifacts"]["panel_stats"]
    log(f"second guarded run on the same audit dir: wall {wall_again:.3f} s, sha "
        f"short-circuit for {by_sha}, panel_stats identical {same_probe}; stages (s): "
        + json.dumps({k: round(v, 4) for k, v in again.stage_seconds.items()}))
    check(by_sha == ["decile_table", "serving_state", "table_1", "table_2"] and same_probe,
          "the second guarded run did not pass the drift check by sha")
    digests = artifact_digests(res)
    frames = {"table_2": res.table_2, "decile_table": res.decile_table,
              **{f"figure_1/{name}": frame for name, frame in res.figure_1.items()}}
    serving = serving_reference(res)
    del res, again
    torch.cuda.empty_cache()
    return counts, digests, frames, serving


def slot_phase(base, daily, digests: dict, registry_root: Path) -> None:
    """The real-size inputs through the prepared-inputs slot: written
    (``save_prepared``), mapped back (``load_prepared``), and run on the
    card with the registry armed at ``registry_root``; the run is
    bit-identical to the main path's in-memory (unarmed) run, with the same
    launches; its ``registry_publish`` stage leaves the serving state (the
    in-memory run's leaves, by sha256) and both kernel libraries in the
    registry, which verifies deep."""
    with tempfile.TemporaryDirectory() as tmp:
        slot = Path(tmp) / prepared.PREPARED_DIRNAME
        fingerprint = "chip-smoke real-size slot"
        start = time.perf_counter()
        prepared.save_prepared(slot, fingerprint, base, daily)
        save_s = time.perf_counter() - start
        files = list(slot.iterdir())
        slot_bytes = sum(p.stat().st_size for p in files)
        start = time.perf_counter()
        loaded = prepared.load_prepared(slot, fingerprint)
        load_s = time.perf_counter() - start
        check(loaded is not None, "the real-size slot did not load")
        with _env(FMRP_PREPARED_VERIFY=1):
            start = time.perf_counter()
            verified = prepared.load_prepared(slot, fingerprint)
            verify_s = time.perf_counter() - start
        check(verified is not None, "the real-size slot failed its sha256 verification")
        del verified
        log(f"prepared slot at real size: {slot_bytes:,} bytes in {len(files)} files; "
            f"save_prepared {save_s:.3f} s, load_prepared (memory-mapped) {load_s:.4f} s, "
            f"load_prepared with FMRP_PREPARED_VERIFY=1 {verify_s:.3f} s (page cache warm: "
            "the slot was just written)")
        res, wall, counts = counted_run(*loaded, registry_dir=registry_root)
        del loaded
        diffs = sorted(name for name, d in artifact_digests(res).items()
                       if digests.get(name) != d)
        launches = {k: counts[k] for k in MAIN_PATH_LAUNCHES}
        log(f"main path from the mapped slot, registry armed: wall {wall:.3f} s; launches "
            f"{launches}; artifacts that differ in bits from the in-memory unarmed run "
            f"{diffs}; stages (s): "
            + json.dumps({k: round(v, 4) for k, v in res.stage_seconds.items()}))
        check(not diffs, f"the run from the slot differs from the in-memory run in {diffs}")
        check(launches == MAIN_PATH_LAUNCHES, f"the run from the slot launched {launches}")
        reg = Registry(registry_root)
        entry = registry_artifacts.get_entry_dir("serving_state", registry=reg)
        published = ServingState.load(entry / "serving_state.npz")
        same_leaves = array_bundle_digest(
            {leaf: getattr(published, leaf) for leaf in SERVING_LEAVES}) == \
            digests["serving_state"]
        rows = reg.ls()
        bad = reg.verify(deep=True)
        log(f"registry after the armed run: stage registry_publish "
            f"{res.stage_seconds['registry_publish']:.4f} s; entries "
            + json.dumps([(r["kind"], r.get("program") or r.get("name"), r["bytes"])
                          for r in rows])
            + f"; the published serving state's leaves sha256-equal to the in-memory "
            f"unarmed run's {same_leaves}; verify(deep=True) faults {bad}")
        check(same_leaves, "the published serving state is not the run's")
        check(sorted(r.get("program") for r in rows if r["kind"] == "executable")
              == ["cuda_kernel:gram", "cuda_kernel:rolling"],
              "the kernel libraries were not published")
        check(not bad, f"the registry has corrupt entries: {bad}")
        del res, published
    torch.cuda.empty_cache()




# --- the telemetry layer and the online service ----------------------------

SERVING_MAX_BATCH = 256
SERVING_MONTHS = 12
# serving vs the batch forecast, f32: both sum the same six terms (the
# intercept and P = 5 products) in f32, in different orders (the batch's
# einsum, the serving loop over P in order), so they may differ by the
# rounding of such a sum: at most (P + 1)·eps32 of the terms' absolute sum
SERVING_ULPS = 8
PROFILE_KERNELS = {"k1": r"\brolling_reduce_kernel\b", "k2": r"\bgram(_tc)?_kernel\b",
                   "moments": r"\bmoments_(totals|scan)_kernel\b"}


def phase_timed(name: str, fn, *args):
    """Run one phase and print its seconds."""
    start = time.perf_counter()
    out = fn(*args)
    log(f"phase {name}: {time.perf_counter() - start:.1f} s")
    return out


def serving_reference(res) -> dict:
    """What the serving phase holds the service to, taken from a main-path
    run before it is freed: its serving state, and the batch forecast
    (``rolling_er_forecast`` on the "All stocks" figure model, from the
    run's own cross-sections, as the state) over the last
    ``SERVING_MONTHS`` months, with the rows to query (in the universe,
    with a realized return: the batch forecast's row set)."""
    y = res.panel.var("retx")
    x = res.panel.select(list(FIGURE1_VARS))
    mask = res.subset_masks["All stocks"]
    cs = CSRegressionResult(*(torch.as_tensor(np.asarray(a), device=y.device)
                              for a in res.sweep["All stocks"].cs))
    fr = rolling_er_forecast(y, x, mask, cs=cs)
    last = slice(-SERVING_MONTHS, None)
    t = y.shape[0]
    rows = (mask[last] & torch.isfinite(y[last])).cpu().numpy()
    return dict(state=res.serving_state, er=fr.er[last].cpu().numpy(),
                slopes_bar=fr.slopes_bar[last].cpu().numpy(),
                intercept_bar=fr.intercept_bar[last].cpu().numpy(),
                x=x[last].cpu().numpy(), rows=rows, months=np.arange(t - SERVING_MONTHS, t))


def _serving_worst(got, ref, months, firms) -> tuple:
    """The serving answers against the batch forecast: (the NaN patterns
    are equal, the worst |diff| over its bound, the worst |diff|), the
    bound ``SERVING_ULPS``·eps32 of |ā| + Σ|x_p b̄_p| (float64 on the host)."""
    state, slot = ref["state"], months - ref["months"][0]
    want = ref["er"][slot, firms]
    same_nan = bool(np.array_equal(np.isnan(got), np.isnan(want)))
    fin = np.isfinite(want)
    xq = ref["x"][slot, firms].astype(np.float64)
    terms = (np.abs(state.intercept_bar[months].astype(np.float64))
             + np.abs(xq * state.slopes_bar[months].astype(np.float64)).sum(-1))
    bound = SERVING_ULPS * np.finfo(np.float32).eps * terms
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))[fin]
    return same_nan, float((diff / bound[fin]).max(initial=0.0)), float(diff.max(initial=0.0))


def serving_phase(ref) -> None:
    """``ERService(device="cuda", max_batch=256)`` over the main path's
    serving state: every bucket captured once at warm-up; every universe
    row with a realized return of the last 12 months queried through
    ``submit_many`` in mixed batch sizes (1..256, seeded; p50/p99 latency
    and qps read from ``stats()`` after this pass) and again through
    ``query_many`` (256 rows a call), held against the batch forecast of
    the same run (NaN pattern exact, f32 pin ``SERVING_ULPS``); the real
    rows bit-equal across every bucket and between graph replay and an
    eager dispatch; no capture, no ledger record and no build-cache growth
    after warm-up; per bucket, the graph dispatch's time against the eager
    one's (host clock, each ends in a stream synchronize)."""
    state = ref["state"]
    slot_months, firms = np.nonzero(ref["rows"])
    months = ref["months"][slot_months]
    xq = ref["x"][slot_months, firms]
    n_rows = len(months)
    bars_equal = bool(np.array_equal(state.slopes_bar[ref["months"]], ref["slopes_bar"],
                                     equal_nan=True)
                      and np.array_equal(state.intercept_bar[ref["months"]],
                                         ref["intercept_bar"], equal_nan=True))
    check(bool((state.have_coef()[ref["months"]] == np.isfinite(ref["intercept_bar"])).all()),
          "serving state and batch forecast disagree on which months have a lagged mean")
    ledger_before = telemetry.cost_ledger().last_seq
    start = time.perf_counter()
    with ERService(state, max_batch=SERVING_MAX_BATCH, device="cuda") as svc:
        warm_s = time.perf_counter() - start
        buckets = svc.executor.buckets()
        captures = [r for r in telemetry.cost_ledger().since(ledger_before)
                    if r.program == "serving_bucket"]
        check(svc.executor.compiles == len(buckets) == len(captures)
              and all(r.provenance == "captured" for r in captures),
              f"warm-up captured {svc.executor.compiles} buckets for a ladder of "
              f"{len(buckets)}")
        log(f"serving: ERService over the main path's state ({state.n_months} months, "
            f"{state.n_predictors} predictors, f32) warm in {warm_s:.3f} s: {len(buckets)} "
            f"CUDA graphs captured, per bucket (ms) "
            + json.dumps({r.bucket: round(r.compile_s * 1e3, 3) for r in captures})
            + f"; serving bars equal the batch forecast's over the last {SERVING_MONTHS} "
            f"months: {bars_equal}")
        mark = telemetry.cost_ledger().last_seq
        with telemetry.recompile_watch("serving", warm=True) as watch:
            first_s = time_host(svc.query, int(months[0]), xq[0])
            rng = np.random.default_rng(SERVING_MAX_BATCH)
            got = np.empty(n_rows)
            start = time.perf_counter()
            lo = 0
            while lo < n_rows:
                hi = min(n_rows, lo + int(rng.integers(1, SERVING_MAX_BATCH + 1)))
                out = svc.submit_many([(int(m), r) for m, r in zip(months[lo:hi], xq[lo:hi])])
                check(all(kind == "ok" for kind, _ in out), "submit_many refused a request")
                got[lo:hi] = [fut.result(timeout=60) for _, fut in out]
                lo = hi
            submit_s = time.perf_counter() - start
            stats = svc.stats()
            start = time.perf_counter()
            again = np.concatenate([
                svc.query_many(list(months[k:k + SERVING_MAX_BATCH]),
                               list(xq[k:k + SERVING_MAX_BATCH]), timeout=60)
                for k in range(0, n_rows, SERVING_MAX_BATCH)])
            query_s = time.perf_counter() - start
            end_stats = svc.stats()
            # bits across buckets and graph vs eager, on the first 256 rows
            head_m, head_x = months[:SERVING_MAX_BATCH], xq[:SERVING_MAX_BATCH]
            full = svc.executor.run(head_m, head_x)
            cross = {}
            for size in (*buckets, 3, 5, 100, 255):
                parts = [svc.executor.run(head_m[k:k + size], head_x[k:k + size])
                         for k in range(0, len(head_m), size)]
                cross[size] = bool(np.array_equal(np.concatenate(parts), full, equal_nan=True))
            eager = svc.executor.run_eager(head_m, head_x)
            graph_eq_eager = bool(np.array_equal(eager, full, equal_nan=True))
            timing = {}
            for b in buckets:
                bm, bx = head_m[:b], head_x[:b]
                g = [time_host(svc.executor.run, bm, bx) for _ in range(15)]
                e = [time_host(svc.executor.run_eager, bm, bx) for _ in range(15)]
                timing[b] = (float(np.median(g)) * 1e3, float(np.median(e)) * 1e3)
        compiles, misses = svc.executor.compiles, end_stats["executable_cache_misses"]
    after = telemetry.cost_ledger().since(mark)
    same_nan, worst, worst_abs = _serving_worst(got, ref, months, firms)
    same_nan2, worst2, _ = _serving_worst(again, ref, months, firms)
    log(f"serving: {n_rows} rows (last {SERVING_MONTHS} months, {int(np.isfinite(got).sum())} "
        f"answered): submit_many in mixed batches {submit_s:.3f} s "
        f"({n_rows / submit_s:.0f} rows/s), query_many 256 at a time {query_s:.3f} s "
        f"({n_rows / query_s:.0f} rows/s); vs the batch forecast: NaN pattern equal "
        f"{same_nan and same_nan2}, worst |diff| {worst_abs:.3e} = {max(worst, worst2):.3f} of "
        f"the bound ({SERVING_ULPS}·eps32·(|a|+Σ|x b|)); the two passes bit-equal "
        f"{bool(np.array_equal(got, again, equal_nan=True))}")
    log(f"serving: the first query after warm-up took {first_s * 1e3:.3f} ms; stats after "
        f"the submit_many pass: p50 {stats['p50_ms']:.3f} ms, p99 "
        f"{stats['p99_ms']:.3f} ms, qps {stats['qps']:.0f} (since warm-up), batches "
        f"{stats['n_batches']}, occupancy {stats['batch_occupancy']:.3f}, hits "
        f"{stats['executable_cache_hits']}, misses {stats['executable_cache_misses']}, "
        f"compiles {stats['executable_compiles']}")
    log("serving bits: real rows equal across bucket sizes "
        + json.dumps({str(k): v for k, v in cross.items()})
        + f"; graph replay = eager dispatch {graph_eq_eager}")
    log("serving dispatch per bucket, graph vs eager (ms, median of 15, host clock to the "
        "synchronized result): "
        + json.dumps({b: [round(g, 4), round(e, 4)] for b, (g, e) in timing.items()}))
    check(same_nan and same_nan2, "serving NaN pattern differs from the batch forecast")
    check(worst <= 1.0 and worst2 <= 1.0, "serving differs from the batch forecast beyond "
          "its f32 pin")
    check(all(cross.values()), f"real rows differ in bits across buckets: {cross}")
    check(graph_eq_eager, "graph replay and eager dispatch differ in bits")
    check(misses == 0 and compiles == len(buckets) and not after and watch.grew == 0,
          f"a capture or a build after warm-up: misses {misses}, compiles {compiles}, "
          f"ledger records {len(after)}, build cache +{watch.grew}")
    return got


def time_host(fn, *args) -> float:
    start = time.perf_counter()
    fn(*args)
    return time.perf_counter() - start


def service_ingest_phase(prior, row, month, card) -> None:
    """``ERService.ingest_month`` on the card (float64, the real-size
    serving state of ``ingest_phase``): a NaN flood injected at
    ``serving.ingest`` (``poison_nan_flood``) quarantines the month under
    ``cs.nan_flood`` and the service keeps quoting from its previous state;
    the clean month then swaps in behind a freshly captured executor while
    two client threads keep quoting the previous month (every answer its
    previous bits), its state equal to ``serving.ingest.ingest_month``'s
    and its quotes to that state's projection (rtol 1e-9, atol 1e-12)."""
    rows = np.nonzero(row[2] & np.isfinite(row[1]).all(1))[0][:SERVING_MAX_BATCH]
    prev = prior.n_months - 1
    with ERService(prior, max_batch=SERVING_MAX_BATCH, device="cuda") as svc:
        before = svc.query_many([prev] * len(rows), list(row[1][rows]), timeout=60)
        with FaultPlan({"serving.ingest": FaultSpec(times=1, mutate=poison_nan_flood)}):
            poisoned = svc.ingest_month(*row, month)
        reasons = svc.quarantined_months()
        still = svc.query_many([prev] * len(rows), list(row[1][rows]), timeout=60)
        # the swap under load: two client threads keep quoting the previous
        # month while the ingest thread captures the new executor's graphs;
        # every answer must be the previous bits, from either executor
        stop, served, wrong = threading.Event(), [0, 0], []

        def client(k):
            while not stop.is_set():
                got = svc.query_many([prev] * len(rows), list(row[1][rows]), timeout=60)
                served[k] += len(rows)
                if not np.array_equal(got, before, equal_nan=True):
                    wrong.append(k)

        clients = [threading.Thread(target=client, args=(k,)) for k in range(2)]
        for th in clients:
            th.start()
        start = time.perf_counter()
        try:
            healed = svc.ingest_month(*row, month)
            ingest_s = time.perf_counter() - start
            time.sleep(0.2)
        finally:
            stop.set()
            for th in clients:
                th.join(timeout=60)
        check(not any(th.is_alive() for th in clients), "a serving client hung")
        quotes = svc.query_many([svc.state.n_months - 1] * len(rows), list(row[1][rows]),
                                timeout=60)
        stats = svc.stats()
        state = svc.state
    t = state.n_months - 1
    want = state.intercept_bar[t] + np.clip(row[1][rows], state.x_lo[t],
                                            state.x_hi[t]) @ state.slopes_bar[t]
    leaves_equal = all(np.array_equal(getattr(state, leaf), getattr(card, leaf), equal_nan=True)
                       for leaf in SERVING_LEAVES)
    quote_ok = bool(np.allclose(quotes, want, rtol=1e-9, atol=1e-12, equal_nan=True))
    log(f"service ingest (f64, {len(rows)} quoted rows): poisoned month accepted {poisoned}, "
        f"quarantined {sorted(reasons)} ({next(iter(reasons.values()), '')[:80]}), quotes "
        f"unchanged {bool(np.array_equal(before, still, equal_nan=True))}; clean month "
        f"accepted {healed} in {ingest_s:.3f} s (ingest + {len(svc.executor.buckets())} "
        f"captures) while two clients quoted {sum(served)} rows of the previous month "
        f"({len(wrong)} answers off its bits), state equal to ingest_month's "
        f"{leaves_equal}, quotes within rtol 1e-9 "
        f"{quote_ok}; compiles {stats['executable_compiles']}, misses "
        f"{stats['executable_cache_misses']}, degraded {stats['degraded']}")
    check(not poisoned and any("cs.nan_flood" in r for r in reasons.values()),
          "the poisoned month was not quarantined under cs.nan_flood")
    check(bool(np.array_equal(before, still, equal_nan=True)),
          "the quarantine changed the service's quotes")
    check(healed and not stats["degraded"] and state.n_months == prior.n_months + 1,
          "the clean month did not swap in")
    check(leaves_equal and quote_ok, "service ingest differs from ingest_month")
    check(not wrong and min(served) > 0, "quotes during the swap were wrong or none served")
    check(stats["executable_cache_misses"] == 0, "a query after the swap built a bucket")


# --- the registry and the serving fleet ---------------------------------------

# A fresh process with an empty build directory and the registry armed: it
# must load both kernel libraries from the registry (no nvcc build) and hold
# each kernel against its plain version at a main-path shape.
EXECUTABLE_PLANE_CHILD = """
import json, os, sys, time
start = time.perf_counter()
import torch
from fm_returnprediction_tpu_torch import cuda_build
torch.cuda.init()
ready = time.perf_counter()
seconds = cuda_build.build_kernels()
for name in cuda_build.KERNEL_SOURCES:
    cuda_build._library(name)
fetch_s = time.perf_counter() - ready
import chip_smoke as cs
from fm_returnprediction_tpu_torch.ops.rolling import rolling_reduce_cuda
from fm_returnprediction_tpu_torch.specgrid.grams import gram_contract_cuda
gen = torch.Generator(device="cuda")
gen.manual_seed(int(sys.argv[1]))
x = cs.rolling_input(600, 22000, torch.float32, gen, 1.0, 0.02)
k1_err = cs.check_rolling(x, 12, 1, "sum", 1e-4, "sum w=12 mp=1 600x22000 float32 (fetched)")
del x
cs.check_gram(600, 22000, 14, torch.float32, 1e-5, gen, False)
print("EXE-PLANE " + json.dumps({
    "seconds": seconds, "fetch_s": fetch_s, "start_s": ready - start,
    "nvcc_builds": cuda_build.NVCC_RUNS,
    "build_dir": sorted(os.listdir(cuda_build.build_dir()))
    if cuda_build.build_dir().exists() else [],
    "fetched": {k: str(v[0]) for k, v in cuda_build._FETCHED.items()},
    "launches": {"k1": rolling_reduce_cuda.launches, "k2": gram_contract_cuda.launches},
    "k1_max_abs": k1_err}))
"""
# the journaled passes are cut short: every journal event is written and
# flushed, so they run at ~2k rows/s (PERF.md, Findings)
FLEET_JOURNALED_ROWS = 4096    # rows of the journaled pass the kill lands in
# rows of the socket process fleet's pass (the socket transport moves ~1,500
# rows/s: 60 s for all 88,157)
PROCESS_SOCKET_ROWS = 4096
# rows of the thread fleets' and the shm process fleet's passes: the first
# of the serving phase's rows, cut from all 88,157 for the script's time
FLEET_ROWS = 16384
FLEET_KILL_AT = 3000           # the routed request the kill lands on
FLEET_CRASH_AT = 2000          # the admitted request the hard crash lands between
FLEET_RECOVER_ROWS = 4096      # rows the recovered fleet quotes against the bare service
JOURNAL_APPENDS = 20000        # appends timed per journal location
FLEET_CYCLES = 5               # kill → replace cycles before the memory reading
BROWNOUT_FILL = 400            # rows queued (auto_flush off) to pin the occupancy
BROWNOUT_ROWS = 4096           # rows offered once the ladder is at coreset
LOADGEN_REQUESTS, LOADGEN_WORKERS = 2048, 32


def registry_phase(registry_root: Path, seed: int, cold_build: dict, state) -> None:
    """The executable plane from a fresh process, and the warm pool."""
    with tempfile.TemporaryDirectory() as build:
        start = time.perf_counter()
        done = subprocess.run(
            [sys.executable, "-c", EXECUTABLE_PLANE_CHILD, str(seed)],
            cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600,
            env={**os.environ, "FMRP_REGISTRY_DIR": str(registry_root),
                 "FMRP_CUDA_BUILD_DIR": build})
        wall = time.perf_counter() - start
    check(done.returncode == 0, f"the executable-plane process exited {done.returncode}: "
          f"{done.stderr[-3000:]}{done.stdout[-2000:]}")
    child = json.loads(done.stdout.split("EXE-PLANE ", 1)[1].splitlines()[0])
    root = str(registry_root)
    log(f"executable plane, a fresh process (empty build directory, registry armed): "
        f"process wall {wall:.2f} s ({child['start_s']:.2f} s to torch and the card); "
        f"fetch and load of both libraries {child['fetch_s']:.3f} s against the cold nvcc "
        f"build {max(cold_build.values()):.2f} s ({json.dumps({k: round(v, 2) for k, v in cold_build.items()})}); "
        f"nvcc builds {child['nvcc_builds']}, build directory {child['build_dir']}, loaded "
        f"from the registry {sorted(child['fetched'])}; K1 and K2 held against their plain "
        f"versions there (launches {child['launches']})")
    check(child["nvcc_builds"] == 0 and not child["build_dir"], "the fresh process built")
    check(sorted(child["fetched"]) == ["gram", "rolling"]
          and all(p.startswith(root) for p in child["fetched"].values()),
          f"the fresh process did not load both libraries from the registry: {child}")
    # K2 twice: check_gram's call and the repeat it holds bit for bit
    check(child["launches"] == {"k1": 1, "k2": 2}, f"fetched kernels launched {child}")

    start = time.perf_counter()
    svc, report = warm_from_registry(registry_dir=registry_root, max_batch=SERVING_MAX_BATCH,
                                     strict=True, device="cuda")
    wall = time.perf_counter() - start
    same = bool(np.array_equal(svc.state.slopes_bar, state.slopes_bar, equal_nan=True))
    svc.close()
    svc.release()
    log(f"warm pool: warm_from_registry over the published state in {wall:.3f} s (the "
        f"service's warm-up {report.wall_s:.3f} s): builds {report.builds}, captures "
        f"{report.captures}, libraries fetched {report.fetched}; state equal to the main "
        f"path's {same}")
    check(report.builds == 0 and report.captures == 9 and same,
          f"the warm pool's report {report}")


def _fleet_pass(fleet, months, xq, n=None) -> tuple:
    """Every row (or the first ``n``) through ``fleet.submit`` in the
    serving phase's seeded mixed batches (1..256): each batch's requests
    submitted, then their quotes gathered. Returns (quotes, seconds)."""
    n = len(months) if n is None else n
    rng = np.random.default_rng(SERVING_MAX_BATCH)
    got = np.empty(n)
    start = time.perf_counter()
    lo = 0
    while lo < n:
        hi = min(n, lo + int(rng.integers(1, SERVING_MAX_BATCH + 1)))
        futs = [fleet.submit(int(m), r) for m, r in zip(months[lo:hi], xq[lo:hi])]
        got[lo:hi] = [f.result(timeout=60) for f in futs]
        lo = hi
    return got, time.perf_counter() - start


def _replica_latency(fleet) -> tuple:
    """The worst replica's p50 and p99 (ms) from its own ``stats()``."""
    stats = [fleet.replica(r).service.stats() for r in fleet.replica_states()]
    return max(s["p50_ms"] for s in stats), max(s["p99_ms"] for s in stats)


def _serving_bound(ref, months, firms) -> np.ndarray:
    """``SERVING_ULPS``·eps32·(|ā| + Σ|x_p b̄_p|) per row (float64 host)."""
    state, slot = ref["state"], months - ref["months"][0]
    xq = ref["x"][slot, firms].astype(np.float64)
    terms = (np.abs(state.intercept_bar[months].astype(np.float64))
             + np.abs(xq * state.slopes_bar[months].astype(np.float64)).sum(-1))
    return SERVING_ULPS * np.finfo(np.float32).eps * terms


def _journal_append_us(directory) -> float:
    """Microseconds per ``RequestJournal.append`` (each one written and
    flushed, write-ahead) in ``directory``, one thread."""
    from fm_returnprediction_tpu_torch.serving import RequestJournal

    with tempfile.TemporaryDirectory(dir=directory) as tmp:
        with RequestJournal(Path(tmp) / "bench.jsonl") as journal:
            start = time.perf_counter()
            for k in range(JOURNAL_APPENDS):
                journal.append("admit", k)
            return (time.perf_counter() - start) / JOURNAL_APPENDS * 1e6


def fleet_phase(ref, bare: np.ndarray, registry_root: Path) -> dict:
    """The serving fleet at real size over the main path's f32 state;
    returns the thread fleets' rows/s by size (process_fleet_phase reads
    its process replicas against them)."""
    rates = {}
    state = ref["state"]
    slot_months, firms = np.nonzero(ref["rows"])
    months = ref["months"][slot_months]
    xq = ref["x"][slot_months, firms]
    n_rows = min(FLEET_ROWS, len(months))
    kw = dict(max_batch=SERVING_MAX_BATCH, registry_dir=registry_root, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        journal = Path(tmp) / "fleet.jsonl"
        for size in (1, 2):
            fleet = ServingFleet(state, size, **kw)
            got, wall = _fleet_pass(fleet, months, xq, n_rows)
            p50, p99 = _replica_latency(fleet)
            equal = bool(np.array_equal(got, bare[:n_rows], equal_nan=True))
            log(f"fleet of {size}: {n_rows} rows in mixed batches in {wall:.3f} s "
                f"({n_rows / wall:.0f} rows/s), worst replica p50 {p50:.3f} ms p99 "
                f"{p99:.3f} ms; every quote bit-equal to the bare service's {equal}; warm "
                f"reports (builds, captures) "
                + json.dumps({r: (w.builds, w.captures) for r, w in fleet.warm_reports.items()}))
            check(equal, f"the fleet of {size} quotes differ from the bare service's")
            check(all(w.builds == 0 and w.captures == 9 for w in fleet.warm_reports.values()),
                  "a fleet replica's warm-up built or did not capture 9 buckets")
            fleet.close()
            rates[size] = n_rows / wall

        # the journal's cost: every event is written and flushed before the
        # action it records, so its rate is the file system's
        where = {"TMPDIR": tempfile.gettempdir()}
        if os.path.isdir("/dev/shm") and os.access("/dev/shm", os.W_OK):
            where["/dev/shm"] = "/dev/shm"
        append_us = {name: _journal_append_us(d) for name, d in where.items()}
        log("journal append (written and flushed), µs each over "
            f"{JOURNAL_APPENDS} appends: "
            + json.dumps({k: round(v, 2) for k, v in append_us.items()})
            + f" (TMPDIR {where['TMPDIR']})")

        fleet = ServingFleet(state, 2, journal=journal, **kw)
        # the routed replica killed under load, one tick replacing it
        killed = {}
        armed = threading.Event()

        def stamped_kill(payload):
            killed["t"], killed["rid"] = time.perf_counter(), payload[1]
            fleet_kill_routed()(payload)
            armed.set()
            return payload

        out = {}

        def load():
            out["got"], out["wall"] = _fleet_pass(fleet, months, xq, FLEET_JOURNALED_ROWS)

        with FaultPlan({"fleet.replica_kill": FaultSpec(skip=FLEET_KILL_AT, times=1,
                                                        mutate=stamped_kill)}) as plan:
            worker = threading.Thread(target=load)
            worker.start()
            check(armed.wait(timeout=120), "the kill never fired")
            actions = fleet.supervisor.tick()
            new = [r for r in fleet.replica_states() if r not in ("r0", "r1")]
            key = next(str(k) for k in range(100000) if fleet._ring.route(str(k)) in new)
            fleet.submit(int(months[0]), xq[0], key=key).result(timeout=60)
            first_s = time.perf_counter() - killed["t"]
            worker.join(timeout=300)
        check(not worker.is_alive() and plan.fired["fleet.replica_kill"] == 1,
              "the kill-under-load pass did not finish")
        fleet.drain(timeout=60)
        stats = fleet.stats()
        replay = replay_journal(journal)
        warm = fleet.warm_reports[new[0]]
        equal = bool(np.array_equal(out["got"], bare[:FLEET_JOURNALED_ROWS], equal_nan=True))
        log(f"kill under load: a journaled fleet of 2 quoting {FLEET_JOURNALED_ROWS} rows; "
            f"{killed['rid']} killed at routed request {FLEET_KILL_AT}; tick "
            f"{actions}; the replacement {new[0]} warmed in {warm.wall_s:.3f} s (builds "
            f"{warm.builds}, captures {warm.captures}); kill → its first quote "
            f"{first_s * 1e3:.1f} ms; the pass {out['wall']:.3f} s "
            f"({FLEET_JOURNALED_ROWS / out['wall']:.0f} rows/s), requeues "
            f"{stats['requeues_total']}, every quote bit-equal {equal}; journal: admitted "
            f"{replay.n_admitted}, done {replay.n_done}, dropped {len(replay.dropped)}, "
            f"duplicated {len(replay.duplicated)}, requeues {replay.n_requeues}, clean "
            f"{replay.clean}")
        check(actions == [f"failover:{killed['rid']}->{new[0]}"] and warm.builds == 0,
              f"the tick did not replace the killed replica through the warm pool: {actions}")
        check(equal and replay.clean and not replay.dropped and not replay.duplicated,
              "the kill under load lost, duplicated or changed a quote")

        # hard crash with a torn tail, then recovery from the registry
        crash_out = {}
        with FaultPlan({"fleet.hard_crash": FaultSpec(skip=FLEET_CRASH_AT, times=1,
                                                      mutate=fleet_hard_crash),
                        "fleet.journal_torn_tail": FaultSpec(times=1,
                                                             corrupt=tear_journal_tail)}) as plan:
            try:
                _fleet_pass(fleet, months, xq)
            except Exception as exc:  # noqa: BLE001 — the crash ends the pass
                crash_out["exc"] = type(exc).__name__
        check(plan.fired["fleet.hard_crash"] == 1
              and plan.fired["fleet.journal_torn_tail"] == 1, "the hard crash did not fire")
        start = time.perf_counter()
        recovered, report = ServingFleet.recover(journal, **kw)
        recover_s = time.perf_counter() - start
        got, _ = _fleet_pass(recovered, months, xq, FLEET_RECOVER_ROWS)
        equal = bool(np.array_equal(got, bare[:FLEET_RECOVER_ROWS], equal_nan=True))
        log(f"hard crash at admitted request {FLEET_CRASH_AT} ({crash_out.get('exc')}), then "
            f"ServingFleet.recover in {recover_s:.3f} s: torn lines {report.journal.torn_lines} "
            f"({report.journal.torn_bytes} bytes), closed out "
            f"{len(report.journal.recovered)} in-flight, replays clean {report.clean}, "
            f"{report.n_replicas} replicas ({report.zero_compile_starts} without a build), "
            f"state {report.state_source.split(':')[0]}; {FLEET_RECOVER_ROWS} rows quoted "
            f"bit-equal {equal}")
        check(report.journal.torn_lines == 1 and report.clean and report.n_replicas == 2
              and report.zero_compile_starts == 2 and equal,
              f"recovery: {report}")

        # one LoadGen burst against the capacity model
        model = capacity_model(recovered)
        load = LoadGen(recovered, months, xq, seed=SERVING_MAX_BATCH).run(
            [LoadPhase("burst", n_requests=LOADGEN_REQUESTS, workers=LOADGEN_WORKERS)])
        phase = load["phases"][0]
        log(f"LoadGen burst ({LOADGEN_REQUESTS} requests, {LOADGEN_WORKERS} closed-loop "
            f"workers, 2 replicas): {phase['rows_per_s']:.0f} rows/s, p50 {phase['p50_ms']} "
            f"ms, p99 {phase['p99_ms']} ms, ok {phase['ok']}, shed {phase['shed']}, errors "
            f"{phase['errors']}; capacity_model {json.dumps(model)}; measured / predicted "
            f"{phase['rows_per_s'] / model['predicted_rows_per_s']:.4f}")
        check(phase["ok"] == LOADGEN_REQUESTS and phase["errors"] == 0,
              f"the LoadGen burst: {phase}")

        # kill → replace cycles and the card's allocated memory
        def cycle():
            victim = sorted(recovered.replica_states())[0]
            recovered.kill_replica(victim, reason="memory cycle")
            check(recovered.supervisor.tick()[0].startswith(f"failover:{victim}"),
                  "a memory cycle did not fail over")

        cycle()
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        (extra,) = recovered.scale_out(1, reason="footprint")
        torch.cuda.synchronize()
        footprint = torch.cuda.memory_allocated() - base_bytes
        recovered.kill_replica(extra, reason="footprint")
        recovered.retire(extra)
        for _ in range(FLEET_CYCLES):
            cycle()
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - base_bytes
        log(f"memory: one replica holds {footprint:,} bytes on the card; after "
            f"{FLEET_CYCLES} kill → replace cycles the allocated memory moved {grown:+,} bytes "
            f"(tolerance: half of one replica, {footprint // 2:,}); reserved "
            f"{torch.cuda.memory_reserved():,} bytes")
        check(footprint > 0 and grown <= footprint // 2,
              "kill → replace cycles leave device memory behind")
        recovered.close()

    # brownout on a tight token bucket
    clk = [0.0]
    fleet = ServingFleet(state, 2, max_batch=SERVING_MAX_BATCH, max_queue=256,
                         auto_flush=False, device="cuda", admission_clock=lambda: clk[0],
                         admission=AdmissionPolicy(rate_per_s=2000.0, burst=64.0),
                         brownout=BrownoutPolicy(ladder=("full", "coreset", "shed"),
                                                 enter_burn=1e9, exit_burn=1.0,
                                                 enter_occupancy=0.5, exit_occupancy=0.1,
                                                 dwell_ticks=1, recover_ticks=3))
    try:
        offered, queued, degraded, shed = 0, [], [], 0
        for k in range(BROWNOUT_FILL + BROWNOUT_ROWS):
            if k == BROWNOUT_FILL:
                actions = fleet.supervisor.tick()
                check(actions == ["brownout:coreset"], f"the ladder did not engage: {actions}")
            clk[0] += 0.0004            # 2,500 offered a second against 2,000 admitted
            offered += 1
            try:
                fut = fleet.submit(int(months[k]), xq[k])
            except ServiceOverloadError as exc:
                check(exc.reason == "token_bucket", f"an unexpected shed {exc.reason}")
                shed += 1
                continue
            (queued if k < BROWNOUT_FILL else degraded).append((k, fut))
        fleet.flush_all()
        full = np.asarray([f.result(timeout=60) for _, f in queued])
        idx = np.asarray([k for k, _ in degraded])
        quotes = [f.result(timeout=60) for _, f in degraded]
        q = np.asarray([float(v) for v in quotes])
        # a quote the row cannot answer is NaN and carries no bound
        disclosed = all(isinstance(v, DegradedQuote) and v.route == "coreset"
                        and v.m == (state.n_predictors + 1) // 2
                        and (v.err_bound is not None or np.isnan(v)) for v in quotes)
        bound_ = np.asarray([np.nan if v.err_bound is None else v.err_bound
                             for v in quotes]) + _serving_bound(ref, months[idx], firms[idx])
        want = bare[idx]
        same_nan = bool(np.array_equal(np.isnan(q), np.isnan(want)))
        fin = np.isfinite(want)
        ratio = float((np.abs(q - want)[fin] / bound_[fin]).max(initial=0.0))
        full_equal = bool(np.array_equal(full, bare[[k for k, _ in queued]], equal_nan=True))
        log(f"brownout (token bucket 2,000/s, burst 64; {offered} offered at 2,500/s): ladder "
            f"at coreset after {BROWNOUT_FILL} queued rows; degraded share "
            f"{len(quotes) / offered:.4f}, shed share {shed / offered:.4f}, queued full "
            f"{len(queued) / offered:.4f} (bit-equal to the bare service {full_equal}); every "
            f"degraded quote disclosed {disclosed}, NaN pattern equal {same_nan}, worst "
            f"|degraded − full| / (err_bound + {SERVING_ULPS}·eps32 of the terms) {ratio:.4f}; "
            f"err_bound median {float(np.median(bound_[fin])):.3e}")
        check(disclosed and same_nan and ratio <= 1.0 and full_equal and shed > 0,
              "a degraded quote was undisclosed or beyond its bound")
    finally:
        fleet.close()
    return rates


def shm_room() -> str:
    """``/dev/shm``'s size and free bytes, for the log."""
    try:
        st = os.statvfs("/dev/shm")
    except OSError as exc:
        return f"/dev/shm unreadable ({exc})"
    return (f"/dev/shm size {st.f_blocks * st.f_frsize:,} bytes, free "
            f"{st.f_bavail * st.f_frsize:,}")


def _device_free() -> int:
    torch.cuda.synchronize()
    return int(torch.cuda.mem_get_info()[0])


def process_fleet_phase(ref, bare: np.ndarray, registry_root: Path, thread_rates: dict) -> None:
    """Process replicas at real size over the main path's f32 state: a
    fleet of 2 replica processes (each its own CUDA context, warmed from
    the registry) over the socket and, where ``/dev/shm`` fits the rings,
    the shm transport, each quoting every row of the serving phase in the
    same mixed batches (the socket fleet the first ``PROCESS_SOCKET_ROWS``
    where the shm fleet runs), bit-equal to the bare service, with p50/p99
    and rows/s beside the thread fleets'; then a journaled, traced fleet of 2
    with one replica SIGKILLed under load: the supervisor replaces it, the
    journal replays clean, the quotes stay bit-equal, and the card's free
    memory comes back within one replica's share; then the trace merge
    (``python -m fm_returnprediction_tpu_torch.telemetry.timeline``)
    exits 0 and prints its hop table."""
    from fm_returnprediction_tpu_torch.parallel.shm import HEADER_BYTES, shm_available

    state = ref["state"]
    slot_months, firms = np.nonzero(ref["rows"])
    months = ref["months"][slot_months]
    xq = ref["x"][slot_months, firms]
    n_rows = len(months)
    kw = dict(max_batch=SERVING_MAX_BATCH, registry_dir=registry_root, device="cuda",
              replica_mode="process")
    transports = ["socket"]
    if shm_available(2 * (HEADER_BYTES + 64 * 65536)):
        transports.append("shm")
    log(f"process fleet: {shm_room()}; transports {transports}")
    for transport in transports:
        n = min(PROCESS_SOCKET_ROWS if transport == "socket" and len(transports) > 1
                else FLEET_ROWS, n_rows)
        free0 = _device_free()
        start = time.perf_counter()
        fleet = ServingFleet(state, 2, transport=transport, **kw)
        spawn_s = time.perf_counter() - start
        share = (free0 - _device_free()) // 2
        try:
            got, wall = _fleet_pass(fleet, months, xq, n)
            p50, p99 = _replica_latency(fleet)
            warm = {r: (w.builds, w.captures) for r, w in fleet.warm_reports.items()}
            st = fleet.stats()
        finally:
            fleet.close()
        equal = bool(np.array_equal(got, bare[:n], equal_nan=True))
        log(f"process fleet of 2 ({transport}): spawned in {spawn_s:.2f} s, "
            f"{share:,} bytes of the card per replica process; {n} rows in mixed batches "
            f"in {wall:.3f} s ({n / wall:.0f} rows/s against the thread fleet's "
            f"{thread_rates[2]:.0f} with 2 replicas and {thread_rates[1]:.0f} with 1), worst "
            f"replica p50 {p50:.3f} ms p99 {p99:.3f} ms; transport {st['transport']}; every "
            f"quote bit-equal to the bare service's {equal}; warm reports (builds, captures) "
            + json.dumps(warm))
        check(equal, f"the process fleet ({transport}) quotes differ from the bare service's")
        check(st["transport"] == transport, f"the fleet ran on {st['transport']}")
        check(all(b == 0 and c == 9 for b, c in warm.values()),
              "a replica process built a kernel or did not capture 9 buckets")

    with tempfile.TemporaryDirectory() as tmp:
        journal, trace_dir = Path(tmp) / "proc.jsonl", Path(tmp) / "trace"
        out = {}
        with _env(FMRP_TELEMETRY=1, FMRP_TRACE_DIR=trace_dir):
            with telemetry.tracing(str(trace_dir)):
                free0 = _device_free()
                fleet = ServingFleet(state, 2, journal=journal, transport=transports[-1], **kw)
                free1 = _device_free()
                share = (free0 - free1) // 2
                try:
                    victim = fleet.replica("r0").service.proc

                    def load():
                        out["got"], out["wall"] = _fleet_pass(fleet, months, xq,
                                                              FLEET_JOURNALED_ROWS)

                    worker = threading.Thread(target=load)
                    worker.start()
                    time.sleep(0.5)
                    victim.kill()
                    victim.wait(timeout=60)
                    killed = time.perf_counter()
                    actions = []
                    while "r0" in fleet.replica_states() and time.perf_counter() - killed < 120:
                        actions += fleet.supervisor.tick()
                        time.sleep(0.05)
                    replaced_s = time.perf_counter() - killed
                    worker.join(timeout=300)
                    fleet.drain(timeout=60)
                    free2 = _device_free()
                    stats = fleet.stats()
                    # this session's replay, before the topology pass crashes the
                    # fleet and its recovery starts a new session on the path
                    replay = replay_journal(journal)
                    topology_pass(fleet, transports[-1], journal, registry_root, months, xq,
                                  bare)
                finally:
                    fleet.close()
                free3 = _device_free()
        check(not worker.is_alive(), "the kill-under-load pass did not finish")
        equal = bool(np.array_equal(out["got"], bare[:FLEET_JOURNALED_ROWS], equal_nan=True))
        log(f"process fleet SIGKILL under load ({transports[-1]}, journaled, traced): r0 "
            f"(pid {victim.pid}) killed; ticks {actions}; replaced {replaced_s * 1e3:.1f} ms "
            f"after the kill; the pass of {FLEET_JOURNALED_ROWS} rows {out['wall']:.3f} s, "
            f"requeues {stats['requeues_total']}, every quote bit-equal {equal}; journal: "
            f"admitted {replay.n_admitted}, dropped {len(replay.dropped)}, duplicated "
            f"{len(replay.duplicated)}, clean {replay.clean}; the card's free memory: before "
            f"{free0:,}, fleet up {free1:,} ({share:,} per replica), after kill → replace "
            f"{free2:,} ({free2 - free1:+,}), after close {free3:,} ({free3 - free0:+,})")
        check(equal and replay.clean and not replay.dropped and not replay.duplicated,
              "the process fleet's kill lost, duplicated or changed a quote")
        check(any(a.startswith("failover:r0") for a in actions),
              f"the supervisor did not replace the killed replica process: {actions}")
        check(abs(free2 - free1) <= share and free0 - free3 <= share,
              "a killed or closed replica process left its memory on the card")
        for _ in range(100):
            if len(list(trace_dir.glob("events*.jsonl"))) >= 4:
                break
            time.sleep(0.1)
        merged = subprocess.run(
            [sys.executable, "-m", "fm_returnprediction_tpu_torch.telemetry.timeline",
             str(journal), str(trace_dir)], cwd=Path(__file__).resolve().parent,
            capture_output=True, text=True, timeout=300)
        log(f"timeline over {sorted(p.name for p in trace_dir.glob('events*.jsonl'))}: exit "
            f"{merged.returncode}\n" + merged.stdout.strip())
        check(merged.returncode == 0, f"the timeline merge exited {merged.returncode}: "
              f"{merged.stderr[-2000:]}")
    # the traced block's spans are exported; a later traced run's export
    # must hold its own spans only
    telemetry.reset()


# rows each fleet of the topology pass quotes against the bare service
TOPOLOGY_ROWS = 1024


def topology_pass(fleet, transport: str, journal: Path, registry_root: Path, months, xq,
                  bare: np.ndarray) -> None:
    """The topology controller on the journaled process fleet of
    ``process_fleet_phase``: declared as 2 process replicas on
    ``transport``, one replica SIGKILLed, ``probe()`` classifying it
    ``killed``, ``repair()`` respawning it from the registry's warm pool
    (the seconds from classification to respawn, the
    ``fmrp_topology_last_respawn_s`` gauge), quotes after the repair
    bit-equal to the bare service; then the fleet hard-crashed with
    requests in flight and the declared shape rebuilt from the journal by
    ``TopologyController.recover``, with no nvcc build, quoting the same
    bits."""
    from fm_returnprediction_tpu_torch import cuda_build
    from fm_returnprediction_tpu_torch.topology import TopologyController, TopologySpec

    spec = TopologySpec(replicas=2, replica_mode="process", transport=transport)
    ctl = TopologyController(spec, fleet=fleet)
    n = TOPOLOGY_ROWS
    nvcc0 = cuda_build.NVCC_RUNS
    victim = sorted(fleet.replica_states())[0]
    proc = fleet.replica(victim).service.proc
    proc.kill()
    proc.wait(timeout=60)
    start = time.perf_counter()
    probe = {}
    while probe.get(victim) != "killed" and time.perf_counter() - start < 30:
        probe = ctl.probe()
    classify_s = time.perf_counter() - start
    check(probe.get(victim) == "killed", f"probe() after the SIGKILL: {probe}")
    actions = ctl.repair(probe)
    respawn_s = telemetry.registry().gauge("fmrp_topology_last_respawn_s").value
    after = ctl.probe()
    new_rid = actions[0].split("->")[1].split(":")[0] if actions else None
    warm = fleet.warm_reports.get(new_rid)
    got, wall = _fleet_pass(fleet, months, xq, n)
    repaired_equal = bool(np.array_equal(got, bare[:n], equal_nan=True))
    log(f"topology ({transport}): {victim} SIGKILLed, probe() said {probe[victim]!r} in "
        f"{classify_s * 1e3:.1f} ms; repair() {actions} in {respawn_s:.3f} s from "
        f"classification to respawn (fmrp_topology_last_respawn_s), the respawn built "
        f"{getattr(warm, 'builds', None)} and captured {getattr(warm, 'captures', None)}; "
        f"probe() after it {after}; {n} rows after the repair in {wall:.3f} s, bit-equal to "
        f"the bare service {repaired_equal}")
    check(len(actions) == 1 and sorted(after.values()) == ["live", "live"],
          f"repair() {actions}, then probe() {after}")
    check(warm is not None and warm.builds == 0, f"the respawned replica's warm report {warm}")
    check(repaired_equal, "quotes after the topology repair differ from the bare service's")

    for i in range(4):   # in flight at the crash
        fleet.submit(int(months[i]), xq[i])
    fleet.hard_crash()
    start = time.perf_counter()
    ctl2, report = TopologyController.recover(journal, registry_dir=registry_root,
                                              state=fleet.state, max_batch=SERVING_MAX_BATCH,
                                              device="cuda")
    recover_s = time.perf_counter() - start
    try:
        builds = {r: w.builds for r, w in ctl2.fleet.warm_reports.items()}
        got, wall = _fleet_pass(ctl2.fleet, months, xq, n)
        kinds = sorted(m.kind for m in ctl2.members())
    finally:
        ctl2.close()
    recovered_equal = bool(np.array_equal(got, bare[:n], equal_nan=True))
    nvcc = cuda_build.NVCC_RUNS - nvcc0
    log(f"topology recover after hard_crash: {recover_s:.2f} s to rebuild {ctl2.spec} "
        f"(journal mark {report.journal.last_topology}); clean {report.clean}, closed out "
        f"{len(report.journal.recovered)} in flight, replicas {report.n_replicas}, "
        f"zero-build starts {report.zero_compile_starts}, builds {builds}, nvcc builds in the "
        f"pass {nvcc}; members {kinds}; {n} rows in {wall:.3f} s, bit-equal to the bare "
        f"service {recovered_equal}")
    check(ctl2.spec == spec and report.clean and report.n_replicas == 2,
          f"recover rebuilt {ctl2.spec}, clean {report.clean}")
    check(report.zero_compile_starts == 2 and not any(builds.values()) and nvcc == 0,
          f"recover built kernels: {builds}, nvcc {nvcc}")
    check(kinds == ["replica_process", "replica_process", "router"], f"members {kinds}")
    check(recovered_equal, "the recovered fleet's quotes differ from the bare service's")


def trace_phase(base, daily, digests: dict) -> None:
    """``run_pipeline(trace_dir=...)`` at real size against an untraced
    run: artifacts bit-identical (and to the main path's), launches equal,
    ``events.jsonl`` and ``trace.json`` parse, every stage of
    ``timer.durations`` has its span under the ``run_pipeline`` root; the
    traced wall beside the untraced one."""
    plain, wall_off, counts_off = counted_run(base, daily)
    with tempfile.TemporaryDirectory() as tmp:
        traced, wall_on, counts_on = counted_run(base, daily, trace_dir=tmp)
        records = [json.loads(line) for line in (Path(tmp) / "events.jsonl").open()]
        doc = json.loads((Path(tmp) / "trace.json").read_text())
        sizes = {p.name: p.stat().st_size for p in Path(tmp).iterdir()}
    spans = [r for r in records if r["type"] == "span"]
    root = [s for s in spans if s["name"] == "run_pipeline"]
    missing = sorted(set(traced.timer.durations) - {s["name"] for s in spans})
    diffs = bit_differences(plain, traced)
    vs_main = sorted(k for k, v in artifact_digests(traced).items() if digests.get(k) != v)
    launches = {k: counts_on[k] for k in MAIN_PATH_LAUNCHES}
    log(f"trace phase: untraced wall {wall_off:.3f} s, traced {wall_on:.3f} s "
        f"({len(spans)} spans, {len(doc['traceEvents'])} Chrome events, files {sizes}); "
        f"launches equal {counts_on == counts_off} {launches}; artifacts that differ in bits: "
        f"traced vs untraced {diffs}, vs the main path {vs_main}; stages without a span "
        f"{missing}")
    check(len(root) == 1 and all(s["trace_id"] == root[0]["trace_id"] for s in spans
                                 if s["thread_name"] == root[0]["thread_name"]),
          "the traced run has no single run_pipeline root")
    check(not diffs and not vs_main, f"tracing changed artifacts: {diffs} {vs_main}")
    check(counts_on == counts_off and launches == MAIN_PATH_LAUNCHES,
          f"tracing changed the launches: {counts_on} vs {counts_off}")
    check(not missing, f"stages without a span: {missing}")
    del plain, traced
    torch.cuda.empty_cache()


def profile_phase(base, daily, digests: dict) -> None:
    """One main path at real size with ``profile_dir=``: the
    ``torch.profiler`` trace's device rows carry K1's and K2's kernel names
    with the launch counters' counts; the run's artifacts equal the main
    path's; and, from the trace, the card's busy share inside the
    ``factors/daily_kernels`` stage (the union of its kernels, copies and
    sets over the stage's host interval)."""
    with tempfile.TemporaryDirectory() as tmp:
        res, wall, counts = counted_run(base, daily, profile_dir=tmp)
        trace = Path(tmp) / PROFILE_TRACE_NAME
        size = trace.stat().st_size
        doc = json.loads(trace.read_text())
    kernels = profile_kernel_counts(doc, PROFILE_KERNELS)
    stages = {}
    for name in ("factors/daily_kernels", "factors/characteristics_winsorize", "table_2",
                 "run_pipeline"):
        share, window_s, n = device_busy_share(doc, name)
        stages[name] = (round(share, 4), round(window_s, 4), n)
    diffs = sorted(k for k, v in artifact_digests(res).items() if digests.get(k) != v)
    device_events = sum(1 for e in doc["traceEvents"] if e.get("cat") in DEVICE_CATEGORIES)
    log(f"profile phase: wall {wall:.3f} s with torch.profiler (CPU + CUDA), trace "
        f"{size:,} bytes, {len(doc['traceEvents'])} events ({device_events} on the device); "
        f"kernel launches in the trace {kernels} vs the counters "
        f"{ {k: counts[k] for k in PROFILE_KERNELS} }; artifacts that differ from the main "
        f"path {diffs}")
    log("device busy share inside each stage (share, stage s, intervals): "
        + json.dumps(stages))
    check(kernels == {k: counts[k] for k in PROFILE_KERNELS},
          "the profile's kernel rows do not match the launch counters")
    check({k: counts[k] for k in MAIN_PATH_LAUNCHES} == MAIN_PATH_LAUNCHES,
          f"the profiled run launched {counts}")
    check(not diffs, f"profiling changed artifacts: {diffs}")
    del res
    torch.cuda.empty_cache()


def trace_cli_phase() -> None:
    """``--synthetic --trace-dir D --profile-dir P --registry-dir R
    --fleet-size 2 --replica-mode process`` at 60 × 130 through the command
    line: exit 0, both trace files and the profile written and parsed, the
    usual launches; the fleet smoke (two replica processes) with every
    quote finite and 2 healthy replicas; then the registry command line's
    ``verify`` and ``ls`` (its ``main``, in process): ``verify`` returns 0."""
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir, profile_dir = Path(tmp) / "trace", Path(tmp) / "profile"
        registry_root = Path(tmp) / "registry"
        run = run_cli(["--synthetic", "--firms", SYNTHETIC_CLI_FIRMS, "--months",
                       SYNTHETIC_CLI_MONTHS, "--trace-dir", trace_dir,
                       "--profile-dir", profile_dir, "--registry-dir", registry_root,
                       "--fleet-size", 2, "--replica-mode", "process"])
        made = {d.name: sorted(p.name for p in d.iterdir()) for d in (trace_dir, profile_dir)}
        names = {json.loads(line).get("name") for line in (trace_dir / "events.jsonl").open()}
        json.loads((trace_dir / "trace.json").read_text())
        kernels = profile_kernel_counts(profile_dir / PROFILE_TRACE_NAME, PROFILE_KERNELS)
        smoke = re.search(r"^serving fleet smoke: (\{.*\})$", run["stdout"], re.MULTILINE)
        check(smoke is not None, "the CLI printed no fleet smoke")
        smoke = json.loads(smoke.group(1))
        # the verification and the listing in process (the command line's
        # main): a process start less each than a subprocess
        import contextlib
        import io

        from fm_returnprediction_tpu_torch.registry.__main__ import main as registry_main

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            verify_rc = registry_main(["--registry-dir", str(registry_root), "verify"])
        verified = buf.getvalue()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            registry_main(["--registry-dir", str(registry_root), "ls"])
        listed = buf.getvalue()
    launches = run["launches"]
    log(f"CLI --trace-dir --profile-dir --registry-dir --fleet-size 2 --replica-mode process at "
        f"{SYNTHETIC_CLI_FIRMS} "
        f"x {SYNTHETIC_CLI_MONTHS}: exit 0 in {run['wall']:.1f} s; files {made}; launches "
        f"{launches['k1']}/{launches['k2']}/{launches['moments']}, in the profile {kernels}; "
        f"stage registry_publish {run['stages'].get('registry_publish')} s; fleet smoke "
        f"{json.dumps(smoke, sort_keys=True)}; registry verify exit {verify_rc} "
        f"({verified.strip()}); ls: {' | '.join(listed.strip().splitlines())}")
    check(smoke.get("finite_quotes") == smoke.get("n_queries")
          and smoke.get("healthy_replicas") == 2, f"the CLI fleet smoke {smoke}")
    check(verify_rc == 0, f"registry verify exited {verify_rc}: {verified[-2000:]}")
    check("registry_publish" in run["stages"], "the CLI run has no registry_publish stage")
    check(made == {"trace": ["events.jsonl", "trace.json"], "profile": [PROFILE_TRACE_NAME]},
          f"CLI trace files {made}")
    check({"run_pipeline", "table_2", "serving_state"} <= names, "CLI trace lacks stage spans")
    check(kernels == {"k1": launches["k1"], "k2": launches["k2"], "moments": 0}
          and launches["k2"] == 2, f"CLI profile kernels {kernels} vs launches {launches}")



# The scenario sweep at real size: 3 models × 3 universes × (full sample,
# two halves) = 27 cells, (3 + 7 + 14) × 9 = 216 rows; each run's launches,
# K1/K2/K3 and K2 by call shape. A run_pipeline run launches K2 for Table 2
# and the figure grid too; the factorized sweep contracts its 9 pairs in one
# launch; the 12-subperiod sweep without the factorization its 117 specs in
# two (60 + 57).
SPECGRID_CELLS, SPECGRID_ROWS = 27, 216
SPECGRID_LAUNCHES = {
    "guarded": ({"k1": 17, "k2": 3, "moments": 0}, {"P=14,S=9,f32": 2, "P=5,S=3,f32": 1}),
    "bf16": ({"k1": 17, "k2": 3, "moments": 0}, {"P=14,S=9,bf16": 2, "P=5,S=3,bf16": 1}),
    "coreset": ({"k1": 0, "k2": 1, "moments": 0}, {"P=14,S=9,f32,rw": 1}),
    "coreset_bf16": ({"k1": 0, "k2": 1, "moments": 0}, {"P=14,S=9,bf16,rw": 1}),
    "split": ({"k1": 0, "k2": 2, "moments": 0}, {f"P=14,S={SPLIT_SPECS},f32": 2}),
    "on_panel": ({"k1": 0, "k2": 1, "moments": 0}, {"P=14,S=9,f32": 1}),
}
SCENARIO_COLUMNS = ["cell", "model", "universe", "window", "winsor_pct", "nw_weight",
                    "predictor", "coef", "tstat", "nw_se", "mean_r2", "mean_n", "n_months",
                    "refereed"]


def check_scenario_frame(frame: pd.DataFrame, label: str, cells: int, extra=(),
                         min_finite: float = 0.9) -> None:
    """The sweep's tidy frame: its cells and columns, finite estimates (a
    share of at least ``min_finite`` of the coefficients: a predictor with
    fewer than 10 valid months in a window has none)."""
    check(list(frame.columns) == SCENARIO_COLUMNS + list(extra),
          f"{label}: scenario columns {list(frame.columns)}")
    check(frame["cell"].nunique() == cells, f"{label}: {frame['cell'].nunique()} cells, "
          f"not {cells}")
    finite = float(np.isfinite(frame["coef"].to_numpy(float)).mean())
    log(f"{label}: {len(frame)} rows over {cells} cells, finite coef share {finite:.3f}, "
        f"refereed cells {frame.loc[frame['refereed'], 'cell'].nunique()}")
    ran = frame["n_months"].to_numpy() > 0
    check(finite >= min_finite and ran.mean() >= min_finite
          and bool(np.isfinite(frame["mean_r2"].to_numpy(float)[ran]).all()),
          f"{label}: non-finite estimates")


def _k2_pinned(label: str, counts: dict, want: tuple) -> None:
    totals, by_key = want
    got_by_key = {k[len("gram/"):]: v for k, v in counts.items() if k.startswith("gram/")}
    log(f"{label} launches: K1 {counts['k1']}, K2 {counts['k2']} {got_by_key}, "
        f"K3 {counts['moments']}")
    check({k: counts[k] for k in totals} == totals and got_by_key == by_key,
          f"{label}: launches {({k: counts[k] for k in totals}, got_by_key)}, not {want}")


def specgrid_phase(base, daily) -> dict:
    """The scenario sweep at real size on the main path's inputs: through
    ``run_pipeline(make_specgrid=True)`` guarded, again with
    ``FMRP_GRAM_PRECISION=bf16`` (Table 2 and the figure grid follow the
    knob too, as in the reference), then ``run_scenarios`` on the coreset
    route (float32, and bf16 with its row weights) and on the 12-subperiod
    unfactorized sweep whose 117 specs are cut into two launches. Each run's launches are pinned; returns them by run."""
    runs = {}
    res, wall, counts = counted_run(base, daily, guard=True, make_specgrid=True)
    frame = res.specgrid_scenarios
    log(f"specgrid (guarded, f32): wall {wall:.3f} s, stage specgrid "
        f"{res.stage_seconds['specgrid']:.4f} s; audit " + res.audit.report().replace("\n", "; "))
    check(not res.audit.violations and not res.audit.quarantined,
          "guarded specgrid run: contract violations or quarantined artifacts")
    check(len(frame) == SPECGRID_ROWS, f"specgrid frame has {len(frame)} rows")
    check_scenario_frame(frame, "specgrid (guarded, f32)", SPECGRID_CELLS)
    _k2_pinned("specgrid (guarded, f32)", counts, SPECGRID_LAUNCHES["guarded"])
    runs["guarded"] = counts

    with _env(FMRP_GRAM_PRECISION="bf16"):
        low, wall16, counts16 = counted_run(base, daily, make_specgrid=True)
    f16 = low.specgrid_scenarios
    promoted = f16.groupby("cell")["bf16_promoted_months"].first()
    dt = np.abs(f16["tstat"].to_numpy(float) - frame["tstat"].to_numpy(float))
    log(f"specgrid (bf16): wall {wall16:.3f} s, stage specgrid "
        f"{low.stage_seconds['specgrid']:.4f} s; promoted months per cell min "
        f"{promoted.min()} median {promoted.median()} max {promoted.max()}; "
        f"|t(bf16) - t(f32)| max {np.nanmax(dt):.3e}")
    check(bool((f16["precision"] == "bf16").all()), "bf16 sweep: rows not marked bf16")
    check_scenario_frame(f16, "specgrid (bf16)", SPECGRID_CELLS,
                         extra=("precision", "bf16_promoted_months"))
    _k2_pinned("specgrid (bf16)", counts16, SPECGRID_LAUNCHES["bf16"])
    runs["bf16"] = counts16
    del low, f16

    # the first of 12 fifty-month windows starts before the 36-month
    # predictors have their history
    for name, kw, cells, extra, min_finite in (
            ("coreset", dict(route="coreset"), SPECGRID_CELLS,
             ("route", "coreset_m", "coreset_rate", "suspect_months"), 0.9),
            ("coreset_bf16", dict(route="coreset", precision="bf16"), SPECGRID_CELLS,
             ("precision", "bf16_promoted_months", "route", "coreset_m", "coreset_rate",
              "suspect_months"), 0.9),
            ("split", dict(subperiods=12, factorize="off"), SPLIT_SPECS, (), 0.75)):
        reset_counts()
        start = time.perf_counter()
        got, stats = run_scenarios(res.panel, res.subset_masks, res.factors_dict,
                                   return_stats=True, **kw)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - start
        counts_s = launch_counts()
        log(f"run_scenarios({kw}): wall {wall_s:.3f} s; stats "
            + json.dumps({k: v for k, v in stats.items() if k != "seconds"}, default=str))
        check_scenario_frame(got, f"run_scenarios {name}", cells, extra=extra,
                             min_finite=min_finite)
        _k2_pinned(f"run_scenarios {name}", counts_s, SPECGRID_LAUNCHES[name])
        if name == "coreset":
            # against the exact Gram solves only: a refereed exact cell is the
            # float32 QR route's, whose eps·N cutoff truncates raw-unit columns
            exact = frame[~frame["refereed"]].set_index(["cell", "predictor"])
            approx = got.set_index(["cell", "predictor"]).loc[exact.index]
            gap = (approx["coef"] - exact["coef"]).abs() / exact["nw_se"]
            log(f"coreset (m {stats['coreset_m']} of {res.panel.values.shape[1]} a month, "
                f"rate {got['coreset_rate'].min():.3f}-{got['coreset_rate'].max():.3f}): "
                f"|coef - exact coef| / exact nw_se over the {len(exact)} rows of unrefereed "
                f"exact cells: median {gap.median():.3f}, 90th percentile "
                f"{gap.quantile(0.9):.3f}, max {gap.max():.3f}")
            check(not got["refereed"].any(), "coreset cells were refereed")
        runs[name] = counts_s
    runs["on_panel"] = _on_panel_check(res)
    return runs, res


def _on_panel_check(res) -> dict:
    """``run_spec_grid_on_panel`` on the guarded run's resident panel with
    Table 2's grid: one K2 launch, every leaf bit-equal to ``run_spec_grid``
    on the same sliced tensors."""
    grid = table2_grid(res.factors_dict, subsets=list(res.subset_masks))
    reset_counts()
    start = time.perf_counter()
    got = run_spec_grid_on_panel(res.panel, res.subset_masks, grid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = launch_counts()
    _k2_pinned("run_spec_grid_on_panel (Table 2's grid)", counts, SPECGRID_LAUNCHES["on_panel"])
    want = run_spec_grid(res.panel.var("retx").contiguous(),
                         res.panel.select(grid.union_predictors).contiguous(),
                         {n: res.subset_masks[n] for n in grid.universe_names}, grid)
    equal = [f for f, a, b in zip(got._fields, got, want)
             if f != "referee_specs" and not np.array_equal(a, b, equal_nan=True)]
    log(f"run_spec_grid_on_panel: {len(grid)} specs, union P={len(grid.union_predictors)}, "
        f"wall {wall:.4f} s, referee specs {list(got.referee_specs)}; leaves that differ from "
        f"run_spec_grid on the same tensors: {equal}")
    check(not equal and got.referee_specs == want.referee_specs,
          f"run_spec_grid_on_panel differs from run_spec_grid: {equal}")
    check(bool(np.isfinite(got.coef).any()), "run_spec_grid_on_panel: no finite coefficient")
    return counts


def _held_cell_gap(got: pd.DataFrame, want: pd.DataFrame) -> float:
    """The worst coefficient gap at ``max(|b|, nw_se)`` and t-stat gap at
    ``max(|t|, 1)`` between two frames of the same cells, NaN patterns
    checked equal."""
    worst = 0.0
    for col, scale in (("coef", np.fmax(want["coef"].abs(), want["nw_se"])),
                       ("tstat", np.fmax(want["tstat"].abs(), 1.0))):
        g, w = got[col].to_numpy(float), want[col].to_numpy(float)
        check(bool(np.array_equal(np.isnan(g), np.isnan(w))), f"{col}: NaN patterns differ")
        fin = np.isfinite(w)
        worst = max(worst, float((np.abs(g - w)[fin] / scale.to_numpy(float)[fin]).max(
            initial=0.0)))
    return worst


def wide_grid(factors: dict, universes, extra: int):
    """Table 2's spec shapes over a union widened by ``extra`` seeded
    columns: Models 1 and 2 select their Table 2 columns, Model 3 its 14
    and every seeded column, each over Table 2's three universes. Returns
    ``(grid, Table 2's union, the seeded columns' names)``."""
    from fm_returnprediction_tpu_torch.specgrid.specs import Spec, SpecGrid

    cols = [model_columns(m, factors) for m in MODELS]
    union = list(dict.fromkeys(c for cs in cols for c in cs))
    seeded = [f"seeded_{i}" for i in range(extra)]
    specs = [Spec(f"{m.name} | {u}", tuple(c) + (tuple(seeded) if k == len(MODELS) - 1 else ()),
                  u)
             for k, (m, c) in enumerate(zip(MODELS, cols)) for u in universes]
    return SpecGrid(tuple(specs), union=tuple(union + seeded)), union, seeded


def _seeded_columns(t: int, n: int, k: int, seed: int, device, dtype,
                    nan_frac: float = 0.02) -> torch.Tensor:
    """``k`` seeded standard-normal (T, N) columns, ``nan_frac`` of the
    entries NaN, made from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cols = torch.randn((t, n, k), generator=gen, device=device, dtype=torch.float64)
    cols = torch.where(torch.rand((t, n, k), generator=gen, device=device, dtype=torch.float64)
                       < nan_frac, torch.full_like(cols, float("nan")), cols)
    return cols.to(dtype)


def union_grid(factors: dict, universe: str):
    """The 920-column union: Table 2's union and seeded columns after it;
    3 specs over ``universe``: Model 1's columns (the union's first 3), the
    first half and every column. Returns ``(grid, Table 2's union, the
    seeded columns' names)``."""
    from fm_returnprediction_tpu_torch.specgrid.specs import Spec, SpecGrid

    cols = [model_columns(m, factors) for m in MODELS]
    union = list(dict.fromkeys(c for cs in cols for c in cs))
    seeded = [f"seeded_{i}" for i in range(UNION_P - len(union))]
    names = tuple(union + seeded)
    specs = tuple(Spec(f"P{w} | {universe}", names[:w], universe)
                  for w in (len(cols[0]),) + UNION_WIDTHS[1:])
    return SpecGrid(specs, union=names), union, seeded


def k2_wide_path_phase(res, seed: int) -> dict:
    """K2 past 32 columns through the normal entry, ``run_spec_grid``, on
    the main path's float32 panel (600 × 22,000): Table 2's union and 26
    seeded columns (``WIDE_P`` = 40), Table 2's spec shapes over it
    (``wide_grid``), in float32, with coreset row weights, in bfloat16 and
    in float64; then unions of 64 and 100 columns (50 and 86 seeded) at
    the first 4,096 firms of the last ``WIDE_PATH_MONTHS`` months (depth
    cut for the script's time) on the same four branches; then the
    920-column union (``_union_path``). Each run's K2
    launches are counted by key: ⌈9 / gram_spec_chunk(P, dtype=…)⌉, one
    on every branch (one launch takes the whole batch past 32 columns);
    Models 1 and 2 come out finite. No referee: its QR re-solves launch no
    K2 (the card-vs-CPU check runs the wide grid refereed). Returns the
    launch counts (``gram/…`` keys) of every run."""
    panel, masks = res.panel, res.subset_masks
    t, n = panel.values.shape[:2]
    universes = [u for u in masks if u in ("All stocks", "All-but-tiny stocks", "Large stocks")]
    y = panel.var("retx").contiguous()
    dev = panel.values.device
    merged: dict = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for p, firms in WIDE_SHAPES:
        grid, union, seeded = wide_grid(res.factors_dict, universes, p - 14)
        t_run = t if p == WIDE_P else WIDE_PATH_MONTHS
        cols = torch.cat([panel.select(union)[t - t_run:],
                          _seeded_columns(t_run, n, len(seeded), seed + p, dev, torch.float32)],
                         dim=-1)[:, :firms].contiguous()
        yy = y[t - t_run:, :firms].contiguous()
        mm = {u: masks[u][t - t_run:, :firms].contiguous() for u in universes}
        rw = coreset_like_weights(t_run, firms, torch.float32, gen, binary=False)
        runs = (("f32", dict(), yy, cols, torch.float32),
                ("rw", dict(row_weights=rw), yy, cols, torch.float32),
                ("bf16", dict(precision="bf16"), yy, cols, torch.bfloat16),
                ("f64", dict(), yy.double(), cols.double(), torch.float64))
        for label, kw, y_run, x_run, operands in runs:
            masks_run = mm
            reset_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = run_spec_grid(y_run, x_run, masks_run, grid, False, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            counts = launch_counts()
            want = -(-len(grid.specs) // gram_spec_chunk(p, dtype=operands))
            nested = out.coef[: 2 * len(universes)]
            n_cols = [len(s.predictors) for s in grid.specs[: 2 * len(universes)]]
            finite = all(np.isfinite(nested[i, :k]).all() for i, k in enumerate(n_cols))
            log(f"K2 wide path: run_spec_grid P={p} S={len(grid.specs)} N={firms} {label}: "
                f"{wall:.3f} s, K2 {counts['k2']} ({ {k: v for k, v in counts.items() if k.startswith('gram/')} }), "
                f"specs with a suspect month {int((out.suspect_months > 0).sum())}, Models 1-2 "
                f"finite {finite}")
            check(counts["k2"] == want, f"wide run_spec_grid P={p} {label}: K2 {counts['k2']}, "
                  f"not {want}")
            check(finite, f"wide run_spec_grid P={p} {label}: Models 1-2 not finite")
            for key, v in counts.items():
                if key.startswith("gram/"):
                    merged[key] = merged.get(key, 0) + v
        del cols, rw, yy, mm
        torch.cuda.empty_cache()
    _union_path(res, seed, gen, merged)
    return merged


def _union_path(res, seed: int, gen, merged: dict) -> None:
    """``run_spec_grid`` over the 920-column union (``union_grid``): the
    last ``UNION_T`` months of the main path's panel (its first months hold
    fewer firms than the widest spec has columns), all its firms, over All
    stocks, in float32, with coreset row weights, in bfloat16 and in
    float64. Each run's K2 launches are one launch of the tile-pair kernel
    and one pre-pass launch; each spec's selected coefficients finite. Adds
    the launches (``gram/…``, ``fold/…``) to ``merged``."""
    panel, masks = res.panel, res.subset_masks
    t, n = UNION_T, panel.values.shape[1]
    universe = "All stocks"
    grid, union, seeded = union_grid(res.factors_dict, universe)
    dev = panel.values.device
    t0 = panel.values.shape[0] - t
    cols = torch.cat([panel.select(union)[t0:],
                      _seeded_columns(t, n, len(seeded), seed + UNION_P, dev, torch.float32,
                                      nan_frac=UNION_NAN)], dim=-1).contiguous()
    y = panel.var("retx")[t0:].contiguous()
    mm = {universe: masks[universe][t0:].contiguous()}
    rw = coreset_like_weights(t, n, torch.float32, gen, binary=False)
    widths = [len(sp.predictors) for sp in grid.specs]
    runs = (("f32", dict(), y, cols, torch.float32),
            ("rw", dict(row_weights=rw), y, cols, torch.float32),
            ("bf16", dict(precision="bf16"), y, cols, torch.bfloat16),
            ("f64", dict(), y.double(), cols.double(), torch.float64))
    for label, kw, y_run, x_run, operands in runs:
        tiles = gram_tile_plan(UNION_P, operands, len(grid.specs))
        check(tiles is not None, f"920-column run_spec_grid {label}: not on the tile route")
        reset_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = run_spec_grid(y_run, x_run, mm, grid, False, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counts = launch_counts()
        want = (1, 1)
        finite = all(np.isfinite(out.coef[i, :w]).all() for i, w in enumerate(widths))
        log(f"K2 920-column path: run_spec_grid P={UNION_P} S={len(grid.specs)} T={t} N={n} "
            f"{label}: {wall:.3f} s, tile pairs, {len(tiles.pairs)} pairs of {tiles.tiles} "
            f"tiles, K2 {counts['k2']}, pre-pass {counts['fold']}, mean rows a month "
            f"{np.round(out.mean_n, 1).tolist()}, specs with a suspect month "
            f"{int((out.suspect_months > 0).sum())}, selected coefficients finite {finite}")
        check((counts["k2"], counts["fold"]) == want,
              f"920-column run_spec_grid {label}: launches (K2, pre-pass) "
              f"{(counts['k2'], counts['fold'])}, not {want}")
        check(finite, f"920-column run_spec_grid {label}: a selected coefficient is not finite")
        for key, v in counts.items():
            if key.startswith(("gram/", "fold/")):
                merged[key] = merged.get(key, 0) + v
        del out, x_run, y_run
    del cols, rw, y, mm
    torch.cuda.empty_cache()


def multiproc_phase(res) -> dict:
    """The 27-cell f32 scenario sweep at real size across ``MP_PROCS``
    contraction worker processes (``FMRP_SPECGRID_PROCS``), over the
    ``shm`` transport where ``/dev/shm`` fits the panel, else ``frames``:
    each worker a fresh interpreter with its own CUDA context, launching K2
    on its 11,000-firm shard, the parent solving the merged stats. The
    build directory starts empty and no registry is armed, so the pool's
    staggered start shows at most one nvcc build over the workers. The
    run: the wall beside a one-process sweep of the same panel in this
    call, the workers' reports (device, K2 launches, builds), the parent's
    own K2 launches (0), the cells held against the one-process sweep's
    at ``SUSPECT_TOL``; the pool's merged stats for a 9-spec grid against
    one-process K2 on the full panel at K2's f32 tolerance (1e-5 of each
    block's max, counts exact). After an ``shm`` sweep the same 9-spec grid
    goes through the sweep's contraction (``multiproc_grid_stats``) over
    ``frames``, with the build directory warm: a fresh pool of workers on
    the card, no nvcc build, the merged stats bit-identical to the shm
    pool's. Returns the workers' launches by kernel-table key."""
    from fm_returnprediction_tpu_torch.parallel.shm import shm_available

    panel, masks, factors = res.panel, res.subset_masks, res.factors_dict
    t, n = panel.values.shape[:2]
    reset_counts()
    start = time.perf_counter()
    one = run_scenarios(panel, masks, factors)
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - start
    panel_bytes = t * n * (14 * 4 + 4 + 3)
    # the whole sweep over one transport: shm where /dev/shm holds the panel
    # (PR 14 read the two bit-identical, frames 27.36 s against shm 17.11 s;
    # PERF.md); frames then runs the 9-spec grid
    transport = "shm" if shm_available(panel_bytes) else "frames"
    log(f"multiproc: {shm_room()}; panel ~{panel_bytes:,} bytes; the sweep over {transport}; "
        f"the one-process sweep {one_wall:.3f} s")
    out = {}
    with tempfile.TemporaryDirectory() as build_dir, _env(
            FMRP_CUDA_BUILD_DIR=build_dir, FMRP_REGISTRY_DIR=None,
            FMRP_GRID_TRANSPORT=transport, FMRP_SPECGRID_PROCS=MP_PROCS):
        reset_counts()
        start = time.perf_counter()
        try:
            got = run_scenarios(panel, masks, factors)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            parent = launch_counts()
            workers = dict(multiproc.WORKER_LAUNCHES)
            pool = multiproc.cached_pool()
            reports, merge_s = list(pool.last_reports), pool.last_merge_s
            grid, merged = _merged_stats_check()
        finally:
            multiproc._close_cached_pool()
        builds = sum(r["nvcc_runs"] for r in reports)
        gap = _held_cell_gap(got, one)
        log(f"multiproc sweep ({transport}, {MP_PROCS} workers): wall {wall:.3f} s "
            f"(one process {one_wall:.3f} s), the last merge {merge_s:.3f} s; parent "
            f"launches K1 {parent['k1']} K2 {parent['k2']}; worker K2 launches "
            f"{workers}; reports " + json.dumps(reports)
            + f"; nvcc builds over the pool {builds}; worst held cell gap to the "
            f"one-process sweep {gap:.3e} (tol {SUSPECT_TOL:g})")
        check_scenario_frame(got, f"multiproc sweep ({transport})", SPECGRID_CELLS)
        check(parent["k2"] == 0, "the parent launched K2 on the multi-process path")
        _check_worker_reports(reports)
        check(builds <= 1, f"{builds} nvcc builds over the pool")
        check(gap <= SUSPECT_TOL, "the multi-process sweep is off the one-process one")
        out[f"gram-worker/P=14,S={ABSORB_SPECS},f32"] = workers.get(
            f"P=14,S={ABSORB_SPECS},f32", 0)
        if transport == "shm":
            os.environ["FMRP_GRID_TRANSPORT"] = "frames"
            reset_counts()
            start = time.perf_counter()
            try:
                frames = multiproc.multiproc_grid_stats(*grid[:-1], procs=MP_PROCS,
                                                        row_weights=grid[-1], device="cuda")
                frames_wall = time.perf_counter() - start
                pool = multiproc.cached_pool()
                reports, kind = list(pool.last_reports), pool.transport
            finally:
                multiproc._close_cached_pool()
            parent = launch_counts()
            builds = sum(r["nvcc_runs"] for r in reports)
            same = all(np.array_equal(a, b, equal_nan=True) for a, b in zip(frames, merged))
            log(f"multiproc 9-spec grid over {kind} ({MP_PROCS} workers, warm build "
                f"directory): spawn, ship and contract {frames_wall:.3f} s; parent K2 "
                f"launches {parent['k2']}; worker K2 launches "
                f"{dict(multiproc.WORKER_LAUNCHES)}; reports " + json.dumps(reports)
                + f"; nvcc builds {builds}; merged stats bit-identical to the shm pool's "
                f"{same}")
            check(kind == "frames", f"the 9-spec grid ran over {kind}")
            check(parent["k2"] == 0, "the parent launched K2 on the frames pass")
            _check_worker_reports(reports)
            check(builds == 0, f"{builds} nvcc builds over a warm build directory")
            check(same, "the shm and frames pools' merged stats differ")
    torch.cuda.empty_cache()
    return out


def _check_worker_reports(reports) -> None:
    check(len(reports) == MP_PROCS and all(
        r["device"].startswith("cuda") and r["launches"] >= 1 for r in reports),
          f"a worker did not launch K2 on the card: {reports}")


def _merged_stats_check() -> tuple:
    """The cached pool's merged stats for a 9-spec grid (3 universes × 3
    column sets, every month) against one-process K2 on the full panel.
    Returns the grid as ``multiproc_grid_stats``' arguments (the pool's own
    panel objects, its row weights last) and the merged stats."""
    _key, (y, x, unis, rw), pool = multiproc._POOL_CACHE
    p = x.shape[-1]
    uidx = np.arange(9) % len(unis)
    col_sel = np.zeros((9, p), bool)
    for i in range(9):
        col_sel[i, :p - 3 * (i // 3)] = True
    window = np.ones((9, x.shape[0]), bool)
    start = time.perf_counter()
    merged = pool.contract(uidx, col_sel, window)
    merge_s = time.perf_counter() - start
    universes = torch.stack([torch.as_tensor(u, device="cuda") for u in unis])
    dev = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    single = contract_spec_grams(y, x, universes, dev(uidx), dev(col_sel), dev(window))
    got = [dev(a) for a in merged[:5]]
    worst, max_abs = gram_worst(got, single[:5])
    counts_exact = bool(torch.equal(got[2], single[2]))
    center_gap = worst_of((dev(merged[5]) - single[5]).abs())
    log(f"multiproc merged stats (9 specs, {MP_PROCS} shards, {merge_s:.3f} s) against "
        f"one-process K2: worst_rel_to_block_max {worst:.3e} (tol 1e-5), max_abs "
        f"{max_abs:.3e}, counts exact {counts_exact}, center max |diff| {center_gap:.3e}")
    check(worst <= 1e-5 and counts_exact, "the merged stats are off one-process K2")
    return (y, x, unis, uidx, col_sel, window, rw), merged


def _cell_diffs(got: dict, ref: dict):
    """(held difference, plain relative difference, cell, number, index,
    reference value) for every Table 2 entry, worst held first, checking
    that the NaN patterns agree. A coefficient is held at its scale
    ``max(|b|, nw_se)`` and its t-stat at ``max(|t|, 1)`` — the same bound
    divided by the SE — so a statistically-zero coefficient is held at its
    standard error's scale; every other number at ``|b|``."""
    out = []
    for key, r in ref.items():
        se = np.atleast_1d(np.asarray(r["nw_se"], float))
        for name in ("coef", "tstat", "mean_r2", "mean_n"):
            a = np.atleast_1d(np.asarray(got[key][name], float))
            b = np.atleast_1d(np.asarray(r[name], float))
            check(bool((np.isnan(a) == np.isnan(b)).all()),
                  f"card vs CPU: NaN pattern of {key} {name}")
            for i in np.flatnonzero(np.isfinite(b)):
                diff = abs(a[i] - b[i])
                scale = abs(b[i])
                if name == "coef":
                    scale = max(scale, se[i])
                elif name == "tstat":
                    scale = max(scale, 1.0)
                out.append((float(diff / max(scale, 1e-300)),
                            float(diff / max(abs(b[i]), 1e-300)),
                            key, name, int(i), float(b[i])))
    return sorted(out, key=lambda d: d[0], reverse=True)


def _rel_worst(got: np.ndarray, want: np.ndarray, what: str) -> float:
    """Worst relative difference of two arrays whose NaN/inf patterns must
    agree (checked)."""
    got = np.asarray(got, dtype=float)
    want = np.asarray(want, dtype=float)
    check(got.shape == want.shape, f"card vs CPU: {what} shape {got.shape} vs {want.shape}")
    check(all(np.array_equal(f(got), f(want)) for f in (np.isnan, np.isposinf, np.isneginf)),
          f"card vs CPU: {what} non-finite pattern differs")
    fin = np.isfinite(want)
    if not fin.any():
        return 0.0
    return float((np.abs(got[fin] - want[fin]) / np.maximum(np.abs(want[fin]), 1e-300)).max())


def _decile_count_flips(gpu, cpu) -> int:
    """Decile-count cells (subset, month, decile) that differ card vs CPU in
    the two runs' own sweeps: a firm changing decile moves one count
    between two cells."""
    check(list(gpu.sweep) == list(cpu.sweep), "card vs CPU: swept subsets differ")
    return sum(int(np.sum(np.asarray(gpu.sweep[name].deciles.decile_counts)
                          != np.asarray(entry.deciles.decile_counts)))
               for name, entry in cpu.sweep.items())


def _reporting_vs_cpu(gpu, cpu) -> None:
    """Table 1, the decile table, the figure frames and the serving state,
    card vs CPU."""
    t1g, t1c = gpu.table_1, cpu.table_1
    n_cols = [c for c in t1c.columns if c[1] == "N"]
    n_exact = bool((t1g[n_cols].to_numpy() == t1c[n_cols].to_numpy()).all())
    t1_worst = _rel_worst(t1g.drop(columns=n_cols).to_numpy(),
                          t1c.drop(columns=n_cols).to_numpy(), "Table 1")
    log(f"card vs CPU Table 1: Avg/Std worst rel diff {t1_worst:.3e} (tol 1e-10), "
        f"N exact {n_exact}")
    check(n_exact and t1_worst <= 1e-10, "card vs CPU: Table 1 beyond tolerance")

    flips = _decile_count_flips(gpu, cpu)
    dg, dc = gpu.decile_table, cpu.decile_table
    months_exact = bool((dg.loc["Months"].to_numpy() == dc.loc["Months"].to_numpy()).all())
    dec_worst = _rel_worst(dg.drop(index="Months").to_numpy(),
                           dc.drop(index="Months").to_numpy(), "decile table")
    log(f"card vs CPU decile table: worst rel diff {dec_worst:.3e} (tol 1e-8), Months "
        f"exact {months_exact}, decile-count cells that differ (flips) {flips}")
    check(months_exact and dec_worst <= 1e-8, "card vs CPU: decile table beyond tolerance")

    fig_worst = 0.0
    for name, frame in cpu.figure_1.items():
        check(gpu.figure_1[name].index.equals(frame.index), f"card vs CPU: Figure 1 {name} months")
        fig_worst = max(fig_worst, _rel_worst(gpu.figure_1[name].to_numpy(), frame.to_numpy(),
                                              f"Figure 1 {name}"))
    log(f"card vs CPU Figure 1 frames: worst rel diff {fig_worst:.3e} (tol 1e-8)")
    check(fig_worst <= 1e-8, "card vs CPU: Figure 1 frames beyond tolerance")

    sg, sc = gpu.serving_state, cpu.serving_state
    st_worst = max(_rel_worst(getattr(sg, k), getattr(sc, k), f"serving {k}")
                   for k in ("coef", "slopes_bar", "intercept_bar"))
    exact = {k: bool(np.array_equal(getattr(sg, k), getattr(sc, k)))
             for k in ("n_obs", "month_valid")}
    # the support bounds are minima/maxima of the enriched panel, which the
    # card computes in another order: they agree as closely as the panels do
    bounds = {k: _rel_worst(getattr(sg, k), getattr(sc, k), f"serving {k}")
              for k in ("x_lo", "x_hi")}
    bit_equal = {k: bool(np.array_equal(getattr(sg, k), getattr(sc, k))) for k in bounds}
    log(f"card vs CPU serving state: coef/slopes_bar/intercept_bar worst rel diff "
        f"{st_worst:.3e} (tol 1e-8); exact {exact}; support bounds worst rel diff "
        f"{bounds} (tol 1e-10), bit-equal {bit_equal}")
    check(st_worst <= 1e-8 and all(exact.values()) and max(bounds.values()) <= 1e-10,
          "card vs CPU: serving state beyond tolerance")


# firms of the card-vs-CPU universe (240 months, float64); cut from 2,000,
# its CPU side the host-bound cost. At 1,200 one absorb cell without a
# suspect month sits at 1.3e-8 of the 1e-8 pin, both devices at its worst
# month's condition (1.2e7) times the sum-order eps: such a cell is held to
# the bound its own months give (_condition_pin)
CVC_FIRMS = 1200


def card_vs_cpu(seed: int, absorb_reading: bool = False) -> None:
    base, daily = make_smoke_inputs(n_firms=CVC_FIRMS, n_months=240, seed=seed + 1,
                                    dtype=np.float64)
    start = time.perf_counter()
    boot = dict(make_bootstrap=True, bootstrap_replicates=BOOT_CPU_REPLICATES)
    gpu = run_pipeline(dense_base=base, compact_daily=daily, device="cuda", dtype=torch.float64, **boot)
    gpu_s = time.perf_counter() - start
    again = run_pipeline(dense_base=base, compact_daily=daily, device="cuda", dtype=torch.float64)
    start = time.perf_counter()
    cpu = run_pipeline(dense_base=base, compact_daily=daily, device="cpu", dtype=torch.float64, **boot)
    cpu_s = time.perf_counter() - start
    diffs = _cell_diffs(gpu.table_2_cells, cpu.table_2_cells)
    repeat = _cell_diffs(again.table_2_cells, gpu.table_2_cells)
    worst, plain, key, name, i, ref = diffs[0]
    plain_worst = max(diffs, key=lambda d: d[1])
    log(f"card vs CPU (T=240, N={CVC_FIRMS}, f64): cuda {gpu_s:.2f} s, cpu {cpu_s:.2f} s, "
        f"Table 2 worst held diff {worst:.3e} (tol 1e-8; coef at max(|b|, nw_se), t-stat "
        f"at max(|t|, 1)) at {key} {name}[{i}] = {ref:.6e} (plain rel {plain:.3e}); "
        f"worst plain rel diff {plain_worst[1]:.3e} at {plain_worst[2]} {plain_worst[3]}"
        f"[{plain_worst[4]}] = {plain_worst[5]:.6e}; card run-to-run worst plain rel diff "
        f"{max(d[1] for d in repeat):.3e}; formatted tables equal: "
        f"{gpu.table_2.equals(cpu.table_2)}")
    check(worst <= 1e-8, "card vs CPU: Table 2 beyond tolerance")
    _reporting_vs_cpu(gpu, cpu)
    _boot_vs_cpu(gpu, cpu)
    _scenarios_vs_cpu(gpu)
    _backtest_vs_cpu(gpu)
    _estimators_vs_cpu(gpu, absorb_reading)
    _wide_vs_cpu(gpu, seed)
    _union_vs_cpu(seed)


def _grid_gap(got, want, suspect: np.ndarray) -> tuple:
    """The worst held gap of two ``SpecGridResult``s (coef at ``max(|b|,
    nw_se)``, t-stat at ``max(|t|, 1)``) over the specs without a suspect
    month and over those with one; NaN patterns and month counts equal."""
    for name in ("coef", "tstat"):
        a, b = np.asarray(getattr(got, name), float), np.asarray(getattr(want, name), float)
        check(bool(np.array_equal(np.isnan(a), np.isnan(b))), f"{name}: NaN patterns differ")
    check(np.array_equal(got.n_months, want.n_months), "month counts differ")
    scale = {"coef": np.fmax(np.abs(want.coef), want.nw_se),
             "tstat": np.maximum(np.abs(want.tstat), 1.0)}
    gap = np.zeros(want.coef.shape[0])
    for name, sc in scale.items():
        d = np.abs(np.asarray(getattr(got, name)) - np.asarray(getattr(want, name))) / sc
        # a column the spec does not select is NaN on both sides (checked)
        gap = np.maximum(gap, np.where(np.isfinite(d), d, 0.0).max(axis=1))
    held = float(gap[~suspect].max(initial=0.0))
    return held, float(gap[suspect].max(initial=0.0))


def _wide_vs_cpu(gpu, seed: int) -> None:
    """K2 past 32 columns card vs CPU at float64 on the card-vs-CPU
    universe: ``run_spec_grid`` over Table 2's union and 26 seeded columns
    (``wide_grid``, 40 columns, one K2 launch), and one FWL cell (Model 2,
    all stocks) whose 20 controls are the union's last 20 columns; specs
    without a suspect month at 1e-8, the others at ``SUSPECT_TOL``."""
    from fm_returnprediction_tpu_torch.specgrid.estimators import run_estimator_grid_weights
    from fm_returnprediction_tpu_torch.specgrid.specs import Spec, SpecGrid

    panel, masks = gpu.panel, gpu.subset_masks
    t, n = panel.values.shape[:2]
    universes = [u for u in masks if u in ("All stocks", "All-but-tiny stocks", "Large stocks")]
    grid, union, seeded = wide_grid(gpu.factors_dict, universes, WIDE_P - 14)
    dev = panel.values.device
    x = torch.cat([panel.select(union),
                   _seeded_columns(t, n, len(seeded), seed, dev, torch.float64)], dim=-1)
    sides = {"card": (panel.var("retx").contiguous(), x.contiguous(),
                      {u: masks[u] for u in universes})}
    sides["cpu"] = tuple(a.cpu() for a in sides["card"][:2]) + (
        {u: m.cpu() for u, m in sides["card"][2].items()},)
    model2 = model_columns(MODELS[1], gpu.factors_dict)
    fwl_grid = SpecGrid((Spec("Model 2 | All stocks", tuple(model2), "All stocks"),),
                        union=grid.union)
    # the controls are union columns 20-39, so the cell's 1e-8 pin reaches
    # every column of the second selection word
    est = parse_estimator("fwl:" + "+".join(seeded[6:26]))
    out, counts = {}, {}
    for side, (y, xx, mm) in sides.items():
        reset_counts()
        start = time.perf_counter()
        res = run_spec_grid(y, xx, mm, grid)
        fwl, disc = run_estimator_grid_weights(est, y, xx, mm, fwl_grid, ("reference",))
        out[side] = (res, fwl["reference"], disc, time.perf_counter() - start)
        counts[side] = launch_counts()
    (g, gf, gd, g_s), (c, cf, cd, c_s) = out["card"], out["cpu"]
    suspect = np.asarray(c.suspect_months) > 0
    held, worst_sus = _grid_gap(g, c, suspect)
    f_suspect = np.asarray(cf.suspect_months) > 0
    f_held, f_sus = _grid_gap(gf, cf, f_suspect)
    log(f"card vs CPU wide (P={WIDE_P}, f64, 240 x {CVC_FIRMS:,}): run_spec_grid and the FWL "
        f"cell with 20 controls, card {g_s:.2f} s (K2 {counts['card']['k2']}: "
        f"{ {k: v for k, v in counts['card'].items() if k.startswith('gram/')} }), cpu "
        f"{c_s:.2f} s; run_spec_grid worst held diff {held:.3e} over "
        f"{int((~suspect).sum())} specs without a suspect month (tol 1e-8), {worst_sus:.3e} "
        f"over {int(suspect.sum())} with one (tol {SUSPECT_TOL:g}); referee specs card "
        f"{list(g.referee_specs)} cpu {list(c.referee_specs)}; FWL cell worst held diff "
        f"{f_held:.3e} ({int(f_suspect.sum())} suspect), deficient months "
        f"{gd['deficient_months'].tolist()} vs {cd['deficient_months'].tolist()}")
    check(counts["card"]["k2"] == (2 if dev.type == "cuda" else 0),
          f"wide card run: K2 {counts['card']['k2']}, not one a contraction")
    check(list(g.referee_specs) == list(c.referee_specs), "wide: referee specs differ")
    check(np.array_equal(gd["deficient_months"], cd["deficient_months"]),
          "wide FWL: deficient months differ")
    check(held <= 1e-8 and worst_sus <= SUSPECT_TOL and f_held <= 1e-8
          and f_sus <= SUSPECT_TOL, "card vs CPU: the wide grid beyond tolerance")


def _union_vs_cpu(seed: int) -> None:
    """The 920-column union card vs CPU at float64 (on the card the
    tile-pair kernel): ``run_spec_grid`` over 920 seeded columns (12 months
    × 2,000 firms, 1e-4 of the entries NaN, y a few columns' sum and
    noise), 3 specs (the first 3, 460 and every column): specs without a
    suspect month at 1e-8, the others at ``SUSPECT_TOL``; the card's
    launches one and one pre-pass."""
    from fm_returnprediction_tpu_torch.specgrid.specs import Spec, SpecGrid

    t, n, p = 12, 2000, UNION_P
    rng = np.random.default_rng(seed + 920)
    x = rng.standard_normal((t, n, p))
    x[rng.random(x.shape) < UNION_NAN] = np.nan
    beta = np.zeros(p)
    beta[[0, 2, 400, 700, p - 1]] = [0.5, -0.3, 0.2, 0.4, -0.25]
    y = np.nansum(x * beta, axis=-1) + rng.standard_normal((t, n))
    names = tuple(f"c{i}" for i in range(p))
    grid = SpecGrid(tuple(Spec(f"P{w}", names[:w], "all") for w in UNION_WIDTHS), union=names)
    masks = {"all": np.ones((t, n), bool)}
    out, counts, secs = {}, {}, {}
    for side in ("cuda", "cpu"):
        reset_counts()
        start = time.perf_counter()
        out[side] = run_spec_grid(torch.tensor(y, device=side), torch.tensor(x, device=side),
                                  {k: torch.tensor(m, device=side) for k, m in masks.items()},
                                  grid)
        secs[side] = time.perf_counter() - start
        counts[side] = launch_counts()
    g, c = out["cuda"], out["cpu"]
    suspect = np.asarray(c.suspect_months) > 0
    held, worst_sus = _grid_gap(g, c, suspect)
    check(gram_tile_plan(p, torch.float64, len(grid.specs)) is not None,
          "card vs CPU 920 columns: not on the tile route")
    want = (1, 1)
    got = (counts["cuda"]["k2"], counts["cuda"]["fold"])
    log(f"card vs CPU tile pairs (P={p}, f64, {t} x {n:,}, 3 specs): card {secs['cuda']:.2f} s "
        f"(K2 {got[0]}, pre-pass {got[1]}), cpu {secs['cpu']:.2f} s; worst held diff "
        f"{held:.3e} over {int((~suspect).sum())} specs without a suspect month (tol 1e-8), "
        f"{worst_sus:.3e} over {int(suspect.sum())} with one (tol {SUSPECT_TOL:g}); referee "
        f"specs card {list(g.referee_specs)} cpu {list(c.referee_specs)}")
    check(got == want, f"920-column card run: launches {got}, not {want}")
    check(list(g.referee_specs) == list(c.referee_specs), "920 columns: referee specs differ")
    check(held <= 1e-8 and worst_sus <= SUSPECT_TOL,
          "card vs CPU: the 920-column grid beyond tolerance")


SCENARIO_FLOATS = {"coef", "tstat", "nw_se", "mean_r2", "mean_n", "coreset_rate"}


def _scenario_worst(got: pd.DataFrame, want: pd.DataFrame, strict: bool = True) -> float:
    """Worst held difference of two scenario frames whose labels, flags,
    counts and NaN patterns must be equal (checked): a coefficient at
    ``max(|b|, nw_se)``, its t-stat at ``max(|t|, 1)``, the rest relative.
    With ``strict=False`` only the numbers are read, and a NaN pattern that
    differs reads as inf."""
    check(list(got.columns) == list(want.columns) and len(got) == len(want),
          "card vs CPU: scenario frames differ in shape")
    for c in want.columns:
        if strict and c not in SCENARIO_FLOATS:
            check(bool((got[c].to_numpy() == want[c].to_numpy()).all()),
                  f"card vs CPU: scenario column {c} differs")
    se = want["nw_se"].to_numpy(float)
    worst = 0.0
    for c in SCENARIO_FLOATS & set(want.columns):
        g, w = got[c].to_numpy(float), want[c].to_numpy(float)
        if not strict and not (np.isnan(g) == np.isnan(w)).all():
            return float("inf")
        check(bool((np.isnan(g) == np.isnan(w)).all()), f"card vs CPU: NaN pattern of {c}")
        fin = np.isfinite(w)
        scale = np.abs(w[fin])
        if c == "coef":
            scale = np.fmax(scale, se[fin])
        elif c == "tstat":
            scale = np.maximum(scale, 1.0)
        if fin.any():
            worst = max(worst, float((np.abs(g[fin] - w[fin]) / np.maximum(scale, 1e-300)).max()))
    return worst


# The limit on a coreset cell with a suspect month, card vs CPU, at the
# scales of ``_scenario_worst``. Such a month is one the Gram route's QR
# referee would re-solve; the coreset route has no referee, so the
# ill-conditioned Gram solve stands and moves with the order of the sums.
# The limit sits between the CPU's own spread under another firm chunk and
# a planted fault (each row weight applied twice), both read in the same
# run (PERF.md, Findings). The Gram bank has no referee either: the
# backtest's cells and bootstrap_query's pairs with a suspect month are held
# to the same limit, placed the same way (_backtest_witnesses).
SUSPECT_TOL = 1e-3
SUSPECT_CHUNK = 256


def _rows(frame: pd.DataFrame, keep: np.ndarray) -> pd.DataFrame:
    return frame[keep].reset_index(drop=True)


def _coreset_witnesses(host_panel, host_masks, factors, want, suspect) -> dict:
    """The two readings behind ``SUSPECT_TOL``, both on the CPU: the same
    coreset sweep with the plain contraction cut into ``SUSPECT_CHUNK``-firm
    chunks (another order of the same sums; flags must stay exact), and
    with every row weight applied twice (``w²`` in place of ``w``, a weight
    operand multiplied in once too often; its numbers only, since it also
    moves the flags). Returns the worst differences from ``want`` on the
    suspect rows and the others, and the flag columns the fault moved."""
    from unittest import mock

    from fm_returnprediction_tpu_torch.specgrid import coreset, grams

    plan_of = coreset.coreset_plan

    def doubled_plan(*args, **kwargs):
        plan = plan_of(*args, **kwargs)
        return plan._replace(row_weights=plan.row_weights * plan.row_weights)

    out = {}
    with mock.patch.object(grams, "auto_firm_chunk", lambda *a, **k: SUSPECT_CHUNK):
        reordered = run_scenarios(host_panel, host_masks, factors, route="coreset")
    out["order_suspect"] = _scenario_worst(_rows(reordered, suspect), _rows(want, suspect))
    out["order_held"] = _scenario_worst(_rows(reordered, ~suspect), _rows(want, ~suspect))
    with mock.patch.object(coreset, "coreset_plan", doubled_plan):
        faulty = run_scenarios(host_panel, host_masks, factors, route="coreset")
    out["fault_suspect"] = _scenario_worst(_rows(faulty, suspect), _rows(want, suspect),
                                           strict=False)
    out["fault_held"] = _scenario_worst(_rows(faulty, ~suspect), _rows(want, ~suspect),
                                        strict=False)
    out["fault_moved"] = [c for c in want.columns if c not in SCENARIO_FLOATS
                          and not (faulty[c].to_numpy() == want[c].to_numpy()).all()]
    return out


def _scenarios_vs_cpu(gpu) -> None:
    """The float64 scenario sweep on the card against the same sweep on the
    CPU, both from the card run's panel (copied to the host, so both sides
    draw the same coreset plan): the default sweep, 200 cells with
    bootstrap draws and the coreset route, at rtol 1e-8 (Table 2's pins),
    labels and flags exact. On the coreset route a cell with a suspect
    month is held to ``SUSPECT_TOL`` instead, and the two readings that
    place that limit (``_coreset_witnesses``) are logged and checked: the
    CPU's own spread under another sum order below it, a planted weight
    fault above it."""
    host_panel = dataclasses.replace(gpu.panel, values=gpu.panel.values.cpu())
    host_masks = {k: m.cpu() for k, m in gpu.subset_masks.items()}
    for label, kw in (("default", {}), ("cells=200", dict(cells=200)),
                      ("coreset", dict(route="coreset"))):
        got = run_scenarios(gpu.panel, gpu.subset_masks, gpu.factors_dict, **kw)
        want = run_scenarios(host_panel, host_masks, gpu.factors_dict, **kw)
        suspect = np.zeros(len(want), bool)
        if "suspect_months" in want:
            suspect = (want["suspect_months"] > 0).to_numpy()
        worst = _scenario_worst(_rows(got, ~suspect), _rows(want, ~suspect))
        log(f"card vs CPU scenario sweep ({label}, f64): {len(want)} rows, worst diff "
            f"{worst:.3e} over the {int((~suspect).sum())} rows of "
            f"{want.loc[~suspect, 'cell'].nunique()} cells without a suspect month (tol 1e-8); "
            f"refereed cells {want.loc[want['refereed'], 'cell'].nunique()}")
        check(worst <= 1e-8, f"card vs CPU: scenario sweep ({label}) beyond tolerance")
        if suspect.any():
            worst_sus = _scenario_worst(_rows(got, suspect), _rows(want, suspect))
            wit = _coreset_witnesses(host_panel, host_masks, gpu.factors_dict, want, suspect)
            log(f"card vs CPU scenario sweep ({label}, f64): worst diff {worst_sus:.3e} over the "
                f"{int(suspect.sum())} rows of {want.loc[suspect, 'cell'].nunique()} cells with a "
                f"suspect month (tol {SUSPECT_TOL:g}); CPU with {SUSPECT_CHUNK}-firm chunks vs "
                f"CPU: suspect rows {wit['order_suspect']:.3e}, other rows "
                f"{wit['order_held']:.3e}; planted fault (each row weight applied twice) vs "
                f"CPU: suspect rows {wit['fault_suspect']:.3e}, other rows "
                f"{wit['fault_held']:.3e}, flag columns it moved {wit['fault_moved']}")
            check(worst_sus <= SUSPECT_TOL,
                  f"card vs CPU: suspect coreset cells ({label}) beyond {SUSPECT_TOL:g}")
            check(wit["order_suspect"] <= SUSPECT_TOL < wit["fault_suspect"]
                  and wit["order_held"] <= 1e-8 < wit["fault_held"],
                  f"the suspect-cell limit {SUSPECT_TOL:g} does not sit between the CPU's "
                  f"sum-order spread and a planted fault: {wit}")


def ingest_vs_cpu() -> None:
    """The raw-frame route at float64 on the card and on the CPU: the same
    synthetic universe through ``run_pipeline(synthetic=True)``."""
    cfg = SyntheticConfig(n_firms=250, n_months=130)
    start = time.perf_counter()
    gpu = run_pipeline(synthetic=True, synthetic_config=cfg, device="cuda", dtype=torch.float64)
    gpu_s = time.perf_counter() - start
    start = time.perf_counter()
    cpu = run_pipeline(synthetic=True, synthetic_config=cfg, device="cpu", dtype=torch.float64)
    cpu_s = time.perf_counter() - start
    panel_worst = _rel_worst(gpu.panel.values.cpu().numpy(), cpu.panel.values.numpy(),
                             "enriched panel")
    diffs = _cell_diffs(gpu.table_2_cells, cpu.table_2_cells)
    log(f"ingest route card vs CPU (synthetic 250 firms x 130 months, f64): cuda {gpu_s:.2f} s "
        f"(generation {gpu.stage_seconds['load_raw_data']:.2f} s), cpu {cpu_s:.2f} s; "
        f"enriched panel {tuple(gpu.panel.values.shape)} worst rel diff {panel_worst:.3e} "
        f"(tol 1e-10); Table 2 worst held diff {diffs[0][0]:.3e} (tol 1e-8); formatted "
        f"tables equal: {gpu.table_2.equals(cpu.table_2)}; audit card "
        f"{gpu.audit.as_dict()} cpu {cpu.audit.as_dict()}")
    check(panel_worst <= 1e-10, "ingest route card vs CPU: enriched panel beyond tolerance")
    check(diffs[0][0] <= 1e-8, "ingest route card vs CPU: Table 2 beyond tolerance")
    _reporting_vs_cpu(gpu, cpu)
    check(gpu.audit.as_dict() == cpu.audit.as_dict(), "ingest route: audits differ card vs CPU")


def frames_route_phase() -> None:
    """``get_factors(crsp_comp, crsp_d, crsp_index_d)`` on the card at the
    raw-frame route's size (250 × 130, float64), the reference's own call:
    the merged monthly frame and the filtered daily frames of the legacy
    route, the dense base panel and the compact daily strips built inside
    (``factors/long_to_dense``, ``factors/daily_ingest``), K1 counted; the
    panel bit-equal to ``get_factors`` on the prebuilt inputs it captured
    and the strips built from the same frames."""
    from fm_returnprediction_tpu_torch.data.synthetic import generate_synthetic_wrds
    from fm_returnprediction_tpu_torch.data.wrds_pull import subset_to_common_stock_and_exchanges
    from fm_returnprediction_tpu_torch.panel.characteristics import get_factors
    from fm_returnprediction_tpu_torch.panel.daily import build_compact_daily
    from fm_returnprediction_tpu_torch.panel.transform_compustat import (
        add_report_date,
        calc_book_equity,
        expand_compustat_annual_to_monthly,
        merge_CRSP_and_Compustat,
    )
    from fm_returnprediction_tpu_torch.panel.transform_crsp import calculate_market_equity

    data = generate_synthetic_wrds(SyntheticConfig(n_firms=250, n_months=130))
    crsp_d = subset_to_common_stock_and_exchanges(data["crsp_d"],
                                                  columns=["permno", "dlycaldt", "retx"])
    crsp = calculate_market_equity(subset_to_common_stock_and_exchanges(data["crsp_m"]))
    comp = expand_compustat_annual_to_monthly(
        calc_book_equity(add_report_date(data["comp"].copy())))
    merged = merge_CRSP_and_Compustat(crsp, comp, data["ccm"])
    capture = {}
    timer = StageTimer("cuda")
    reset_counts()
    start = time.perf_counter()
    with timer.stage("build_panel"):
        panel, factors = get_factors(merged, crsp_d, data["crsp_index_d"], torch.float64,
                                     timer=timer, capture=capture, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = launch_counts()
    daily = build_compact_daily(crsp_d, data["crsp_index_d"], capture["dense_base"].months,
                                dtype=np.float64)
    again, again_factors = get_factors(None, None, None, torch.float64, device="cuda",
                                       dense_base=capture["dense_base"], compact_daily=daily)
    same = (again.var_names == panel.var_names and again_factors == factors
            and bool(torch.equal(torch.isnan(again.values), torch.isnan(panel.values)))
            and bool(torch.equal(torch.nan_to_num(again.values, nan=0.0),
                                 torch.nan_to_num(panel.values, nan=0.0))))
    stages = {k: round(v, 4) for k, v in timer.durations.items() if k.startswith("factors/")}
    log(f"get_factors from raw frames (250 x 130, f64) on the card: {wall:.3f} s, panel "
        f"{tuple(panel.values.shape)}, stages {json.dumps(stages)}; launches K1 {counts['k1']} "
        f"({ {k: v for k, v in counts.items() if k.startswith('std/w=252,')} }), K2 "
        f"{counts['k2']}; bit-equal to the prebuilt route: {same}")
    check(counts["k1"] > 0 and counts.get("std/w=252", 0) > 0,
          "get_factors from raw frames: K1 std was not launched")
    check("factors/long_to_dense" in stages and "factors/daily_ingest" in stages,
          f"get_factors from raw frames: host stages {sorted(stages)}")
    check(same, "get_factors from raw frames differs from the prebuilt route")


# --- the bootstrap-SE table, the stacked-QR route, the month ingest --------

# BASELINE.json configs[4]: 10,000 moving-block replicates of every Table 2
# cell's slope series (block length 5); the card-vs-CPU check runs fewer
BOOT_REPLICATES = 10_000
BOOT_CPU_REPLICATES = 2_000
BOOT_COLUMNS = ["Slope", "Boot SE", "t (boot)", "t (NW)"]


def bootstrap_phase(base, daily):
    """The bootstrap-SE table at real size through
    ``run_pipeline(make_bootstrap=True)`` (B = 10,000): the stage's wall and
    peak device memory, launches as the main path's (the table adds no
    kernel), a finite positive Boot SE in every Model 1 cell, and a second
    ``build_bootstrap_table`` with the same seed bit-identical to the
    run's. Returns the run (the unsharded reference of ``mesh_phase``)."""
    res, wall, counts = counted_run(base, daily, make_bootstrap=True,
                                    bootstrap_replicates=BOOT_REPLICATES)
    table = res.bootstrap_table
    launches = {k: counts[k] for k in MAIN_PATH_LAUNCHES}
    log(f"bootstrap (B={BOOT_REPLICATES}): run wall {wall:.3f} s, stage bootstrap_table "
        f"{res.stage_seconds['bootstrap_table']:.4f} s; launches {launches}; table "
        f"{table.shape}")
    log(table.to_string())
    check(launches == MAIN_PATH_LAUNCHES, f"the bootstrap run launched {launches}")
    check(table.shape == (sum(len(m.predictors) for m in MODELS), 3 * len(BOOT_COLUMNS))
          and list(table.columns.get_level_values(1)[:4]) == BOOT_COLUMNS,
          f"bootstrap table layout {table.shape}")
    se1 = table.loc[MODELS[0].name].xs("Boot SE", axis=1, level=1).to_numpy(float)
    check(bool(np.isfinite(se1).all() and (se1 > 0).all()),
          f"Model 1 Boot SE not finite and positive: {se1}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    start = time.perf_counter()
    again = build_bootstrap_table(res.panel, res.subset_masks, res.factors_dict,
                                  n_replicates=BOOT_REPLICATES)
    torch.cuda.synchronize()
    again_s = time.perf_counter() - start
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    log(f"bootstrap table again with the same seed: {again_s:.4f} s, peak device memory "
        f"above the resident panel {peak:.3f} GiB; bit-identical {again.equals(table)}")
    check(again.equals(table), "two bootstrap tables with one seed differ")
    del again
    torch.cuda.empty_cache()
    return res


# --- the device mesh -----------------------------------------------------------

MESH_SHARDS = 4                       # virtual shards on the one card
# TSQR vs the unsharded QR route, f32, coef at max(|b|, nw_se) and t at
# max(|t|, 1): two solve routes of one f32 panel, held as the stacked route
# is (STACKED_TOL). Both keep singular values down to the QR cutoff eps·N
# (2.6e-3 of the largest), so f32 rounding reaches ~1/cutoff·eps32 of scale
MESH_F32_TOL = 1.5e-3
MESH_F64_FIRMS, MESH_F64_MONTHS = 2000, 240
MESH_BOOT_TOL = 1e-4                  # bootstrap SEs, f32, relative
TIME_SHARDED = (13312, 2432, 252, 100)  # the tallest daily strip; window, min_periods
HIER_PROCS = 2
HIER_F32_TOL = 1e-4                   # the f32 parity budget, Model 1's three predictors
HIER_CHILD = """
import sys, time
t0 = time.perf_counter()
import numpy as np
import torch
from fm_returnprediction_tpu_torch.parallel import fama_macbeth_hier, initialize_multihost
from fm_returnprediction_tpu_torch.parallel import make_mesh_2d
from fm_returnprediction_tpu_torch.parallel import mesh as M
rank, port, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
assert initialize_multihost(f"127.0.0.1:{port}", 2, rank) == (rank, 2)
backend = torch.distributed.get_backend()
data = np.load(tmp + "/model1.npz")
y, x, mask = (torch.from_numpy(data[k]).cuda() for k in ("y", "x", "mask"))
mesh = make_mesh_2d(device="cuda")
torch.cuda.synchronize()
t1 = time.perf_counter()
cs, fm = fama_macbeth_hier(y, x, mask, mesh=mesh)
torch.cuda.synchronize()
t2 = time.perf_counter()
np.savez(tmp + f"/rank{rank}.npz", coef=fm.coef.cpu().numpy(), tstat=fm.tstat.cpu().numpy(),
         nw_se=fm.nw_se.cpu().numpy(), month_valid=cs.month_valid.cpu().numpy(),
         seconds=np.array([t1 - t0, t2 - t1]), processes=mesh.processes,
         devices=np.array([str(d) for d in mesh.devices.flat]), backend=np.array(backend),
         collectives=np.array(sorted(f"{k}:{v}" for k, v in M.collective_counts().items())))
blocked = [m for m in sys.modules if m.split(".")[0] in ("jax", "fm_returnprediction_tpu")]
assert not blocked, blocked
torch.distributed.destroy_process_group()
"""


def _collective_delta(before: dict) -> dict:
    after = mesh_mod.collective_counts()
    return {f"{kind}/{axis}": n - before.get((kind, axis), 0)
            for (kind, axis), n in sorted(after.items()) if n != before.get((kind, axis), 0)}


def _cells_gap(got: dict, want: dict) -> tuple:
    """Table 2 cells: the worst coef gap at ``max(|b|, nw_se)`` and t-stat
    gap at ``max(|t|, 1)``, NaN patterns checked equal."""
    coef_gap = tstat_gap = 0.0
    for key, w in want.items():
        g = got[key]
        for name in ("coef", "tstat"):
            check(bool(np.array_equal(np.isnan(g[name]), np.isnan(w[name]))),
                  f"{key} {name}: NaN patterns differ")
        coef_gap = max(coef_gap, float(np.nanmax(np.abs(g["coef"] - w["coef"])
                                                 / np.fmax(np.abs(w["coef"]), w["nw_se"]))))
        tstat_gap = max(tstat_gap, float(np.nanmax(np.abs(g["tstat"] - w["tstat"])
                                                   / np.fmax(np.abs(w["tstat"]), 1.0))))
    return coef_gap, tstat_gap


def _held_to_k1(got, x, window: int, mp: int, kind: str, label: str) -> float:
    """A rolling result held against the rolling kernel on the same input at
    K1's tolerance (``rolling_tolerance``); returns the worst ratio."""
    want = rolling_reduce_cuda(x, window, mp, kind)
    atol, rel = rolling_tolerance(x, kind, window, 1e-4)
    fin = torch.isfinite(want)
    check(bool((torch.isnan(got) == torch.isnan(want)).all()), f"{label}: NaN pattern")
    diff = torch.where(fin, (got - want).abs(), torch.zeros_like(want))
    limit = (rel * want.abs() + atol).clamp_min(torch.finfo(x.dtype).tiny)
    ratio = float(torch.where(fin, diff / limit, torch.zeros_like(diff)).max())
    log(f"{label}: against K1 max_abs={float(diff.max()):.3e} tol=|d|<=1e-4*|p|+{{4eps*C}} "
        f"worst_ratio={ratio:.3f}")
    check(ratio <= 1.0, f"{label}: beyond K1's tolerance")
    return ratio


def _mesh_main_path(base, daily, ref) -> dict:
    """``run_pipeline(use_mesh=True)`` at real size with ``MESH_DEVICES=4``
    and the bootstrap at B = 10,000, against the unsharded run ``ref``;
    then the float64 pins at 240 × 2,000. Returns the launches."""
    torch.cuda.reset_peak_memory_stats()
    before = mesh_mod.collective_counts()
    with _env(MESH_DEVICES=MESH_SHARDS):
        res, wall, counts = counted_run(base, daily, make_bootstrap=True,
                                        bootstrap_replicates=BOOT_REPLICATES)
    collectives = _collective_delta(before)
    peak = torch.cuda.max_memory_allocated() / 2**30
    strips = {k: v for k, v in counts.items() if STRIP_KEY.match(k)}
    log(f"mesh main path ({MESH_SHARDS} shards): wall {wall:.3f} s; peak device memory "
        f"{peak:.3f} GiB; stages (s) "
        + json.dumps({k: round(v, 4) for k, v in res.stage_seconds.items()}))
    log(f"mesh main path launches: K1 {counts['k1']} (daily strips by shard shape {strips}), "
        f"K2 {counts['k2']} {dict(gram_contract_cuda.launches_by_key)}, K3 "
        f"{counts['moments']}; collectives {collectives}")
    check_main_path_result(res)
    check(strips and all(v % MESH_SHARDS == 0 for v in strips.values()),
          f"the mesh's daily strips did not launch K1 once per shard: {strips}")
    check(counts["k2"] == 1, f"the mesh path launched K2 {counts['k2']} times (Table 2 runs "
          "TSQR; the figure sweep one Gram launch)")
    check(collectives.get("all_gather/firms") == 9 and collectives.get("psum/boot") == 9,
          f"mesh collectives {collectives}")
    # the mesh's Table 2 is distributed TSQR with the QR solver's rcond =
    # eps·N (the reference's): its unsharded counterpart is the QR route
    # (route="stacked"); in f32 both sit far from the Gram route's
    # equilibrated eigh solve, logged beside
    qr_cells = table_2_cells(ref.panel, ref.subset_masks, ref.factors_dict, route="stacked")
    coef_gap, tstat_gap = _cells_gap(res.table_2_cells, qr_cells)
    gram_coef_gap, gram_tstat_gap = _cells_gap(res.table_2_cells, ref.table_2_cells)
    qr_gram = _cells_gap(qr_cells, ref.table_2_cells)
    daily_same = {}
    for col in ("rolling_std_252", "beta"):
        a, b = res.panel.var(col), ref.panel.var(col)
        daily_same[col] = bool(torch.equal(torch.nan_to_num(a, 7.0), torch.nan_to_num(b, 7.0)))
        same_nan = bool((a.isnan() == b.isnan()).all())
        fin = torch.isfinite(b)
        d = float(torch.where(fin, (a - b).abs(), torch.zeros_like(b)).max())
        scale = float(b[fin].abs().max())
        check(same_nan and d <= 1e-4 * scale, f"mesh {col}: {d:.3e} beyond 1e-4 of {scale:.3e}")
    g = res.bootstrap_table.xs("Boot SE", axis=1, level=1).to_numpy(float)
    w = ref.bootstrap_table.xs("Boot SE", axis=1, level=1).to_numpy(float)
    check(bool(np.array_equal(np.isnan(g), np.isnan(w))), "mesh bootstrap: NaN pattern")
    boot_gap = float(np.nanmax(np.abs(g - w) / np.abs(w)))
    log(f"mesh vs unsharded (f32): Table 2 (TSQR) against the unsharded QR route coef gap "
        f"{coef_gap:.3e} of max(|b|, nw_se), t-stat {tstat_gap:.3e} of max(|t|, 1) (tol "
        f"{MESH_F32_TOL:g}); against the Gram route (eigh) coef {gram_coef_gap:.3e}, t-stat "
        f"{gram_tstat_gap:.3e}, where the unsharded QR route itself sits at coef "
        f"{qr_gram[0]:.3e}, t-stat {qr_gram[1]:.3e}; daily vol/beta bit-identical "
        f"{daily_same}; Boot SE worst rel diff {boot_gap:.3e} (tol {MESH_BOOT_TOL:g}); "
        f"bootstrap_table stage {res.stage_seconds['bootstrap_table']:.4f} s vs "
        f"{ref.stage_seconds['bootstrap_table']:.4f} s unsharded")
    check(coef_gap <= MESH_F32_TOL and tstat_gap <= MESH_F32_TOL,
          f"mesh Table 2 beyond {MESH_F32_TOL:g} of the unsharded QR route")
    check(boot_gap <= MESH_BOOT_TOL, "mesh bootstrap SEs beyond tolerance")
    del res

    b64, d64 = make_smoke_inputs(n_firms=MESH_F64_FIRMS, n_months=MESH_F64_MONTHS,
                                 dtype=np.float64)
    kw = dict(device="cuda", dtype=torch.float64, make_figure=False, make_deciles=False,
              make_serving=False)
    one = run_pipeline(dense_base=b64, compact_daily=d64, **kw)
    with _env(MESH_DEVICES=MESH_SHARDS):
        meshed = run_pipeline(dense_base=b64, compact_daily=d64, **kw)
    worst = {"coef": 0.0, "tstat": 0.0}
    for key, want in one.table_2_cells.items():
        got = meshed.table_2_cells[key]
        for name, rtol, atol in (("coef", 1e-7, 1e-10), ("tstat", 1e-6, 1e-9)):
            check(bool(np.array_equal(np.isnan(got[name]), np.isnan(want[name]))),
                  f"f64 mesh {key} {name}: NaN pattern")
            worst[name] = max(worst[name], float(np.nanmax(
                np.abs(got[name] - want[name]) / (atol + rtol * np.abs(want[name])))))
    check(max(worst.values()) <= 1.0, f"f64 mesh Table 2 beyond the reference's pins {worst}")
    log(f"mesh vs unsharded at float64 ({MESH_F64_MONTHS} x {MESH_F64_FIRMS}): Table 2 worst "
        f"|d| / (atol + rtol·|b|) coef {worst['coef']:.3e} (rtol 1e-7, atol 1e-10), t-stat "
        f"{worst['tstat']:.3e} (rtol 1e-6, atol 1e-9); formatted tables equal "
        f"{meshed.table_2.equals(one.table_2)}")
    del one, meshed
    torch.cuda.empty_cache()
    return counts


def _mesh_sweep(ref, gen) -> tuple:
    """The 27-cell f32 sweep with ``FMRP_SPECGRID_MESH=4`` against the
    one-device sweep: 4 K2 launches for the one contraction, the cells at
    ``SUSPECT_TOL``. Returns (launches, the per-shard K2 row)."""
    panel, masks, factors = ref.panel, ref.subset_masks, ref.factors_dict
    one = run_scenarios(panel, masks, factors)
    before = mesh_mod.collective_counts()
    with _env(FMRP_SPECGRID_MESH=MESH_SHARDS):
        reset_counts()
        start = time.perf_counter()
        got, stats = run_scenarios(panel, masks, factors, return_stats=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counts = launch_counts()
    gap = _held_cell_gap(got, one)
    by_key = dict(gram_contract_cuda.launches_by_key)
    log(f"mesh sweep ({MESH_SHARDS} shards): wall {wall:.3f} s; K2 {counts['k2']} {by_key}; "
        f"collectives {_collective_delta(before)}; factorize {stats['gram_factorize']}; worst "
        f"held cell gap to the one-device sweep {gap:.3e} (tol {SUSPECT_TOL:g})")
    check_scenario_frame(got, "mesh sweep", SPECGRID_CELLS)
    check(by_key == {f"P=14,S={ABSORB_SPECS},f32": MESH_SHARDS},
          f"the mesh sweep did not launch K2 once per shard: {by_key}")
    check(gap <= SUSPECT_TOL, "the mesh sweep is off the one-device sweep")
    n_local = -(-panel.values.shape[1] // MESH_SHARDS)
    row = check_gram(600, n_local, 14, torch.float32, 1e-5, gen, True, specs=ABSORB_SPECS,
                     key_prefix="mesh/gram-shard")
    return {row["key"]: by_key[f"P=14,S={ABSORB_SPECS},f32"]}, row


def _mesh_time_sharded(gen) -> tuple:
    """std and sum at w=252 over the tallest daily strip on 4 time shards:
    4 K3 launches a call, one ``all_gather`` and one ``ppermute`` each,
    held against K1 on the whole strip. Returns (launches, the per-shard
    K3 row)."""
    t, n, window, mp = TIME_SHARDED
    x = rolling_input(t, n, torch.float32, gen, 0.02, 0.005)
    meshes = [("virtual", make_mesh(MESH_SHARDS, axis_name="time", device="cuda"))]
    if torch.cuda.device_count() > 1:
        with _env(FMRP_VIRTUAL_DEVICES=1):
            meshes.append(("distinct cards", make_mesh(
                min(MESH_SHARDS, torch.cuda.device_count()), axis_name="time", device="cuda")))
    else:
        log("mesh: one card, so the shards are virtual (FMRP_VIRTUAL_DEVICES) and time "
            "the sharded programs' overhead, not a multi-card speedup")
    launches = 0
    for label, mesh in meshes:
        for kind, fn in (("std", rolling_std_time_sharded), ("sum", rolling_sum_time_sharded)):
            before = mesh_mod.collective_counts()
            reset_counts()
            got = fn(x, window, mp, mesh=mesh)
            torch.cuda.synchronize()
            k3 = masked_cumulative_moments_cuda.launches
            delta = _collective_delta(before)
            ms = time_ms(lambda: fn(x, window, mp, mesh=mesh), reps=3)
            log(f"time-sharded {kind} w={window} {t}x{n} f32 on {mesh.size} {label} shards: K3 "
                f"launches {k3}, collectives {delta}, {ms:.4f} ms a call")
            check(k3 == mesh.size, f"time-sharded {kind}: {k3} K3 launches, not {mesh.size}")
            check(delta == {"all_gather/time": 1, "ppermute/time": 1},
                  f"time-sharded {kind}: collectives {delta}")
            _held_to_k1(got, x, window, mp, kind, f"time-sharded {kind} ({label})")
            if label == "virtual":
                launches += k3
    shard = x[: t // MESH_SHARDS].contiguous()
    row = check_moments(shard, 1e-4, f"{t // MESH_SHARDS}x{n} float32 (one time shard)", True)
    row.pop("main_path")
    row["key"] = f"mesh/moments/{t // MESH_SHARDS}x{n}"
    del x, shard
    torch.cuda.empty_cache()
    return {row["key"]: launches}, row


def _mesh_hierarchy(ref) -> None:
    """Table 2's Model 1 ("All stocks") by ``fama_macbeth_hier`` across
    ``HIER_PROCS`` fresh processes on the card (gloo, 2 virtual shards each,
    a (2, 2) mesh), against the one-process unsharded FM at the f32 parity
    budget."""
    from fm_returnprediction_tpu_torch.parallel.distributed import free_port

    model = MODELS[0]
    y = ref.panel.var("retx")
    x = ref.panel.select(model_columns(model, ref.factors_dict))
    mask = ref.subset_masks["All stocks"]
    _, want = fama_macbeth(y, x, mask)
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(Path(tmp) / "model1.npz", y=y.cpu().numpy(), x=x.cpu().numpy(),
                 mask=mask.cpu().numpy())
        port = free_port()
        env = dict(os.environ, FMRP_VIRTUAL_DEVICES="2",
                   PYTHONPATH=os.pathsep.join(
                       [p for p in (os.environ.get("PYTHONPATH"), str(Path(__file__).parent))
                        if p]))
        start = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", HIER_CHILD, str(r), str(port), tmp],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  env=env) for r in range(HIER_PROCS)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=240)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - start
        check([p.returncode for p in procs] == [0] * HIER_PROCS,
              "the hierarchy ranks failed:\n" + "\n---\n".join(o[-3000:] for o in outs))
        got = [dict(np.load(Path(tmp) / f"rank{r}.npz")) for r in range(HIER_PROCS)]
    w = {k: getattr(want, k).cpu().numpy() for k in ("coef", "tstat", "nw_se")}
    coef_gap = max(float(np.nanmax(np.abs(g["coef"] - w["coef"])
                                   / np.fmax(np.abs(w["coef"]), w["nw_se"]))) for g in got)
    tstat_gap = max(float(np.nanmax(np.abs(g["tstat"] - w["tstat"])
                                    / np.fmax(np.abs(w["tstat"]), 1.0))) for g in got)
    same = all(np.array_equal(got[0][k], got[1][k]) for k in ("coef", "tstat"))
    log(f"hierarchy across {HIER_PROCS} processes ({model.name}, All stocks, f32, backend "
        f"{got[0]['backend']}, mesh rows by process {got[0]['processes'].tolist()}, devices "
        f"{got[0]['devices'].tolist()}): wall {wall:.3f} s with the spawns; per rank start to "
        f"mesh {[round(float(g['seconds'][0]), 3) for g in got]} s, run "
        f"{[round(float(g['seconds'][1]), 4) for g in got]} s; collectives "
        f"{got[0]['collectives'].tolist()}; ranks bit-identical {same}; coef gap {coef_gap:.3e} "
        f"of max(|b|, nw_se), t-stat {tstat_gap:.3e} (tol {HIER_F32_TOL:g})")
    check(same, "the hierarchy's ranks differ")
    check(coef_gap <= HIER_F32_TOL and tstat_gap <= HIER_F32_TOL,
          "the hierarchy is beyond the f32 parity budget")


def mesh_phase(base, daily, ref, gen) -> tuple:
    """The device mesh at real size on 4 virtual shards of the card
    (``FMRP_VIRTUAL_DEVICES=4``): the sharded main path with the bootstrap,
    the mesh spec grid, the time-sharded rolling family and the hierarchy
    across two processes. Returns (launches by kernel-table key, the
    per-shard kernel rows)."""
    with _env(FMRP_VIRTUAL_DEVICES=MESH_SHARDS):
        counts = _mesh_main_path(base, daily, ref)
        launches = {f"mesh/{k}": v for k, v in counts.items() if STRIP_KEY.match(k)}
        sweep, k2_row = _mesh_sweep(ref, gen)
        moments, k3_row = _mesh_time_sharded(gen)
    _mesh_hierarchy(ref)
    launches.update(sweep)
    launches.update(moments)
    rows = []
    for key, count in sorted(launches.items()):
        match = STRIP_KEY.match(key[len("mesh/"):])
        if match:
            window, t, n = (int(v) for v in match.groups())
            x = rolling_input(t, n, torch.float32, gen, 0.02, 0.005)
            label = f"std w={window} mp=100 (daily strip, one mesh shard) {t}x{n} float32"
            row = k1_row(x, window, 100, "std", check_rolling(x, window, 100, "std", 1e-4, label),
                         label)
            row["key"] = key
            rows.append(row)
            del x
    torch.cuda.empty_cache()
    return launches, rows + [k2_row, k3_row]


def _boot_vs_cpu(gpu, cpu) -> None:
    """The float64 bootstrap, card vs CPU. Given the same inputs: one cell's
    slope series (the CPU run's) and one set of starts handed to
    ``replicate_means_from_starts`` on each device, and the same slopes
    through ``block_bootstrap_se`` (one seed, so the same CPU-drawn starts),
    at rtol 1e-10. The two runs' whole tables, whose slopes come from each
    device's own QR solves, are held as Table 2's cells are (1e-8: a slope
    at ``max(|b|, Boot SE)``, a t at ``max(|t|, 1)``, Boot SE relative)."""
    g, c = gpu.bootstrap_table, cpu.bootstrap_table
    check(g.index.equals(c.index) and g.columns.equals(c.columns), "bootstrap table layout")
    held = 0.0
    for subset in c.columns.get_level_values(0).unique():
        a, b = g[subset], c[subset]
        scale = {"Slope": np.maximum(b["Slope"].abs(), b["Boot SE"]), "Boot SE": b["Boot SE"],
                 "t (boot)": np.maximum(b["t (boot)"].abs(), 1.0),
                 "t (NW)": np.maximum(b["t (NW)"].abs(), 1.0)}
        for col, sc in scale.items():
            d = ((a[col] - b[col]).abs() / sc).to_numpy(float)
            check(bool((np.isnan(a[col]) == np.isnan(b[col])).all()),
                  f"card vs CPU: bootstrap {subset} {col} NaN pattern")
            held = max(held, float(np.nanmax(d, initial=0.0)))
    model = MODELS[-1]
    y = cpu.panel.var("retx")
    x = cpu.panel.select(model_columns(model, cpu.factors_dict))
    cs, _ = fama_macbeth(y, x, cpu.subset_masks["All stocks"])
    valid = cs.month_valid[:, None] & torch.isfinite(cs.slopes)
    series, counts = compact_front(cs.slopes.T, valid.T)
    starts = draw_block_starts(counts, BOOT_CPU_REPLICATES, 5, series.shape[1],
                               torch.Generator().manual_seed(1))
    means = [replicate_means_from_starts(series.to(dev), counts.to(dev), starts, 5).cpu()
             for dev in ("cuda", "cpu")]
    ses = [block_bootstrap_se(cs.slopes.to(dev), valid.to(dev), seed=0,
                              n_replicates=BOOT_CPU_REPLICATES).se.cpu()
           for dev in ("cuda", "cpu")]
    means_worst = _rel_worst(means[0].numpy(), means[1].numpy(), "replicate means")
    se_worst = _rel_worst(ses[0].numpy(), ses[1].numpy(), "bootstrap SE")
    log(f"card vs CPU bootstrap (B={BOOT_CPU_REPLICATES}, f64): same series and starts, "
        f"{model.name} All stocks replicate means worst rel diff {means_worst:.3e}, SEs "
        f"{se_worst:.3e} (tol 1e-10); each run's own table held as Table 2's cells "
        f"{held:.3e} (tol 1e-8)")
    check(means_worst <= 1e-10 and se_worst <= 1e-10 and held <= 1e-8,
          "card vs CPU: bootstrap beyond tolerance")


def _frame_worst(got: pd.DataFrame, want: pd.DataFrame, what: str) -> tuple:
    """(worst absolute, worst relative) difference of two float frames of
    one layout whose NaN patterns agree (checked)."""
    check(got.index.equals(want.index) and got.columns.equals(want.columns),
          f"stacked vs gram: {what} layout")
    a, b = got.to_numpy(float), want.to_numpy(float)
    check(bool((np.isnan(a) == np.isnan(b)).all()), f"stacked vs gram: {what} NaN pattern")
    fin = np.isfinite(b)
    diff = np.abs(a[fin] - b[fin])
    return float(diff.max(initial=0.0)), _rel_worst(a, b, what)


def _formatted_worst(a: pd.DataFrame, b: pd.DataFrame) -> float:
    """Worst cell difference of two formatted (``%.3f`` / N) Table 2
    frames of one layout, blanks equal (the reference's
    ``_formatted_frames_close``)."""
    check(a.index.equals(b.index) and a.columns.equals(b.columns), "Table 2 layout")
    worst = 0.0
    for col in a.columns:
        for idx in a.index:
            va, vb = a.loc[idx, col], b.loc[idx, col]
            if va == vb:
                continue
            check(va != "" and vb != "", f"Table 2 {idx} {col}: {va!r} vs {vb!r}")
            worst = max(worst, abs(float(str(va).replace(",", ""))
                                   - float(str(vb).replace(",", ""))))
    return worst


STACKED_LAUNCHES = {"k1": 17, "k2": 0, "moments": 0}
STACKED_TOL = 1.5e-3


def _stacked_gaps(res, gram_frames: dict) -> tuple:
    """(Table 2's worst formatted-cell gap, {frame: (worst abs, worst rel)})
    of a stacked run against the Gram route's frames."""
    t2 = _formatted_worst(res.table_2, gram_frames["table_2"])
    got = {"decile_table": res.decile_table,
           **{f"figure_1/{name}": frame for name, frame in res.figure_1.items()}}
    return t2, {name: _frame_worst(frame, gram_frames[name], name)
                for name, frame in got.items()}


def _gap_text(t2: float, worst: dict) -> str:
    return (f"Table 2 formatted cells worst |diff| {t2:.4g}; (worst abs, worst rel) "
            + json.dumps({k: [float(f"{a:.4g}"), float(f"{r:.4g}")]
                          for k, (a, r) in worst.items()}))


def _stacked_run(base, daily, dtype):
    """One counted main-path run on ``FMRP_SPECGRID_ROUTE=stacked``:
    (result, wall s, launches, peak GiB)."""
    torch.cuda.reset_peak_memory_stats()
    with _env(FMRP_SPECGRID_ROUTE="stacked"):
        reset_counts()
        start = time.perf_counter()
        res = run_pipeline(dense_base=base, compact_daily=daily, device="cuda", dtype=dtype)
        wall = time.perf_counter() - start
        counts = launch_counts()
    return res, wall, {k: counts[k] for k in STACKED_LAUNCHES}, \
        torch.cuda.max_memory_allocated() / 2**30


def stacked_phase(base, daily, gram_frames: dict) -> None:
    """The main path at real size with ``FMRP_SPECGRID_ROUTE=stacked``:
    Table 2 and the figure/decile sweep by batched QR (the real shape takes
    the split branch, 2.5 GB of stacked design > 512 MB), K2 never launched
    and K1 as on the Gram route; the ``table_2`` and ``figure_cs`` stages,
    peak memory, and ``torch.linalg.qr`` at each model's (600, 22000,
    P + 2) design timed on its own. In float32 the QR route's cutoff
    (eps·N of the largest singular value, as in the reference) truncates
    the raw-unit columns, so its gap to the Gram route is logged, not held;
    the frames are held against the Gram route's within ``STACKED_TOL``
    (the reference's cross-route tolerance on formatted frames, which its
    twin test applies at float64) on a float64 pair of runs. Then
    ``ingest_phase`` on the float64 run's panel."""
    res, wall, launches, peak = _stacked_run(base, daily, torch.float32)
    stages = res.stage_seconds
    log(f"stacked route (f32): wall {wall:.3f} s, stage table_2 {stages['table_2']:.4f} s, "
        f"figure_cs {stages['figure_cs']:.4f} s, peak device memory {peak:.3f} GiB; launches "
        f"{launches}; stages (s): " + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    check(launches == STACKED_LAUNCHES, f"the stacked route launched {launches}")
    log("stacked vs gram route at f32 (logged, not held: the QR cutoff truncates raw-unit "
        "columns): " + _gap_text(*_stacked_gaps(res, gram_frames)))

    y = res.panel.var("retx")
    mask = res.subset_masks["All stocks"]
    qr_ms = {}
    for model in MODELS:
        x = res.panel.select(model_columns(model, res.factors_dict))
        valid = mask & torch.isfinite(y) & torch.isfinite(x).all(-1)
        design = torch.cat([torch.ones_like(y)[..., None], x, y[..., None]], -1)
        design = torch.where(valid[..., None], design, torch.zeros_like(design))
        qr_ms[tuple(design.shape)] = time_ms(lambda d=design: torch.linalg.qr(d, mode="r"),
                                             reps=3)
        del design
    per_table = 3 * sum(qr_ms.values()) / 1e3
    log("torch.linalg.qr(mode='r') per call (ms): "
        + json.dumps({"x".join(map(str, k)): round(v, 3) for k, v in qr_ms.items()})
        + f"; Table 2's nine QRs {per_table:.3f} s of its {stages['table_2']:.3f} s stage")
    del res, y, mask
    torch.cuda.empty_cache()

    gram = run_pipeline(dense_base=base, compact_daily=daily, device="cuda", dtype=torch.float64)
    gram64 = {"table_2": gram.table_2, "decile_table": gram.decile_table,
              **{f"figure_1/{name}": frame for name, frame in gram.figure_1.items()}}
    del gram
    torch.cuda.empty_cache()
    res, wall, launches, peak = _stacked_run(base, daily, torch.float64)
    t2, worst = _stacked_gaps(res, gram64)
    log(f"stacked route (f64): wall {wall:.3f} s, stage table_2 "
        f"{res.stage_seconds['table_2']:.4f} s, figure_cs {res.stage_seconds['figure_cs']:.4f} s, "
        f"peak {peak:.3f} GiB; launches {launches}; vs the f64 gram route (tol {STACKED_TOL}): "
        + _gap_text(t2, worst))
    check(launches == STACKED_LAUNCHES, f"the f64 stacked route launched {launches}")
    check(t2 <= STACKED_TOL and all(a <= STACKED_TOL for a, _ in worst.values()),
          "the stacked route's frames differ from the Gram route's beyond tolerance")
    ingest_phase(res)
    bank_ingest_phase(res)
    del res
    torch.cuda.empty_cache()


def ingest_phase(res) -> None:
    """One further month of the real-size serving panel ingested on the
    card: the "All stocks" figure model of a float64 run, a ``solver="normal"``
    state over the first 599 months, then month 600 (its universe rows of
    22,000 firm slots) by ``ingest_month`` on the card and on the CPU, held
    against each other
    and against a full normal-route rebuild on the card at the reference's
    pins (coefficients and means rtol 1e-9 / atol 1e-12, Grams the same,
    support bounds 1e-12)."""
    y = res.panel.var("retx")
    x = res.panel.select(list(FIGURE1_VARS))
    mask = res.subset_masks["All stocks"]
    months = np.asarray(res.panel.months)
    prior = build_serving_state(y[:-1], x[:-1], mask[:-1], months=months[:-1],
                                xvars=list(FIGURE1_VARS), solver="normal")
    row = (y[-1].cpu().numpy(), x[-1].cpu().numpy(), mask[-1].cpu().numpy())
    times = []
    for _ in range(3):
        start = time.perf_counter()
        card = ingest_month(prior, *row, months[-1], device="cuda")
        times.append(time.perf_counter() - start)
    start = time.perf_counter()
    host = ingest_month(prior, *row, months[-1], device="cpu")
    cpu_s = time.perf_counter() - start
    full = build_serving_state(y, x, mask, months=months, xvars=list(FIGURE1_VARS),
                               solver="normal")
    worst = {}
    for name, want in (("cpu", host), ("rebuild", full)):
        for leaf, rtol, atol in (("coef", 1e-9, 1e-12), ("slopes_bar", 1e-9, 1e-12),
                                 ("intercept_bar", 1e-9, 1e-12), ("gram", 1e-9, 1e-12),
                                 ("moment", 1e-9, 1e-12), ("x_lo", 1e-12, 0.0),
                                 ("x_hi", 1e-12, 0.0)):
            a, b = getattr(card, leaf)[-1], getattr(want, leaf)[-1]
            check(bool((np.isnan(a) == np.isnan(b)).all()), f"ingest {name} {leaf} NaN pattern")
            fin = np.isfinite(b)
            excess = np.abs(a[fin] - b[fin]) - (atol + rtol * np.abs(b[fin]))
            worst[f"{name}/{leaf}"] = float(excess.max(initial=-np.inf))
        check(bool(np.array_equal(card.n_obs, want.n_obs)
                   and np.array_equal(card.month_valid, want.month_valid)),
              f"ingest vs {name}: counts or month gates differ")
    log(f"ingest one month ({int(row[2].sum())} firms, f64) on the card: "
        f"{', '.join(f'{t * 1e3:.2f}' for t in times)} ms (three calls), on the CPU "
        f"{cpu_s * 1e3:.2f} ms; worst |diff| - (atol + rtol|want|) per leaf (<= 0 passes) "
        + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()}))
    check(all(v <= 0 for v in worst.values()), "ingest beyond the reference's pins")
    phase_timed("service_ingest_phase", service_ingest_phase, prior, row, months[-1], card)


def bootstrap_backtest_cli_phase() -> None:
    """``python -m fm_returnprediction_tpu_torch.pipeline --synthetic
    --bootstrap 200 --backtest --backtest-sink metrics`` at 60 × 130 on
    the card (one command for both): exit 0 with the
    ``bootstrap_table`` and ``backtest`` stages and the bank's K2 launch;
    then ``bootstrap_se.pkl``/``.tex`` and ``backtest.csv`` written by an
    ``--output-dir`` run: the command line where matplotlib imports, else
    ``run_pipeline(make_figure=False, make_bootstrap=True,
    make_backtest=True, output_dir=…)`` on the same universe (the command
    line draws Figure 1 into any output directory and raises without
    matplotlib, as the reference does)."""
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    firms, months = SYNTHETIC_CLI_FIRMS, SYNTHETIC_CLI_MONTHS
    base_args = ["--synthetic", "--firms", firms, "--months", months, "--bootstrap", 200,
                 "--backtest"]
    run = run_cli(base_args + ["--backtest-sink", "metrics"])
    log(f"CLI --synthetic --firms {firms} --months {months} --bootstrap 200 --backtest "
        f"--backtest-sink metrics: exit 0 in {run['wall']:.1f} s; stage bootstrap_table "
        f"{run['stages'].get('bootstrap_table', float('nan')):.3f} s, backtest "
        f"{run['stages'].get('backtest', float('nan')):.3f} s; launches K1 "
        f"{run['launches']['k1']}, K2 {run['launches']['k2']} {run['launches']['k2_by_key']}")
    check({"bootstrap_table", "backtest"} <= set(run["stages"]) and run["launches"]["k2"] == 3,
          f"bootstrap/backtest CLI stages {sorted(run['stages'])}, launches {run['launches']}")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "out"
        if have_mpl:
            run_cli(base_args + ["--output-dir", out])
        else:
            run_pipeline(synthetic=True, synthetic_config=SyntheticConfig(
                n_firms=firms, n_months=months), device="cuda", make_figure=False,
                make_bootstrap=True, bootstrap_replicates=200, make_backtest=True,
                output_dir=out)
        made = sorted(os.listdir(out))
        frame = pd.read_csv(out / "backtest.csv")
        log(f"bootstrap_se and backtest.csv written by "
            f"{'the command line' if have_mpl else 'run_pipeline(make_figure=False)'}: {made}; "
            f"backtest.csv {frame.shape}")
        check({"bootstrap_se.pkl", "bootstrap_se.tex"} <= set(made),
              "bootstrap_se.pkl/.tex were not written")
        table = pd.read_pickle(out / "bootstrap_se.pkl")
        check(table.shape == (24, 12), f"bootstrap_se.pkl shape {table.shape}")
        check(len(frame) == BACKTEST_CELLS and set(BACKTEST_METRICS) <= set(frame.columns),
              f"backtest.csv shape {frame.shape}")


# --- the rolling-origin backtest on the Gram bank -------------------------

# 2 schemes (expanding, rolling120) × 3 models × 3 universes × EW/VW
BACKTEST_CELLS = 36
# Launches at real size: the guarded run_pipeline(make_backtest=True) — the
# main path's K1 17 and K2 2 plus the bank's one K2 contraction of its 9
# (model, universe) pairs, at Table 2's shape; the bank built alone; and the
# sweep over that bank, which contracts nothing.
BACKTEST_LAUNCHES = {
    "backtest": ({"k1": 17, "k2": 3, "moments": 0}, {"P=14,S=9,f32": 2, "P=5,S=3,f32": 1}),
    "bank": ({"k1": 0, "k2": 1, "moments": 0}, {"P=14,S=9,f32": 1}),
    "sweep": ({"k1": 0, "k2": 0, "moments": 0}, {}),
}
BACKTEST_METRICS = ["oos_r2", "ic_mean", "ic_tstat", "rank_ic_mean", "spread", "spread_tstat",
                    "spread_turnover"]
BACKTEST_INTS = ["cell", "quantiles", "ic_months", "n_months", "forecast_months",
                 "suspect_months"]
BACKTEST_RTOL = 1e-9          # card vs CPU, the frame (float64)
SCAN_REFIT_TOL = 1e-13        # the reference's pin, of max(|path|, 1)
BANK_BOOT_DRAWS = 200


def _timed(fn):
    """(result, wall seconds) of ``fn()``, synchronized with the card."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def backtest_phase(base, daily) -> dict:
    """The backtest at real size: ``run_pipeline(make_backtest=True)``
    guarded (36 cells, VW kept, no violation, launches pinned), the stage
    again on the resident panel (its peak device memory above the panel,
    the stats, bit-identical frame), the bank alone (one K2 launch) and the
    sweep over it with the counters at 0 (no K2 launch, no panel
    contraction, the same frame), and the refit oracle's time at real size
    beside the scan's. Returns the pipeline run's launch counts."""
    res, wall, counts = counted_run(base, daily, guard=True, make_backtest=True)
    frame = res.backtest_table
    log(f"backtest (guarded, f32): wall {wall:.3f} s, stage backtest "
        f"{res.stage_seconds['backtest']:.4f} s; audit " + res.audit.report().replace("\n", "; "))
    check(not res.audit.violations and not res.audit.quarantined,
          "guarded backtest run: contract violations or quarantined artifacts")
    _k2_pinned("backtest (guarded, f32)", counts, BACKTEST_LAUNCHES["backtest"])
    check(frame is not None and len(frame) == BACKTEST_CELLS
          and list(frame["cell"]) == list(range(BACKTEST_CELLS)),
          f"backtest frame: {None if frame is None else len(frame)} rows")
    check(set(frame["weighting"]) == {"ew", "vw"}
          and set(frame["scheme"]) == {"expanding", "rolling120"},
          f"backtest frame cells {set(frame['weighting'])} {set(frame['scheme'])}")
    finite = np.isfinite(frame[BACKTEST_METRICS].to_numpy(float))
    log(frame[["scheme", "set", "universe", "weighting"] + BACKTEST_METRICS
              + ["n_months", "suspect_months"]].to_string())
    check(bool(finite.all()), "backtest frame: non-finite headline metrics")

    panel, masks, factors = res.panel, res.subset_masks, res.factors_dict
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    (again, stats), again_s = _timed(lambda: run_backtest_scenarios(
        panel, masks, factors, return_stats=True, device="cuda"))
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    log(f"backtest stage again on the resident panel: {again_s:.4f} s, peak device memory "
        f"above the resident panel {peak:.3f} GiB; stats "
        + json.dumps({k: v for k, v in stats.items()}, default=str)
        + f"; bit-identical {again.equals(frame)}")
    check(not stats["weighting_reduced"] and stats["panel_contractions"] == 0,
          f"backtest stats {stats}")
    check(again.equals(frame), "two backtest runs on one panel differ")

    reset_counts()
    bank, bank_s = _timed(lambda: bank_for_scenarios(panel, masks, factors,
                                                     fingerprint="backtest", device="cuda"))
    _k2_pinned("bank (f32)", launch_counts(), BACKTEST_LAUNCHES["bank"])
    space = backtest_space(bank)
    x = panel.select(list(bank.union))
    realized, weights = panel.var("retx"), panel.var("me")
    reset_counts()
    (swept, sweep_stats), sweep_s = _timed(lambda: run_backtest(
        bank, x, realized, {n: masks[n] for n in space.universes}, space=space,
        weights_var=weights, min_months=10, device="cuda"))
    sweep_counts = launch_counts()
    log(f"bank_for_scenarios {bank_s:.4f} s ({bank.n_pairs} pairs x {bank.n_months} months); "
        f"run_backtest over the bank {sweep_s:.4f} s, panel_contractions "
        f"{sweep_stats['panel_contractions']}, path solves {sweep_stats['path_solves']}, "
        f"forecasts {sweep_stats['predict_calls']}; the same frame {swept.equals(frame)}")
    _k2_pinned("sweep over the bank", sweep_counts, BACKTEST_LAUNCHES["sweep"])
    check(sweep_stats["panel_contractions"] == 0, "the sweep contracted the panel")
    check(swept.equals(frame), "the sweep over the bank differs from the stage's frame")

    scan, scan_s = _timed(lambda: backtest_paths(bank, "expanding", route="scan", device="cuda"))
    refit, refit_s = _timed(lambda: backtest_paths(bank, "expanding", route="refit",
                                                   device="cuda"))
    log(f"coefficient paths at real size (f32, expanding, OLS): scan {scan_s * 1e3:.2f} ms, "
        f"refit oracle {refit_s:.3f} s ({bank.n_months} origins); scan vs refit worst "
        f"|d| / max(|path|, 1) {_path_gap(scan, refit):.3e} (logged: float32; the float64 "
        "pin is checked card vs CPU)")
    del res, panel, masks, x, realized, weights, again, swept, bank
    torch.cuda.empty_cache()
    return counts


def _path_gap(a, b) -> float:
    """Worst |a − b| / max(|b|, 1) of two coefficient paths whose NaN
    patterns, counts and month gates must agree (checked)."""
    check(np.array_equal(np.isnan(a.path), np.isnan(b.path))
          and np.array_equal(a.month_valid, b.month_valid)
          and np.array_equal(a.count, b.count),
          f"paths {a.scheme} {a.estimator_label}: NaN pattern, month gates or counts differ")
    fin = np.isfinite(b.path)
    gap = np.abs(a.path[fin] - b.path[fin]) / np.maximum(np.abs(b.path[fin]), 1.0)
    beta = np.abs(a.beta - b.beta) / np.maximum(np.abs(b.beta), 1.0)
    return float(max(gap.max(initial=0.0), beta.max(initial=0.0)))


def _held_worst(got: dict, want: dict) -> float:
    """Worst held difference of FM summaries given as dicts of arrays
    (``coef`` at ``max(|b|, nw_se)``, ``tstat`` at ``max(|t|, 1)``, the
    rest relative), NaN patterns and month counts equal (checked)."""
    check(np.array_equal(np.asarray(got["n_months"]), np.asarray(want["n_months"])),
          "card vs CPU: month counts differ")
    worst = 0.0
    for name in ("coef", "tstat", "nw_se", "mean_r2", "mean_n"):
        a, b = np.asarray(got[name], float), np.asarray(want[name], float)
        check(np.array_equal(np.isnan(a), np.isnan(b)), f"card vs CPU: NaN pattern of {name}")
        fin = np.isfinite(b)
        scale = np.abs(b[fin])
        if name == "coef":
            scale = np.fmax(scale, np.asarray(want["nw_se"], float)[fin])
        elif name == "tstat":
            scale = np.maximum(scale, 1.0)
        if fin.any():
            worst = max(worst, float((np.abs(a[fin] - b[fin]) / np.maximum(scale, 1e-300)).max()))
    return worst


def _bucket_counts(bank, panel, masks, device) -> dict:
    """Every backtest cell's (T, D) quantile-bucket counts on ``device``:
    a firm changing bucket moves one count between two cells."""
    space = backtest_space(bank)
    x = panel.select(list(bank.union))
    realized, weights = panel.var("retx"), panel.var("me")
    out = {}
    for scheme in space.schemes:
        paths = backtest_paths(bank, scheme, device=device)
        for pair, (_, uni) in enumerate(bank.pair_labels):
            er, er_valid = _predict_pair(paths, x, masks[uni], pair)
            for vw in (False, True):
                port = quantile_sorts(er, er_valid, realized, weights=weights if vw else None,
                                      n_quantiles=space.n_quantiles, min_obs=space.min_obs,
                                      nw_lags=space.nw_lags, value_weighted=vw)
                out[(scheme, pair, vw)] = port.counts.cpu().numpy()
    return out


def _frame_rel_worst(got: pd.DataFrame, want: pd.DataFrame, rows: np.ndarray) -> float:
    """Worst relative difference of two backtest frames' float columns on
    ``rows``, non-finite patterns equal (checked)."""
    return max((_rel_worst(got[c].to_numpy(float)[rows], want[c].to_numpy(float)[rows],
                           f"backtest {c}")
                for c in want.columns if want[c].dtype.kind == "f"), default=0.0)


def _backtest_witnesses(panel, masks, factors, want, suspect) -> dict:
    """The two readings that place ``SUSPECT_TOL`` for the backtest, both
    on the CPU: the same stage with the plain contraction cut into
    ``SUSPECT_CHUNK``-firm chunks (another order of the bank's sums), and
    with a planted look-ahead fault (month t forecast from origin t, not
    t−1). Worst differences from ``want`` on the rows of cells with a
    suspect month and on the others."""
    from unittest import mock

    from fm_returnprediction_tpu_torch.backtest import sweep
    from fm_returnprediction_tpu_torch.specgrid import grams

    predict = sweep._predict_pair

    def look_ahead(paths, x, mask, pair):
        path = np.concatenate([paths.path[:, 1:], paths.path[:, -1:]], axis=1)
        return predict(paths._replace(path=path), x, mask, pair)

    out = {}
    with mock.patch.object(grams, "auto_firm_chunk", lambda *a, **k: SUSPECT_CHUNK):
        reordered = run_backtest_scenarios(panel, masks, factors, device="cpu")
    with mock.patch.object(sweep, "_predict_pair", look_ahead):
        faulty = run_backtest_scenarios(panel, masks, factors, device="cpu")
    for name, frame in (("order", reordered), ("fault", faulty)):
        out[f"{name}_suspect"] = _frame_rel_worst(frame, want, suspect)
        out[f"{name}_held"] = _frame_rel_worst(frame, want, ~suspect)
    return out


def _backtest_vs_cpu(gpu) -> None:
    """The float64 backtest on the card against the CPU, both from the card
    run's panel (copied to the host): the stage's frame at rtol 1e-9 on the
    cells without a suspect month, labels and integer columns equal, the
    quantile-bucket flips between the two devices counted and logged. A
    cell with a suspect month forecasts from per-month solves the bank
    discloses as ill-conditioned and no referee re-solves, which move with
    the order of the sums: those cells are held at ``SUSPECT_TOL``, and the
    two readings that place it (``_backtest_witnesses``) are logged and
    checked, as for the coreset sweep. The bank's ``bootstrap_query`` (200
    draws on the same resample rows) is held as Table 2's cells are, at
    1e-9 on the pairs without a suspect month and ``SUSPECT_TOL`` on the
    others. On the card, the scan route against the per-origin refit oracle
    at the reference's pin 1e-13 of ``max(|path|, 1)``, expanding and
    rolling120, OLS and FWL on a Model 1 column (the refit's time
    logged)."""
    host_panel = dataclasses.replace(gpu.panel, values=gpu.panel.values.cpu())
    host_masks = {k: m.cpu() for k, m in gpu.subset_masks.items()}
    sides = {"cuda": (gpu.panel, gpu.subset_masks), "cpu": (host_panel, host_masks)}
    factors = gpu.factors_dict
    frames, banks, secs = {}, {}, {}
    for dev, (panel, masks) in sides.items():
        frames[dev], secs[dev] = _timed(lambda: run_backtest_scenarios(panel, masks, factors,
                                                                       device=dev))
        banks[dev] = bank_for_scenarios(panel, masks, factors, fingerprint="backtest",
                                        device=dev)
    got, want = frames["cuda"], frames["cpu"]
    check(list(got.columns) == list(want.columns) and len(got) == len(want) == BACKTEST_CELLS,
          "card vs CPU: backtest frames differ in shape")
    for c in want.columns:
        if want[c].dtype.kind != "f":
            check(bool((got[c].to_numpy() == want[c].to_numpy()).all()),
                  f"card vs CPU: backtest column {c} differs")
    suspect = (want["suspect_months"] > 0).to_numpy()
    held, worst_sus = _frame_rel_worst(got, want, ~suspect), _frame_rel_worst(got, want, suspect)
    counts = {dev: _bucket_counts(banks[dev], *sides[dev], dev) for dev in sides}
    flips = sum(int(np.sum(counts["cuda"][k] != counts["cpu"][k])) for k in counts["cpu"])
    wit = _backtest_witnesses(host_panel, host_masks, factors, want, suspect)
    log(f"card vs CPU backtest (T=240, N={CVC_FIRMS}, f64): cuda {secs['cuda']:.2f} s, cpu "
        f"{secs['cpu']:.2f} s; worst rel diff {held:.3e} over the {int((~suspect).sum())} cells "
        f"without a suspect month (tol {BACKTEST_RTOL:g}), {worst_sus:.3e} over the "
        f"{int(suspect.sum())} with one (tol {SUSPECT_TOL:g}); integer and label columns "
        f"equal; quantile-bucket count cells that differ (flips) {flips} of "
        f"{sum(a.size for a in counts['cpu'].values())}; CPU with {SUSPECT_CHUNK}-firm chunks "
        f"vs CPU: suspect cells {wit['order_suspect']:.3e}, others {wit['order_held']:.3e}; "
        f"planted look-ahead fault vs CPU: suspect cells {wit['fault_suspect']:.3e}, others "
        f"{wit['fault_held']:.3e}")
    check(held <= BACKTEST_RTOL and worst_sus <= SUSPECT_TOL,
          "card vs CPU: backtest frame beyond tolerance")
    check(wit["order_suspect"] <= SUSPECT_TOL < wit["fault_suspect"]
          and wit["order_held"] <= BACKTEST_RTOL < wit["fault_held"],
          f"the backtest's suspect-cell limit {SUSPECT_TOL:g} does not sit between the CPU's "
          f"sum-order spread and a planted fault: {wit}")

    boot = {dev: grambank.bootstrap_query(banks[dev], BANK_BOOT_DRAWS, device=dev)
            for dev in sides}
    fields = ("coef", "tstat", "nw_se", "mean_r2", "mean_n", "n_months")
    point_g, point_c = boot["cuda"][0]._asdict(), boot["cpu"][0]._asdict()
    check(np.array_equal(point_g["suspect_months"], point_c["suspect_months"]),
          "card vs CPU: bootstrap_query suspect months differ")
    worst = {True: 0.0, False: 0.0}
    for k, sus in enumerate(point_c["suspect_months"] > 0):
        pair_g = {f: point_g[f][k] for f in fields}
        pair_c = {f: point_c[f][k] for f in fields}
        worst[bool(sus)] = max(worst[bool(sus)], _held_worst(pair_g, pair_c), _held_worst(
            dict(zip(fields, boot["cuda"][1][k])), dict(zip(fields, boot["cpu"][1][k]))))
    log(f"card vs CPU bootstrap_query ({BANK_BOOT_DRAWS} draws, {banks['cpu'].n_pairs} pairs, "
        f"suspect months {point_c['suspect_months'].tolist()}): worst held diff (point and "
        f"draws) {worst[False]:.3e} on the pairs without a suspect month (tol "
        f"{BACKTEST_RTOL:g}), {worst[True]:.3e} on the others (tol {SUSPECT_TOL:g})")
    check(worst[False] <= BACKTEST_RTOL and worst[True] <= SUSPECT_TOL,
          "card vs CPU: bootstrap_query beyond tolerance")

    control = model_columns(MODELS[0], factors)[0]
    for est in (None, f"fwl:{control}"):
        for scheme in ("expanding", "rolling120"):
            scan, scan_s = _timed(lambda: backtest_paths(banks["cuda"], scheme, estimator=est,
                                                         route="scan", device="cuda"))
            refit, refit_s = _timed(lambda: backtest_paths(banks["cuda"], scheme, estimator=est,
                                                           route="refit", device="cuda"))
            gap = _path_gap(scan, refit)
            log(f"scan vs refit on the card (f64, {scheme}, {est or 'ols'}): worst |d| / "
                f"max(|path|, 1) {gap:.3e} (tol {SCAN_REFIT_TOL:g}); scan {scan_s * 1e3:.2f} ms, "
                f"refit {refit_s:.3f} s ({banks['cuda'].n_months} origins)")
            check(gap <= SCAN_REFIT_TOL, f"scan vs refit ({scheme}, {est}) beyond the pin")


def bank_ingest_phase(res) -> None:
    """The bank's month ingest on the card at real size (float64 panel): a
    bank of months 0…T−2 grown by month T−1 (one K2 launch over one month,
    three calls timed) against a bank contracted on all T months, at the
    reference's pins: leaves at 1e-13 of ``max(|leaf|, 1)``,
    ``window_query`` coefficients at 1e-11 of ``max(|coef|, 1)`` on the
    pairs without a suspect month (the others logged)."""
    panel, masks, factors = res.panel, res.subset_masks, res.factors_dict
    t = len(panel.months)
    space = scenario_space(factors, list(masks), t)
    y, x = panel.var("retx"), panel.select(list(space.union_predictors))
    full = grambank.build_bank(y, x, masks, space, device="cuda")
    head = grambank.build_bank(y[:-1], x[:-1], {k: m[:-1] for k, m in masks.items()}, space,
                               device="cuda")
    last = {k: m[-1] for k, m in masks.items()}
    reset_counts()
    times = []
    for _ in range(3):
        grown, secs = _timed(lambda: grambank.ingest_month(head, y[-1], x[-1], last, t - 1,
                                                           device="cuda"))
        times.append(secs)
    by_key = dict(gram_contract_cuda.launches_by_key)
    worst = {}
    for leaf in ("gram", "moment", "n", "ysum", "yy", "center"):
        a, b = getattr(grown, leaf), getattr(full, leaf)
        worst[leaf] = float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))
    got, want = (grambank.window_query(grown, device="cuda"),
                 grambank.window_query(full, device="cuda"))
    check(np.array_equal(np.isnan(got.coef), np.isnan(want.coef))
          and np.array_equal(got.n_months, want.n_months)
          and np.array_equal(got.suspect_months, want.suspect_months),
          "ingest: window_query NaN pattern, month counts or suspect months differ")
    # the reference pins 1e-11 on unit-scale coefficients; the Lewellen
    # coefficients reach tens, so the pin is held at max(|coef|, 1). A pair
    # with a suspect month (an ill-conditioned solve the bank discloses and
    # no referee re-solves) amplifies the last-bit differences of the
    # leaves: its gap is logged, not held
    gap = np.abs(got.coef - want.coef) / np.maximum(np.abs(want.coef), 1.0)
    clean = want.suspect_months == 0
    q_gap = float(np.nanmax(gap[clean], initial=0.0))
    log(f"bank ingest of month {t - 1} ({int(last['All stocks'].sum())} 'All stocks' firms, "
        f"f64, {full.n_pairs} pairs) on the card: {', '.join(f'{s * 1e3:.2f}' for s in times)} "
        f"ms (three calls); K2 launches {gram_contract_cuda.launches} {by_key}; worst |grown - "
        f"full| / max(|full|, 1) per leaf " + json.dumps({k: float(f"{v:.3g}") for k, v in
                                                         worst.items()})
        + f" (tol 1e-13); window_query coef worst |d| / max(|coef|, 1) {q_gap:.3e} over the "
        f"{int(clean.sum())} pairs without a suspect month (tol 1e-11); pairs with suspect "
        f"months {want.suspect_months[~clean].tolist()}: "
        f"{[float(f'{v:.3g}') for v in np.nanmax(gap[~clean], axis=1, initial=0.0)]} (logged)")
    check(gram_contract_cuda.launches == 3, "ingest: not one K2 launch a call")
    check(clean.any(), "ingest: every pair has a suspect month; nothing to hold")
    check(max(worst.values()) <= 1e-13 and q_gap <= 1e-11, "bank ingest beyond the reference's pins")
    check(np.array_equal(grown.months, full.months), "ingest: month labels differ")


# --- the estimator family ---------------------------------------------------

# FWL partials a column of every Table 2 model out ("Log Size (-1)"); the
# absorb kind's fixed-effect codes are seeded as the JAX bench makes them
# (bench.py: default_rng(2016).integers(0, 12, (T, N))), the second factor
# of the two-way kind with 10 levels from the next seed.
EST_CONTROL = "log_size"
FE_SEEDS = {"ind": (2016, 12), "size": (2017, 10)}
# Launches of each real-size estimator run, the counters at 0 just before
# and read just after. The pipeline run: the main path's K1 17 and K2 2,
# the FWL sweep's 9 (universe, col_sel) pairs in one launch and the
# backtest bank's one. fwl/iv/pooled sweeps contract their 9 pairs at
# Table 2's shape; absorb contracts per spec (27: its FE cells are per
# spec), in one launch; the bank built alone launches once, its queries
# never.
EST_T2 = {"P=14,S=9,f32": 1}
EST_SPECS = {"P=14,S=27,f32": 1}
ESTIMATOR_LAUNCHES = {
    "pipeline": ({"k1": 17, "k2": 4, "moments": 0}, {"P=14,S=9,f32": 3, "P=5,S=3,f32": 1}),
    "iv": ({"k1": 0, "k2": 1, "moments": 0}, EST_T2),
    "absorb": ({"k1": 0, "k2": 1, "moments": 0}, EST_SPECS),
    "absorb2": ({"k1": 0, "k2": 1, "moments": 0}, EST_SPECS),
    "pooled": ({"k1": 0, "k2": 1, "moments": 0}, EST_T2),
    "fwl_cluster": ({"k1": 0, "k2": 1, "moments": 0}, EST_T2),
    "fwl_bf16": ({"k1": 0, "k2": 1, "moments": 0}, {"P=14,S=9,bf16": 1}),
    "absorb_coreset": ({"k1": 0, "k2": 1, "moments": 0}, {"P=14,S=27,f32,rw": 1}),
    "pooled_f64": ({"k1": 0, "k2": 1, "moments": 0}, {"P=14,S=9,f64": 1}),
    "bank": ({"k1": 0, "k2": 1, "moments": 0}, EST_T2),
    "bank_queries": ({"k1": 0, "k2": 0, "moments": 0}, {}),
}
EST_COLUMNS = ("estimator", "se_family", "suspect_months")
ABSORB_COLUMNS = EST_COLUMNS + ("absorb_iters", "absorb_converged")
STREAM_DRAWS = 1000


def fe_codes(t: int, n: int) -> dict:
    return {name: np.random.default_rng(seed).integers(0, levels, (t, n))
            for name, (seed, levels) in FE_SEEDS.items()}


def estimator_specs(factors) -> dict:
    """The estimator cells every estimator run uses, from Table 2's
    columns: FWL on ``EST_CONTROL``; IV of Model 1's B/M column on a Model 3
    column no other model carries (Models 1 and 2 are identified by it;
    in Model 3 it is a structural column too, so those cells are
    rank-deficient and disclose it, as in the reference); the bank's IV on
    Model 1's momentum column (a bank reads instruments out of every pair's
    columns, so the instrument must be banked in every pair)."""
    cols = [model_columns(m, factors) for m in MODELS]
    check(EST_CONTROL == cols[0][0], f"Table 2's first column is {cols[0][0]}")
    only3 = [c for c in cols[2] if c not in cols[1]]
    return {"fwl": f"fwl:{EST_CONTROL}", "iv": f"iv:{cols[0][1]}~{only3[-1]}",
            "bank_iv": f"iv:{cols[0][1]}~{cols[0][2]}"}


def _estimator_run(name: str, panel, masks, factors, spec: str, extra, **kw):
    """One real-size ``run_scenarios(estimators=(spec,))`` with the launch
    counters at 0 just before and read just after: its wall, peak device
    memory above what was resident, launches (pinned), frame checks."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_counts()
    (frame, stats), wall = _timed(lambda: run_scenarios(
        panel, masks, factors, estimators=(spec,), return_stats=True, **kw))
    counts = launch_counts()
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    sus = frame.groupby("cell")["suspect_months"].first()
    log(f"estimators {name} ({spec}{', ' + json.dumps(kw, default=str) if kw else ''}): "
        f"wall {wall:.3f} s, peak above the resident panel {peak:.3f} GiB; cells with a "
        f"suspect month {int((sus > 0).sum())} of {len(sus)} (months per cell max "
        f"{int(sus.max())}); contractions " + json.dumps(
            {k: stats[k] for k in ("specs_solved", "specs_contracted", "pairs_unique")}))
    check_scenario_frame(frame, f"estimators {name}", SPECGRID_CELLS, extra=extra)
    check(set(frame["estimator"]) == {parse_estimator(spec).label},
          f"estimators {name}: labels {set(frame['estimator'])}")
    _k2_pinned(f"estimators {name}", counts, ESTIMATOR_LAUNCHES[name])
    return frame, counts, wall, peak


def _add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _held_gap(got: pd.DataFrame, want: pd.DataFrame) -> dict:
    """Per model: (coef gap at max(|b|, se), se gap relative) of two frames
    of the same cells."""
    check(np.array_equal(np.isfinite(got["coef"].to_numpy(float)),
                         np.isfinite(want["coef"].to_numpy(float))),
          "f32 vs f64: NaN pattern differs")
    out = {}
    for model in want["model"].unique():
        rows = (want["model"] == model).to_numpy()
        b, bw = got["coef"].to_numpy(float)[rows], want["coef"].to_numpy(float)[rows]
        s, sw = got["nw_se"].to_numpy(float)[rows], want["nw_se"].to_numpy(float)[rows]
        fin = np.isfinite(bw) & np.isfinite(sw)
        coef = np.abs(b[fin] - bw[fin]) / np.maximum(np.fmax(np.abs(bw[fin]), sw[fin]), 1e-300)
        se = np.abs(s[fin] - sw[fin]) / np.maximum(np.abs(sw[fin]), 1e-300)
        out[model] = (float(coef.max()), float(se.max()))
    return out


def _pooled_conditions(panel, masks, factors, frame) -> tuple:
    """Each pooled cell's condition number: the equilibrated, month-summed,
    de-centered Gram of its (model, universe, window), from a float64 bank
    on the CPU. Returns ``(rows of cells whose condition times eps(f64)
    reaches a tenth of the 1e-8 pin, {cell key: condition})``. The pooled
    kind discloses rank loss only (``suspect_months``: the pooled Gram
    deficient at the cutoff), as the reference's does; its numbers move
    with the order of its sums by about condition × eps without a flag
    (Model 3's pooled Grams on the smoke panel: 2e7–1.3e8, the other
    models' ~1e4)."""
    from fm_returnprediction_tpu_torch.specgrid.estimators.cluster import decentered_stats
    from fm_returnprediction_tpu_torch.specgrid.scenarios import subperiod_windows
    from fm_returnprediction_tpu_torch.specgrid.solve import expand_window_stats

    bank = bank_for_scenarios(panel, masks, factors, fingerprint="pooled", device="cpu")
    stats = bank.stats("cpu")
    k, t = bank.n_pairs, bank.n_months
    sel = torch.as_tensor(np.concatenate([np.ones((k, 1), bool), bank.col_sel], axis=1))
    months = np.arange(t)
    cond = {}
    for name, win in subperiod_windows(t, 2).items():
        mask = np.ones(t, bool) if win is None else (months >= win[0]) & (months < win[1])
        masked = expand_window_stats(stats, torch.arange(k),
                                     torch.as_tensor(np.broadcast_to(mask, (k, t)).copy()))
        g = decentered_stats(masked, sel)[0].sum(1)                    # (K, Q, Q)
        g = torch.where(sel[:, :, None] & sel[:, None, :], g, torch.eye(g.shape[-1],
                                                                         dtype=g.dtype))
        d = torch.rsqrt(torch.diagonal(g, dim1=-2, dim2=-1).clamp_min(1e-300))
        w = torch.linalg.eigvalsh(g * d[:, :, None] * d[:, None, :])
        for j, (set_name, uni) in enumerate(bank.pair_labels):
            cond[(set_name, uni, name)] = float(w[j, -1] / w[j, 0])
    limit = 1e-9 / np.finfo(np.float64).eps
    ill = np.array([cond[key] > limit for key in zip(frame["model"], frame["universe"],
                                                     frame["window"])])
    return ill, cond


def estimators_phase(base, daily) -> dict:
    """The estimator family at real size (600 × 22,000, f32): through
    ``run_pipeline(specgrid_estimator="fwl:log_size", make_backtest=True)``
    (the sweep and the backtest under FWL), then on the resident panel
    ``run_scenarios`` under IV, one- and two-way absorbed FE, pooled
    two-way clustered SEs, FWL with the clustered FM tail, FWL in bf16 and
    absorb on the coreset route (row weights), and the pooled run again on
    a float64 copy of the panel (the f32 gap logged); the FE cell
    contraction twice (bit-identical); the Gram bank's estimator queries
    (K2 0 after the bank, absorb refused), ``scenario_query`` under FWL and
    a ``StreamingBootstrap`` of 1,000 draws over the bank's slopes, chunked
    and merged. Each run's launches are pinned (``ESTIMATOR_LAUNCHES``);
    returns their sum."""
    from fm_returnprediction_tpu_torch.specgrid.estimators import StreamingBootstrap
    from fm_returnprediction_tpu_torch.specgrid.estimators.absorb import contract_absorb_cells
    from fm_returnprediction_tpu_torch.specgrid.scenarios import subperiod_windows
    from fm_returnprediction_tpu_torch.specgrid.solve import contraction_counts

    total: dict = {}
    torch.cuda.reset_peak_memory_stats()
    spec_fwl = f"fwl:{EST_CONTROL}"
    res, wall, counts = counted_run(base, daily, make_specgrid=True, make_backtest=True,
                                    specgrid_estimator=spec_fwl)
    frame, bt = res.specgrid_scenarios, res.backtest_table
    log(f"estimators pipeline (guarded, f32, specgrid_estimator={spec_fwl!r}, backtest): wall "
        f"{wall:.3f} s, stages specgrid {res.stage_seconds['specgrid']:.4f} s, backtest "
        f"{res.stage_seconds['backtest']:.4f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.3f}"
        f" GiB; audit " + res.audit.report().replace("\n", "; "))
    check(not res.audit.violations and not res.audit.quarantined,
          "estimator pipeline run: contract violations or quarantined artifacts")
    check_scenario_frame(frame, "estimators pipeline (fwl)", SPECGRID_CELLS, extra=EST_COLUMNS)
    control_label = {c: lab for lab, c in res.factors_dict.items()}[EST_CONTROL]
    check(control_label not in set(frame["predictor"]),
          "the partialled control was reported as a predictor")
    check(bt is not None and len(bt) == BACKTEST_CELLS
          and set(bt["estimator"]) == {parse_estimator(spec_fwl).label},
          f"the backtest stage did not run under {spec_fwl}")
    check(bool(np.isfinite(bt[BACKTEST_METRICS].to_numpy(float)).all()),
          "estimator backtest: non-finite headline metrics")
    _k2_pinned("estimators pipeline", counts, ESTIMATOR_LAUNCHES["pipeline"])
    _add_counts(total, counts)
    panel, masks, factors = res.panel, res.subset_masks, res.factors_dict
    specs = estimator_specs(factors)
    t, n = panel.values.shape[:2]
    fe = fe_codes(t, n)
    del res, frame, bt

    runs = (("iv", specs["iv"], EST_COLUMNS, {}),
            ("absorb", "absorb:ind", ABSORB_COLUMNS, dict(fe_codes=fe)),
            ("absorb2", "absorb:ind+size", ABSORB_COLUMNS, dict(fe_codes=fe)),
            ("pooled", "pooled:cluster_twoway", EST_COLUMNS, {}),
            ("fwl_cluster", f"{spec_fwl}@cluster", EST_COLUMNS, {}),
            ("fwl_bf16", spec_fwl, EST_COLUMNS + ("precision", "bf16_promoted_months"),
             dict(precision="bf16")),
            ("absorb_coreset", "absorb:ind", ABSORB_COLUMNS + ("route", "coreset_m",
                                                               "coreset_rate"),
             dict(fe_codes=fe, route="coreset")))
    frames = {}
    for name, spec, extra, kw in runs:
        frames[name], counts, _, _ = _estimator_run(name, panel, masks, factors, spec, extra, **kw)
        _add_counts(total, counts)
        if name.startswith("absorb"):
            per_cell = frames[name].groupby("cell")[["absorb_iters", "absorb_converged"]].first()
            log(f"estimators {name}: absorb_iters min {int(per_cell['absorb_iters'].min())} max "
                f"{int(per_cell['absorb_iters'].max())}, cells converged "
                f"{int(per_cell['absorb_converged'].sum())} of {len(per_cell)} (tol 1e-10 at "
                "the stats' float32)")
            if name != "absorb2":
                check(bool(per_cell["absorb_converged"].all())
                      and int(per_cell["absorb_iters"].max()) == 1,
                      f"{name}: one-way absorption is one exact sweep")

    panel64 = dataclasses.replace(panel, values=panel.values.double())
    wide, counts, _, _ = _estimator_run("pooled_f64", panel64, masks, factors,
                                        "pooled:cluster_twoway", EST_COLUMNS)
    _add_counts(total, counts)
    del panel64
    gaps = _held_gap(frames["pooled"], wide)
    f32_def = frames["pooled"].groupby("model")["suspect_months"].max().to_dict()
    log("pooled:cluster_twoway float32 vs the same run at float64 (real size), per model "
        "(coef worst |d| / max(|b|, se), se worst relative; cells deficient in f32): "
        + "; ".join(f"{m}: {c:.3e}, {e:.3e}, {f32_def[m]}" for m, (c, e) in gaps.items())
        + " (logged: the f32 month sum of de-centered raw-basis Grams, solved in f32)")

    bank_labels = {}
    reset_counts()
    bank, bank_s = _timed(lambda: bank_for_scenarios(panel, masks, factors,
                                                     fingerprint="estimators", device="cuda"))
    _k2_pinned("estimators bank", launch_counts(), ESTIMATOR_LAUNCHES["bank"])
    _add_counts(total, launch_counts())
    reset_counts()
    before = contraction_counts()
    served = {}
    for spec in ("ols@iid", spec_fwl, specs["bank_iv"], "pooled:cluster_month"):
        (served[spec], bank_labels[spec]), q_s = _timed(
            lambda: grambank.estimator_query(bank, spec, device="cuda"))
        res_q = served[spec]
        sel = bank_labels[spec]["col_sel"]
        finite = np.isfinite(res_q.coef[sel]).mean()
        log(f"estimator_query({spec!r}) over the bank's {bank.n_pairs} pairs: {q_s * 1e3:.2f} ms, "
            f"finite coef share {finite:.3f}, suspect months per pair "
            f"{res_q.suspect_months.tolist()}")
        check(finite >= 0.9, f"estimator_query {spec}: non-finite coefficients")
    try:
        grambank.estimator_query(bank, "absorb:ind", device="cuda")
        check(False, "the bank served an absorb cell")
    except ValueError as exc:
        log(f"estimator_query('absorb:ind') raised ValueError as the reference does: {exc}")
    swept, sweep_s = _timed(lambda: grambank.scenario_query(
        bank, windows=subperiod_windows(bank.n_months, 2), estimator=spec_fwl, device="cuda"))
    check(set(swept["estimator"]) == {parse_estimator(spec_fwl).label}
          and np.isfinite(swept["coef"].to_numpy(float)).mean() >= 0.9,
          "scenario_query under FWL: labels or coefficients")
    fwl_q = served[spec_fwl]
    series = (fwl_q.slopes.astype(np.float64), fwl_q.r2, fwl_q.n_obs, fwl_q.month_valid)
    chunked, stream_s = _timed(lambda: StreamingBootstrap(*series, chunk=256, device="cuda")
                               .extend(STREAM_DRAWS))
    half = StreamingBootstrap(*series, chunk=STREAM_DRAWS, device="cuda").extend(STREAM_DRAWS // 2)
    rest = StreamingBootstrap(*series, chunk=STREAM_DRAWS, device="cuda")
    rest.draws_done = STREAM_DRAWS // 2
    merged = half.merge(rest.extend(STREAM_DRAWS))
    gaps = [float(np.nanmax(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
            for a, b in ((chunked.mean, merged.mean), (chunked.m2, merged.m2))]
    queries = launch_counts()
    log(f"bank_for_scenarios {bank_s:.4f} s (K2 once); scenario_query under FWL (2 halves + "
        f"full) {sweep_s:.4f} s, {len(swept)} rows; StreamingBootstrap {STREAM_DRAWS} draws over "
        f"{bank.n_pairs} pairs in chunks of 256 {stream_s:.3f} s, vs two merged halves: mean "
        f"{gaps[0]:.3e}, M2 {gaps[1]:.3e} (tol 1e-10), draws {chunked.draws_done}; "
        f"contractions during the queries "
        f"{ {k: v - before.get(k, 0) for k, v in contraction_counts().items()} }")
    check(max(gaps) <= 1e-10 and np.array_equal(chunked.count, merged.count),
          "StreamingBootstrap: chunked and merged passes differ")
    check(contraction_counts() == before, "the bank's estimator queries contracted the panel")
    _k2_pinned("estimators bank queries", queries, ESTIMATOR_LAUNCHES["bank_queries"])

    # the FE cells twice on the card: the ordered segment sums give the same bits
    y, x = panel.var("retx").contiguous(), panel.select(list(bank.union)).contiguous()
    universes = torch.stack([masks[u] for u in bank.universes])
    k = bank.n_pairs
    args = (y, x, universes, torch.as_tensor(bank.uidx, device="cuda"),
            torch.as_tensor(bank.col_sel, device="cuda"),
            torch.ones((k, t), dtype=torch.bool, device="cuda"), shared_center(x),
            torch.as_tensor(fe["ind"], device="cuda"), torch.as_tensor(fe["size"], device="cuda"))
    kw = dict(ga=FE_SEEDS["ind"][1], gb=FE_SEEDS["size"][1])
    first, cells_s = _timed(lambda: contract_absorb_cells(*args, **kw))
    second = contract_absorb_cells(*args, **kw)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"contract_absorb_cells at real size ({k} specs, 12 x 10 FE cells a month): "
        f"{cells_s:.4f} s; two calls bit-identical {same}")
    check(same, "the FE cell contraction is not bit-identical run to run")
    del first, second, args, y, x, universes, bank, panel, masks
    torch.cuda.empty_cache()
    return total


def _spied_sweep(panel, masks, factors, spec: str, kw: dict, chunk=None) -> tuple:
    """``run_scenarios(estimators=(spec,))`` with each estimator grid's
    transformed stats and per-month solve recorded as the solve receives
    and returns them (``firm_chunk`` width ``chunk`` on the plain
    contraction when given). Returns ``(frame, {(model, universe, window):
    record})``, a record holding the spec's per-month equilibrated
    condition (the selected block of the transformed Gram, diagonal scaled
    to 1, as ``solve.solve_spec_stats`` scales it) and that equilibrated
    block, its per-month slopes, validity and row counts, and its
    coefficients and NW SEs."""
    import contextlib
    from unittest import mock

    from fm_returnprediction_tpu_torch.specgrid import engine as engine_mod
    from fm_returnprediction_tpu_torch.specgrid import grams
    from fm_returnprediction_tpu_torch.specgrid.estimators import grid as grid_mod
    from fm_returnprediction_tpu_torch.specgrid.scenarios import subperiod_windows

    model_of = {tuple(model_columns(m, factors)): m.name for m in MODELS}
    window_of = {w: name for name, w in subperiod_windows(len(panel.months), 2).items()}
    records = {}
    grid_fn, solve_fn = grid_mod.run_estimator_grid_weights, grid_mod.solve_spec_stats

    def grid_spy(estimator, y, x, universe_masks, grid, weights, **kw2):
        seen = {}

        def solve_spy(stats, sel_aug, **kw3):
            sol, counters = solve_fn(stats, sel_aug, **kw3)
            seen.update(stats=stats, sel=sel_aug, sol=sol)
            return sol, counters

        with mock.patch.object(grid_mod, "solve_spec_stats", solve_spy):
            results, disc = grid_fn(estimator, y, x, universe_masks, grid, weights, **kw2)
        stats, sel, sol = (seen[k] for k in ("stats", "sel", "sol"))
        q = stats.gram.shape[-1]
        gram = stats.gram.detach().cpu().double()
        pick = (sel[:, None, :, None] & sel[:, None, None, :]).cpu()
        g = torch.where(pick, gram, torch.eye(q, dtype=torch.float64))
        d = torch.rsqrt(torch.diagonal(g, dim1=-2, dim2=-1).clamp_min(1e-300))
        gs = g * d[..., :, None] * d[..., None, :]
        w = torch.linalg.eigvalsh(gs)
        cond = (w[..., -1] / w[..., 0]).numpy()
        res = results[weights[0]]
        for i, sp in enumerate(grid.specs):
            key = (model_of[tuple(sp.predictors)], sp.universe, window_of[sp.window])
            records.setdefault(key, dict(
                cond=cond[i], gram=gs[i].numpy(), beta=sol.beta[i].detach().cpu().numpy(),
                valid=sol.month_valid[i].detach().cpu().numpy(),
                n=stats.n[i].detach().cpu().double().numpy(), coef=res.coef[i],
                nw_se=res.nw_se[i]))
        return results, disc

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(engine_mod, "run_estimator_grid_weights", grid_spy))
        if chunk:
            stack.enter_context(mock.patch.object(grams, "auto_firm_chunk",
                                                  lambda *a, **k: chunk))
        frame = run_scenarios(panel, masks, factors, estimators=(spec,), **kw)
    return frame, records


def _condition_pin(rec: dict) -> float:
    """The held limit of one cell derived from its own months: to first
    order a month's slopes move by ``κ · ‖ΔG‖/‖G‖`` of ``|β|`` when its
    equilibrated Gram moves by ``ΔG``, and two sum orders of ``n`` rows
    leave ``‖ΔG‖/‖G‖`` at about ``√n · eps``; the coefficient is the mean
    of the month slopes, held at ``max(|b|, nw_se)`` (its t-stat at
    ``max(|t|, 1)``, the same bound over the SE). So the cell's limit is
    ``Σ_m κ_m · √n_m · eps · max_p |β_mp| / max(|b_p|, se_p) / M``, and
    never below the 1e-8 pin."""
    eps = np.finfo(np.float64).eps
    v = rec["valid"]
    if not v.any():
        return 1e-8
    scale = np.fmax(np.abs(rec["coef"]), rec["nw_se"])
    usable = np.isfinite(scale) & (scale > 0)
    ratio = np.abs(rec["beta"][v, 1:]) / np.where(usable, scale, 1.0) * usable
    per_month = rec["cond"][v] * np.sqrt(np.maximum(rec["n"][v], 1.0)) * eps * ratio.max(axis=1)
    return max(1e-8, float(per_month.sum() / v.sum()))


def _cell_gaps(got: pd.DataFrame, want: pd.DataFrame, keep: np.ndarray) -> dict:
    """(model, universe, window) → the held gap of the cell's rows
    (``_scenario_worst``), over the rows ``keep`` selects."""
    out = {}
    for cell in want.loc[keep, "cell"].unique():
        rows = keep & (want["cell"] == cell).to_numpy()
        first = want.loc[rows].iloc[0]
        out[(first["model"], first["universe"], first["window"])] = _scenario_worst(
            _rows(got, rows), _rows(want, rows))
    return out


def _month_reading(card: dict, cpu: dict, chunked: dict, key, gap, chunk_gap) -> str:
    """The months that carry one cell's gap: each month's share of the
    coefficient gap (its slope gap over ``max(|b|, nw_se)`` and the month
    count) on the card and under ``SUSPECT_CHUNK``-firm chunks, its
    condition, and the card's equilibrated transformed Gram against the
    CPU's in eps."""
    v = cpu["valid"]
    months = int(v.sum())
    scale = np.fmax(np.abs(cpu["coef"]), cpu["nw_se"])

    def share(other):
        d = np.abs(other["beta"][:, 1:] - cpu["beta"][:, 1:]) / scale
        return np.where(v, np.nanmax(np.where(np.isfinite(d), d, 0.0), axis=1) / months, -1.0)

    card_share, chunk_share = share(card), share(chunked)
    gram_gap = np.abs(card["gram"] - cpu["gram"]).max(axis=(-1, -2)) / np.finfo(np.float64).eps
    top = np.argsort(card_share)[::-1][:6]
    worst = float(np.where(v, cpu["cond"], 0.0).max())
    return (f"{' | '.join(key)}: card vs CPU {gap:.3e}, CPU {SUSPECT_CHUNK}-firm chunks vs CPU "
            f"{chunk_gap:.3e}, {months} months, worst month condition {worst:.3e} (cond x eps "
            f"{worst * np.finfo(np.float64).eps:.3e}; the suspect tier flags past "
            f"{1 / np.sqrt(np.finfo(np.float64).eps):.3e}), rows at most "
            f"{int(cpu['n'][v].max())}; the months that carry the gap (month: card share, CPU "
            "chunks share, condition, card's equilibrated Gram vs the CPU's in eps): "
            + ", ".join(f"{m}: {card_share[m]:.2e}, {chunk_share[m]:.2e}, {cpu['cond'][m]:.2e}, "
                        f"{gram_gap[m]:.1f}" for m in top))


def _estimators_vs_cpu(gpu, absorb_reading: bool = False) -> None:
    """Each estimator kind at float64 on the card against the CPU, both
    from the card run's panel (copied to the host; one FE code draw): FWL,
    IV, one- and two-way absorb, pooled two-way, FWL with the clustered
    tail, absorb on the coreset route. Labels, flags and the integer
    disclosures (``suspect_months``, ``absorb_iters``, ``absorb_converged``)
    exactly; the numbers of each cell without a suspect month at 1e-8
    (``_scenario_worst``'s scales), or at the bound its own months'
    conditions give where that is larger (``_condition_pin``, from the
    CPU run's recorded solve; with ``absorb_reading`` the absorb kind's
    worst such cell printed month by month, ``_month_reading``), and at
    ``SUSPECT_TOL`` on the
    others, that limit placed for the FWL, IV and two-way absorb sweeps
    between two CPU witnesses: the same sweep under ``SUSPECT_CHUNK``-firm
    chunks (another order of the sums) and with a planted fault (the
    regressand moved one month later, a misaligned return). The pooled
    kind flags rank loss only, so its cells whose pooled Gram's condition
    times eps reaches a tenth of the 1e-8 pin (``_pooled_conditions``) are
    held as suspect cells, between the same two witnesses."""
    from unittest import mock

    from fm_returnprediction_tpu_torch.specgrid import grams

    host_panel = dataclasses.replace(gpu.panel, values=gpu.panel.values.cpu())
    host_masks = {k: m.cpu() for k, m in gpu.subset_masks.items()}
    factors = gpu.factors_dict
    specs = estimator_specs(factors)
    t, n = host_panel.values.shape[:2]
    fe = fe_codes(t, n)
    faulty = host_panel.values.clone()
    i = host_panel.var_index("retx")
    faulty[1:, :, i] = host_panel.values[:-1, :, i]
    faulty[0, :, i] = float("nan")
    fault_panel = dataclasses.replace(host_panel, values=faulty)
    cases = (("fwl", specs["fwl"], {}, True), ("iv", specs["iv"], {}, True),
             ("absorb", "absorb:ind", dict(fe_codes=fe), False),
             ("absorb2", "absorb:ind+size", dict(fe_codes=fe), True),
             ("pooled", "pooled:cluster_twoway", {}, True),
             ("fwl_cluster", f"{specs['fwl']}@cluster", {}, False),
             ("absorb_coreset", "absorb:ind", dict(fe_codes=fe, route="coreset"), False))
    for name, spec, kw, witness in cases:
        pooled = spec.startswith("pooled")
        start = time.perf_counter()
        reading = absorb_reading and name == "absorb"
        if reading:
            got, card_rec = _spied_sweep(gpu.panel, gpu.subset_masks, factors, spec, kw)
        else:
            got = run_scenarios(gpu.panel, gpu.subset_masks, factors, estimators=(spec,), **kw)
        mid = time.perf_counter()
        if pooled:
            want = run_scenarios(host_panel, host_masks, factors, estimators=(spec,), **kw)
        else:
            want, cpu_rec = _spied_sweep(host_panel, host_masks, factors, spec, kw)
        cpu_s = time.perf_counter() - mid
        suspect = (want["suspect_months"] > 0).to_numpy()
        # the held limit of each cell without a suspect month: 1e-8, or the
        # bound its own months' conditions give (_condition_pin)
        pins = ({} if pooled else
                {key: _condition_pin(rec) for key, rec in cpu_rec.items()})
        extra_note = ""
        if pooled:
            ill, cond = _pooled_conditions(host_panel, host_masks, factors, want)
            suspect = suspect | ill
            worst_cond = {m: max(c for key, c in cond.items() if key[0] == m)
                          for m in want["model"].unique()}
            extra_note = ("; pooled Grams with condition × eps ≥ 1e-9 (held as suspect cells): "
                          f"{want.loc[ill, 'cell'].nunique()} cells, worst condition per "
                          "model " + json.dumps({m: f"{c:.2e}" for m, c in worst_cond.items()}))
        gaps = _cell_gaps(got, want, ~suspect)
        held = max(gaps.values(), default=0.0)
        over = {" | ".join(k): g for k, g in gaps.items() if g > pins.get(k, 1e-8)}
        worst_sus = (_scenario_worst(_rows(got, suspect), _rows(want, suspect))
                     if suspect.any() else 0.0)
        derived = {" | ".join(k): [float(f"{pins[k]:.3e}"), float(f"{gaps[k]:.3e}")]
                   for k in gaps if pins.get(k, 1e-8) > 1e-8}
        text = (f"card vs CPU estimators {name} ({spec}, f64, 240 x {CVC_FIRMS:,}): cuda "
                f"{mid - start:.2f} s, cpu {cpu_s:.2f} s; worst diff {held:.3e} over "
                f"{int((~suspect).sum())} rows of {want.loc[~suspect, 'cell'].nunique()} cells "
                f"without a suspect month (tol 1e-8, or the cell's condition bound: cells "
                f"whose bound passes 1e-8, [bound, gap]: {json.dumps(derived)}), "
                f"{worst_sus:.3e} over {int(suspect.sum())} rows of "
                f"{want.loc[suspect, 'cell'].nunique()} cells with one (tol {SUSPECT_TOL:g}); "
                f"labels and integer disclosures equal{extra_note}")
        if "absorb_iters" in want:
            text += (f"; absorb_iters max {int(want['absorb_iters'].max())}, cells converged "
                     f"{int(want.groupby('cell')['absorb_converged'].first().sum())} of "
                     f"{want['cell'].nunique()}")
        log(text)
        if reading and gaps:
            chunked, chunk_rec = _spied_sweep(host_panel, host_masks, factors, spec, kw,
                                              chunk=SUSPECT_CHUNK)
            chunk_gaps = _cell_gaps(chunked, want, ~suspect)
            key = max(gaps, key=gaps.get)
            log("card vs CPU estimators absorb, the worst cell without a suspect month: "
                + _month_reading(card_rec[key], cpu_rec[key], chunk_rec[key], key, gaps[key],
                                 chunk_gaps[key]))
        check(not over and worst_sus <= SUSPECT_TOL,
              f"card vs CPU: estimator sweep {name} beyond tolerance: {over}")
        if witness and suspect.any():
            with mock.patch.object(grams, "auto_firm_chunk", lambda *a, **k: SUSPECT_CHUNK):
                reordered = run_scenarios(host_panel, host_masks, factors, estimators=(spec,),
                                          **kw)
            fault = run_scenarios(fault_panel, host_masks, factors, estimators=(spec,), **kw)
            order_gaps = _cell_gaps(reordered, want, ~suspect)
            wit = {"order_suspect": _scenario_worst(_rows(reordered, suspect),
                                                    _rows(want, suspect)),
                   "order_held": max(order_gaps.values(), default=0.0),
                   "order_over": {" | ".join(k): g for k, g in order_gaps.items()
                                  if g > pins.get(k, 1e-8)},
                   "fault_suspect": _scenario_worst(_rows(fault, suspect), _rows(want, suspect),
                                                    strict=False),
                   "fault_held": _scenario_worst(_rows(fault, ~suspect), _rows(want, ~suspect),
                                                 strict=False)}
            log(f"card vs CPU estimators {name}: CPU with {SUSPECT_CHUNK}-firm chunks vs CPU: "
                f"suspect rows {wit['order_suspect']:.3e}, other rows {wit['order_held']:.3e}; "
                f"planted fault (the return one month late) vs CPU: suspect rows "
                f"{wit['fault_suspect']:.3e}, other rows {wit['fault_held']:.3e}")
            check(wit["order_suspect"] <= SUSPECT_TOL < wit["fault_suspect"]
                  and not wit["order_over"] and 1e-8 < wit["fault_held"],
                  f"estimators {name}: the suspect-cell limit {SUSPECT_TOL:g} does not sit "
                  f"between the CPU's sum-order spread and a planted fault: {wit}")


def estimator_cli_phase() -> None:
    """``python -m fm_returnprediction_tpu_torch.pipeline --synthetic
    --specgrid --specgrid-estimator iv:…`` at 60 × 130 on the card: exit 0
    with the ``specgrid`` stage and one K2 launch more than the main path
    (the sweep's pairs); then ``--specgrid-estimator absorb:ind``, which
    exits non-zero as the reference does (the pipeline has no FE codes: the
    engine's KeyError)."""
    firms, months = SYNTHETIC_CLI_FIRMS, SYNTHETIC_CLI_MONTHS
    spec = "iv:log_bm~log_issues_36"
    base_args = ["--synthetic", "--firms", firms, "--months", months, "--specgrid",
                 "--specgrid-estimator"]
    run = run_cli(base_args + [spec])
    printed = re.search(r"^spec-grid scenarios: (\d+) rows$", run["stdout"], re.MULTILINE)
    log(f"CLI --synthetic --firms {firms} --months {months} --specgrid --specgrid-estimator "
        f"{spec}: exit 0 in {run['wall']:.1f} s; stage specgrid "
        f"{run['stages'].get('specgrid', float('nan')):.3f} s; "
        f"{printed.group(0) if printed else 'no row count printed'}; launches K1 "
        f"{run['launches']['k1']}, K2 {run['launches']['k2']} {run['launches']['k2_by_key']}")
    check("specgrid" in run["stages"] and printed is not None and run["launches"]["k2"] == 3,
          f"estimator CLI stages {sorted(run['stages'])}, launches {run['launches']}")
    start = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", "fm_returnprediction_tpu_torch.pipeline"]
                          + [str(a) for a in base_args + ["absorb:ind"]],
                          cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                          timeout=600)
    tail = done.stderr.strip().splitlines()[-1] if done.stderr.strip() else ""
    log(f"CLI --specgrid-estimator absorb:ind: exit {done.returncode} in "
        f"{time.perf_counter() - start:.1f} s: {tail}")
    check(done.returncode != 0 and "KeyError" in done.stderr,
          "the absorb CLI run did not fail with the engine's KeyError")


# Run as the command line would be, then read the launch counters of that
# process (the command line itself does not print them).
CLI_WRAPPER = """
import json, runpy, sys
from fm_returnprediction_tpu_torch.ops.rolling import (
    masked_cumulative_moments_cuda, rolling_reduce_cuda)
from fm_returnprediction_tpu_torch.specgrid.grams import gram_contract_cuda
sys.argv = ["fm_returnprediction_tpu_torch.pipeline"] + sys.argv[1:]
runpy.run_module("fm_returnprediction_tpu_torch.pipeline", run_name="__main__", alter_sys=True)
print("CLI-LAUNCHES " + json.dumps({"k1": rolling_reduce_cuda.launches,
                                    "k2": gram_contract_cuda.launches,
                                    "moments": masked_cumulative_moments_cuda.launches,
                                    "k1_by_key": rolling_reduce_cuda.launches_by_key,
                                    "k2_by_key": gram_contract_cuda.launches_by_key}))
"""

ARTIFACTS = ("data_saved.marker", "table_1.pkl", "table_1.tex", "table_2.pkl", "table_2.tex",
             "decile_sorts.pkl", "decile_sorts.tex", "serving_state.npz", "figure_1.pdf",
             "research_report.tex")


# The raw-directory command line's synthetic universe: 200 firms over 240
# months, written once and read by three runs; the --synthetic command line
# runs at 60 x 130 (see PERF.md, Cells). Both were cut (from 1000, then
# 400, and from 250, then 150, firms, and from 600 for the process phases)
# to pay for later phases: their generation is linear in firms.
CLI_FIRMS, CLI_MONTHS = 200, 240
SYNTHETIC_CLI_FIRMS, SYNTHETIC_CLI_MONTHS = 60, 130
# Launches of each raw-directory command-line run at CLI_FIRMS x CLI_MONTHS:
# K1 std over the daily strips, sum w=12 and w=24, the figure's mean roll and
# four forecast means; K2 for Table 2 and the figure grid (PERF.md, Findings).
RAW_CLI_LAUNCHES = {"k1": 8, "k2": 2, "moments": 0}
STAGE_LINE = re.compile(r"^(\S+)\s+([0-9.]+)s$", re.MULTILINE)
SKIPPED_LINE = re.compile(r"^(\S+)\s+skipped \((.*)\)$", re.MULTILINE)


def run_cli(args, env=None) -> dict:
    """The command line in a subprocess on the card: its wall time, stage
    seconds, skipped stages (with reasons), launches and stderr."""
    torch.cuda.empty_cache()
    start = time.perf_counter()
    done = subprocess.run([sys.executable, "-c", CLI_WRAPPER] + [str(a) for a in args],
                          cwd=Path(__file__).resolve().parent, capture_output=True,
                          text=True, timeout=600, env={**os.environ, **(env or {})})
    wall = time.perf_counter() - start
    check(done.returncode == 0, f"CLI {args} exited {done.returncode}: {done.stderr[-2000:]}")
    return dict(
        wall=wall, stdout=done.stdout, stderr=done.stderr,
        stages={m.group(1): float(m.group(2)) for m in STAGE_LINE.finditer(done.stdout)},
        skipped={m.group(1): m.group(2) for m in SKIPPED_LINE.finditer(done.stdout)},
        launches=json.loads(done.stdout.split("CLI-LAUNCHES ", 1)[1].splitlines()[0]))


def cli_phase() -> None:
    """``python -m fm_returnprediction_tpu_torch.pipeline --synthetic`` on
    the card, with artifacts and the drift sentinel."""
    firms, months = SYNTHETIC_CLI_FIRMS, SYNTHETIC_CLI_MONTHS
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("pyarrow", "matplotlib", "jinja2")}
    missing = [m for m in ("matplotlib", "jinja2") if not have[m]]
    log(f"artifact libraries here: {have}")
    with tempfile.TemporaryDirectory() as tmp:
        out, audit = Path(tmp) / "out", Path(tmp) / "audit"
        args = ["--synthetic", "--firms", firms, "--months", months, "--audit-dir", audit]
        if missing:
            log(f"CLI phase runs without --output-dir: {missing} do not import here")
        else:
            args += ["--output-dir", out]
        run = run_cli(args)
        stages, launches = run["stages"], run["launches"]
        made = sorted(os.listdir(out)) if out.exists() else []
        log(f"CLI --synthetic --firms {firms} --months {months}: exit 0 in {run['wall']:.1f} s, "
            f"generation {stages.get('load_raw_data', float('nan')):.2f} s; stages (s) "
            f"{json.dumps(stages)}; launches {launches}; artifacts {made}; audit "
            f"{sorted(os.listdir(audit))}")
        check((audit / "audit.json").exists(), "CLI wrote no audit.json")
        check(launches["k1"] > 0 and launches["k2"] == 2 and launches["moments"] == 0,
              f"CLI launches {launches}")
        check({"load_raw_data", "build_panel", "guard_panel_contracts", "table_2",
               "serving_state", "guard_drift"} <= set(stages), f"CLI stages {sorted(stages)}")
        if not missing:
            check(set(ARTIFACTS) <= set(made), f"CLI artifacts missing: "
                  f"{sorted(set(ARTIFACTS) - set(made))}")


def raw_cli_phase(raw: Path) -> None:
    """``python -m fm_returnprediction_tpu_torch.pipeline --raw-data-dir``
    three times on one raw directory: cold (the columnar route writes the
    prepared slot), warm (the slot is mapped), and by the legacy route with
    the slot off. Each run's drift manifest carries the sha256 of its Table
    1, Table 2, decile table and serving state: they are equal across the
    three."""
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, env in (("cold", {}), ("warm", {}),
                          ("legacy", {"FMRP_PANEL_ROUTE": "legacy", "PREPARED_CACHE": "0"})):
            audit = Path(tmp) / name
            run = run_cli(["--raw-data-dir", raw, "--audit-dir", audit], env)
            manifest = json.loads((audit / "audit.json").read_text())["artifacts"]
            run["sha256"] = {k: manifest[k]["sha256"] for k in
                             ("table_1", "table_2", "decile_table", "serving_state")}
            runs[name] = run
            log(f"CLI --raw-data-dir ({name}{', ' + str(env) if env else ''}): exit 0 in "
                f"{run['wall']:.1f} s; stages (s) {json.dumps(run['stages'])}; skipped "
                f"{run['skipped']}; launches {run['launches']}; sha256 {run['sha256']}")
    cold, warm, legacy = runs["cold"], runs["warm"], runs["legacy"]
    check({"panel/monthly_ingest", "factors/daily_ingest", "build_panel/save_prepared"}
          <= set(cold["stages"]), f"cold CLI run: the columnar route did not run: {cold['stages']}")
    check("falling back to the legacy" not in cold["stderr"],
          "cold CLI run: the columnar route fell back to the legacy route")
    check("load_prepared" in warm["stages"]
          and not {"load_raw_data", "factors/daily_ingest", "panel/monthly_ingest"}
          & set(warm["stages"])
          and warm["skipped"].get("load_raw_data") == "prepared checkpoint hit",
          f"warm CLI run did not map the slot: {warm['stages']} {warm['skipped']}")
    check({"load_raw_data", "panel/universe_filter", "factors/long_to_dense"}
          <= set(legacy["stages"]) and "load_prepared" not in legacy["stages"],
          f"legacy CLI run: {legacy['stages']}")
    check(cold["sha256"] == warm["sha256"] == legacy["sha256"],
          "the three raw-directory CLI runs differ in their artifacts' sha256")
    for name, run in runs.items():
        got = {k: run["launches"][k] for k in RAW_CLI_LAUNCHES}
        check(got == RAW_CLI_LAUNCHES, f"{name} CLI run launched {got}, not {RAW_CLI_LAUNCHES}")
    check(cold["launches"] == warm["launches"] == legacy["launches"],
          "the three raw-directory CLI runs launched differently by shape")
    log(f"host ingest at {CLI_FIRMS} x {CLI_MONTHS} in these single runs: columnar (cold) "
        f"{host_ingest_seconds(cold['stages']):.3f} s, legacy "
        f"{host_ingest_seconds(legacy['stages']):.3f} s")


# The stages that read the raw files, up to the panel's host arrays.
INGEST_STAGES = ("load_raw_data", "factors/daily_ingest", "factors/long_to_dense")
INGEST_PAIRS = 3


def host_ingest_seconds(stages: dict) -> float:
    return sum(v for k, v in stages.items() if k.startswith("panel/") or k in INGEST_STAGES)


def specgrid_cli_phase(raw: Path) -> None:
    """``python -m fm_returnprediction_tpu_torch.pipeline --raw-data-dir …
    --specgrid --specgrid-cells 200`` on the raw directory whose slot the
    cold run wrote: exit 0, the slot mapped, the sweep grown to 216 cells by
    8 bootstrap draws, and ``specgrid_scenarios.csv`` written. The command
    line draws Figure 1 into any ``--output-dir`` and, like the reference,
    raises where matplotlib does not import; there it runs without one and
    the csv comes from ``run_pipeline(make_figure=False, output_dir=…)`` on
    the same slot, its row count equal to the one the command line printed."""
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "out"
        args = ["--raw-data-dir", raw, "--specgrid", "--specgrid-cells", 200]
        run = run_cli(args + (["--output-dir", out] if have_mpl else []))
        printed = re.search(r"^spec-grid scenarios: (\d+) rows$", run["stdout"], re.MULTILINE)
        log(f"CLI --raw-data-dir --specgrid --specgrid-cells 200"
            f"{' --output-dir' if have_mpl else ''}: exit 0 in {run['wall']:.1f} s; stages (s) "
            f"{json.dumps(run['stages'])}; launches {run['launches']}; "
            f"{printed.group(0) if printed else 'no row count printed'}")
        check("load_prepared" in run["stages"] and "specgrid" in run["stages"],
              f"specgrid CLI stages {sorted(run['stages'])}")
        check(printed is not None, "the specgrid CLI printed no scenario row count")
        if not have_mpl:
            res = run_pipeline(raw_data_dir=raw, device="cuda", make_figure=False,
                               make_specgrid=True, specgrid_cells=200, output_dir=out)
            check(res.timer.skipped.get("load_raw_data") == "prepared checkpoint hit",
                  "the csv run did not map the slot")
            del res
        made = sorted(os.listdir(out))
        log(f"specgrid_scenarios.csv written by "
            f"{'the command line' if have_mpl else 'run_pipeline(make_figure=False)'}; "
            f"artifacts {made}")
        check("specgrid_scenarios.csv" in made, "no specgrid_scenarios.csv was written")
        frame = pd.read_csv(out / "specgrid_scenarios.csv")
        check(frame["cell"].nunique() == 216 and frame["draw"].max() == 7
              and len(frame) == int(printed.group(1)),
              f"specgrid csv: {frame['cell'].nunique()} cells, {len(frame)} rows")
        launches = run["launches"]
        check((launches["k1"], launches["k2"], launches["moments"]) == (8, 3, 0)
              and launches["k2_by_key"] == {"P=14,S=9,f32": 2, "P=5,S=3,f32": 1},
              f"specgrid CLI launches {launches}")


def ingest_pairs_phase(raw: Path) -> None:
    """The host ingest of the raw directory by the columnar and the legacy
    route, in process with the prepared slot off: INGEST_PAIRS pairs in
    alternating order (the host's speed drifts within a call, so single
    runs do not compare the routes). Logs each route's median, the spread
    between its quartiles and the pairs the columnar route won."""
    times = {"columnar": [], "legacy": []}
    won = 0
    with _env(FMRP_PANEL_ROUTE=None, PREPARED_CACHE=0):
        for i in range(INGEST_PAIRS):
            pair = {}
            for route in (("columnar", "legacy") if i % 2 == 0 else ("legacy", "columnar")):
                os.environ["FMRP_PANEL_ROUTE"] = route
                timer = StageTimer("cuda")
                load_or_build_panel(raw, dtype=torch.float32, device="cuda", timer=timer)
                pair[route] = host_ingest_seconds(timer.durations)
                times[route].append(pair[route])
            won += pair["columnar"] < pair["legacy"]
    summary = {route: {"median": float(np.median(t)),
                       "quartile_spread": float(np.subtract(*np.percentile(t, [75, 25]))),
                       "runs": t} for route, t in times.items()}
    log(f"host ingest at {CLI_FIRMS} x {CLI_MONTHS}, float32, {INGEST_PAIRS} alternating pairs "
        f"in process: {json.dumps(summary)}; columnar faster in {won} of {INGEST_PAIRS} pairs, "
        f"legacy / columnar medians "
        f"{summary['legacy']['median'] / summary['columnar']['median']:.2f}")


NUMBER = re.compile(r"-?\d[\d,]*\.?\d*(?:e[-+]?\d+)?")


def compare_artifact_files(gpu_dir: Path, cpu_dir: Path) -> None:
    """The artifacts a card run and a CPU run wrote at float64: the pickled
    frames and the serving state at the card-vs-CPU tolerances (PERF.md,
    Layers); a ``.tex`` file equal as text, or its differing cells named
    (their layout must be equal)."""
    names = sorted(os.listdir(gpu_dir))
    check(names == sorted(os.listdir(cpu_dir)), f"artifact files differ: {names} vs "
          f"{sorted(os.listdir(cpu_dir))}")
    t1g, t1c = (pd.read_pickle(d / "table_1.pkl") for d in (gpu_dir, cpu_dir))
    n_cols = [c for c in t1c.columns if c[1] == "N"]
    t1_worst = _rel_worst(t1g.drop(columns=n_cols).to_numpy(), t1c.drop(columns=n_cols).to_numpy(),
                          "table_1.pkl")
    check(t1g[n_cols].equals(t1c[n_cols]) and t1_worst <= 1e-10, "table_1.pkl beyond tolerance")
    t2g, t2c = (pd.read_pickle(d / "table_2.pkl") for d in (gpu_dir, cpu_dir))
    t2_cells = [(row, col, t2g.loc[row, col], t2c.loc[row, col]) for row in t2c.index
                for col in t2c.columns if t2g.loc[row, col] != t2c.loc[row, col]]
    check(t2g.shape == t2c.shape and all(
        abs(float(a.replace(",", "")) - float(b.replace(",", ""))) <= 1.0001e-3
        for *_, a, b in t2_cells), f"table_2.pkl: cells beyond a rounding step {t2_cells}")
    dg, dc = (pd.read_pickle(d / "decile_sorts.pkl") for d in (gpu_dir, cpu_dir))
    dec_worst = _rel_worst(dg.drop(index="Months").to_numpy(), dc.drop(index="Months").to_numpy(),
                           "decile_sorts.pkl")
    check(dg.loc["Months"].equals(dc.loc["Months"]) and dec_worst <= 1e-8,
          "decile_sorts.pkl beyond tolerance")
    sg, sc = (ServingState.load(d / "serving_state.npz") for d in (gpu_dir, cpu_dir))
    st_worst = max(_rel_worst(getattr(sg, k), getattr(sc, k), f"serving_state.npz {k}")
                   for k in ("coef", "slopes_bar", "intercept_bar"))
    bounds = max(_rel_worst(getattr(sg, k), getattr(sc, k), f"serving_state.npz {k}")
                 for k in ("x_lo", "x_hi"))
    check(st_worst <= 1e-8 and bounds <= 1e-10 and all(
        np.array_equal(getattr(sg, k), getattr(sc, k)) for k in ("n_obs", "month_valid")),
        "serving_state.npz beyond tolerance")
    tex = {}
    for name in (n for n in names if n.endswith(".tex")):
        lg, lc = ((d / name).read_text().splitlines() for d in (gpu_dir, cpu_dir))
        check(len(lg) == len(lc) and all(NUMBER.sub("#", a) == NUMBER.sub("#", b)
                                         for a, b in zip(lg, lc)),
              f"{name}: the card's and the CPU's files differ beyond their numbers")
        tex[name] = [(i + 1, x, y) for i, (a, b) in enumerate(zip(lg, lc))
                     for x, y in zip(NUMBER.findall(a), NUMBER.findall(b)) if x != y]
    log(f"artifact files card vs CPU (float64): {names}; table_1.pkl Avg/Std worst rel diff "
        f"{t1_worst:.3e} (tol 1e-10), N exact; table_2.pkl formatted cells that differ "
        f"{t2_cells}; decile_sorts.pkl worst rel diff {dec_worst:.3e} (tol 1e-8); "
        f"serving_state.npz coef/slopes/intercept {st_worst:.3e} (tol 1e-8), bounds "
        f"{bounds:.3e} (tol 1e-10); .tex cells that differ (line, card, CPU): "
        + json.dumps({k: v[:8] + ([f"... {len(v) - 8} more"] if len(v) > 8 else [])
                      for k, v in tex.items()}))


def resume_phase(raw: Path) -> None:
    """``run_pipeline`` on the raw directory at float64 with stage
    checkpoints: a fault plan crashes the run once at
    ``pipeline.serving_state``; the rerun loads Table 1, Table 2 and the
    decile table from their checkpoints, launches K2 only for the figure
    sweep and writes the artifacts (``make_figure=False``: matplotlib may
    not import here). Its tables and serving state are bit-identical to an
    uncheckpointed run on the card, its files agree with a CPU run's, and
    every stage checkpoint reloads into the object it holds."""
    kw = dict(raw_data_dir=raw, dtype=torch.float64, make_figure=False)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpt = tmp / "ckpt"
        with FaultPlan({"pipeline.serving_state": FaultSpec(times=1)}) as plan:
            try:
                run_pipeline(device="cuda", checkpoint_dir=ckpt, **kw)
                crashed = False
            except InjectedFault:
                crashed = True
        saved = sorted(os.listdir(ckpt))
        check(crashed and plan.fired["pipeline.serving_state"] == 1,
              "the fault plan did not crash the run at pipeline.serving_state")
        before = dict(checkpoint.OUTCOMES)
        reset_counts()
        start = time.perf_counter()
        resumed = run_pipeline(device="cuda", checkpoint_dir=ckpt, output_dir=tmp / "cuda", **kw)
        wall = time.perf_counter() - start
        counts = launch_counts()
        outcomes = {k: checkpoint.OUTCOMES[k] - before.get(k, 0)
                    for k in ("hit", "miss", "corrupt", "save")}
        by_key = dict(gram_contract_cuda.launches_by_key)
        k1_by_key = dict(rolling_reduce_cuda.launches_by_key)
        fresh = run_pipeline(device="cuda", **kw)
        diffs = bit_differences(resumed, fresh)
        log(f"resume on the card (raw {CLI_FIRMS} x {CLI_MONTHS}, float64): checkpoints after "
            f"the crash {saved}; rerun wall {wall:.3f} s, checkpoint outcomes {outcomes}, "
            f"launches K1 {counts['k1']} {k1_by_key} K2 "
            f"{counts['k2']} {by_key} K3 {counts['moments']}; "
            f"stages (s) {json.dumps({k: round(v, 4) for k, v in resumed.stage_seconds.items()})}"
            f"; artifacts that differ in bits from an uncheckpointed run {diffs}")
        check(saved == ["decile_table.pkl", "manifest.json", "table_1.pkl", "table_2.pkl"],
              f"checkpoints after the crash: {saved}")
        check(outcomes == {"hit": 3, "miss": 1, "corrupt": 0, "save": 1},
              f"the rerun's checkpoint outcomes {outcomes}")
        check(by_key == {"P=5,S=3,f64": 1}, f"the rerun launched K2 {by_key}, not once for the "
              "figure sweep")
        check(not diffs, f"the resumed run differs from an uncheckpointed run in {diffs}")

        reloaded = {name: pd.read_pickle(ckpt / f"{name}.pkl")
                    for name in ("table_1", "table_2", "decile_table")}
        state = ServingState.load(ckpt / "serving_state.npz")
        check(reloaded["table_1"].equals(fresh.table_1)
              and reloaded["decile_table"].equals(fresh.decile_table)
              and array_bundle_digest({f"{m}|{u}|{k}": np.asarray(v)
                                       for (m, u), c in reloaded["table_2"].items()
                                       for k, v in c.items()})
              == artifact_digests(fresh)["table_2_cells"]
              and all(np.array_equal(getattr(state, leaf), getattr(fresh.serving_state, leaf),
                                     equal_nan=leaf != "month_valid")
                      for leaf in SERVING_LEAVES),
              "a stage checkpoint does not reload into the object it holds")
        del resumed, fresh
        cpu = run_pipeline(device="cpu", output_dir=tmp / "cpu", **kw)
        check(cpu.timer.skipped.get("load_raw_data") == "prepared checkpoint hit",
              "the CPU run did not map the slot the card runs wrote")
        del cpu
        compare_artifact_files(tmp / "cuda", tmp / "cpu")


# --- the task graph --------------------------------------------------------

# Run the task graph's command line as a user would, then print the launch
# counters and the nvcc builds of that process.
TASKGRAPH_WRAPPER = """
import json, runpy, sys
from fm_returnprediction_tpu_torch import cuda_build
from fm_returnprediction_tpu_torch.ops.rolling import (
    masked_cumulative_moments_cuda, rolling_reduce_cuda)
from fm_returnprediction_tpu_torch.specgrid.grams import gram_contract_cuda
sys.argv = ["fm_returnprediction_tpu_torch.taskgraph"] + sys.argv[1:]
try:
    runpy.run_module("fm_returnprediction_tpu_torch.taskgraph", run_name="__main__",
                     alter_sys=True)
    code = 0
except SystemExit as exc:
    code = exc.code
print("TG-LAUNCHES " + json.dumps({"exit": code, "k1": rolling_reduce_cuda.launches,
                                   "k2": gram_contract_cuda.launches,
                                   "moments": masked_cumulative_moments_cuda.launches,
                                   "nvcc": cuda_build.NVCC_RUNS}))
"""
ANSI = re.compile(r"\x1b\[[0-9;]*m")
TASK_STARTED = re.compile(r"^\.  (\S+)$", re.MULTILINE)
TASK_UP_TO_DATE = re.compile(r"^-- (\S+) \(up to date\)$", re.MULTILINE)
# The DAG's tasks without the figure; "reports" (figure_1.pdf, which needs
# matplotlib) and "latex" run only where matplotlib imports.
TG_TASKS = ["build_panel", "serve_state", "specgrid", "backtest"]
# The real-size DAG: 600 months of the real-scale synthetic universe
# (data.benchscale) with every column; its permnos cut from 22,000 (131.7 s
# for the phase) to 2,000 to keep the whole script under 800 s (PERF.md,
# Cells).
TG_MONTHS = 600
TG_PERMNOS = 2000
WRDS_TABLES = (("dsf_v2", "crsp_d"), ("msf_v2", "crsp_m"), ("comp.funda", "comp"),
               ("ccmxpf_linktable", "ccm"), ("dsix", "crsp_index_d"))


def _dag_tasks() -> list:
    """The tasks to name: every task where matplotlib imports, else the
    ones that do not draw the figure."""
    if importlib.util.find_spec("matplotlib") is not None:
        return TG_TASKS + ["reports", "latex"]
    return list(TG_TASKS)


def run_taskgraph_cli(args, env: dict) -> dict:
    """The task graph's command line in a subprocess on the card: wall,
    the tasks it started and found up to date, launches and nvcc builds."""
    torch.cuda.empty_cache()
    start = time.perf_counter()
    done = subprocess.run([sys.executable, "-c", TASKGRAPH_WRAPPER] + [str(a) for a in args],
                          cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                          timeout=600, env={**os.environ, **env})
    wall = time.perf_counter() - start
    check(done.returncode == 0, f"taskgraph {args} exited {done.returncode}: "
          f"{done.stderr[-2000:]}")
    out = ANSI.sub("", done.stdout)
    counts = json.loads(out.split("TG-LAUNCHES ", 1)[1].splitlines()[0])
    return dict(wall=wall, counts=counts, started=TASK_STARTED.findall(out),
                up_to_date=TASK_UP_TO_DATE.findall(out), stdout=out)


def taskgraph_cli_phase() -> None:
    """``python -m fm_returnprediction_tpu_torch.taskgraph --synthetic`` on
    the card, the documented entry, twice on one state DB: the first run
    executes every task it names (and their dependencies), launching K1
    and K2 and building nothing (the kernels were built at the start); the
    rerun finds every task up to date and runs no action (no launch, no
    build)."""
    names = _dag_tasks()
    with tempfile.TemporaryDirectory() as tmp:
        env = {"DATA_DIR": f"{tmp}/data", "OUTPUT_DIR": f"{tmp}/out"}
        args = ["--synthetic", "--db", f"{tmp}/db.sqlite"] + names
        first = run_taskgraph_cli(args, env)
        again = run_taskgraph_cli(args, env)
        made = sorted(os.listdir(f"{tmp}/out"))
    want = {"config", "pull_data", *names}
    log(f"taskgraph --synthetic {' '.join(names)} on the card: first run {first['wall']:.1f} s, "
        f"tasks run {first['started']}, launches {first['counts']}; rerun {again['wall']:.1f} s, "
        f"up to date {again['up_to_date']}, tasks run {again['started']}, launches "
        f"{again['counts']}; artifacts {made}")
    check(first["counts"]["exit"] == 0 and again["counts"]["exit"] == 0,
          "the task graph's command line did not exit 0")
    check(set(first["started"]) == want and not first["up_to_date"],
          f"the first run ran {first['started']}, not {sorted(want)}")
    check(first["counts"]["k1"] > 0 and first["counts"]["k2"] > 0
          and first["counts"]["nvcc"] == 0,
          f"the first run's launches and builds {first['counts']}")
    check(not again["started"] and set(again["up_to_date"]) == want,
          f"the rerun ran {again['started']} and found {again['up_to_date']} up to date")
    check(again["counts"] == {"exit": 0, "k1": 0, "k2": 0, "moments": 0, "nvcc": 0},
          f"the rerun launched or built {again['counts']}")
    check({"specgrid_scenarios.csv", "backtest.csv", "task_timings.json"} <= set(made),
          f"the task graph's artifacts {made}")


class _StandInWrds:
    """A ``wrds`` module answering the pullers' five queries from frames in
    memory (each frame handed over once, its ``jdate`` column dropped as a
    WRDS table has none). The network is never reached."""

    def __init__(self, frames: dict):
        self.frames = frames
        self.queries = []
        outer = self

        class Connection:
            def __init__(self, wrds_username=""):
                pass

            def raw_sql(self, sql, date_cols=None):
                outer.queries.append(sql)
                key = next(k for table, k in WRDS_TABLES if table in sql)
                frame = outer.frames.pop(key)
                if "jdate" in frame.columns:
                    frame.pop("jdate")
                return frame

            def close(self):
                pass

        self.module = type(sys)("wrds")
        self.module.Connection = Connection

    def __enter__(self):
        self.saved = sys.modules.get("wrds")
        sys.modules["wrds"] = self.module
        return self

    def __exit__(self, *exc):
        if self.saved is None:
            sys.modules.pop("wrds", None)
        else:
            sys.modules["wrds"] = self.saved


def taskgraph_real_phase(seed: int) -> None:
    """The task graph in process at 600 months of the real-scale synthetic
    universe: ``pull_data`` through the WRDS pullers against a stand-in
    ``wrds`` module serving ``generate_benchscale_wrds``'s frames, then the
    panel checkpoint, the serving state and the two sweeps on the card,
    twice on one state DB. The first run launches K1 and K2; the rerun runs
    no action (no launch, no build). The loaded ``lewellen_panel.npz`` is
    ``load_or_build_panel``'s panel of the same raw directory, bit for
    bit."""
    from fm_returnprediction_tpu_torch import cuda_build
    from fm_returnprediction_tpu_torch.data.benchscale import generate_benchscale_wrds
    from fm_returnprediction_tpu_torch.panel.dense import DensePanel
    from fm_returnprediction_tpu_torch.taskgraph.engine import (
        PlainReporter,
        TaskRunner,
        write_timing_log,
    )
    from fm_returnprediction_tpu_torch.taskgraph.tasks import PANEL_FILE, build_tasks

    names = _dag_tasks()
    start = time.perf_counter()
    frames = generate_benchscale_wrds(n_permnos=TG_PERMNOS, n_months=TG_MONTHS, seed=seed)
    gen_s = time.perf_counter() - start
    daily_rows = len(frames["crsp_d"])
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        tasks = build_tasks(raw_dir=tmp / "raw", processed_dir=tmp / "processed",
                            output_dir=tmp / "out", device="cuda")
        per_task = {}   # task → (K1, K2) launches of its actions
        for t in tasks:
            def before(name=t.name):
                per_task[name] = (rolling_reduce_cuda.launches, gram_contract_cuda.launches)

            def after(name=t.name):
                k1, k2 = per_task[name]
                per_task[name] = (rolling_reduce_cuda.launches - k1,
                                  gram_contract_cuda.launches - k2)

            t.actions = [before, *t.actions, after]
        db = tmp / "db.sqlite"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        nvcc0 = cuda_build.NVCC_RUNS
        reset_counts()
        start = time.perf_counter()
        with _StandInWrds(frames) as wrds, TaskRunner(tasks, db_path=db,
                                                      reporter=PlainReporter()) as runner:
            ok = runner.run(names)
            write_timing_log(runner, tmp / "timings.json")
        first_s = time.perf_counter() - start
        first = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check(ok, "the real-size task graph failed")
        timings = json.loads((tmp / "timings.json").read_text())
        npz = tmp / "processed" / PANEL_FILE
        npz_bytes = npz.stat().st_size

        reset_counts()
        start = time.perf_counter()
        with TaskRunner(tasks, db_path=db, reporter=PlainReporter()) as runner:
            ok2 = runner.run(names)
            stale = [t.name for t in tasks if t.name in names and not runner.is_up_to_date(t)]
        rerun_s = time.perf_counter() - start
        rerun = launch_counts()
        builds = cuda_build.NVCC_RUNS - nvcc0

        loaded = DensePanel.load(npz, device="cuda")
        want, _ = load_or_build_panel(tmp / "raw", device="cuda")
        same = (loaded.var_names == want.var_names
                and bool(torch.equal(torch.isnan(loaded.values), torch.isnan(want.values)))
                and bool(torch.equal(torch.nan_to_num(loaded.values, nan=0.0),
                                     torch.nan_to_num(want.values, nan=0.0)))
                and np.array_equal(loaded.mask, want.mask)
                and np.array_equal(loaded.ids, want.ids)
                and np.array_equal(loaded.months, want.months))
        shape = tuple(loaded.values.shape)
        del loaded, want
    log(f"taskgraph at {TG_MONTHS} months x {TG_PERMNOS:,} permnos ({daily_rows:,} daily rows, "
        f"generated in {gen_s:.1f} s), tasks {names}: {len(wrds.queries)} WRDS queries served "
        f"by the stand-in; first run {first_s:.1f} s, per task (s) "
        f"{json.dumps({k: round(v, 3) for k, v in sorted(timings.items())})}; launches K1 "
        f"{first['k1']} K2 {first['k2']} K3 {first['moments']}, per task (K1, K2) "
        f"{json.dumps(per_task)}; {PANEL_FILE} {npz_bytes:,} bytes "
        f"for a panel of {shape}; peak device memory {peak / 2**30:.3f} GiB; rerun "
        f"{rerun_s:.2f} s, launches K1 {rerun['k1']} K2 {rerun['k2']} K3 {rerun['moments']}, "
        f"stale after it {stale}; nvcc builds {builds}; the loaded checkpoint bit-identical to "
        f"load_or_build_panel's panel {same}")
    check(len(wrds.queries) == 5, f"the stand-in answered {len(wrds.queries)} queries, not 5")
    check(first["k1"] > 0 and first["k2"] > 0, f"the first run launched {first}")
    check(ok2 and not stale and rerun["k1"] == rerun["k2"] == rerun["moments"] == 0,
          f"the rerun launched K1 {rerun['k1']} K2 {rerun['k2']} or left {stale} stale")
    check(builds == 0, f"the real-size task graph built {builds} kernels")
    check(0 < shape[0] <= TG_MONTHS and 0 < shape[1] <= TG_PERMNOS,
          f"the panel checkpoint's shape {shape}")
    check(same, "the panel checkpoint differs from load_or_build_panel's panel")


# --- the dense daily route and the dry run ---------------------------------

# the forced strips' width (firms): 4 strips of the 22,000-firm grid
DENSE_STRIP_FIRMS = 6144


def dense_daily_grid(daily) -> tuple:
    """The dense (D, N) float32 return grid and its mask of the compact
    daily rows, by one scatter (the layout ``panel.daily.DailyPanel``
    holds)."""
    counts = np.diff(daily.offsets)
    firm = np.repeat(np.arange(len(counts)), counts)
    pos = daily.row_pos.astype(np.int64)
    ret = np.full((daily.n_days, len(counts)), np.nan, dtype=np.float32)
    mask = np.zeros(ret.shape, dtype=bool)
    ret[pos, firm] = daily.row_values
    mask[pos, firm] = True
    return ret, mask


def _route_gap(got: np.ndarray, want: np.ndarray) -> tuple:
    """NaN patterns equal, then the largest absolute and relative gap."""
    check(bool(np.array_equal(np.isnan(got), np.isnan(want))), "NaN patterns differ")
    fin = np.isfinite(want)
    diff = np.abs(got[fin].astype(np.float64) - want[fin])
    rel = diff / np.maximum(np.abs(want[fin]), np.finfo(np.float32).tiny)
    return float(diff.max(initial=0.0)), float(rel.max(initial=0.0))


def daily_dense_phase(daily) -> tuple:
    """The dense daily route at real size: the (D, 22,000) float32 grid
    through ``daily_characteristics_chunked`` with the default budget
    (60% of the card: one call expected) and with strips forced by
    ``FMRP_DAILY_BUDGET_BYTES``; the two runs bit-equal, and bit-equal to
    the main path's compact route (``daily_characteristics_compact_chunked``)
    on the same rows (the gap printed); K1 std held against its plain
    version and timed at the grid's and the strips' shapes. Returns the
    runs' launch counts (keys prefixed ``dense/``) and the kernel rows."""
    start = time.perf_counter()
    ret, mask = dense_daily_grid(daily)
    d, n = ret.shape
    log(f"dense daily grid ({d}, {n}) float32: {ret.nbytes:,} bytes of returns and "
        f"{mask.nbytes:,} of mask, scattered from {len(daily.row_values):,} rows in "
        f"{time.perf_counter() - start:.2f} s")
    args = (ret, mask, daily.mkt, daily.day_month_id, daily.week_id, daily.week_month_id,
            daily.n_months, daily.n_weeks)
    merged = {}

    def run(label, budget):
        with _env(FMRP_DAILY_BUDGET_BYTES=budget):
            chunk = daily_chunked.auto_firm_chunk(d, n, ret.dtype.itemsize, device="cuda")
            budget_bytes = daily_chunked._default_budget_bytes("cuda")
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            reset_counts()
            t0 = time.perf_counter()
            vol, beta = daily_chunked.daily_characteristics_chunked(
                *args, mkt_present=daily.mkt_present, device="cuda")
            wall = time.perf_counter() - t0
            counts = launch_counts()
        peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
        strips = 1 if chunk is None else -(-n // chunk)
        log(f"dense route, {label}: budget {budget_bytes:,} bytes, firm_chunk {chunk} "
            f"({strips} call{'s' if strips > 1 else ''}), {wall:.3f} s, launches K1 "
            f"{counts['k1']} {({k: v for k, v in counts.items() if k.startswith('std/')})}, "
            f"K2 {counts['k2']}, K3 {counts['moments']}; peak device memory above the "
            f"resident {peak:.3f} GiB (the budget model: "
            f"{d * ret.dtype.itemsize * daily_chunked._WORKSPACE_ARRAYS * min(chunk or n, n) / 2**30:.3f} GiB)")
        check(counts["k1"] == counts.get("std/w=252", 0) == strips,
              f"dense route, {label}: K1 launches {counts['k1']}, not one a strip ({strips})")
        for key, v in counts.items():
            merged["dense/" + key] = merged.get("dense/" + key, 0) + v
        return vol, beta, chunk, strips

    vol1, beta1, chunk1, _ = run("default budget", None)
    budget = d * ret.dtype.itemsize * daily_chunked._WORKSPACE_ARRAYS * DENSE_STRIP_FIRMS
    vol2, beta2, chunk2, strips2 = run("forced strips", budget)
    check(chunk2 == DENSE_STRIP_FIRMS and strips2 >= 3, f"forced strips: {chunk2}, {strips2}")
    same = (np.array_equal(vol1, vol2, equal_nan=True)
            and np.array_equal(beta1, beta2, equal_nan=True))
    log(f"dense route: {strips2} forced strips bit-equal to the default run: {same}")
    check(same, "dense route: the strips differ from the default run")

    t0 = time.perf_counter()
    vol_c, beta_c = daily_chunked.daily_characteristics_compact_chunked(
        daily.row_values, daily.row_pos, daily.offsets, daily.mkt, daily.mkt_present,
        daily.day_month_id, daily.week_id, daily.week_month_id, daily.n_days, daily.n_weeks,
        daily.n_months, device="cuda", dtype=torch.float32)
    compact_s = time.perf_counter() - t0
    gaps = {"vol": _route_gap(vol1, vol_c), "beta": _route_gap(beta1, beta_c)}
    log(f"dense vs compact route (the main path's, {compact_s:.3f} s): vol bit-equal "
        f"{np.array_equal(vol1, vol_c, equal_nan=True)}, beta bit-equal "
        f"{np.array_equal(beta1, beta_c, equal_nan=True)}; max abs/rel gap vol "
        f"{gaps['vol'][0]:.3e}/{gaps['vol'][1]:.3e}, beta {gaps['beta'][0]:.3e}/"
        f"{gaps['beta'][1]:.3e}")

    # K1's time chunks start every max(2·window, 512) rows from row 0
    # whatever the height (ops.rolling.rolling_chunk_plan), and every other
    # step is per firm column, so the routes give the same bits
    check(np.array_equal(vol1, vol_c, equal_nan=True)
          and np.array_equal(beta1, beta_c, equal_nan=True),
          "dense vs compact route: the columns differ")

    # the rolling kernel's input in the dense route: each firm's rows
    # compacted to the front of the (D, N) grid
    x = _dense_compacted(ret, mask)
    rows = []
    for cols in (n, DENSE_STRIP_FIRMS):
        xc = x[:, :cols].contiguous()
        label = f"std w=252 mp=100 (dense daily route) {d}x{cols} float32"
        err = check_rolling(xc, 252, 100, "std", 1e-4, label)
        row = k1_row(xc, 252, 100, "std", err, label)
        row["key"] = "dense/" + row["key"]
        rows.append(row)
        del xc
    del x
    torch.cuda.empty_cache()
    return merged, rows


def _dense_compacted(ret: np.ndarray, mask: np.ndarray) -> torch.Tensor:
    """``rolling_vol_252_monthly``'s K1 input: each column's present rows
    packed to the front, NaN after them, on the card."""
    mask_t = torch.from_numpy(mask).cuda()
    plan = make_compaction(mask_t)
    ret_t = torch.from_numpy(ret).cuda()
    out = torch.where(plan.valid, compact(ret_t, plan), torch.full_like(ret_t, float("nan")))
    del plan, ret_t, mask_t
    return out


def dryrun_phase() -> dict:
    """``dryrun_multichip(4)`` on the card (4 mesh positions: virtual shards
    of one card, or distinct cards where there are 4) and ``entry()``'s FM
    step, held against the same step on the CPU."""
    reset_counts()
    start = time.perf_counter()
    gaps = dryrun_multichip(4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = launch_counts()
    log(f"dryrun_multichip(4): {wall:.3f} s over {torch.cuda.device_count()} card(s); "
        f"launches K1 {counts['k1']}, K2 {counts['k2']}, K3 {counts['moments']}; largest gap "
        "to the one-device step: " + json.dumps({k: float(f"{v:.3e}") for k, v in gaps.items()}))
    check(counts["k1"] > 0 and counts["moments"] > 0,
          "dryrun_multichip(4): K1 or K3 was not launched")
    check(len(gaps) == 7, f"dryrun_multichip(4): patterns run {sorted(gaps)}")

    fn, args = entry()
    start = time.perf_counter()
    got = [a.cpu().numpy() for a in fn(*args)]
    entry_s = time.perf_counter() - start
    fn_cpu, args_cpu = entry(device="cpu")
    want = [a.numpy() for a in fn_cpu(*args_cpu)]
    worst = {name: float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))
             for name, a, b in zip(("coef", "tstat", "mean_r2"), got, want)}
    log(f"entry(): FM step on (24, 64, 14) float32 in {entry_s:.4f} s; card vs CPU |d| / "
        f"max(|x|, 1): " + json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()})
        + " (tol 1e-5 coef and R², 1e-4 t-stat)")
    check(all(np.isfinite(a).all() for a in got), "entry(): non-finite FM step")
    check(worst["coef"] <= 1e-5 and worst["mean_r2"] <= 1e-5 and worst["tstat"] <= 1e-4,
          "entry(): card vs CPU beyond tolerance")
    return counts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=20140131)
    parser.add_argument("--kernels-only", action="store_true",
                        help="build and check each kernel once, no timing")
    parser.add_argument("--ptxas", action="store_true",
                        help="print nvcc's register/shared-memory report")
    parser.add_argument("--absorb-reading", action="store_true",
                        help="print the absorb kind's worst card-vs-CPU cell month by month")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    smi = nvidia_smi_line()
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is enabled")

    start = time.perf_counter()
    per_kernel = build_kernels(ptxas_verbose=args.ptxas)
    log(f"kernel build {time.perf_counter() - start:.2f} s "
        + json.dumps({k: round(v, 2) for k, v in per_kernel.items()}))
    if args.ptxas:
        sass_hmma_phase()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    timed = not args.kernels_only
    rows = (phase_timed("k1_phase", k1_phase, gen, timed)
            + phase_timed("k2_phase", k2_phase, gen, timed)
            + phase_timed("k2_wide_phase", k2_wide_phase, gen, timed)
            + phase_timed("k3_phase", k3_phase, gen, timed))
    if args.kernels_only:
        log("kernels-only run: kernel phases passed")
        return 0

    start = time.perf_counter()
    base, daily = make_smoke_inputs(seed=args.seed, dtype=np.float32)
    log(f"main path inputs: panel {base.values.shape} f32, "
        f"{len(daily.row_values):,} daily rows over {daily.n_days} days, "
        f"built in {time.perf_counter() - start:.1f} s")
    with tempfile.TemporaryDirectory() as audit_dir:
        counts, digests, gram_frames, serving = phase_timed("main_path", main_path, base,
                                                            daily, Path(audit_dir))
    bare = phase_timed("serving_phase", serving_phase, serving)
    with tempfile.TemporaryDirectory() as registry_root:
        registry_root = Path(registry_root)
        phase_timed("slot_phase", slot_phase, base, daily, digests, registry_root)
        phase_timed("registry_phase", registry_phase, registry_root, args.seed, per_kernel,
                    serving["state"])
        thread_rates = phase_timed("fleet_phase", fleet_phase, serving, bare, registry_root)
        phase_timed("process_fleet_phase", process_fleet_phase, serving, bare, registry_root,
                    thread_rates)
    del serving, bare
    phase_timed("trace_phase", trace_phase, base, daily, digests)
    phase_timed("profile_phase", profile_phase, base, daily, digests)
    sweep_counts, sweep_res = phase_timed("specgrid_phase", specgrid_phase, base, daily)
    path_counts = {"main": counts, **sweep_counts}
    path_counts["multiproc"] = phase_timed("multiproc_phase", multiproc_phase, sweep_res)
    path_counts["wide"] = phase_timed("k2_wide_path_phase", k2_wide_path_phase, sweep_res,
                                      args.seed)
    del sweep_res
    boot_ref = phase_timed("bootstrap_phase", bootstrap_phase, base, daily)
    path_counts["mesh"], mesh_rows = phase_timed("mesh_phase", mesh_phase, base, daily,
                                                 boot_ref, gen)
    del boot_ref
    path_counts["backtest"] = phase_timed("backtest_phase", backtest_phase, base, daily)
    path_counts["estimators"] = phase_timed("estimators_phase", estimators_phase, base, daily)
    phase_timed("stacked_phase", stacked_phase, base, daily, gram_frames)
    path_counts["dense"], dense_rows = phase_timed("daily_dense_phase", daily_dense_phase,
                                                   daily)
    del base, daily
    path_counts["dryrun"] = phase_timed("dryrun_phase", dryrun_phase)
    rows += phase_timed("strip_phase", strip_phase, gen, counts) + mesh_rows + dense_rows
    phase_timed("card_vs_cpu", card_vs_cpu, args.seed, args.absorb_reading)
    phase_timed("ingest_vs_cpu", ingest_vs_cpu)
    phase_timed("frames_route_phase", frames_route_phase)
    phase_timed("cli_phase", cli_phase)
    phase_timed("bootstrap_backtest_cli_phase", bootstrap_backtest_cli_phase)
    phase_timed("estimator_cli_phase", estimator_cli_phase)
    phase_timed("trace_cli_phase", trace_cli_phase)
    with tempfile.TemporaryDirectory() as tmp:
        raw = Path(tmp) / "raw"
        start = time.perf_counter()
        write_synthetic_cache(raw, SyntheticConfig(n_firms=CLI_FIRMS, n_months=CLI_MONTHS))
        log(f"raw directory {CLI_FIRMS} firms x {CLI_MONTHS} months written in "
            f"{time.perf_counter() - start:.1f} s")
        phase_timed("raw_cli_phase", raw_cli_phase, raw)
        phase_timed("specgrid_cli_phase", specgrid_cli_phase, raw)
        phase_timed("ingest_pairs_phase", ingest_pairs_phase, raw)
        phase_timed("resume_phase", resume_phase, raw)
    phase_timed("taskgraph_cli_phase", taskgraph_cli_phase)
    phase_timed("taskgraph_real_phase", taskgraph_real_phase, args.seed)

    for row in rows:
        key = row.pop("key")
        # the scenario sweep's K2 shapes are launched by its runs, the rest
        # by the main path; Table 2's shape adds the backtest run's launches
        prefix = key.split("/")[0]
        paths = ROW_PATH.get(key, (prefix,) if prefix in ("mesh", "dense") else ("main",))
        row["launches"] = sum(path_counts[p].get(key, 0) for p in paths)
        if row.get("main_path") == K3_MAIN_PATH:
            check(row["launches"] == 0, f"{row['name']}: launched on the main path, "
                  "which does not call it at this shape")
            continue
        check(row["launches"] > 0, f"{row['name']} was not launched on the main path")
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
