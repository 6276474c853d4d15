"""Moving-block bootstrap of the Fama-MacBeth slope series, on one device.

The reference's Table 2 reports Newey-West analytic SEs only; the
bootstrap-SE table (``reporting.bootstrap_table``, the 10k-replicate block
bootstrap of BASELINE.json configs[4]) adds the bootstrap SE of each mean
slope:

- each predictor's slope series is compacted to its valid months in
  chronological order (``ops.newey_west.compact_front``, as the NW SE pairs
  adjacent surviving months), of length ``n_p``;
- a replicate resamples the compacted series by moving blocks of length
  ``L``: position ``j`` of the pseudo-series takes block ``j // L`` at offset
  ``j % L`` from a start drawn uniformly in ``[0, n_p − L]``
  (``idx = start[j // L] + j % L``, clamped to ``n_p − 1``), and the
  replicate statistic is the mean of the first ``n_p`` positions. A
  predictor with ``n_p <= L`` gives NaN (every replicate would be the
  sample mean, a spurious zero SE);
- the SE is the ddof=1 standard deviation of the replicate means, from
  moments centred on the full-sample (pilot) mean:
  ``var = (Σd² − (Σd)²/B) / (B − 1)`` with ``d = replicate mean − pilot``.

The draw is split from the gather. The reference draws each replicate's
starts from ``jax.random`` keys, whose bits torch cannot reproduce, so
:func:`draw_block_starts` draws them from an explicit seeded
``torch.Generator`` and :func:`replicate_means_from_starts` is a pure
function of the starts. Handing both packages (or the card and the CPU)
the same starts makes their replicate means comparable at float64. The
starts are drawn on the CPU, so one seed gives the same starts, and the
same table up to rounding, on every device; as in the reference, every
predictor of a replicate maps the same uniform draws onto its own range
``[0, n_p − L]``.

Replicates are gathered in chunks of at most ``REPLICATE_CHUNK_ELEMENTS``
gathered values, and the chunks' moment sums are added in chunk order, so
a repeated call is bit-identical.

With a ``mesh`` the replicates shard over its ``axis_name`` axis: the same
CPU draws are split by replicate into one contiguous range per shard, each
shard sums the moments of its range on its device, and one rank-ordered
``psum`` of 2·P values combines them. B is not rounded up to a multiple of
the shard count (the reference rounds it up), so a result depends on the
seed and not on the mesh, up to rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fm_returnprediction_tpu_torch.ops.newey_west import compact_front
from fm_returnprediction_tpu_torch.parallel.mesh import psum

__all__ = [
    "BootstrapResult",
    "REPLICATE_CHUNK_ELEMENTS",
    "draw_block_starts",
    "replicate_means_from_starts",
    "bootstrap_replicate_means",
    "block_bootstrap_se",
]

# the most (replicate, predictor, month) values one gather holds: 2**25
# int64 indices are 256 MiB on the device
REPLICATE_CHUNK_ELEMENTS = 1 << 25


class BootstrapResult(NamedTuple):
    se: torch.Tensor     # (P,) bootstrap SE of the mean slope
    mean: torch.Tensor   # (P,) mean of the replicate means (bias diagnostic)
    n_replicates: int    # B drawn
    block_length: int


def _max_starts(counts: torch.Tensor, block_length: int) -> torch.Tensor:
    """Highest block start per predictor: ``max(n − L, 0)`` with
    ``n = max(n_valid, 1)``."""
    n = torch.clamp_min(counts.to(torch.int64), 1)
    return torch.clamp_min(n - block_length, 0)


def draw_block_starts(counts: torch.Tensor, n_replicates: int, block_length: int,
                      n_months: int, generator: torch.Generator) -> torch.Tensor:
    """(B, P, n_blocks) block starts, uniform in ``[0, max(n_p − L, 0)]``
    for predictor p, ``n_blocks = ceil(n_months / L)``, drawn on the CPU
    from ``generator`` (a seeded CPU ``torch.Generator``). Every predictor
    of a replicate maps the same uniform draws onto its own range."""
    n_blocks = -(-n_months // block_length)
    top = _max_starts(counts.cpu(), block_length)
    u = torch.rand((n_replicates, 1, n_blocks), generator=generator, dtype=torch.float64)
    starts = torch.floor(u * (top + 1).to(torch.float64)[None, :, None]).to(torch.int64)
    # u < 1, but u·(m + 1) can round up to m + 1
    return torch.minimum(starts, top[None, :, None])


def replicate_means_from_starts(series: torch.Tensor, counts: torch.Tensor,
                                starts: torch.Tensor, block_length: int) -> torch.Tensor:
    """(B, P) replicate means from given block starts.

    series (P, T) compacted slope series (valid entries first, tail
    zeroed); counts (P,) valid entries; starts (B, P, n_blocks) with
    ``n_blocks >= ceil(T / L)`` (moved to series' device). Predictors with
    ``counts <= L`` give NaN."""
    p, t = series.shape
    starts = starts.to(series.device)
    j = torch.arange(t, device=series.device)
    n = torch.clamp_min(counts.to(torch.int64), 1)
    idx = starts[:, :, j // block_length] + (j % block_length)
    idx = torch.minimum(idx, (n - 1)[None, :, None])   # clamp inside the valid region
    pseudo = torch.gather(series.expand(starts.shape[0], p, t), -1, idx)
    w = (j[None, :] < counts[:, None]).to(series.dtype)
    means = (pseudo * w).sum(dim=-1) / torch.clamp_min(counts, 1).to(series.dtype)
    return torch.where((counts > block_length)[None, :], means,
                       torch.full_like(means, float("nan")))


def bootstrap_replicate_means(slopes: torch.Tensor, slope_valid: torch.Tensor,
                              starts: torch.Tensor, block_length: int) -> torch.Tensor:
    """(B, P) replicate means of every predictor's slope series: slopes and
    slope_valid (T, P), compacted here, then
    :func:`replicate_means_from_starts`."""
    series, counts = compact_front(slopes.transpose(0, 1), slope_valid.transpose(0, 1))
    return replicate_means_from_starts(series, counts, starts, block_length)


def _moment_sums(series, counts, starts, pilot, block_length: int):
    """``(Σd, Σd²)`` over the replicates of ``starts``, ``d`` = replicate
    mean − pilot, in chunks of at most ``REPLICATE_CHUNK_ELEMENTS``
    gathered values added in chunk order."""
    p, t = series.shape
    s1 = torch.zeros_like(pilot)
    s2 = torch.zeros_like(pilot)
    chunk = max(1, REPLICATE_CHUNK_ELEMENTS // max(p * t, 1))
    for lo in range(0, starts.shape[0], chunk):
        means = replicate_means_from_starts(series, counts, starts[lo:lo + chunk], block_length)
        d = means - pilot[None, :]
        s1 = s1 + d.sum(dim=0)
        s2 = s2 + (d * d).sum(dim=0)
    return s1, s2


def block_bootstrap_se(slopes: torch.Tensor, slope_valid: torch.Tensor, seed: int = 0,
                       n_replicates: int = 10_000, block_length: int = 5,
                       mesh=None, axis_name: str = "boot") -> BootstrapResult:
    """Moving-block bootstrap SE of the mean slope, per predictor.

    slopes (T, P) monthly slope estimates (``monthly_cs_ols``);
    slope_valid (T, P) bool, month ran and slope finite; ``seed`` seeds the
    CPU generator of :func:`draw_block_starts`. The gather runs on the
    slopes' device, or with ``mesh`` on each shard's device, the replicates
    split over ``axis_name`` (module docstring); the result lies on the
    slopes' device.
    """
    if n_replicates < 2:
        raise ValueError(
            f"n_replicates must be >= 2 for a ddof=1 variance, got {n_replicates}")
    series, counts = compact_front(slopes.transpose(0, 1), slope_valid.transpose(0, 1))
    p, t = series.shape
    starts = draw_block_starts(counts, n_replicates, block_length, t,
                               torch.Generator().manual_seed(seed))
    v = slope_valid.to(slopes.dtype)
    pilot = (torch.where(slope_valid, slopes, torch.zeros_like(slopes)).sum(dim=0)
             / torch.clamp_min(v.sum(dim=0), 1.0))
    if mesh is None:
        s1, s2 = _moment_sums(series, counts, starts, pilot, block_length)
    else:
        d = mesh.shape[axis_name]
        k = mesh.axis_names.index(axis_name)
        cuts = [n_replicates * i // d for i in range(d + 1)]
        parts = []
        for pos in mesh.local_positions():
            i = mesh.coords(pos)[k]
            dev = mesh.device_of(pos)
            parts.append(_moment_sums(series.to(dev), counts.to(dev),
                                      starts[cuts[i]:cuts[i + 1]], pilot.to(dev),
                                      block_length))
        s1, s2 = (a.to(slopes.device) for a in psum(mesh, parts, axis_name)[0])
    b = float(n_replicates)
    mean = pilot + s1 / b
    var = (s2 - s1 * s1 / b) / (b - 1.0)
    return BootstrapResult(torch.sqrt(torch.clamp_min(var, 0.0)), mean, n_replicates,
                           block_length)
