"""The rolling kernel's time-axis chunks, checked on the CPU.

The CUDA kernel (``csrc/rolling.cu``) cuts the time axis into chunks of
``rolling_chunk_rows(window)`` rows; the block for chunk ``[start, stop)``
starts its lead and lag triples from zero at ``anchor = max(start - window,
0)`` and writes from ``start`` on. The kernel runs only on the card, so this
file holds the plan itself and a float64 numpy emulation of that anchored
walk against the plain version (``rolling_reduce_plain``) at rtol 1e-10,
the tolerance of ``tests/test_torch_rolling.py``, with an identical NaN
pattern.
"""

import inspect

import numpy as np
import pytest
import torch

from fm_returnprediction_tpu_torch.ops import rolling as port

pytestmark = pytest.mark.torch_port


def _anchored_walk(x, window, min_periods, kind):
    """The kernel's arithmetic in numpy, chunk by chunk: lead and lag
    cumulative triples from zero at each chunk's anchor, the lag fed by
    x[t - window] once t - window reaches the anchor, then the
    finalization of ``csrc/rolling.cu``."""
    t_len, n = x.shape
    out = np.full_like(x, np.nan)
    for anchor, start, stop in port.rolling_chunk_plan(t_len, window):
        lead = [np.zeros(n) for _ in range(3)]
        lag = [np.zeros(n) for _ in range(3)]
        for t in range(anchor, stop):
            for triple, row in ((lead, t), (lag, t - window)):
                if row < anchor:
                    continue
                fin = np.isfinite(x[row])
                v = np.where(fin, x[row], 0.0)
                triple[0] += v
                triple[1] += v * v
                triple[2] += fin
            if t < start:
                continue
            w1, w2, wc = (a - b for a, b in zip(lead, lag))
            if kind == "sum":
                r = w1
            elif kind == "mean":
                r = w1 / np.maximum(wc, 1.0)
            else:
                var = np.maximum(w2 - w1 * w1 / np.maximum(wc, 1.0), 0.0)
                r = np.where(wc >= 2, np.sqrt(var / np.maximum(wc - 1.0, 1.0)), np.nan)
            out[t] = np.where(wc >= min_periods, r, np.nan)
    return out


def _case(name):
    """(x, window, min_periods): several chunks unless the window exceeds T."""
    rng = np.random.default_rng(11)
    if name == "noisy":            # T not a multiple of the chunk
        x = 1.0 + 0.3 * rng.standard_normal((1300, 6))
        x[rng.random(x.shape) < 0.07] = np.nan
        return x, 252, 100
    if name == "half_chunk":       # window = chunk / 2: each warm-up is a whole window
        x = 1.0 + 0.3 * rng.standard_normal((1537, 5))
        x[rng.random(x.shape) < 0.05] = np.nan
        return x, 300, 2
    if name == "window_over_t":    # one chunk, the window longer than the series
        x = 1.0 + 0.3 * rng.standard_normal((400, 5))
        x[rng.random(x.shape) < 0.05] = np.nan
        return x, 700, 1
    if name == "all_nan_cols":     # whole columns missing, min_periods 0
        x = 1.0 + 0.3 * rng.standard_normal((1100, 6))
        x[:, [0, 4]] = np.nan
        return x, 12, 0
    if name == "compacted":        # valid rows packed to the front, NaN tail
        x = 1.0 + 0.3 * rng.standard_normal((1200, 8))
        counts = rng.integers(0, 1201, 8)
        counts[0] = 1200
        x[np.arange(1200)[:, None] >= counts[None, :]] = np.nan
        return x, 24, 24
    raise KeyError(name)


@pytest.mark.parametrize("case", ["noisy", "half_chunk", "window_over_t",
                                  "all_nan_cols", "compacted"])
@pytest.mark.parametrize("kind", ["sum", "mean", "std"])
def test_anchored_walk_matches_plain(case, kind):
    x, window, mp = _case(case)
    if case == "half_chunk":
        assert port.rolling_chunk_rows(window) == 2 * window
    got = _anchored_walk(x, window, mp, kind)
    want = port.rolling_reduce_plain(torch.from_numpy(x), window, mp, kind).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0, equal_nan=True)


@pytest.mark.parametrize("t_len", [1, 511, 512, 513, 1300, 13312])
@pytest.mark.parametrize("window", [1, 12, 120, 252, 300, 700])
def test_plan_covers_the_time_axis_exactly(t_len, window):
    plan = port.rolling_chunk_plan(t_len, window)
    covered = np.zeros(t_len, int)
    for anchor, start, stop in plan:
        assert 0 <= anchor <= start < stop <= t_len
        assert anchor == max(start - window, 0)
        covered[start:stop] += 1
    assert (covered == 1).all()
    assert [s for _, s, _ in plan] == sorted(s for _, s, _ in plan)


@pytest.mark.parametrize("window", [1, 2, 12, 24, 120, 252, 255, 256, 300, 4000])
def test_chunk_is_at_least_two_windows(window):
    rows = port.rolling_chunk_rows(window)
    assert rows >= 2 * window and rows >= 512


def test_plan_depends_on_t_and_window_alone():
    assert list(inspect.signature(port.rolling_chunk_rows).parameters) == ["window"]
    assert list(inspect.signature(port.rolling_chunk_plan).parameters) == [
        "t_len", "window"]
    first = port.rolling_chunk_plan(13312, 252)
    assert port.rolling_chunk_plan(13312, 252) == first
    assert len(first) == 26 and first[1] == (260, 512, 1024)
