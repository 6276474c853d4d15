"""The moments kernel's two-pass chunked scan, checked on the CPU.

The CUDA kernel (``csrc/rolling.cu``) cuts the time axis into chunks of
``moments_chunk_rows(T)`` rows (``moments_chunk_plan``). Pass 1 sums every
chunk but the last; pass 2 starts chunk k from the totals of chunks
0 .. k-1, added in chunk order, and walks its rows. The kernel runs only on
the card, so this file holds the plan itself and a float64 numpy emulation
of the two passes against the plain version
(``masked_cumulative_moments_plain``) and the JAX package's Pallas kernel in
interpret mode. Tolerances: rtol 1e-10 / atol 1e-12 on the sums (the
emulation adds in the kernel's order, the plain version row by row, the
Pallas kernel by a triangular matmul per block; the kernel's
``fma(v, v, s2)`` rounds once where the emulation rounds twice), counts
exact.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_returnprediction_tpu.ops.pallas_kernels import (
    masked_cumulative_moments as jax_moments,
)
from fm_returnprediction_tpu_torch.ops import rolling as port

pytestmark = pytest.mark.torch_port


def _two_pass(x):
    """The kernel's arithmetic in numpy: each chunk's masked totals in row
    order (pass 1), then each chunk from the carry of the chunks before it,
    added in chunk order, walking its rows (pass 2)."""
    t_len, n = x.shape
    fin = np.isfinite(x)
    plan = port.moments_chunk_plan(t_len)

    def walk(start, stop, triple, out=None):
        s1, s2, c = triple
        for t in range(start, stop):
            s1 = np.where(fin[t], s1 + x[t], s1)
            s2 = np.where(fin[t], s2 + x[t] * x[t], s2)
            c = np.where(fin[t], c + 1.0, c)
            if out is not None:
                out[0][t], out[1][t], out[2][t] = s1, s2, c
        return s1, s2, c

    zero = (np.zeros(n), np.zeros(n), np.zeros(n))
    totals = [walk(start, stop, zero) for start, stop in plan[:-1]]
    out = tuple(np.full(x.shape, np.nan) for _ in range(3))
    for k, (start, stop) in enumerate(plan):
        carry = zero
        for total in totals[:k]:
            carry = tuple(a + b for a, b in zip(carry, total))
        walk(start, stop, carry, out)
    return out


def _case(name):
    """A seeded (T, N) float64 input; T relative to the chunk length of a
    short series (64 rows)."""
    rows = port.moments_chunk_rows(1)
    rng = np.random.default_rng(31)
    t_len, n = {
        "nan_inf_ragged": (10 * rows + 60, 37),   # eleven chunks, the last ragged
        "exact_multiple": (8 * rows, 5),
        "one_past_a_chunk": (rows + 1, 6),        # a one-row last chunk
        "one_chunk": (rows - 1, 6),
        "one_row": (1, 7),
    }[name]
    x = 0.02 * rng.standard_normal((t_len, n))
    x[rng.random(x.shape) < 0.07] = np.nan
    x[rng.random(x.shape) < 0.01] = np.inf
    x[rng.random(x.shape) < 0.01] = -np.inf
    if n > 3:
        x[:, 3] = np.nan                                    # an all-NaN column
    counts = rng.integers(0, t_len + 1, n)                  # NaN tails
    counts[0] = t_len
    x[np.arange(t_len)[:, None] >= counts[None, :]] = np.nan
    return x


CASES = ["nan_inf_ragged", "exact_multiple", "one_past_a_chunk", "one_chunk", "one_row"]


def _assert_moments(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("case", CASES)
def test_two_pass_matches_plain(case):
    x = _case(case)
    if case == "nan_inf_ragged":
        assert np.isposinf(x).any() and np.isneginf(x).any()
        plan = port.moments_chunk_plan(x.shape[0])
        assert len(plan) == 11 and plan[-1][1] - plan[-1][0] == 60
    got = _two_pass(x)
    want = [w.numpy() for w in port.masked_cumulative_moments_plain(torch.from_numpy(x))]
    _assert_moments(got, want)
    np.testing.assert_array_equal(got[2][-1], np.isfinite(x).sum(0))


@pytest.mark.parametrize("case", CASES)
def test_two_pass_matches_pallas_interpret(case):
    x = _case(case)
    want = jax_moments(jnp.asarray(x), block_t=128, block_n=128, interpret=True)
    _assert_moments(_two_pass(x), [np.asarray(w) for w in want])


@pytest.mark.parametrize("which", ["1", "L-1", "L", "L+1", "600", "8191", "8192",
                                   "13312"])
def test_plan_covers_the_time_axis_exactly(which):
    rows = port.moments_chunk_rows(1)
    t_len = {"1": 1, "L-1": rows - 1, "L": rows, "L+1": rows + 1}.get(which)
    t_len = t_len or int(which)
    plan = port.moments_chunk_plan(t_len)
    covered = np.zeros(t_len, int)
    for start, stop in plan:
        assert 0 <= start < stop <= t_len
        assert stop - start <= port.moments_chunk_rows(t_len)
        covered[start:stop] += 1
    assert (covered == 1).all()
    assert [s for s, _ in plan] == sorted(s for s, _ in plan)
    assert len(plan) == -(-t_len // port.moments_chunk_rows(t_len))


@pytest.mark.parametrize("t_len,rows", [
    (1, 64), (600, 64), (1024, 64), (3072, 64), (4095, 64), (4096, 128),
    (7168, 128), (8192, 256), (13312, 256), (10 ** 6, 256),
])
def test_chunk_rows_follow_the_rule(t_len, rows):
    """The largest power of two in [64, 256] leaving at least 32 chunks."""
    assert port.moments_chunk_rows(t_len) == rows


def test_plan_depends_on_t_alone():
    assert list(inspect.signature(port.moments_chunk_rows).parameters) == ["t_len"]
    assert list(inspect.signature(port.moments_chunk_plan).parameters) == ["t_len"]
    first = port.moments_chunk_plan(13312)
    assert port.moments_chunk_plan(13312) == first
    rows = port.moments_chunk_rows(13312)
    assert first[1] == (rows, 2 * rows) and first[-1][1] == 13312


def test_kernel_launcher_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        port.masked_cumulative_moments_cuda(torch.zeros((4, 3)))
