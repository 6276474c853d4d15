"""The port's rolling family vs the JAX package's.

Same float64 inputs (numpy, seeded) through ``fm_returnprediction_tpu``'s
XLA route, its fused Pallas kernel in interpret mode, and the port's
``rolling_*`` on CPU tensors (the plain version of the rolling kernel).
Tolerance: rtol 1e-10 with an identical NaN pattern (both sides take
cumulative-sum differences, summed in a different order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_returnprediction_tpu.ops import rolling as jax_rolling
from fm_returnprediction_tpu.ops.pallas_kernels import (
    rolling_mean_fused,
    rolling_std_fused,
    rolling_sum_fused,
)
from fm_returnprediction_tpu_torch.ops import rolling as port

pytestmark = pytest.mark.torch_port

_FUSED = {"sum": rolling_sum_fused, "mean": rolling_mean_fused,
          "std": rolling_std_fused}


def _case(name):
    rng = np.random.default_rng(7)
    if name == "noisy":          # NaN holes, long series
        x = 1.0 + 0.3 * rng.standard_normal((300, 24))
        x[rng.random(x.shape) < 0.07] = np.nan
    elif name == "all_nan_cols":  # whole columns missing
        x = 1.0 + 0.3 * rng.standard_normal((80, 12))
        x[:, [0, 5]] = np.nan
    elif name == "short":         # series shorter than the window
        x = 1.0 + 0.3 * rng.standard_normal((10, 6))
        x[:3, 2] = np.nan
    elif name == "compacted":     # valid rows packed to the front, NaN tail
        x = 1.0 + 0.3 * rng.standard_normal((120, 16))
        counts = rng.integers(0, 121, 16)
        x[np.arange(120)[:, None] >= counts[None, :]] = np.nan
    else:
        raise KeyError(name)
    return x


# (window, min_periods) pairs at the min_periods edges (0, 1, 2, the full
# window) and the pipeline's own settings
_WINDOWS = [(12, 0), (12, 1), (12, 12), (24, 24), (30, 2)]


def _assert_same(port_out, ref, what):
    np.testing.assert_array_equal(np.isnan(port_out), np.isnan(ref), err_msg=what)
    np.testing.assert_allclose(port_out, ref, rtol=1e-10, atol=0,
                               equal_nan=True, err_msg=what)


@pytest.mark.parametrize("case", ["noisy", "all_nan_cols", "short", "compacted"])
@pytest.mark.parametrize("kind", ["sum", "mean", "std"])
def test_rolling_matches_jax_xla(case, kind):
    x = _case(case)
    for window, mp in _WINDOWS + [(252, 100)]:
        got = getattr(port, f"rolling_{kind}")(torch.from_numpy(x), window, mp).numpy()
        want = np.asarray(getattr(jax_rolling, f"rolling_{kind}")(
            jnp.asarray(x), window, mp, use_pallas=False))
        _assert_same(got, want, f"{kind} w={window} mp={mp}")


@pytest.mark.parametrize("case", ["noisy", "all_nan_cols", "short"])
@pytest.mark.parametrize("kind", ["sum", "mean", "std"])
def test_rolling_matches_pallas_interpret(case, kind):
    x = _case(case)
    for window, mp in ((12, 1), (24, 24), (40, 2)):
        got = port.rolling_reduce_plain(torch.from_numpy(x), window, mp, kind).numpy()
        want = np.asarray(_FUSED[kind](jnp.asarray(x), window, mp, block_t=64,
                                       block_n=128, interpret=True))
        _assert_same(got, want, f"{kind} w={window} mp={mp}")


@pytest.mark.parametrize("case", ["noisy", "short", "compacted"])
def test_rolling_prod_matches_jax(case):
    x = _case(case)
    for window, mp in ((11, 11), (5, 1), (3, 0)):
        got = port.rolling_prod(torch.from_numpy(x), window, mp).numpy()
        want = np.asarray(jax_rolling.rolling_prod(jnp.asarray(x), window, mp))
        _assert_same(got, want, f"prod w={window} mp={mp}")


def test_rolling_dispatch_takes_plain_version_on_cpu():
    x = torch.from_numpy(_case("noisy"))
    before = port.rolling_reduce_cuda.launches
    out = port.rolling_std(x, 24, 5)
    assert port.rolling_reduce_cuda.launches == before
    np.testing.assert_array_equal(
        out.numpy(), port.rolling_reduce_plain(x, 24, 5, "std").numpy())


def test_rolling_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        port.rolling_reduce_cuda(torch.zeros((4, 3)), 2, 1, "sum")
