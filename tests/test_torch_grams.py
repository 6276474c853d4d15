"""The port's Gram contraction vs the JAX package's.

Same float64 inputs (numpy, seeded; the thin-month, all-NaN-column,
y-less-firm, empty-universe and window-edge cases of the JAX kernel suite)
through ``fm_returnprediction_tpu``'s ``contract_spec_grams`` on its XLA
route and its Pallas kernel in interpret mode, and the port's
``contract_spec_grams`` on CPU tensors (the plain version of the Gram
kernel). Tolerance: 1e-12 of each (spec, month) block's max-abs entry,
counts exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_returnprediction_tpu.specgrid.grams import contract_spec_grams as jax_contract
from fm_returnprediction_tpu_torch.specgrid import grams as port

pytestmark = pytest.mark.torch_port


def _panel(seed=0, t=13, n=301, p=5, s=4, u=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, n, p))
    x[rng.random(x.shape) < 0.1] = np.nan
    x[:, 7, 2] = np.nan                       # an all-NaN firm column
    y = rng.standard_normal((t, n))
    y[rng.random(y.shape) < 0.15] = np.nan
    y[:, 11] = np.nan                         # a y-less firm
    universes = rng.random((u, t, n)) > 0.3
    universes[0, 3] = False                   # a month with an empty universe
    uidx = np.arange(s) % u
    col_sel = rng.random((s, p)) > 0.4
    col_sel[0] = [True] + [False] * (p - 1)   # univariate spec
    col_sel[-1] = True                        # full union spec
    window = np.ones((s, t), bool)
    window[s - 1, : min(6, t - 1)] = False    # subperiod window edge
    window[1, 0] = False
    return y, x, universes, uidx, col_sel, window


def _thin_month_panel():
    y, x, universes, uidx, col_sel, window = _panel(seed=3, t=7, n=137, p=4, s=3)
    universes[:, 5, 4:] = False               # month 5: at most 4 valid rows
    return y, x, universes, uidx, col_sel, window


_CASES = {
    "default": lambda: _panel(),
    "thin_month_ragged": _thin_month_panel,
    "wide": lambda: _panel(seed=5, t=9, n=700, p=9, s=6, u=3),
}


def _block_scale(stats):
    """(S, T) max-abs over each spec-month block of all five statistics."""
    gram, moment, n, ysum, yy = (np.asarray(a) for a in stats[:5])
    return np.maximum.reduce([
        np.abs(gram).max(axis=(-1, -2)), np.abs(moment).max(axis=-1),
        np.abs(n), np.abs(ysum), np.abs(yy),
    ])


def _assert_stats_close(port_stats, ref, rtol=1e-12):
    scale = np.maximum(_block_scale(ref), 1.0)
    for name in ("gram", "moment", "n", "ysum", "yy"):
        got = getattr(port_stats, name).numpy()
        want = np.asarray(getattr(ref, name))
        if name == "n":
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        s = scale.reshape(scale.shape + (1,) * (got.ndim - 2))
        assert np.all(np.abs(got - want) <= rtol * s), name
    np.testing.assert_allclose(port_stats.center.numpy(), np.asarray(ref.center),
                               rtol=1e-13, atol=0)


def _port_stats(args, **kw):
    return port.contract_spec_grams(*(torch.from_numpy(np.asarray(a)) for a in args), **kw)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_contraction_matches_jax_xla(case):
    args = _CASES[case]()
    ref = jax_contract(*(jnp.asarray(a) for a in args))
    _assert_stats_close(_port_stats(args), ref)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_contraction_matches_pallas_interpret(case):
    args = _CASES[case]()
    ref = jax_contract(*(jnp.asarray(a) for a in args), route="pallas",
                       block_n=128, interpret=True)
    _assert_stats_close(_port_stats(args), ref)


@pytest.mark.parametrize("chunk", [128, 256])
def test_contraction_is_chunk_invariant(chunk):
    args = _panel(seed=2)
    whole = _port_stats(args, firm_chunk=1024)
    part = _port_stats(args, firm_chunk=chunk)
    _assert_stats_close(part, whole)


def test_split_stats_reads_the_augmented_block():
    # [1 | x | y] for two rows: the augmented product holds every statistic
    a = torch.tensor([[1.0, 2.0, 3.0], [1.0, -1.0, 5.0]], dtype=torch.float64)
    out = (a.T @ a)[None, None]
    gram, moment, n, ysum, yy = port.split_stats(out, 1)
    assert float(n) == 2.0 and float(ysum) == 8.0 and float(yy) == 34.0
    np.testing.assert_array_equal(moment[0, 0].numpy(), [8.0, 1.0])
    np.testing.assert_array_equal(gram[0, 0].numpy(), [[2.0, 1.0], [1.0, 5.0]])


def test_gram_cuda_wrapper_refuses_cpu_tensors():
    y, x, universes, uidx, col_sel, window = (torch.from_numpy(np.asarray(a))
                                              for a in _panel())
    valid = universes[uidx].to(torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        port.gram_contract_cuda(y, x, valid, col_sel, port.shared_center(x))
