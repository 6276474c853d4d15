"""The Gram contraction's options, the port vs the JAX package.

Row weights, bfloat16 operands, the factorized route (``window=None``,
``unique_pairs``, ``expand_window_stats``) and the bf16 tier of the solve,
on the same numpy inputs (seeded; the thin-month, all-NaN-column, y-less
firm, empty-universe and window-edge cases of the JAX kernel suite). The
JAX side runs its XLA route and, where its own tests do, its Pallas kernel
in interpret mode; the port's CPU tensors run the plain version.

Tolerances, as the JAX package pins its Pallas kernel against its XLA
route (``tests/test_gram_kernels.py``): row weights at 1e-6 (float32) and
1e-13 (float64) of each statistic's largest entry, with Σw at rtol 1e-6;
bfloat16 at 1e-6 of scale, stored float32, with counts exactly the full
precision route's when there are no weights. The factorized route and the
window expansion are exact sums of the same products: 1e-12 at float64,
counts equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fm_returnprediction_tpu.specgrid.grams import contract_spec_grams as jax_contract
from fm_returnprediction_tpu.specgrid.grams import unique_pairs as jax_unique_pairs
from fm_returnprediction_tpu.specgrid.solve import expand_window_stats as jax_expand
from fm_returnprediction_tpu.specgrid.solve import run_spec_grid as jax_run_grid
from fm_returnprediction_tpu.specgrid.solve import solve_spec_stats as jax_solve
from fm_returnprediction_tpu.specgrid.specs import Spec as JaxSpec
from fm_returnprediction_tpu.specgrid.specs import SpecGrid as JaxSpecGrid
from fm_returnprediction_tpu_torch.specgrid import grams as port
from fm_returnprediction_tpu_torch.specgrid import solve as port_solve
from fm_returnprediction_tpu_torch.specgrid.specs import Spec, SpecGrid

pytestmark = pytest.mark.torch_port

STATS = ("gram", "moment", "n", "ysum", "yy", "center")


def _panel(seed=0, t=13, n=301, p=5, s=4, u=2, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, n, p)).astype(dtype)
    x[rng.random(x.shape) < 0.1] = np.nan
    x[:, 7, 2] = np.nan                       # an all-NaN firm column
    y = rng.standard_normal((t, n)).astype(dtype)
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
    return [y, x, universes, uidx, col_sel, window]


def _row_weights(shape, dtype, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) * 2).astype(dtype)


def _jax(args, **kw):
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return jax_contract(*(None if a is None else jnp.asarray(a) for a in args), **kw)


def _port(args, **kw):
    kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return port.contract_spec_grams(
        *(None if a is None else torch.from_numpy(np.asarray(a)) for a in args), **kw)


def _close(got, ref, rtol, counts_exact=True, count_rtol=None):
    for name in STATS:
        g = getattr(got, name).numpy()
        r = np.asarray(getattr(ref, name))
        assert g.dtype == r.dtype, name
        if name == "n" and counts_exact:
            np.testing.assert_array_equal(g, r, err_msg=name)
        elif name == "n" and count_rtol is not None:
            np.testing.assert_allclose(g, r, rtol=count_rtol, atol=0, err_msg=name)
        scale = max(float(np.max(np.abs(r))), 1.0)
        np.testing.assert_allclose(g, r, rtol=0, atol=rtol * scale, err_msg=name)


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-6), (np.float64, 1e-13)])
def test_row_weights_match_xla(dtype, rtol):
    args = _panel(seed=5, dtype=dtype)
    rw = _row_weights(args[0].shape, dtype)
    _close(_port(args, row_weights=rw), _jax(args, row_weights=rw), rtol,
           counts_exact=False, count_rtol=1e-6)


def test_row_weights_match_pallas_interpret():
    args = _panel(seed=5)
    rw = _row_weights(args[0].shape, np.float32)
    ref = _jax(args, row_weights=rw, route="pallas", block_n=128, interpret=True)
    _close(_port(args, row_weights=rw), ref, 1e-6, counts_exact=False, count_rtol=1e-6)


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_bf16_matches_jax_counts_exact(route):
    args = _panel(seed=7)
    kw = dict(route="pallas", block_n=128, interpret=True) if route == "pallas" else {}
    ref = _jax(args, precision="bf16", **kw)
    got = _port(args, precision="bf16")
    assert got.gram.dtype == torch.float32
    _close(got, ref, 1e-6)
    # bf16 counts are the full-precision route's, exactly
    full = _jax([a.astype(np.float64) if a.dtype == np.float32 else a for a in args])
    np.testing.assert_array_equal(got.n.numpy(), np.asarray(full.n))
    # and the grams really sit at bf16 distance from that route
    d = np.max(np.abs(got.gram.numpy() - np.asarray(full.gram)))
    assert 1e-7 < d / np.max(np.abs(np.asarray(full.gram))) < 3e-2


def test_bf16_with_row_weights_matches_xla():
    args = _panel(seed=7)
    rw = _row_weights(args[0].shape, np.float32)
    _close(_port(args, precision="bf16", row_weights=rw),
           _jax(args, precision="bf16", row_weights=rw), 1e-6, counts_exact=False,
           count_rtol=1e-6)


# bf16 values by their bits: a sign, a 7-bit significand and an exponent
# that is normal (|v| near 1), tiny or large, or the value 0
_BF16_EXPONENTS = st.one_of(st.integers(-20, 20), st.integers(-59, -40),
                            st.integers(40, 63))
_BF16 = st.one_of(
    st.just(0),
    st.builds(lambda sign, e, m: sign << 15 | (e + 127) << 7 | m,
              st.integers(0, 1), _BF16_EXPONENTS, st.integers(0, 127)))


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(_BF16, _BF16), min_size=1, max_size=64))
def test_row_weight_split_is_exact(pairs):
    """The Gram kernel's row-weight split (csrc/gram.cu, bf16 operands): for
    bf16 w and a, w·a is exact in float32 (two 8-bit significands), and
    hi = bf16(w·a), lo = bf16(w·a − hi) add back to it exactly, so one
    tensor-core product on hi and one on lo sum the exact weighted term. The
    exponents keep |w·a| at 0 or within [2^-118, 2^128), where the
    remainder's at most 8 significant bits are a bf16 value (below 2^-118
    bf16's subnormals would cut them; no panel value is that small)."""
    bits = torch.tensor(pairs, dtype=torch.int32).to(torch.int16)
    w, a = bits.view(torch.bfloat16).float().unbind(-1)
    prod = w * a
    assert torch.equal(prod.double(), w.double() * a.double())
    hi = prod.to(torch.bfloat16)
    lo = (prod - hi.float()).to(torch.bfloat16)
    assert torch.equal(hi.float() + lo.float(), prod)


@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_window_none_matches(precision):
    args = _panel(seed=3)
    if precision == "highest":
        args = [a.astype(np.float64) if a.dtype == np.float32 else a for a in args]
    args[5] = None
    rtol = 1e-12 if precision == "highest" else 1e-6
    _close(_port(args, precision=precision), _jax(args, precision=precision), rtol)


def test_unique_pairs_and_window_expansion_match():
    uidx = np.array([0, 0, 1, 1, 0, 2])
    col_sel = np.array([[1, 0, 1], [1, 0, 1], [1, 1, 1], [1, 1, 1], [0, 1, 0],
                        [1, 0, 1]], bool)
    for pad in (None, 6):
        got = port.unique_pairs(uidx, col_sel, pad_to=pad)
        want = jax_unique_pairs(uidx, col_sel, pad_to=pad)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="pair pad"):
        port.unique_pairs(uidx, col_sel, pad_to=2)

    y, x, universes, _, _, _ = _panel(seed=4, t=9, n=211, p=3, u=3, dtype=np.float64)
    uidx_u, col_sel_u, pair_idx = port.unique_pairs(uidx, col_sel)
    window = np.ones((len(uidx), 9), bool)
    window[1, :4] = False
    window[3, 5:] = False
    args = [y, x, universes, uidx_u, col_sel_u, None]
    ref = jax_expand(_jax(args), jnp.asarray(pair_idx), jnp.asarray(window))
    got = port_solve.expand_window_stats(_port(args), torch.from_numpy(pair_idx).long(),
                                         torch.from_numpy(window))
    _close(got, ref, 1e-12)
    # the factorized stats are the per-spec windowed contraction's
    direct = _port([y, x, universes, uidx, col_sel, window])
    for name in STATS:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(direct, name).numpy(), rtol=1e-12, atol=1e-12)


def test_knobs_resolve_like_jax(monkeypatch):
    monkeypatch.delenv("FMRP_GRAM_PRECISION", raising=False)
    monkeypatch.delenv("FMRP_GRAM_FACTORIZE", raising=False)
    assert port.resolve_gram_precision() == "highest"
    assert port.resolve_gram_factorize() == "auto"
    monkeypatch.setenv("FMRP_GRAM_PRECISION", "BF16")
    monkeypatch.setenv("FMRP_GRAM_FACTORIZE", "off")
    assert port.resolve_gram_precision() == "bf16"
    assert port.resolve_gram_factorize() == "off"
    assert port.resolve_gram_precision("highest") == "highest"
    with pytest.raises(ValueError):
        port.resolve_gram_precision("fp8")
    with pytest.raises(ValueError):
        port.resolve_gram_factorize("maybe")
    with pytest.raises(ValueError):
        _port(_panel(), precision="fp8")


def test_spec_chunk_of_one_launch():
    assert port.gram_spec_chunk(14) == 60
    assert port.gram_spec_chunk(5) == 292
    assert port.gram_spec_chunk(32) == 13


def _collinear_grid(near: bool):
    """The JAX suite's bf16 promotion case: a nearly collinear pair (every
    month beyond 1/√eps(bf16)), or a well-conditioned one."""
    rng = np.random.default_rng(2)
    t, n = 6, 160
    base = rng.standard_normal((t, n)).astype(np.float32)
    other = (base + 1e-3 * rng.standard_normal((t, n)).astype(np.float32) if near
             else rng.standard_normal((t, n)).astype(np.float32))
    x = np.stack([base, other], axis=-1)
    y = (base + 0.1 * rng.standard_normal((t, n))).astype(np.float32)
    return y, x, {"all": np.ones((t, n), bool)}


@pytest.mark.parametrize("near", [True, False])
def test_bf16_promotion_matches_jax(near):
    """bf16 stats solved with bf16's eps flag the same months; the flagged
    spec is re-solved by the full-precision QR referee on both sides."""
    y, x, masks = _collinear_grid(near)
    want = jax_run_grid(y, x, masks, JaxSpecGrid((JaxSpec("m", ("c0", "c1"), "all"),),
                                                 union=("c0", "c1")),
                        precision="bf16", gram_route="xla")
    got = port_solve.run_spec_grid(
        torch.from_numpy(y), torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in masks.items()},
        SpecGrid((Spec("m", ("c0", "c1"), "all"),), union=("c0", "c1")), precision="bf16")
    np.testing.assert_array_equal(got.suspect_months, want.suspect_months)
    assert got.referee_specs == want.referee_specs == ((0,) if near else ())
    assert int(got.suspect_months[0]) == (6 if near else 0)
    for name in ("coef", "tstat", "mean_r2", "mean_n"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-4,
                                   atol=0, err_msg=name)


def test_contracted_eps_flags_like_jax():
    """``solve_spec_stats(contracted_eps=eps(bf16))`` on the same bf16 stats
    flags the same (spec, month) cells as the JAX solve."""
    y, x, masks = _collinear_grid(True)
    x2 = np.concatenate([x, _collinear_grid(False)[1][..., 1:]], axis=-1)
    universes = np.stack([masks["all"]])
    uidx = np.zeros(3, np.int64)
    col_sel = np.array([[1, 1, 0], [1, 0, 1], [0, 1, 1]], bool)
    window = np.ones((3, 6), bool)
    args = [y, x2, universes, uidx, col_sel, window]
    ref = _jax(args, precision="bf16")
    sel_aug = np.concatenate([np.ones((3, 1), bool), col_sel], axis=1)
    eps = float(jnp.finfo(jnp.bfloat16).eps)
    want = jax_solve(ref, jnp.asarray(sel_aug), contracted_eps=eps)
    got, _ = port_solve.solve_spec_stats(
        port.SpecGramStats(*(torch.from_numpy(np.asarray(a)) for a in ref)),
        torch.from_numpy(sel_aug), contracted_eps=eps)
    np.testing.assert_array_equal(got.suspect.numpy(), np.asarray(want.suspect))
    np.testing.assert_array_equal(got.month_valid.numpy(), np.asarray(want.month_valid))
    assert got.suspect.numpy()[0].all() and not got.suspect.numpy()[1:].any()


def test_eigh_in_slices_matches_one_call(monkeypatch):
    """A batch over ``EIGH_BATCH`` systems is decomposed in slices (the card's
    batched eigh refuses 70,200 systems); the solve's numbers are unchanged."""
    y, x, universes, uidx, col_sel, window = _panel(seed=8, t=7, n=211, p=4, s=3,
                                                    dtype=np.float64)
    stats = _port([y, x, universes, uidx, col_sel, window])
    sel_aug = torch.from_numpy(np.concatenate([np.ones((3, 1), bool), col_sel], axis=1))
    whole, _ = port_solve.solve_spec_stats(stats, sel_aug)
    monkeypatch.setattr(port_solve, "EIGH_BATCH", 5)
    sliced, _ = port_solve.solve_spec_stats(stats, sel_aug)
    for a, b in zip(whole, sliced):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-14, equal_nan=True)
