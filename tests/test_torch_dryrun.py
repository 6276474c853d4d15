"""The port's dry run (``dryrun.py``) against the reference's entry
points (``__graft_entry__.py``) on the CPU.

``entry(device="cpu")`` runs the FM step on the same tiny float32 panel as
``__graft_entry__.entry()``: coefficients and the mean R² at 1e-6. The
float32 t-stats of the two packages are 1.46e-5 (relative) apart, each
within 1e-5 of the float64 FM on the same panel (7.5e-6 and 7.1e-6): the
Newey-West SE divides float32 slope deviations about a mean 195 SEs from
zero, so their rounding reaches it ~200-fold. They are held at 2e-5 to
each other and at 1e-5 to the float64 step. ``dryrun_multichip(n, device="cpu")`` runs every sharding pattern on
``n`` virtual CPU positions, each held against its one-device counterpart
inside the function, and leaves ``FMRP_VIRTUAL_DEVICES`` as it found it.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from fm_returnprediction_tpu_torch import dryrun

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]


def _graft():
    spec = importlib.util.spec_from_file_location("graft_entry", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_matches_the_reference_step():
    fn, args = dryrun.entry(device="cpu")
    ref_fn, ref_args = _graft().entry()
    for a, b in zip(args, ref_args):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = [a.numpy() for a in fn(*args)]
    want = [np.asarray(a) for a in ref_fn(*ref_args)]
    truth = [a.numpy() for a in fn(args[0].double(), args[1].double(), args[2])]
    assert all(a.dtype == np.float32 for a in got)
    for name, k in (("coef", 0), ("mean_r2", 2)):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got[1], want[1], rtol=2e-5, err_msg="tstat")
    for side in (got, want):
        np.testing.assert_allclose(side[1], truth[1], rtol=1e-5, err_msg="tstat vs float64")
        np.testing.assert_allclose(side[0], truth[0], rtol=1e-5, atol=1e-6,
                                   err_msg="coef vs float64")


@pytest.mark.parametrize("n, prior", [(4, None), (3, "2")])
def test_dryrun_multichip_on_the_cpu(monkeypatch, n, prior):
    if prior is None:
        monkeypatch.delenv("FMRP_VIRTUAL_DEVICES", raising=False)
    else:
        monkeypatch.setenv("FMRP_VIRTUAL_DEVICES", prior)
    gaps = dryrun.dryrun_multichip(n, device="cpu")
    want = {"fm_sharded_slopes", "bootstrap_se", "daily_vol", "daily_beta",
            "time_sharded_std", "time_sharded_beta"} | ({"hier_slopes"} if n % 2 == 0 else set())
    assert set(gaps) == want
    assert all(np.isfinite(v) for v in gaps.values()), gaps
    import os
    assert os.environ.get("FMRP_VIRTUAL_DEVICES") == prior


def test_dryrun_without_a_card_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()
