"""The port's masked cumulative moments (K3) vs the JAX package's Pallas
kernel.

Same float64 inputs (numpy, seeded) through
``fm_returnprediction_tpu.ops.pallas_kernels.masked_cumulative_moments`` in
interpret mode and the port's ``masked_cumulative_moments`` on CPU tensors
(the kernel's plain version). Tolerances: sums rtol 1e-10 / atol 1e-12 (the
Pallas kernel sums each block by a triangular matmul, the plain version
sequentially), counts exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_returnprediction_tpu.ops.pallas_kernels import (
    masked_cumulative_moments as jax_moments,
)
from fm_returnprediction_tpu_torch.ops import rolling as port

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def noisy_panel():
    rng = np.random.default_rng(23)
    x = 0.02 * rng.standard_normal((700, 40))
    x[rng.random(x.shape) < 0.07] = np.nan
    return x


@pytest.mark.parametrize("rows,cols,block_t", [(700, 40, 128), (391, 37, 64)])
def test_moments_match_pallas_interpret(noisy_panel, rows, cols, block_t):
    x = noisy_panel[:rows, :cols]
    want = jax_moments(jnp.asarray(x), block_t=block_t, block_n=128, interpret=True)
    got = port.masked_cumulative_moments(torch.from_numpy(x))
    for g, w, what in zip(got, want, ("csum", "csumsq", "ccnt")):
        assert g.dtype == torch.float64, what
        assert tuple(g.shape) == x.shape, what
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[2].numpy()[-1], np.isfinite(x).sum(0))


def test_moments_count_keeps_the_data_dtype(noisy_panel):
    x = torch.from_numpy(noisy_panel[:50, :5]).float()
    csum, csumsq, ccnt = port.masked_cumulative_moments(x)
    assert csum.dtype == csumsq.dtype == ccnt.dtype == torch.float32


def test_moments_dispatch_takes_plain_version_on_cpu(noisy_panel, monkeypatch):
    def refuse(x):
        raise AssertionError("the CUDA wrapper was called for a CPU tensor")

    monkeypatch.setattr(port, "masked_cumulative_moments_cuda", refuse)
    x = torch.from_numpy(noisy_panel)
    got = port.masked_cumulative_moments(x)
    want = port.masked_cumulative_moments_plain(x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_moments_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        port.masked_cumulative_moments_cuda(torch.zeros((4, 3)))
