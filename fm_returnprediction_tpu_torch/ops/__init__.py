"""The compute core of the port: batched OLS, Fama-MacBeth and Newey-West
reductions, rolling windows (the rolling kernels on the card), compaction,
masked quantiles and winsorizing. Functions take and return torch tensors
on the caller's device; importing this package builds and loads no kernel
(the first launch does)."""

from fm_returnprediction_tpu_torch.ops.compaction import (
    Compaction,
    compact,
    lag,
    make_compaction,
    scatter_back,
)
from fm_returnprediction_tpu_torch.ops.fama_macbeth import (
    FamaMacbethSummary,
    fama_macbeth,
    fama_macbeth_summary,
)
from fm_returnprediction_tpu_torch.ops.newey_west import compact_front, nw_mean_se
from fm_returnprediction_tpu_torch.ops.ols import (
    CSRegressionResult,
    monthly_cs_ols,
    row_validity,
)
from fm_returnprediction_tpu_torch.ops.quantiles import masked_quantile, winsorize_cs
from fm_returnprediction_tpu_torch.ops.rolling import (
    rolling_mean,
    rolling_prod,
    rolling_std,
    rolling_sum,
    windowed_count,
    windowed_sum,
)

__all__ = [
    "Compaction", "compact", "lag", "make_compaction", "scatter_back",
    "FamaMacbethSummary", "fama_macbeth", "fama_macbeth_summary",
    "compact_front", "nw_mean_se",
    "CSRegressionResult", "monthly_cs_ols", "row_validity",
    "masked_quantile", "winsorize_cs",
    "rolling_mean", "rolling_prod", "rolling_std", "rolling_sum",
    "windowed_count", "windowed_sum",
]
