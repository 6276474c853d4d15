"""Model layer of the port: the Lewellen predictor sets and the
out-of-sample forecasts."""

from fm_returnprediction_tpu_torch.models.forecast import (
    DecileSortResult,
    ForecastResult,
    decile_sorts,
    rolling_er_forecast,
)
from fm_returnprediction_tpu_torch.models.lewellen import (
    FIGURE1_VARS,
    MODELS,
    ModelSpec,
    model_by_name,
)

__all__ = [
    "DecileSortResult",
    "ForecastResult",
    "decile_sorts",
    "rolling_er_forecast",
    "FIGURE1_VARS",
    "MODELS",
    "ModelSpec",
    "model_by_name",
]
