"""The Lewellen (2015) model zoo.

Three nested cross-sectional predictor sets, run over three size universes
each. Display names match the reference's ``variables_dict`` keys exactly
(Table 2 row labels depend on them).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

__all__ = ["ModelSpec", "MODELS", "FIGURE1_VARS", "model_columns"]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    predictors: List[str]  # display names, in Table 2 row order


MODELS: List[ModelSpec] = [
    ModelSpec(
        "Model 1: Three Predictors",
        ["Log Size (-1)", "Log B/M (-1)", "Return (-2, -12)"],
    ),
    ModelSpec(
        "Model 2: Seven Predictors",
        [
            "Log Size (-1)",
            "Log B/M (-1)",
            "Return (-2, -12)",
            "Log Issues (-1,-36)",
            "Accruals (-1)",
            "ROA (-1)",
            "Log Assets Growth (-1)",
        ],
    ),
    ModelSpec(
        "Model 3: Fourteen Predictors",
        [
            "Log Size (-1)",
            "Log B/M (-1)",
            "Return (-2, -12)",
            "Log Issues (-1,-12)",
            "Accruals (-1)",
            "ROA (-1)",
            "Log Assets Growth (-1)",
            "Dividend Yield (-1,-12)",
            "Log Return (-13,-36)",
            "Log Issues (-1,-36)",
            "Beta (-1,-36)",
            "Std Dev (-1,-12)",
            "Debt/Price (-1)",
            "Sales/Price (-1)",
        ],
    ),
]

# Figure 1 plots Model-2 slopes but with its OWN 5-variable set (panel
# column → legend label), not the 7-predictor Model 2.
FIGURE1_VARS: Dict[str, str] = {
    "log_bm": "B/M",
    "return_12_2": "Ret12",
    "log_issues_36": "Issue36",
    "accruals_final": "Accruals",
    "log_assets_growth": "Log AG",
}


def model_columns(model: ModelSpec, variables_dict: Dict[str, str]) -> List[str]:
    """Panel column names for a model's display-label predictors."""
    xvars = []
    for label in model.predictors:
        if label not in variables_dict:
            raise ValueError(f"'{label}' not found in variables_dict!")
        xvars.append(variables_dict[label])
    return xvars
