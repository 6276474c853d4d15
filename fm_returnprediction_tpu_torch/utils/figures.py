"""Figure persistence helper."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

__all__ = ["save_figure"]


def save_figure(fig, plot_name_prefix: str, output_dir: Optional[Union[Path, str]] = None,
                dpi: int = 300) -> Path:
    """Save a matplotlib figure as ``<prefix>.png`` under ``output_dir``
    (defaults to the current working directory)."""
    output_dir = Path(output_dir) if output_dir is not None else Path.cwd()
    output_dir.mkdir(parents=True, exist_ok=True)
    plot_path = output_dir / f"{plot_name_prefix}.png"
    fig.savefig(plot_path, dpi=dpi, bbox_inches="tight")
    return plot_path
