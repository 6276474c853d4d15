"""Artifact persistence and LaTeX report generation/compilation.

Re-provides the reference's ``save_data`` / ``create_latex_document_from_pkl``
/ ``compile_latex_document`` (``src/calc_Lewellen_2014.py:959-1231``) with the
same artifact set — ``table_1.pkl``, ``table_2.pkl``, ``table_1.tex``,
``table_2.tex``, ``figure_1.pdf``, ``data_saved.marker``,
``research_report.tex`` (+ ``.pdf`` when ``pdflatex`` exists) — but honoring
the configured OUTPUT_DIR instead of a hardcoded relative path (the
reference's ``../_output`` cwd-dependence is defect SURVEY §2.2.12).
"""

from __future__ import annotations

import shutil
import subprocess
from datetime import datetime
from pathlib import Path
from typing import Optional

import pandas as pd

__all__ = [
    "save_data",
    "check_if_data_saved",
    "create_latex_document",
    "compile_latex_document",
]


def save_data(table_1: pd.DataFrame, table_2: pd.DataFrame, figure_1, output_dir) -> Path:
    """Persist tables (pickle + LaTeX), the figure PDF, and the marker file."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    table_1.to_pickle(output_dir / "table_1.pkl")
    table_2.to_pickle(output_dir / "table_2.pkl")
    (output_dir / "table_1.tex").write_text(
        table_1.to_latex(index=True, bold_rows=True, multicolumn=True)
    )
    (output_dir / "table_2.tex").write_text(
        table_2.to_latex(index=True, bold_rows=True, multicolumn=True)
    )
    if figure_1 is not None:
        fig = figure_1[0] if isinstance(figure_1, tuple) else figure_1
        fig.savefig(output_dir / "figure_1.pdf", bbox_inches="tight")

    marker = output_dir / "data_saved.marker"
    marker.write_text(f"Data saved successfully at {datetime.now().isoformat()}")
    return marker


def check_if_data_saved(output_dir) -> bool:
    return (Path(output_dir) / "data_saved.marker").exists()


def create_latex_document(output_dir) -> Optional[Path]:
    """Build ``research_report.tex`` from the pickled tables + figure PDF.

    The document template below (section titles, captions, labels,
    ``\\FloatBarrier`` placement, 0.9\\textwidth figure) reproduces the
    reference's output-artifact contract nearly verbatim — the ``.tex``
    IS the artifact users diff — from
    ``src/calc_Lewellen_2014.py:1099-1137``; it is a format contract,
    not shared code."""
    output_dir = Path(output_dir)
    table1_pkl = output_dir / "table_1.pkl"
    table2_pkl = output_dir / "table_2.pkl"
    figure_pdf = output_dir / "figure_1.pdf"
    missing = [str(p) for p in (table1_pkl, table2_pkl, figure_pdf) if not p.exists()]
    if missing:
        print("Missing files:", ", ".join(missing))
        return None

    df1 = pd.read_pickle(table1_pkl)
    df2 = pd.read_pickle(table2_pkl)
    latex_table1 = df1.to_latex(index=False, float_format="%.4f", escape=True)
    latex_table2 = df2.to_latex(index=False, float_format="%.4f", escape=True)

    doc = f"""\\documentclass[12pt]{{article}}
\\usepackage{{booktabs}}
\\usepackage{{graphicx}}
\\usepackage{{caption}}
\\usepackage{{geometry}}
\\usepackage{{multirow}}
\\usepackage{{placeins}}
\\geometry{{margin=1in}}

\\title{{Return Prediction Results}}
\\author{{fm\\_returnprediction\\_tpu}}
\\date{{{datetime.now().strftime('%B %d, %Y')}}}

\\begin{{document}}

\\maketitle

\\section{{Data Summary}}

\\begin{{table}}
\\centering
\\caption{{Summary Statistics}}
\\label{{tab:table1}}
{latex_table1}
\\end{{table}}

\\clearpage
\\section{{Regression Results}}

\\begin{{table}}
\\centering
\\caption{{Return Predictability}}
\\label{{tab:table2}}
{latex_table2}
\\end{{table}}

\\clearpage
\\section{{Time-Series Patterns}}
\\FloatBarrier

\\begin{{figure}}
\\caption{{Time-series of return predictability.}}
\\centering
\\includegraphics[width=0.9\\textwidth]{{{figure_pdf.name}}}
\\label{{fig:figure1}}
\\end{{figure}}

\\end{{document}}
"""
    out = output_dir / "research_report.tex"
    out.write_text(doc, encoding="utf-8")
    return out


def compile_latex_document(tex_file_path) -> Optional[Path]:
    """Compile with pdflatex (two passes, continue on error); returns the PDF
    path or None when pdflatex is unavailable or compilation fails."""
    pdflatex = shutil.which("pdflatex")
    if pdflatex is None:
        print("pdflatex not found in PATH; skipping PDF compilation.")
        return None
    tex_file_path = Path(tex_file_path)
    if not tex_file_path.exists():
        print(f"LaTeX file not found at {tex_file_path}")
        return None
    for _ in range(2):
        subprocess.run(
            [pdflatex, "-interaction=nonstopmode", tex_file_path.name],
            cwd=tex_file_path.parent,
            capture_output=True,
            text=True,
        )
    pdf_path = tex_file_path.with_suffix(".pdf")
    return pdf_path if pdf_path.exists() else None
