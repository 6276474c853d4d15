"""Static documentation site builder.

Renders the repo's markdown docs plus the executed-notebook HTML into one
self-contained static site: the ``markdown`` package inside a minimal HTML
shell, written as a browsable ``docs/site/`` for GitHub Pages (with its
``.nojekyll`` marker). The reference package's builder, page for page.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Dict, List

__all__ = ["build_docs_site"]

_PAGE = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>{title}</title>
<style>
body {{ font: 16px/1.55 system-ui, sans-serif; margin: 0; color: #1a1a1a; }}
nav {{ background: #15243b; padding: .6rem 1.2rem; }}
nav a {{ color: #cfe0ff; margin-right: 1.1rem; text-decoration: none; }}
nav a:hover {{ text-decoration: underline; }}
main {{ max-width: 54rem; margin: 0 auto; padding: 1.5rem; }}
pre {{ background: #f5f6f8; padding: .8rem; overflow-x: auto; border-radius: 6px; }}
code {{ background: #f5f6f8; padding: .1rem .25rem; border-radius: 4px; }}
table {{ border-collapse: collapse; }}
td, th {{ border: 1px solid #d8dce3; padding: .3rem .6rem; }}
</style>
</head>
<body>
<nav>{nav}</nav>
<main>{body}</main>
</body>
</html>
"""


def _render_markdown(text: str) -> str:
    import markdown

    return markdown.markdown(
        text, extensions=["tables", "fenced_code", "toc"]
    )


def build_docs_site(
    base_dir: Path,
    site_dir: Path,
    pages: Dict[str, Path] | None = None,
) -> List[Path]:
    """Render ``pages`` (title → markdown path) plus any notebook HTML under
    ``docs/notebooks`` into ``site_dir``. Returns the written paths."""
    base_dir = Path(base_dir)
    site_dir = Path(site_dir)
    site_dir.mkdir(parents=True, exist_ok=True)

    if pages is None:
        pages = {"Overview": base_dir / "README.md"}
        for md in sorted((base_dir / "docs").glob("*.md")):
            title = md.stem.replace("_", " ").title()
            if title in pages:  # never clobber an earlier page (e.g. the README)
                title = f"{title} ({md.stem})"
            pages[title] = md
    pages = {title: path for title, path in pages.items() if Path(path).is_file()}

    notebooks = sorted((base_dir / "docs" / "notebooks").glob("*.html"))

    # "index" is reserved for the Overview/README landing page; any other
    # title whose slug collides with one already taken gets a numeric suffix
    slugs: Dict[str, str] = {}
    taken = set()
    for title in pages:
        s = "index" if title == "Overview" else title.lower().replace(" ", "-")
        if s == "index" and title != "Overview":
            s = "index-page"
        base_slug, k = s, 2
        while s in taken:
            s = f"{base_slug}-{k}"
            k += 1
        taken.add(s)
        slugs[title] = s

    nav = "".join(
        f'<a href="{slugs[t]}.html">{t}</a>' for t in pages
    ) + "".join(f'<a href="notebooks/{nb.name}">{nb.stem}</a>' for nb in notebooks)

    written = []
    for title, path in pages.items():
        html = _PAGE.format(
            title=title, nav=nav, body=_render_markdown(Path(path).read_text())
        )
        out = site_dir / f"{slugs[title]}.html"
        out.write_text(html)
        written.append(out)

    if notebooks:
        nb_dir = site_dir / "notebooks"
        nb_dir.mkdir(exist_ok=True)
        for nb in notebooks:
            shutil.copy2(nb, nb_dir / nb.name)
            written.append(nb_dir / nb.name)

    # GitHub Pages marker
    nojekyll = site_dir / ".nojekyll"
    nojekyll.write_text("")
    written.append(nojekyll)
    return written
