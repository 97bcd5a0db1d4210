"""Static HTML viewer over the cluster figure tree.

Serves the same purpose as the reference's report generator (reference:
diffmining/typicality/make-html.py) but is an original design, not a
reproduction of its template: instead of hard-coding the ranked-figure
filename pattern into the page script, the generator embeds the discovered
figure inventory as JSON and the page resolves images by lookup — so any
figure naming the mining stage emits keeps working. Controls are <select>
dropdowns with prev/next keyboard navigation. Pure filesystem work — no deps.
The port's own copy of diffmining_tpu/typicality/make_html.py; it runs on
the host:

    python -m diffmining_tpu_torch html FIGURES_DIR [OUTPUT_DIR] [NC]

Directory contract (what the mining stage writes, typicality/cluster.py):
    {figures_dir}/{pt|ft}/{t_min-t_max}/clusters/{category}__*.png
"""
from __future__ import annotations

import json
import os
import shutil
import sys
from os.path import join, relpath


def scan_figures(figures_dir: str):
    """-> {(model, trange, category): relative_figure_path}, preferring the
    'ranked' figure when a category has several."""
    inventory = {}
    for root, _dirs, files in os.walk(figures_dir):
        parts = root.split(os.sep)
        if parts[-1] != "clusters" or len(parts) < 3:
            continue
        model, trange = parts[-3], parts[-2]
        for file in sorted(files):
            if not file.endswith(".png"):
                continue
            category = file.split("__")[0]
            key = (model, trange, category)
            if key not in inventory or "ranked" in file:
                inventory[key] = relpath(join(root, file), os.path.dirname(figures_dir.rstrip(os.sep)))
    return inventory


_PAGE = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>diffmining — typicality clusters</title>
<style>
  body {{ font-family: system-ui, sans-serif; margin: 1.5rem; }}
  .controls {{ display: flex; gap: 2rem; flex-wrap: wrap; margin-bottom: 1rem; }}
  .controls label {{ font-weight: 600; margin-right: .4rem; }}
  figure {{ margin: 0; }}
  figcaption {{ color: #555; font-size: .85rem; margin-bottom: .5rem; }}
  img {{ max-width: 100%; border: 1px solid #ddd; }}
</style>
</head>
<body>
<h1>Typicality cluster report</h1>
<div class="controls">
  <span><label for="category">category</label><select id="category"></select></span>
  <span><label for="model">model</label><select id="model"></select></span>
  <span><label for="trange">t-range</label><select id="trange"></select></span>
</div>
<figure>
  <figcaption id="caption"></figcaption>
  <img id="figure" alt="cluster figure">
</figure>
<script>
const FIGURES = {figures_json};
const axes = ["model", "trange", "category"];
function values(axis) {{
  const i = axes.indexOf(axis);
  return [...new Set(Object.keys(FIGURES).map(k => k.split("\\u0000")[i]))].sort();
}}
function fill(id, vals) {{
  const el = document.getElementById(id);
  el.innerHTML = vals.map(v => `<option value="${{v}}">${{v}}</option>`).join("");
}}
function current() {{
  return axes.map(a => document.getElementById(a).value).join("\\u0000");
}}
function show() {{
  const key = current();
  const img = document.getElementById("figure");
  const path = FIGURES[key];
  img.src = path || "";
  document.getElementById("caption").textContent =
      path ? path : "no figure for this selection";
}}
["category", "model", "trange"].forEach(id =>
  document.getElementById(id).addEventListener("change", show));
document.addEventListener("keydown", e => {{
  if (e.key !== "ArrowLeft" && e.key !== "ArrowRight") return;
  const el = document.getElementById("category");
  const step = e.key === "ArrowRight" ? 1 : -1;
  el.selectedIndex = (el.selectedIndex + step + el.length) % el.length;
  show();
}});
fill("model", values("model"));
fill("trange", values("trange"));
fill("category", values("category"));
show();
</script>
</body>
</html>
"""


def generate_html(figures_dir: str, output_dir: str = "blurred-html", nc: str = "32") -> str:
    """Build index.html + copy the figure tree. `nc` is accepted for CLI
    compatibility with the reference's argument order but unused — figures
    are discovered, not pattern-matched."""
    figures_dir = os.path.abspath(figures_dir)
    output_dir = os.path.abspath(output_dir)
    figures_name = os.path.basename(figures_dir.rstrip(os.sep))

    inventory = scan_figures(figures_dir)
    figures_json = json.dumps(
        {"\u0000".join(k): v for k, v in sorted(inventory.items())}, indent=0
    )

    os.makedirs(output_dir, exist_ok=True)
    shutil.copytree(figures_dir, join(output_dir, figures_name), dirs_exist_ok=True)
    index = join(output_dir, "index.html")
    with open(index, "w") as f:
        f.write(_PAGE.format(figures_json=figures_json))
    return index


def main(argv=None) -> str:
    """``html FIGURES_DIR [OUTPUT_DIR] [NC]``: the reference's positional
    arguments; returns the index path."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or len(argv) > 3 or "-h" in argv or "--help" in argv:
        raise SystemExit("usage: html <figures_dir> [output_dir] [nc]")
    return generate_html(*argv)


if __name__ == "__main__":
    main()
