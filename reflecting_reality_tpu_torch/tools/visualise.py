"""Inference visualizer, the port's copy of
`reflecting_reality_tpu/tools/visualise.py` (reference:
examples/brushnet/visualise.py — a FiftyOne app over inference dirs with
eval CSV metric fields and subset tags).

The default backend is a self-contained static HTML gallery: every uid's
grid sheet plus its per-seed metric values from eval_*.csv / eval_best.csv,
client-side sortable by any metric and filterable by subset tag (novel /
small_mirrors / abo, derived from the path column like the reference
:74-203).  `--backend fiftyone` launches the same dataset in the FiftyOne
app and needs the fiftyone package.

Usage:
  python -m reflecting_reality_tpu_torch.tools.visualise --infer_dir <dir> \
    [--eval_csv eval] [--test_csv test.csv] [--backend html|fiftyone]
"""

from __future__ import annotations

import argparse
import html
import json
import os
from typing import Dict, List, Optional

SUBSETS = {
    "abo": lambda path: path.startswith("abo"),
    "novel": lambda path: "novel" in path,
    "small_mirrors": lambda path: "small" in path,
}

_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>MirrorFusion results — {title}</title>
<style>
body{{font-family:system-ui;margin:1rem;background:#111;color:#eee}}
.card{{display:inline-block;margin:8px;padding:8px;background:#1c1c1c;border-radius:8px;vertical-align:top}}
.card img{{max-width:320px;display:block;border-radius:4px}}
.card table{{font-size:11px;color:#aaa;margin-top:4px}}
.controls{{margin-bottom:1rem}}
select,input{{background:#222;color:#eee;border:1px solid #444;padding:4px}}
</style></head><body>
<h2>MirrorFusion — {title}</h2>
<div class="controls">
sort by <select id="sort"></select>
<label><input type="checkbox" id="desc" checked> desc</label>
subset <select id="subset"><option value="">all</option></select>
</div>
<div id="grid"></div>
<script>
const data = {data};
const metrics = {metrics};
const sortSel = document.getElementById('sort');
const subsetSel = document.getElementById('subset');
metrics.forEach(m => sortSel.add(new Option(m, m)));
[...new Set(data.flatMap(d => d.tags))].forEach(t => subsetSel.add(new Option(t, t)));
function render(){{
  const m = sortSel.value, desc = document.getElementById('desc').checked;
  const sub = subsetSel.value;
  let rows = data.filter(d => !sub || d.tags.includes(sub));
  if (m) rows = rows.slice().sort((a,b) => (desc?-1:1)*((a.metrics[m]??-1e9)-(b.metrics[m]??-1e9)));
  document.getElementById('grid').innerHTML = rows.map(d => `
    <div class="card"><img loading="lazy" src="${{d.img}}">
    <b>${{d.uid}}</b> ${{d.tags.join(' ')}}
    <table>${{Object.entries(d.metrics).map(([k,v]) =>
      `<tr><td>${{k}}</td><td>${{v==null?'–':v.toFixed(4)}}</td></tr>`).join('')}}</table></div>`).join('');
}}
sortSel.onchange = subsetSel.onchange = document.getElementById('desc').onchange = render;
render();
</script></body></html>"""


def collect(infer_dir: str, eval_csv: str = "eval",
            test_csv: Optional[str] = None) -> List[Dict]:
    import pandas as pd

    uids = sorted(u[:-4] for u in os.listdir(infer_dir) if u.endswith(".png"))
    frames = {}
    best_path = os.path.join(infer_dir, f"{eval_csv}_best.csv")
    if os.path.exists(best_path):
        frames["best"] = pd.read_csv(best_path)
    i = 0
    while os.path.exists(os.path.join(infer_dir, f"{eval_csv}_{i}.csv")):
        frames[f"seed{i}"] = pd.read_csv(os.path.join(infer_dir, f"{eval_csv}_{i}.csv"))
        i += 1

    paths = {}
    if test_csv and os.path.exists(test_csv):
        df = pd.read_csv(test_csv)
        if "uid" in df and "path" in df:
            from reflecting_reality_tpu_torch.metrics.evaluate import transform_uid

            df = transform_uid(df)
            paths = dict(zip(df["uid"], df["path"]))

    cards = []
    for uid in uids:
        metrics = {}
        for tag, df in frames.items():
            row = df[df["uid"] == uid]
            if len(row):
                for col in df.columns:
                    if col in ("uid", "select_img_index"):
                        continue
                    v = row.iloc[0][col]
                    try:
                        v = float(v)
                    except (TypeError, ValueError):
                        continue
                    if v == v:  # not NaN
                        metrics[f"{tag}/{col}"] = v
        path = str(paths.get(uid, ""))
        tags = [name for name, f in SUBSETS.items() if path and f(path)]
        cards.append({"uid": uid, "img": f"{uid}.png", "metrics": metrics, "tags": tags})
    return cards


def write_html(infer_dir: str, cards: List[Dict], out_name: str = "index.html") -> str:
    metric_names = sorted({m for c in cards for m in c["metrics"]})
    page = _PAGE.format(
        title=html.escape(os.path.basename(os.path.abspath(infer_dir))),
        data=json.dumps(cards),
        metrics=json.dumps(metric_names),
    )
    out = os.path.join(infer_dir, out_name)
    with open(out, "w") as f:
        f.write(page)
    return out


def launch_fiftyone(infer_dir: str, cards: List[Dict]):  # pragma: no cover
    try:
        import fiftyone as fo
    except ImportError:
        raise RuntimeError("--backend fiftyone needs the fiftyone package, which is not "
                           "installed; the default --backend html needs none") from None

    ds = fo.Dataset()
    for c in cards:
        sample = fo.Sample(filepath=os.path.join(infer_dir, c["img"]), tags=c["tags"])
        for k, v in c["metrics"].items():
            sample[k.replace("/", "_")] = v
        ds.add_sample(sample)
    session = fo.launch_app(ds)
    session.wait()


def main(argv=None):
    p = argparse.ArgumentParser(description="Visualize inference results")
    p.add_argument("--infer_dir", type=str, required=True)
    p.add_argument("--eval_csv", type=str, default="eval")
    p.add_argument("--test_csv", type=str, default=None)
    p.add_argument("--backend", type=str, default="html", choices=["html", "fiftyone"])
    args = p.parse_args(argv)

    cards = collect(args.infer_dir, args.eval_csv, args.test_csv)
    if args.backend == "fiftyone":
        launch_fiftyone(args.infer_dir, cards)
    else:
        out = write_html(args.infer_dir, cards)
        print(f"wrote {out} ({len(cards)} samples)")


if __name__ == "__main__":
    main()
