"""Fill a Markdown file's dry-run placeholders from the port's dry-run
JSON records (``launch.dryrun`` and ``launch.graph_dryrun``).

    PYTHONPATH=src python tools/fill_experiments_torch.py TARGET.md \
        [--dir experiments/dryrun_torch]

TARGET.md holds ``<!-- DRYRUN_SUMMARY -->`` and ``<!-- ROOFLINE_TABLE -->``
markers; the text after each, up to the next blank line followed by a
heading (or the end of the file), is replaced: the summary of every mesh,
then one roofline table a mesh.  A marker that is absent is left out.
"""
import argparse
import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.roofline.report import (MESHES, dryrun_summary,  # noqa: E402
                                         load_records, roofline_table)

ROOT = os.path.join(os.path.dirname(__file__), "..")
TITLES = {"single": "Single pod (256 cards)", "multipod":
          "Multi-pod (512 cards)", "card": "One card (H100)"}


def fill(text: str, recs) -> str:
    until = r"(?=\n\n#|\Z)"
    text = re.sub(r"<!-- DRYRUN_SUMMARY -->.*?" + until,
                  lambda _: "<!-- DRYRUN_SUMMARY -->\n" + dryrun_summary(recs),
                  text, flags=re.S)
    tables = "\n\n".join(
        f"### {TITLES[m]}\n\n" + roofline_table(recs, m) for m in MESHES
        if any(r.get("mesh") == m for r in recs))
    return re.sub(r"<!-- ROOFLINE_TABLE -->.*?" + until,
                  lambda _: "<!-- ROOFLINE_TABLE -->\n" + tables,
                  text, flags=re.S)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("target")
    ap.add_argument("--dir", default=os.path.join(ROOT, "experiments",
                                                  "dryrun_torch"))
    args = ap.parse_args(argv)
    recs = load_records(args.dir)
    with open(args.target) as f:
        text = f.read()
    with open(args.target, "w") as f:
        f.write(fill(text, recs))
    print(args.target, "updated with",
          len([r for r in recs if r.get("status") == "ok"]), "ok cells")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
