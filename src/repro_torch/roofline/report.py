"""CLI: render the roofline table from a dry-run results file.

  PYTHONPATH=src python -m repro_torch.roofline.report dryrun_results.jsonl [mesh]
"""
from __future__ import annotations

import sys

from repro_torch.roofline.analysis import (bottleneck_sentence, load_rows,
                                           to_markdown)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    path = argv[0] if argv else "dryrun_results.jsonl"
    mesh = argv[1] if len(argv) > 1 else None
    rows = load_rows(path, mesh=mesh)
    print(to_markdown(rows))
    print()
    doms = {}
    for r in rows:
        doms.setdefault(r.dominant, []).append(r)
    for dom, rs in sorted(doms.items()):
        print(f"{dom}-bound: {len(rs)} combos — e.g. "
              f"{rs[0].arch} x {rs[0].shape}: {bottleneck_sentence(rs[0])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
