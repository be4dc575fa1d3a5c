#!/usr/bin/env python
"""Docs check for the port: fail on `` `repro_torch.…` `` references in the
docs that do not resolve.

``scripts/check_docs.py`` checks the JAX package's dotted references
(``repro.…``) and the file paths; this checks the port's: every inline-code
token that is a dotted name under ``repro_torch`` (`` `repro_torch.dist.grid` ``)
and every module run with ``-m`` in inline code
(`` `python -m repro_torch.launch.train --device cpu` ``) must import as a
module, or as a module followed by attributes that exist on it. Fenced code
blocks are skipped, as ``check_docs.py`` skips them. Wired into
``scripts/smoke_torch.sh`` beside ``check_docs.py``.

  PYTHONPATH=src python scripts/check_docs_torch.py [file.md ...]
"""
from __future__ import annotations

import importlib
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from check_docs import (DEFAULT_DOCS, INLINE_CODE_RE, ROOT,  # noqa: E402
                        strip_fenced_blocks)

DOTTED_RE = re.compile(r"^repro_torch(\.[A-Za-z_][A-Za-z0-9_]*)*$")
RUN_MODULE_RE = re.compile(r"(?:^|\s)-m\s+(repro_torch(?:\.[A-Za-z_]\w*)*)")


def resolves(dotted: str, *, module_only: bool = False) -> bool:
    """``repro_torch.a.b[.attr...]``: the longest prefix that imports as a
    module, then the rest as attributes of it (none with
    ``module_only``)."""
    parts = dotted.split(".")
    for end in range(len(parts), 0, -1):
        name = ".".join(parts[:end])
        try:
            obj = importlib.import_module(name)
        except ModuleNotFoundError as e:
            if not name.startswith(e.name or ""):
                raise           # the module exists, a dependency of it not
            continue
        rest = parts[end:]
        if module_only and rest:
            return False
        for name in rest:
            if not hasattr(obj, name):
                return False
            obj = getattr(obj, name)
        return True
    return False


def check_file(path: Path) -> tuple:
    """(references checked, failures) of one markdown file."""
    rel = path.relative_to(ROOT) if path.is_relative_to(ROOT) else path
    text = strip_fenced_blocks(path.read_text())
    n, bad = 0, []
    for lineno, line in enumerate(text.splitlines(), 1):
        for m in INLINE_CODE_RE.finditer(line):
            tok = m.group(1).strip()
            refs = [(tok, False)] if DOTTED_RE.match(tok) else []
            refs += [(r, True) for r in RUN_MODULE_RE.findall(tok)]
            for ref, module_only in refs:
                n += 1
                if not resolves(ref, module_only=module_only):
                    what = "module" if module_only else "reference"
                    bad.append(f"{rel}:{lineno}: unresolvable {what} "
                               f"{ref!r}")
    return n, bad


def main(argv: list) -> int:
    files = ([Path(a).resolve() for a in argv]
             if argv else [p for p in DEFAULT_DOCS if p.exists()])
    if not files:
        print("check_docs_torch: no docs found", file=sys.stderr)
        return 1
    total, failures = 0, []
    for path in files:
        n, bad = check_file(path)
        total += n
        failures.extend(bad)
    for f in failures:
        print(f, file=sys.stderr)
    print(f"check_docs_torch: {len(files)} files, {total} repro_torch "
          f"references, {len(failures)} unresolvable")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
