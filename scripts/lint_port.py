#!/usr/bin/env python
"""Import lint of the PyTorch/CUDA port: it must stand alone.

Fails (exit 1, one line per offence) when a module of ``src/repro_torch``,
``chip_smoke.py`` or an ``examples/*_torch.py`` imports ``jax``,
``jaxlib`` or anything of the JAX package ``repro``. Pure AST: every
``import`` statement counts, a lazy one inside a function too, and nothing
is executed.

    python scripts/lint_port.py [ROOT]
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "repro")


def port_files(root: Path) -> list[Path]:
    return (sorted((root / "src" / "repro_torch").rglob("*.py"))
            + [root / "chip_smoke.py"]
            + sorted((root / "examples").glob("*_torch.py")))


def offences(path: Path) -> list[str]:
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        out += [f"{path}:{node.lineno}: imports {n}" for n in names
                if n.split(".")[0] in FORBIDDEN]
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = Path(argv[0] if argv else Path(__file__).resolve().parents[1])
    files = port_files(root)
    bad = [o for f in files for o in offences(f)]
    for line in bad:
        print(line)
    print(f"lint_port: {len(files)} files, {len(bad)} forbidden imports")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
