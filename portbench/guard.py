"""What no run may load: JAX and the JAX package beside the port.

Module names are compared by their top-level name (the part before the
first dot) as a whole word: `streammos_tpu_torch` begins with
`streammos_tpu` and is allowed; `streammos_tpu` and `streammos_tpu.ops`
are not. The reference's own imports are read from its source: it may
load neither these nor anything of the measured package.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "streammos_tpu")
PROGRAM = "streammos_tpu_torch"
REFERENCE_DIR = Path(__file__).resolve().parent / "reference"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top(n) in FORBIDDEN)


def imported_names(path: Path) -> List[str]:
    """Every module an `import` or `from ... import` in `path` names."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module)
    return out


def reference_violations(ref_dir: Path = REFERENCE_DIR) -> List[str]:
    """Imports of the reference's sources that reach the measured package,
    JAX or the JAX package."""
    return sorted(f"{p.name}: {n}" for p in ref_dir.glob("*.py")
                  for n in imported_names(p)
                  if top(n) in FORBIDDEN + (PROGRAM,))
