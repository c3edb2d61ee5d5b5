#!/usr/bin/env python3
"""Name-by-name scan of the JAX package against the port.

    python3 port_tools/name_scan.py

For every module of gemini_seal_tpu/, the module at the same relative path
of gemini_seal_tpu_torch/ must exist and define the same public names: the
top-level functions and classes, the methods of each class (``__init__``
included) and the upper-case module constants.  Reads the sources with
``ast`` (imports neither package) and prints each JAX module with the names
the port lacks, one line each; exits 0 whatever it finds (ROADMAP.md lists
the names left out on purpose, with the reason for each).
"""

from __future__ import annotations

import ast
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "gemini_seal_tpu", "gemini_seal_tpu_torch"


def public_names(path: str) -> set:
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{sub.name}" for sub in node.body
                           if isinstance(sub, ast.FunctionDef))
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name) and t.id.isupper())
    return out


def is_public(name: str) -> bool:
    parts = name.split(".")
    return all(not p.startswith("_") or (i == len(parts) - 1 and p == "__init__")
               for i, p in enumerate(parts))


def scan() -> dict:
    missing = {}
    root = os.path.join(REPO, JAX_PKG)
    for folder, _, files in os.walk(root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(folder, f), root)
            port = os.path.join(REPO, PORT_PKG, rel)
            if not os.path.exists(port):
                missing[rel] = ["<the module>"]
                continue
            lacking = sorted(n for n in public_names(os.path.join(folder, f))
                             - public_names(port) if is_public(n))
            if lacking:
                missing[rel] = lacking
    return missing


def main() -> int:
    missing = scan()
    for rel, names in sorted(missing.items()):
        print(f"{JAX_PKG}/{rel}: {', '.join(names)}")
    if not missing:
        print("every public name has a counterpart")
    return 0


if __name__ == "__main__":
    sys.exit(main())
