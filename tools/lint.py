#!/usr/bin/env python
"""Minimal undefined-name linter (no third-party linters in this image).

Walks every Python file in the repo and flags names that are referenced
but bound nowhere in the enclosing scope chain, module globals, or
builtins — the exact class of bug (NameError from a missing import) that
shipped in round 1 (hevc/slice.py). Uses the stdlib symtable, so scoping
rules (comprehensions, nested functions, class bodies) are Python's own.
"""

from __future__ import annotations

import builtins
import pathlib
import symtable
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
TARGETS = ["heif_tpu", "tests", "bench.py", "chip_smoke.py", "__graft_entry__.py",
           "tools"]
BUILTINS = set(dir(builtins)) | {"__file__", "__name__", "__doc__", "__package__",
                                 "__builtins__", "__spec__", "__loader__", "__debug__",
                                 "__class__", "__path__", "WindowsError"}


def bound_names(table: symtable.SymbolTable) -> set[str]:
    out = set()
    for sym in table.get_symbols():
        if sym.is_assigned() or sym.is_imported() or sym.is_parameter():
            out.add(sym.get_name())
    for child in table.get_children():
        out.add(child.get_name())
    return out


def check_table(table, inherited: set[str], module_globals: set[str], errs, path):
    local = bound_names(table)
    # class bodies do not contribute to the scope of nested functions
    next_inherited = inherited if table.get_type() == "class" else inherited | local
    for sym in table.get_symbols():
        name = sym.get_name()
        if sym.is_referenced() and not (
            sym.is_assigned() or sym.is_imported() or sym.is_parameter()
        ):
            if sym.is_free():
                continue  # resolved by a real enclosing function scope
            if name in BUILTINS or name in module_globals or name in inherited:
                continue
            if name in local:
                continue
            errs.append(f"{path}:{table.get_lineno()}: undefined name '{name}' "
                        f"in {table.get_name()}")
    for child in table.get_children():
        check_table(child, next_inherited, module_globals, errs, path)


def check_file(path: pathlib.Path, errs: list) -> None:
    src = path.read_text()
    try:
        top = symtable.symtable(src, str(path), "exec")
    except SyntaxError as e:
        errs.append(f"{path}: syntax error: {e}")
        return
    module_globals = bound_names(top)
    for child in top.get_children():
        check_table(child, set(), module_globals, errs, path)
    # module-level references
    check_table_module(top, module_globals, errs, path)


def check_table_module(top, module_globals, errs, path):
    for sym in top.get_symbols():
        name = sym.get_name()
        if sym.is_referenced() and not (
            sym.is_assigned() or sym.is_imported()
        ):
            if name in BUILTINS or name in module_globals:
                continue
            errs.append(f"{path}:1: undefined module-level name '{name}'")


def main() -> int:
    errs: list[str] = []
    files = []
    for t in TARGETS:
        p = ROOT / t
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.exists():
            files.append(p)
    for f in files:
        check_file(f, errs)
    for e in errs:
        print(e)
    print(f"lint: {len(files)} files, {len(errs)} errors")
    return 1 if errs else 0


if __name__ == "__main__":
    sys.exit(main())
