"""Repo AST lint: the three shipped bug classes, encoded as rules (the
reference's ``repro.analysis.ast_lint`` as it is, over the port's files).

Each rule is a pattern this repo actually shipped (and later fixed in a
dedicated PR) — the lint keeps the class extinct:

* ``ast-salted-hash`` — ``init_from_defs`` keyed parameter init on
  builtin ``hash()``, which ``PYTHONHASHSEED`` salts per process, so
  "deterministic" init differed across processes (fixed to
  ``zlib.crc32``). Any ``hash(...)`` call is flagged; process-local
  uses carry an inline justified waiver.
* ``ast-env-mutation`` — a module once exported ``XLA_FLAGS`` at import
  time, reconfiguring JAX for every importer. Environment mutation is
  only legal inside a function/method body or under an
  ``if __name__ == "__main__":`` guard.
* ``ast-axis-shape-guess`` — the engine's ``_splice`` matched the batch
  axis by ``big.shape[0] == small.shape[0]``, corrupting the cache as
  soon as two dims collided (e.g. ``n_slots == n_layers``). Equality
  comparisons against ``<expr>.shape[i]`` are flagged; declare the axis
  instead (``CACHE_AXES``-style) or compare ranks/whole shapes.

Suppression: ``# repro: ignore[rule-id] -- justification`` on the
offending line (see ``findings.apply_suppressions``).
"""
from __future__ import annotations

import ast
import os
from typing import List, Optional

from repro_torch.analysis.findings import (Finding, Location,
                                           apply_suppressions)
from repro_torch.analysis.registry import AnalysisContext, register_pass

#: os.environ methods that mutate the process environment.
_ENV_MUTATORS = ("setdefault", "update", "pop", "clear", "popitem")


def _is_os_environ(node: ast.AST) -> bool:
    """``os.environ`` or a bare ``environ`` (from os import environ)."""
    if isinstance(node, ast.Attribute) and node.attr == "environ" \
            and isinstance(node.value, ast.Name) and node.value.id == "os":
        return True
    return isinstance(node, ast.Name) and node.id == "environ"


def _is_main_guard(node: ast.AST) -> bool:
    """``if __name__ == "__main__":`` (either comparand order)."""
    if not isinstance(node, ast.If) or not isinstance(node.test, ast.Compare):
        return False
    t = node.test
    names = [t.left] + list(t.comparators)
    return (len(t.ops) == 1 and isinstance(t.ops[0], ast.Eq)
            and any(isinstance(n, ast.Name) and n.id == "__name__"
                    for n in names)
            and any(isinstance(n, ast.Constant) and n.value == "__main__"
                    for n in names))


def _is_shape_subscript(node: ast.AST) -> bool:
    """``<expr>.shape[<idx>]``."""
    return (isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Attribute)
            and node.value.attr == "shape")


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: List[Finding] = []
        self._func_depth = 0
        self._main_depth = 0

    # -- scope tracking ------------------------------------------------------
    def visit_FunctionDef(self, node):
        self._func_depth += 1
        self.generic_visit(node)
        self._func_depth -= 1

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_If(self, node):
        if _is_main_guard(node):
            self._main_depth += 1
            self.generic_visit(node)
            self._main_depth -= 1
        else:
            self.generic_visit(node)

    @property
    def _import_time(self) -> bool:
        return self._func_depth == 0 and self._main_depth == 0

    def _emit(self, rule: str, node: ast.AST, message: str,
              suggestion: str = ""):
        self.findings.append(Finding(
            rule, "error",
            Location(file=self.path, line=getattr(node, "lineno", None)),
            message, suggestion))

    # -- rules ---------------------------------------------------------------
    def visit_Call(self, node):
        # ast-salted-hash: builtin hash() call
        if isinstance(node.func, ast.Name) and node.func.id == "hash":
            self._emit(
                "ast-salted-hash", node,
                "builtin hash() is salted per process (PYTHONHASHSEED) — "
                "unusable for persisted or cross-process keys",
                "use zlib.crc32 / hashlib for stable keys")
        # ast-env-mutation: os.environ.setdefault(...) / os.putenv(...)
        if isinstance(node.func, ast.Attribute):
            f = node.func
            if f.attr in _ENV_MUTATORS and _is_os_environ(f.value):
                self._check_env(node, f"os.environ.{f.attr}(...)")
            if f.attr == "putenv" and isinstance(f.value, ast.Name) \
                    and f.value.id == "os":
                self._check_env(node, "os.putenv(...)")
        self.generic_visit(node)

    def visit_Assign(self, node):
        for tgt in node.targets:
            self._check_env_assign(tgt, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._check_env_assign(node.target, node)
        self.generic_visit(node)

    def visit_Delete(self, node):
        for tgt in node.targets:
            self._check_env_assign(tgt, node)
        self.generic_visit(node)

    def _check_env_assign(self, tgt: ast.AST, node: ast.AST):
        if isinstance(tgt, ast.Subscript) and _is_os_environ(tgt.value):
            self._check_env(node, "os.environ[...] = ...")

    def _check_env(self, node: ast.AST, what: str):
        if self._import_time:
            self._emit(
                "ast-env-mutation", node,
                f"import-time environment mutation ({what}) outside a "
                f"__main__ guard reconfigures every importer "
                f"(the XLA_FLAGS bug class)",
                "move it into a function the entry point calls, or under "
                "if __name__ == '__main__':")

    def visit_Compare(self, node):
        # ast-axis-shape-guess: <expr>.shape[i] == <expr>
        sides = [node.left] + list(node.comparators)
        if any(isinstance(op, ast.Eq) for op in node.ops) \
                and any(_is_shape_subscript(s) for s in sides):
            self._emit(
                "ast-axis-shape-guess", node,
                "axis guessed by a .shape[i] == comparison — collides as "
                "soon as two unrelated dims share an extent (the _splice "
                "bug class)",
                "index the declared axis (CACHE_AXES-style) or compare "
                "full shapes/ranks")
        self.generic_visit(node)


def lint_source(source: str, path: str = "<memory>") -> List[Finding]:
    """Lint one source string; applies inline suppressions."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("analysis-pass-error", "error",
                        Location(file=path, line=e.lineno),
                        f"unparseable: {e.msg}")]
    linter = _Linter(path)
    linter.visit(tree)
    return apply_suppressions(linter.findings, source, path)


def lint_file(path: str, rel: Optional[str] = None) -> List[Finding]:
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), rel or path)


#: Files the lint covers besides the package: the card's smoke run.
TARGET_SCRIPTS = ("chip_smoke.py",)


def target_files(root: str) -> List[str]:
    """Repo-relative paths the lint covers: the port's package and
    ``chip_smoke.py``.

    Tests are excluded by design — they seed violations as fixtures.
    """
    out = [s for s in TARGET_SCRIPTS if os.path.isfile(os.path.join(root, s))]
    top = os.path.join(root, "src", "repro_torch")
    for dirpath, _, files in os.walk(top):
        for name in sorted(files):
            if name.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, name), root))
    return sorted(out)


@register_pass(
    "ast_lint",
    rules=("ast-salted-hash", "ast-env-mutation", "ast-axis-shape-guess",
           "analysis-suppression", "analysis-pass-error"),
    description="shipped-bug-class AST rules over src/repro_torch + "
                "chip_smoke.py")
def run_pass(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []
    for rel in target_files(ctx.root):
        findings.extend(lint_file(os.path.join(ctx.root, rel), rel))
    return findings
