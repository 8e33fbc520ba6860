"""Shared analyzer machinery: findings, the rule interface, AST helpers.

Everything here is pure stdlib (``ast`` + ``fnmatch``) — the analyzer
must be importable and runnable on the barest edge install, matching
the paper's zero-dependency thesis.  The JAX package's analyzer finds
the functions it compiles by their ``jax.jit`` decorators; this one
finds the functions a CUDA graph captures (``captured_functions``).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from fnmatch import fnmatch


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str      # package-relative, e.g. "core/engine.py"
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


class Rule:
    """One invariant checker.

    Subclasses set ``id`` (the pragma-facing kebab-case name), ``title``
    and ``rationale`` (the §11 docs table is generated from these), and
    ``scope`` — fnmatch patterns over package-relative paths.  ``check``
    returns raw findings; the runner applies pragma suppression.
    """

    id: str = ""
    title: str = ""
    rationale: str = ""
    scope: tuple[str, ...] = ("*",)

    def applies_to(self, relpath: str) -> bool:
        return any(fnmatch(relpath, pat) for pat in self.scope)

    def check(self, tree: ast.Module, relpath: str) -> list[Finding]:
        raise NotImplementedError

    def finding(self, relpath: str, node: ast.AST, message: str) -> Finding:
        return Finding(
            rule=self.id,
            path=relpath,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0),
            message=message,
        )


# --------------------------------------------------------------------------
# AST helpers
# --------------------------------------------------------------------------

def dotted_name(node: ast.AST) -> str | None:
    """``torch.matmul`` / ``torch.cuda.synchronize`` → their dotted
    string, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> str | None:
    return dotted_name(node.func)


def method_name(node: ast.Call) -> str | None:
    """``<expr>.name(...)`` → name, else None."""
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def is_self_attr(node: ast.AST, attrs: set[str] | None = None) -> str | None:
    """``self.<attr>`` → attr (optionally restricted to ``attrs``)."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        if attrs is None or node.attr in attrs:
            return node.attr
    return None


def decorator_names(fn: ast.FunctionDef) -> list[str]:
    """Dotted names of a function's decorators (for ``Call`` decorators,
    the callee's)."""
    names: list[str] = []
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = dotted_name(target)
        if name is not None:
            names.append(name)
    return names


def walk_functions(tree: ast.AST):
    """Yield every FunctionDef/AsyncFunctionDef (including nested)."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


# The counterpart of a jitted function: a function a CUDA graph captures.
# ``CapturedStep(fn, static_inputs, device)`` captures ``fn`` (a local
# function or a lambda passed to it); the step factories return the
# closures that serving cells and generation capture, so every function
# defined inside one of them runs inside a capture.
CAPTURE_NAMES = {"CapturedStep", "steps.CapturedStep"}
STEP_FACTORIES = ("make_*_step", "build_sharded_retrieve")


def captured_functions(tree: ast.Module):
    """(name, node) of each function or lambda in ``tree`` that a CUDA
    graph captures: the first argument of a ``CapturedStep(...)`` call
    (a lambda, the name of a function defined in this module, or a
    ``self.<attr>`` assigned one of those), and
    every function or lambda nested in a step factory
    (``STEP_FACTORIES``)."""
    defs: dict[str, list[ast.AST]] = {}
    for fn in walk_functions(tree):
        defs.setdefault(fn.name, []).append(fn)
    # ``self.<attr> = lambda ...`` / ``= <function name>``: a step held
    # on an object and passed on as ``CapturedStep(self.<attr>, ...)``
    held: dict[str, list[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                attr = is_self_attr(t)
                if attr is not None:
                    held.setdefault(attr, []).append(node.value)
    seen: set[int] = set()
    out: list[tuple[str, ast.AST]] = []

    def add(name: str, node: ast.AST) -> None:
        if id(node) not in seen:
            seen.add(id(node))
            out.append((name, node))

    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and call_name(node) in CAPTURE_NAMES
                and node.args):
            args = [node.args[0]]
            attr = is_self_attr(node.args[0])
            if attr is not None:
                args = held.get(attr, [])
            for arg in args:
                if isinstance(arg, ast.Lambda):
                    add(f"self.{attr}" if attr else "<lambda>", arg)
                elif isinstance(arg, ast.Name):
                    for fn in defs.get(arg.id, ()):
                        add(fn.name, fn)
    for fn in walk_functions(tree):
        if not any(fnmatch(fn.name, pat) for pat in STEP_FACTORIES):
            continue
        for inner in ast.walk(fn):
            if inner is fn:
                continue
            if isinstance(inner, (ast.FunctionDef, ast.AsyncFunctionDef)):
                add(f"{fn.name}.{inner.name}", inner)
            elif isinstance(inner, ast.Lambda):
                add(f"{fn.name}.<lambda>", inner)
    return out
