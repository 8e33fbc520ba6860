"""File discovery, pragma application, and report assembly.

The runner walks the package tree, parses each module once, runs every
in-scope rule, then applies the suppression pragmas.  Pragma *hygiene*
problems (unknown rule id, unused pragma, missing justification under
``--strict``) are reported as findings with rule id ``pragma`` so the
same exit-code contract covers them.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

from repro_torch.analysis.base import Finding, Rule
from repro_torch.analysis.pragmas import Pragma, PragmaIndex, parse_pragmas
from repro_torch.analysis.rules import RULES

__all__ = ["RULES", "Finding", "Report", "run_analysis", "render_audit"]

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache"}
# the analyzer does not analyze itself: its fixtures and rule sources
# quote every forbidden pattern verbatim
_SKIP_PREFIXES = ("analysis/",)


@dataclass
class Report:
    """Everything one analysis run produced."""

    root: str
    files: list[str] = field(default_factory=list)
    findings: list[Finding] = field(default_factory=list)
    pragmas: list[Pragma] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)  # unparsable files

    @property
    def ok(self) -> bool:
        return not self.findings and not self.errors

    def format(self) -> str:
        lines = [f.format() for f in self.findings]
        lines.extend(f"{p}: [parse-error]" for p in self.errors)
        lines.append(
            f"{len(self.files)} files, {len(self.findings)} findings, "
            f"{sum(1 for p in self.pragmas if p.used)} suppressions"
        )
        return "\n".join(lines)


def _package_root(root: str) -> str:
    """Analysis is rooted at the ``repro_torch`` package so rule scopes
    read as package-relative paths (``core/hsf.py``).  A bare directory
    (the fixture case in tests) is used as-is."""
    for cand in (os.path.join(root, "src", "repro_torch"),
                 os.path.join(root, "repro_torch")):
        if os.path.isdir(cand):
            return cand
    return root


def _discover(pkg_root: str) -> list[str]:
    out: list[str] = []
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, name), pkg_root)
            rel = rel.replace(os.sep, "/")
            if rel.startswith(_SKIP_PREFIXES):
                continue
            out.append(rel)
    return out


def _hygiene_findings(
    relpath: str,
    index: PragmaIndex,
    known_rules: set[str],
    strict: bool,
) -> list[Finding]:
    out: list[Finding] = []
    for p in index.pragmas:
        if p.rule not in known_rules:
            out.append(Finding(
                rule="pragma", path=relpath, line=p.line, col=0,
                message=f"pragma names unknown rule `{p.rule}` — "
                        "a typo here silently disables nothing; known "
                        "rules: " + ", ".join(sorted(known_rules)),
            ))
            continue
        if not p.used:
            out.append(Finding(
                rule="pragma", path=relpath, line=p.line, col=0,
                message=f"unused pragma allow[{p.rule}] — the code it "
                        "excused is gone; remove it",
            ))
        if strict and not p.justification:
            out.append(Finding(
                rule="pragma", path=relpath, line=p.line, col=0,
                message=f"pragma allow[{p.rule}] has no justification — "
                        "--strict requires `-- <why>` on every "
                        "suppression",
            ))
    return out


def run_analysis(
    root: str,
    strict: bool = False,
    rules: tuple[Rule, ...] = RULES,
) -> Report:
    pkg_root = _package_root(root)
    report = Report(root=pkg_root)
    known_rules = {r.id for r in rules}
    for relpath in _discover(pkg_root):
        report.files.append(relpath)
        full = os.path.join(pkg_root, relpath)
        with open(full, encoding="utf-8") as fh:
            source = fh.read()
        try:
            tree = ast.parse(source, filename=relpath)
        except SyntaxError as exc:
            report.errors.append(f"{relpath}:{exc.lineno}")
            continue
        index = PragmaIndex(parse_pragmas(relpath, source.splitlines()))
        report.pragmas.extend(index.pragmas)
        for rule in rules:
            if not rule.applies_to(relpath):
                continue
            for f in rule.check(tree, relpath):
                if not index.suppresses(f.rule, f.line):
                    report.findings.append(f)
        report.findings.extend(
            _hygiene_findings(relpath, index, known_rules, strict)
        )
    report.findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return report


def render_audit(report: Report, rules: tuple[Rule, ...] = RULES) -> str:
    """The checked-in suppression audit (docs/ANALYSIS_AUDIT_TORCH.md):
    every active pragma with its justification, grouped by rule.  CI
    diffs this against the committed copy so a new suppression is a
    visible reviewed line, never a silent one."""
    lines = [
        "# Analysis suppression audit",
        "",
        "Generated by `python -m repro_torch.analysis --write-audit`",
        "and verified with `--check-audit`.  Every entry is an inline",
        "`# analysis: allow[rule]` pragma in the tree — the set below is",
        "the complete list of places the invariants are intentionally",
        "relaxed, each with its reviewed justification.",
        "",
    ]
    by_rule: dict[str, list[Pragma]] = {}
    for p in report.pragmas:
        if p.used:
            by_rule.setdefault(p.rule, []).append(p)
    for rule in rules:
        pragmas = by_rule.pop(rule.id, [])
        if not pragmas:
            continue
        lines.append(f"## {rule.id} — {rule.title}")
        lines.append("")
        for p in sorted(pragmas, key=lambda p: (p.path, p.line)):
            lines.append(f"- `{p.path}:{p.line}` — {p.justification}")
        lines.append("")
    for rule_id, pragmas in sorted(by_rule.items()):  # unregistered ids
        lines.append(f"## {rule_id}")
        lines.append("")
        for p in sorted(pragmas, key=lambda p: (p.path, p.line)):
            lines.append(f"- `{p.path}:{p.line}` — {p.justification}")
        lines.append("")
    if len(lines) == 8:
        lines.append("(no active suppressions)")
        lines.append("")
    return "\n".join(lines)
