"""Suppression pragma grammar (docs/ARCHITECTURE.md §11).

A pragma makes an intentional rule exception *reviewable*::

    cos = q @ dv.T  # analysis: allow[unpinned-reduction] -- opt-in gemm
                    #   path, documented non-bit-stable (ARCHITECTURE §5)

(The JAX package's grammar, unchanged: a pragma reads the same in
either tree.)

Grammar (one pragma per comment)::

    "# analysis: allow[" rule-id "]" [ separator justification ]

- ``rule-id`` is a registered rule (``runner.RULES``) — unknown ids are
  themselves findings, so a typo cannot silently disable nothing.
- ``separator`` is ``--``, ``—`` or ``:``; the justification is free
  text.  ``--strict`` requires a non-empty justification on every
  pragma (the acceptance contract: suppressions are *audited*, not
  waved through).
- A trailing pragma applies to its own physical line; a comment-only
  pragma line applies to the next *logical* source line — continuation
  comment lines are skipped, and a statement spanning several physical
  lines (open brackets) is covered to its closing line.
- A pragma that suppresses nothing is reported (``unused pragma``) so
  stale suppressions cannot linger after the code they excused is gone.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

PRAGMA_RE = re.compile(
    r"#\s*analysis:\s*allow\[(?P<rule>[a-z0-9-]*)\]"
    r"(?:\s*(?:--|—|:)\s*(?P<why>.*?))?\s*$"
)


@dataclass
class Pragma:
    """One parsed suppression comment."""

    path: str
    line: int          # line the pragma comment sits on (1-based)
    applies_to: int    # first line whose findings it suppresses
    applies_end: int   # last covered line (logical-statement span)
    rule: str
    justification: str
    used: bool = field(default=False, compare=False)


def parse_pragmas(relpath: str, lines: list[str]) -> list[Pragma]:
    """Scan raw source lines for pragmas.

    Purely lexical: a pragma inside a string literal would be honored
    too, which is fine — the analyzer's own fixture tests are the only
    place that happens, and they build sources from fragments.
    """
    out: list[Pragma] = []
    for i, text in enumerate(lines, start=1):
        m = PRAGMA_RE.search(text)
        if m is None:
            continue
        applies_to = applies_end = i
        why = [(m.group("why") or "").strip()]
        if text.lstrip().startswith("#"):
            # comment-only pragma: applies to the next source line;
            # further comment lines continue the justification
            applies_to = i + 1
            while (applies_to <= len(lines)
                   and lines[applies_to - 1].lstrip().startswith("#")):
                why.append(lines[applies_to - 1].lstrip().lstrip("#").strip())
                applies_to += 1
            applies_end = _statement_end(lines, applies_to)
        out.append(
            Pragma(
                path=relpath,
                line=i,
                applies_to=applies_to,
                applies_end=applies_end,
                rule=m.group("rule"),
                justification=" ".join(w for w in why if w),
            )
        )
    return out


def _statement_end(lines: list[str], start: int) -> int:
    """Last physical line of the logical statement starting at ``start``
    (1-based), found by bracket balance.  Lexical — string literals
    containing brackets could fool it — but the covered code is the
    repo's own scoring/persistence modules, where that doesn't arise."""
    depth = 0
    i = start
    while i <= len(lines):
        text = lines[i - 1].split("#", 1)[0]
        depth += sum(text.count(c) for c in "([{")
        depth -= sum(text.count(c) for c in ")]}")
        if depth <= 0:
            return i
        i += 1
    return len(lines)


class PragmaIndex:
    """Per-file suppression lookup with use tracking."""

    def __init__(self, pragmas: list[Pragma]):
        self.pragmas = pragmas
        self._by_rule: dict[str, list[Pragma]] = {}
        for p in pragmas:
            self._by_rule.setdefault(p.rule, []).append(p)

    def suppresses(self, rule: str, line: int) -> bool:
        for p in self._by_rule.get(rule, ()):
            if p.applies_to <= line <= p.applies_end:
                p.used = True
                return True
        return False
