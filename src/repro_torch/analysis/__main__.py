"""``python -m repro_torch.analysis`` — the invariant-analyzer CLI.

Exit codes:
    0  tree is clean (no findings; under --strict, all pragmas justified)
    1  findings (or parse errors)
    2  usage error (argparse)
    3  --check-audit drift: the committed suppression audit does not
       match the tree — regenerate with --write-audit and review
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis.runner import RULES, render_audit, run_analysis


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="RAGdb (PyTorch port) invariant analyzer (rules: "
                    + ", ".join(r.id for r in RULES) + ")",
    )
    parser.add_argument(
        "--root", default=".",
        help="repo root (or a bare package dir for fixtures)")
    parser.add_argument(
        "--strict", action="store_true",
        help="require a justification on every suppression pragma")
    parser.add_argument(
        "--json", action="store_true",
        help="machine-readable findings on stdout")
    parser.add_argument(
        "--write-audit", metavar="PATH",
        help="write the suppression audit (docs/ANALYSIS_AUDIT_TORCH.md)")
    parser.add_argument(
        "--check-audit", metavar="PATH",
        help="exit 3 unless PATH matches the regenerated audit")
    args = parser.parse_args(argv)

    report = run_analysis(args.root, strict=args.strict)

    if args.json:
        print(json.dumps(
            {
                "files": len(report.files),
                "findings": [
                    {"rule": f.rule, "path": f.path, "line": f.line,
                     "col": f.col, "message": f.message}
                    for f in report.findings
                ],
                "errors": report.errors,
                "suppressions": sum(1 for p in report.pragmas if p.used),
            },
            indent=2,
        ))
    else:
        print(report.format())

    if args.write_audit:
        # plain write, not the durability protocol: this is a dev/CI
        # artifact regenerated from source, not a crash-safe publish
        with open(args.write_audit, "w", encoding="utf-8") as fh:
            fh.write(render_audit(report))
        print(f"wrote {args.write_audit}", file=sys.stderr)

    if not report.ok:
        return 1

    if args.check_audit:
        expected = render_audit(report)
        actual = ""
        if os.path.exists(args.check_audit):
            with open(args.check_audit, encoding="utf-8") as fh:
                actual = fh.read()
        if actual != expected:
            print(
                f"{args.check_audit} is stale — suppressions changed; "
                "regenerate with --write-audit and commit the diff",
                file=sys.stderr,
            )
            return 3

    return 0


if __name__ == "__main__":
    sys.exit(main())
