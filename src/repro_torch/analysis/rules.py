"""The invariant rules (R1–R6), retargeted to PyTorch.  See
docs/ARCHITECTURE.md §11 for the rationale table; each rule's
``rationale`` string is the one-line form.

Every rule is a conservative *syntactic* checker: it flags the pattern
wherever it appears in scope and relies on the pragma grammar
(pragmas.py) to make intentional exceptions explicit and justified.
False positives are cheap (one reviewed pragma line); false negatives
are the expensive failure mode — reduction-order drift survives review
until a parity test catches it.

What differs from the JAX package's rules: R1 also knows torch's
products (``torch.matmul``/``mm``/``bmm``/``einsum``/..., ``F.linear``,
the ``.matmul(``/``.mm(``/``.bmm(``/``.dot(`` methods); R4 also catches
in-place writes to the tensors a snapshot pins; R5 looks inside the
functions a CUDA graph captures (``base.captured_functions``) where the
JAX package looks inside jitted ones, and audits ``synchronize`` where
it audits ``block_until_ready``.  R2, R3 and R6 hold as written.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.base import (
    Finding,
    Rule,
    call_name,
    captured_functions,
    decorator_names,
    dotted_name,
    is_self_attr,
    method_name,
    walk_functions,
)

# --------------------------------------------------------------------------
# R1 — pinned-reduction discipline in scoring modules
# --------------------------------------------------------------------------

_REDUCTION_FNS = {"dot", "matmul", "einsum", "inner", "tensordot", "vdot",
                  "mm", "bmm", "mv", "addmm", "baddbmm", "linear"}
_NUMERIC_MODULES = {"np", "numpy", "torch", "F", "torch.nn.functional"}
# tensor methods that reduce over the feature axis: ``a.matmul(b)`` and
# friends (``np.dot`` is a module function, matched above first)
_REDUCTION_METHODS = {"matmul", "mm", "bmm", "dot", "mv"}


class PinnedReductionRule(Rule):
    """R1: every cosine on a bit-identity path routes through
    ``hsf.stable_rowdot``."""

    id = "unpinned-reduction"
    title = "Pinned-order reductions in scoring modules"
    rationale = (
        "cuBLAS and torch's CPU kernels leave dot-product reduction "
        "order unspecified (it varies with operand height, blocking, "
        "threads and the device), so a raw `@`/`torch.matmul`/`einsum` "
        "over the feature axis can round differently between the flat "
        "scan, a gathered IVF block, a shard, the CPU and the card — "
        "silently breaking every bit-identity contract.  Scoring-module "
        "reductions must route through hsf.stable_rowdot (the explicit "
        "pairwise-halving tree) or carry a pragma stating why the path "
        "is intentionally unpinned (e.g. the opt-in gemm/kernel paths)."
    )
    scope = (
        "core/hsf.py",
        "core/engine.py",
        "core/retrieval.py",
        "index/*.py",
    )
    # the pinned formulation itself (and clones of it in fixtures) is
    # the one place elementwise-multiply trees may live
    exempt_functions = ("stable_rowdot",)

    def check(self, tree: ast.Module, relpath: str) -> list[Finding]:
        exempt_spans: list[tuple[int, int]] = [
            (fn.lineno, fn.end_lineno or fn.lineno)
            for fn in walk_functions(tree)
            if fn.name in self.exempt_functions
        ]

        def exempt(node: ast.AST) -> bool:
            line = getattr(node, "lineno", 0)
            return any(a <= line <= b for a, b in exempt_spans)

        out: list[Finding] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
                if not exempt(node):
                    out.append(self.finding(
                        relpath, node,
                        "raw `@` matmul in a scoring module — route the "
                        "cosine through hsf.stable_rowdot or justify the "
                        "unpinned reduction with a pragma",
                    ))
            elif isinstance(node, ast.Call):
                if exempt(node):
                    continue
                name = call_name(node)
                mod, _, fn = (name or "").rpartition(".")
                if mod in _NUMERIC_MODULES and fn in _REDUCTION_FNS:
                    out.append(self.finding(
                        relpath, node,
                        f"unpinned reduction `{name}` in a scoring module "
                        "— route through hsf.stable_rowdot or justify "
                        "with a pragma",
                    ))
                elif method_name(node) in _REDUCTION_METHODS:
                    out.append(self.finding(
                        relpath, node,
                        f"unpinned reduction `.{method_name(node)}(...)` "
                        "in a scoring module — route through "
                        "hsf.stable_rowdot or justify with a pragma",
                    ))
        return out


# --------------------------------------------------------------------------
# R2 — single-writer lock discipline on KnowledgeBase mutators
# --------------------------------------------------------------------------

# authoritative writer state: doc regions, the change log, the df/idf
# statistics (via vectorizer), the index state, and the persistence
# chain.  Derived caches (_matrix/_dirty/_postings/...) are excluded:
# they are rebuilt idempotently and guarded by the same contract.
_WRITER_ATTRS = {
    "records", "texts", "term_counts", "signatures", "vectorizer",
    "index_state", "loaded_generation",
    "_version", "_changed_at", "_removed_at", "_meta_changed_at",
    "_index_rev", "_index_persisted_rev", "_index_persisted_centroid_sha",
    "_persisted_version", "_persisted_ids", "_persisted_path", "_base_uid",
}
_MUTATING_METHODS = {
    "pop", "clear", "update", "setdefault", "add", "discard", "remove",
    "append", "extend", "add_doc", "remove_doc", "popitem",
}
_GUARD_NAME = "_single_writer"


def _method_mutates_directly(fn: ast.FunctionDef) -> list[str]:
    """Attr names of authoritative state this method writes directly."""
    hits: list[str] = []
    for node in ast.walk(fn):
        targets: list[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            # self.attr = ... / self.attr[...] = ... / self.vectorizer.df = ...
            probe = t
            if isinstance(probe, ast.Subscript):
                probe = probe.value
            if isinstance(probe, ast.Attribute) and is_self_attr(probe.value):
                probe = probe.value  # nested: self.vectorizer.df
            attr = is_self_attr(probe, _WRITER_ATTRS)
            if attr is not None:
                hits.append(attr)
        if isinstance(node, ast.Call):
            # self.<state>.pop(...) / self.vectorizer.add_doc(...)
            f = node.func
            if (isinstance(f, ast.Attribute)
                    and f.attr in _MUTATING_METHODS
                    and is_self_attr(f.value, _WRITER_ATTRS) is not None):
                hits.append(f.value.attr)  # type: ignore[union-attr]
    return hits


def _has_writer_guard(fn: ast.FunctionDef) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.With):
            for item in node.items:
                expr = item.context_expr
                if (isinstance(expr, ast.Call)
                        and isinstance(expr.func, ast.Attribute)
                        and expr.func.attr == _GUARD_NAME
                        and isinstance(expr.func.value, ast.Name)
                        and expr.func.value.id == "self"):
                    return True
    return False


class WriterLockRule(Rule):
    """R2: public mutators of a single-writer class hold the guard."""

    id = "writer-lock"
    title = "Single-writer lock discipline"
    rationale = (
        "KnowledgeBase is not a concurrent structure: a second writer "
        "silently corrupts df counts and change-log ordering, which the "
        "serving snapshots then pin forever.  Every public method that "
        "mutates authoritative state (doc regions, change log, df, "
        "index state, persistence chain) must run under the "
        "non-blocking `_single_writer` guard; internal `_*` helpers are "
        "called under it by their public wrappers."
    )
    scope = ("core/ingest.py",)

    def check(self, tree: ast.Module, relpath: str) -> list[Finding]:
        out: list[Finding] = []
        for cls in ast.walk(tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            members = {n.name for n in cls.body
                       if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
            fields = {t.target.id for t in cls.body
                      if isinstance(t, ast.AnnAssign)
                      and isinstance(t.target, ast.Name)}
            if _GUARD_NAME not in members and "_write_lock" not in fields:
                continue  # not a single-writer class
            methods = {n.name: n for n in cls.body
                       if isinstance(n, ast.FunctionDef)}
            # transitive closure: a method mutates if it writes state or
            # calls a sibling method that does
            mutates: dict[str, list[str]] = {
                name: _method_mutates_directly(fn)
                for name, fn in methods.items()
            }
            changed = True
            while changed:
                changed = False
                for name, fn in methods.items():
                    for node in ast.walk(fn):
                        if (isinstance(node, ast.Call)
                                and isinstance(node.func, ast.Attribute)
                                and isinstance(node.func.value, ast.Name)
                                and node.func.value.id == "self"
                                and node.func.attr in methods
                                and mutates[node.func.attr]
                                and not mutates[name]):
                            mutates[name] = [f"{node.func.attr}()"]
                            changed = True
            for name, fn in methods.items():
                if name.startswith("_") or not mutates[name]:
                    continue  # internal helper / read-only method
                if any("staticmethod" in d for d in decorator_names(fn)):
                    continue  # no self: constructs a fresh instance
                if not _has_writer_guard(fn):
                    what = ", ".join(sorted(set(mutates[name]))[:4])
                    out.append(self.finding(
                        relpath, fn,
                        f"public method `{cls.name}.{name}` mutates writer "
                        f"state ({what}) without `with "
                        f"self.{_GUARD_NAME}(...)`",
                    ))
        return out


# --------------------------------------------------------------------------
# R3 — durability discipline for container/journal publishes
# --------------------------------------------------------------------------

_WRITE_MODE_CHARS = set("wax+")
# The fsync-then-rename commit protocol lives in exactly these
# functions; new publish sites must either call them or be added here
# with a review of their crash-safety story.
_DURABILITY_HELPERS = {
    "_atomic_write_json",    # fsync'd JSON + atomic rename + dir fsync
    "write_container",       # fsync'd container image + atomic rename
    "append_journal_record", # truncate-to-commit, append, fsync, manifest
    "reset_journal",         # unlink-only (journal fold)
    "publish_sharded",       # content-addressed rename before manifest commit
    "_gc_shard_files",       # unlink-only (post-publish collection)
}


def _open_mode(node: ast.Call) -> str | None:
    """The mode literal of an ``open``/``os.fdopen`` call, if constant."""
    mode: ast.AST | None = None
    if len(node.args) >= 2:
        mode = node.args[1]
    for kw in node.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return "r"  # default mode: read-only
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return mode.value
    return None  # dynamic — conservatively unknown


class DurabilityRule(Rule):
    """R3: artifact publishes go through the fsync-then-rename helpers."""

    id = "durability"
    title = "Durability discipline for file publishes"
    rationale = (
        "Crash-safe persistence hangs on one protocol: write to a temp "
        "file, fsync, atomic-rename, fsync the directory "
        "(core/container.py).  A bare `open(.., 'w')` or `os.rename` "
        "publish can surface a torn or vanishing artifact after power "
        "loss — every write/rename in a persistence module must live "
        "inside one of the audited durability helpers."
    )
    scope = (
        "core/container.py",
        "core/ingest.py",
        "checkpoint/*.py",
        "serving/*.py",
        "index/*.py",
    )

    def check(self, tree: ast.Module, relpath: str) -> list[Finding]:
        helper_spans = [
            (fn.lineno, fn.end_lineno or fn.lineno)
            for fn in walk_functions(tree)
            if fn.name in _DURABILITY_HELPERS
        ]

        def inside_helper(node: ast.AST) -> bool:
            line = getattr(node, "lineno", 0)
            return any(a <= line <= b for a, b in helper_spans)

        out: list[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name == "os.rename":
                # flagged even inside helpers: the blessed primitive is
                # os.replace (clobbering atomic rename) — os.rename has
                # platform-dependent failure on existing targets
                out.append(self.finding(
                    relpath, node,
                    "`os.rename` is never the publish primitive — use "
                    "the fsync-then-`os.replace` helpers "
                    "(core/container.py)",
                ))
            elif name == "os.replace" and not inside_helper(node):
                out.append(self.finding(
                    relpath, node,
                    "bare `os.replace` outside the durability helpers — "
                    "a rename-commit without fsync is not power-loss "
                    "durable; route through _atomic_write_json/"
                    "write_container or justify with a pragma",
                ))
            elif name in ("open", "os.fdopen") and not inside_helper(node):
                mode = _open_mode(node)
                if mode is None or _WRITE_MODE_CHARS & set(mode):
                    out.append(self.finding(
                        relpath, node,
                        f"writable `{name}(..., {mode!r})` outside the "
                        "durability helpers — artifact writes must use "
                        "the fsync-then-rename protocol or justify with "
                        "a pragma",
                    ))
        return out


# --------------------------------------------------------------------------
# R4 — snapshot immutability
# --------------------------------------------------------------------------

_SNAPSHOT_CLASSES = {"EngineSnapshot"}
# the tensors a published snapshot pins: the engine's doc tensors and
# kernel operands (``EngineSnapshot.capture`` binds them, it copies
# nothing) and the sharded IVF plane's per-shard blocks (the snapshot
# pins the index).  The writer rebinds them (copy-on-write: a clone,
# then the rebind); it never writes them in place.
_PINNED_TENSORS = {"doc_vecs", "doc_sigs", "kernel_operands",
                   "dv_blocks", "ds_blocks", "gid_blocks"}
_INPLACE_METHODS = {
    "add_", "sub_", "mul_", "div_", "copy_", "index_copy_", "index_put_",
    "index_add_", "index_fill_", "masked_fill_", "masked_scatter_",
    "scatter_", "scatter_add_", "zero_", "fill_", "clamp_", "put_",
}
_CONTAINER_CALLS = {"list", "tuple"}
_COPY_METHODS = {"clone"}


def _is_frozen_dataclass(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        if (isinstance(dec, ast.Call)
                and dotted_name(dec.func) in ("dataclass", "dataclasses.dataclass")):
            for kw in dec.keywords:
                if (kw.arg == "frozen"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is True):
                    return True
    return False


def _snapshot_sources(node: ast.AST) -> bool:
    """Expressions that yield a published snapshot: the class
    constructor, ``EngineSnapshot.capture(...)``, a ``.current``
    property read, or the manager's ``self._current``."""
    if isinstance(node, ast.Call):
        name = call_name(node)
        if name in _SNAPSHOT_CLASSES:
            return True
        if name is not None:
            head, _, tail = name.rpartition(".")
            if tail == "capture" and head.rpartition(".")[2] in _SNAPSHOT_CLASSES:
                return True
    if isinstance(node, ast.Attribute) and node.attr in ("current", "_current"):
        return True
    return False


class _PinTaint:
    """Which expressions of one function reach a tensor a snapshot pins.

    ``pinned`` names hold such a tensor (``x = snap.doc_vecs``, ``dv =
    self.dv_blocks[s]``); ``containers`` hold a fresh list or tuple of
    them (``blocks = list(self.dv_blocks)``: storing into the list is
    fine, writing into an element is not); ``fresh`` holds the source
    text of element targets rebound to a copy (``blocks[s] =
    blocks[s].clone()``), which may then be written, until a name in
    that text is bound again (``for s in ...`` starts another element).
    Statements are read in source order."""

    def __init__(self, snapshots: set[str]):
        self.snapshots = snapshots
        self.pinned: set[str] = set()
        self.containers: set[str] = set()
        self.fresh: dict[str, set[str]] = {}

    def rebound(self, name: str) -> None:
        """``name`` takes a new value: element texts naming it no longer
        denote the element that was copied."""
        self.fresh = {k: v for k, v in self.fresh.items() if name not in v}

    def level(self, node: ast.AST) -> str | None:
        """"pinned", "container" or None for an expression."""
        while True:
            if ast.unparse(node) in self.fresh:
                return None
            if isinstance(node, ast.Name):
                if node.id in self.pinned:
                    return "pinned"
                return "container" if node.id in self.containers else None
            if isinstance(node, ast.Attribute):
                if node.attr in _PINNED_TENSORS:
                    return "pinned"
                if ((isinstance(node.value, ast.Name)
                        and node.value.id in self.snapshots)
                        or _snapshot_sources(node.value)):
                    return "pinned"
                node = node.value
            elif isinstance(node, ast.Subscript):
                if self.level(node.value) is not None:
                    return "pinned"  # an element or a view of one
                return None
            else:
                return None

    def value_level(self, node: ast.AST) -> str | None:
        if (isinstance(node, ast.Call) and call_name(node) in _CONTAINER_CALLS
                and node.args and self.level(node.args[0]) is not None):
            return "container"
        if isinstance(node, (ast.Name, ast.Attribute, ast.Subscript)):
            return self.level(node)
        return None

    def bind(self, target: ast.AST, value: ast.AST) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            values = (value.elts if isinstance(value, (ast.Tuple, ast.List))
                      and len(value.elts) == len(target.elts)
                      else [value] * len(target.elts))
            for t, v in zip(target.elts, values):
                self.bind(t, v)
            return
        lvl = self.value_level(value)
        if isinstance(target, ast.Name):
            self.rebound(target.id)
            self.pinned.discard(target.id)
            self.containers.discard(target.id)
            if lvl == "pinned":
                self.pinned.add(target.id)
            elif lvl == "container":
                self.containers.add(target.id)
        elif isinstance(target, ast.Subscript):
            key = ast.unparse(target)
            copied = (isinstance(value, ast.Call)
                      and method_name(value) in _COPY_METHODS)
            if copied or lvl is None:
                self.fresh[key] = {n.id for n in ast.walk(target)
                                   if isinstance(n, ast.Name)}
            else:
                self.fresh.pop(key, None)


def _in_source_order(fn: ast.AST):
    nodes = [n for n in ast.walk(fn) if hasattr(n, "lineno")]
    return sorted(nodes, key=lambda n: (n.lineno, n.col_offset))


class SnapshotMutationRule(Rule):
    """R4: ``EngineSnapshot`` attributes are assigned only in
    construction, and the tensors it pins are never written in place."""

    id = "snapshot-mutation"
    title = "Snapshot immutability"
    rationale = (
        "Readers serve published EngineSnapshots lock-free; the torn-"
        "read guarantee is exactly that a snapshot's attributes never "
        "change after capture.  The class must stay a frozen dataclass, "
        "and no code may assign attributes on a captured snapshot or "
        "bypass freezing via `object.__setattr__`.  A snapshot binds "
        "the engine's tensors without copying them, so no tensor it "
        "pins (doc_vecs, doc_sigs, kernel_operands, the sharded "
        "plane's blocks) may be written in place — no `add_`/`copy_`/"
        "`index_copy_`/`masked_fill_`/... and no slice store: the "
        "writer clones, patches the clone and rebinds."
    )
    scope = ("*",)

    def check(self, tree: ast.Module, relpath: str) -> list[Finding]:
        out: list[Finding] = []
        for cls in ast.walk(tree):
            if (isinstance(cls, ast.ClassDef)
                    and cls.name in _SNAPSHOT_CLASSES
                    and not _is_frozen_dataclass(cls)):
                out.append(self.finding(
                    relpath, cls,
                    f"`{cls.name}` must be declared "
                    "`@dataclass(frozen=True)` — snapshots are the "
                    "lock-free read plane",
                ))
        seen: set[tuple[int, int]] = set()

        def flag(node: ast.AST, message: str) -> None:
            key = (node.lineno, node.col_offset)
            if key not in seen:  # nested functions are walked twice
                seen.add(key)
                out.append(self.finding(relpath, node, message))

        for fn in walk_functions(tree):
            tainted: set[str] = set()
            pins = _PinTaint(tainted)
            for node in _in_source_order(fn):
                if isinstance(node, ast.Assign):
                    if _snapshot_sources(node.value):
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                tainted.add(t.id)
                    for t in node.targets:
                        if (isinstance(t, ast.Attribute)
                                and (( isinstance(t.value, ast.Name)
                                       and t.value.id in tainted)
                                     or _snapshot_sources(t.value))):
                            flag(t,
                                 "attribute store on a captured "
                                 "EngineSnapshot — snapshots are "
                                 "immutable after construction; build a "
                                 "new snapshot and swap the reference")
                        elif (isinstance(t, ast.Subscript)
                                and pins.level(t.value) == "pinned"):
                            flag(t,
                                 "slice store into a tensor a snapshot "
                                 "pins — write a clone and rebind it "
                                 "(copy-on-write), never the pinned "
                                 "tensor")
                    for t in node.targets:
                        pins.bind(t, node.value)
                elif isinstance(node, (ast.For, ast.comprehension)):
                    for n in ast.walk(node.target):
                        if isinstance(n, ast.Name):
                            pins.rebound(n.id)
                elif (isinstance(node, ast.AugAssign)
                        and pins.level(node.target) == "pinned"):
                    # `t += x` on a tensor (or an element of one) is in place
                    flag(node.target,
                         "in-place update of a tensor a snapshot pins — "
                         "write a clone and rebind it")
                elif isinstance(node, ast.Call):
                    if call_name(node) == "object.__setattr__":
                        flag(node,
                             "`object.__setattr__` bypasses frozen-"
                             "dataclass immutability — construct new "
                             "state instead, or justify with a pragma")
                    elif (method_name(node) in _INPLACE_METHODS
                            and pins.level(node.func.value) == "pinned"):
                        flag(node,
                             f"in-place `.{method_name(node)}(...)` on a "
                             "tensor a snapshot pins — write a clone and "
                             "rebind it (copy-on-write)")
        return out


# --------------------------------------------------------------------------
# R5 — no host synchronization inside captured functions
# --------------------------------------------------------------------------

_HOST_SYNC_CALLS = {"np.asarray", "numpy.asarray", "np.array",
                    "numpy.array"}
_HOST_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
_HOST_SYNC_BUILTINS = {"float", "int", "bool"}


class HostSyncRule(Rule):
    """R5: captured functions never force a device round-trip."""

    id = "host-sync"
    title = "Hot-path host-sync hygiene"
    rationale = (
        "A `.item()`, `.cpu()`, `.tolist()`, `.numpy()`, `int()`, "
        "`float()` or `np.asarray` on a tensor inside a function a CUDA "
        "graph captures either fails the capture or, run eagerly, "
        "forces a device→host sync per dispatch — the silent serving-"
        "latency cliff EdgeRAG warns about.  Host materialization "
        "belongs at the one audited boundary (score_batch_arrays' "
        "return).  `synchronize` (`torch.cuda.synchronize`, a stream's "
        "or an event's) is flagged *anywhere* in a scoped module, "
        "captured or not: it stalls the dispatch pipeline, so every "
        "call site must carry a pragma stating why the barrier is "
        "deliberate (e.g. tracing-only span attribution, gated off the "
        "hot path, or the end of a capture)."
    )
    scope = ("core/*.py", "index/*.py", "serving/*.py", "kernels/*",
             "launch/steps.py")

    def check(self, tree: ast.Module, relpath: str) -> list[Finding]:
        out: list[Finding] = []
        seen: set[tuple[int, int]] = set()
        for fname, fn in captured_functions(tree):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                key = (node.lineno, node.col_offset)
                if key in seen:  # a nested step is walked twice
                    continue
                name = call_name(node)
                meth = method_name(node)
                if meth in _HOST_SYNC_METHODS and not node.args \
                        and name not in _HOST_SYNC_CALLS:
                    msg = (f"`.{meth}()` inside captured `{fname}` — host "
                           "sync per dispatch (and no capture)")
                elif name in _HOST_SYNC_CALLS:
                    msg = (f"`{name}` inside captured `{fname}` — host "
                           "materialization belongs outside the captured "
                           "function")
                elif (name in _HOST_SYNC_BUILTINS and node.args
                        and not isinstance(node.args[0], ast.Constant)):
                    msg = (f"`{name}(...)` inside captured `{fname}` — on "
                           "a tensor it forces a host sync (host-value "
                           "coercions: justify with a pragma)")
                else:
                    continue
                seen.add(key)
                out.append(self.finding(relpath, node, msg))
        # explicit barriers are audited everywhere in scope, not just
        # inside captured bodies — `torch.cuda.synchronize()` and the
        # stream/event `.synchronize()` methods stall the dispatch queue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if ((name is not None
                 and name.rpartition(".")[2] == "synchronize")
                    or method_name(node) == "synchronize"):
                out.append(self.finding(
                    relpath, node,
                    "`synchronize` in a hot-path module — an explicit "
                    "device barrier must be a deliberate, pragma-"
                    "justified boundary (tracing attribution, "
                    "measurement, the end of a capture), never ambient "
                    "synchronization",
                ))
        return out


# --------------------------------------------------------------------------
# R6 — tenant pool pin/lock discipline
# --------------------------------------------------------------------------

_POOL_CLASS = "ContainerPool"
_POOL_STATE = "_resident"
_POOL_GUARD = "_pool_guard"
# OrderedDict mutators split by severity: removals tear a mount down
# (must be pins-checked eviction paths), reorders/inserts merely need
# the pool guard
_POOL_REMOVALS = {"pop", "popitem", "clear"}
_POOL_MUTATORS = _POOL_REMOVALS | {"update", "setdefault", "move_to_end"}


def _resident_attr(node: ast.AST) -> bool:
    return isinstance(node, ast.Attribute) and node.attr == _POOL_STATE


def _resident_mutations(fn: ast.FunctionDef) -> tuple[bool, bool]:
    """(mutates, removes) for direct ``<expr>._resident`` operations in
    ``fn``: subscript/attribute stores, ``del``, and the dict-mutator
    method calls."""
    mutates = removes = False
    for node in ast.walk(fn):
        targets: list[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        elif isinstance(node, ast.Delete):
            targets = list(node.targets)
            for t in targets:
                probe = t.value if isinstance(t, ast.Subscript) else t
                if _resident_attr(probe):
                    mutates = removes = True
            continue
        for t in targets:
            probe = t.value if isinstance(t, ast.Subscript) else t
            if _resident_attr(probe):
                mutates = True
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _POOL_MUTATORS
                and _resident_attr(node.func.value)):
            mutates = True
            if node.func.attr in _POOL_REMOVALS:
                removes = True
    return mutates, removes


def _holds_pool_guard(fn: ast.FunctionDef) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.With):
            for item in node.items:
                expr = item.context_expr
                if (isinstance(expr, ast.Call)
                        and isinstance(expr.func, ast.Attribute)
                        and expr.func.attr == _POOL_GUARD
                        and isinstance(expr.func.value, ast.Name)
                        and expr.func.value.id == "self"):
                    return True
    return False


def _has_pins_check(fn: ast.FunctionDef) -> bool:
    """A refcount comparison against a ``pins`` attribute anywhere in
    the function (``if mt.pins > 0: raise`` / ``assert mt.pins == 0`` /
    the LRU scan's ``if mt.pins == 0``)."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare):
            operands = [node.left, *node.comparators]
            if any(isinstance(o, ast.Attribute) and o.attr == "pins"
                   for o in operands):
                return True
    return False


class TenantPinRule(Rule):
    """R6: pool residency transitions hold the guard; eviction paths
    carry the refcount check."""

    id = "tenant-pin"
    title = "Tenant pool pin/evict discipline"
    rationale = (
        "A tenant mount serving an in-flight flush holds a refcount "
        "pin; evicting it anyway tears the snapshot stack under the "
        "flush, and mutating the pool's resident map outside its guard "
        "races pin/evict transitions.  `ContainerPool._resident` may "
        "be mutated only inside the pool, under `with "
        "self._pool_guard(...)` (or in `*_locked` helpers called under "
        "it), and every method that removes a mount must contain an "
        "explicit `pins == 0` refcount comparison before teardown."
    )
    scope = ("*",)

    def check(self, tree: ast.Module, relpath: str) -> list[Finding]:
        out: list[Finding] = []
        pool_fns: set[int] = set()
        for cls in ast.walk(tree):
            if not isinstance(cls, ast.ClassDef) or cls.name != _POOL_CLASS:
                continue
            for fn in cls.body:
                if not isinstance(fn, ast.FunctionDef):
                    continue
                pool_fns.add(id(fn))
                mutates, removes = _resident_mutations(fn)
                if fn.name == "__init__":
                    continue  # construction: the map is not shared yet
                if mutates and not (fn.name.endswith("_locked")
                                    or _holds_pool_guard(fn)):
                    out.append(self.finding(
                        relpath, fn,
                        f"`{_POOL_CLASS}.{fn.name}` mutates "
                        f"`{_POOL_STATE}` without `with "
                        f"self.{_POOL_GUARD}(...)` (and is not a "
                        "`*_locked` helper called under it)",
                    ))
                if removes and not _has_pins_check(fn):
                    out.append(self.finding(
                        relpath, fn,
                        f"`{_POOL_CLASS}.{fn.name}` removes a mount "
                        f"from `{_POOL_STATE}` without a `pins == 0` "
                        "refcount check — eviction may never tear a "
                        "pinned snapshot stack",
                    ))
        # outside the pool class, _resident is read-only everywhere
        for fn in walk_functions(tree):
            if id(fn) in pool_fns:
                continue
            mutates, _ = _resident_mutations(fn)
            if mutates:
                out.append(self.finding(
                    relpath, fn,
                    f"direct `{_POOL_STATE}` mutation outside "
                    f"`{_POOL_CLASS}` — all residency transitions go "
                    "through the pool's pin/unpin/evict API",
                ))
        return out


RULES: tuple[Rule, ...] = (
    PinnedReductionRule(),
    WriterLockRule(),
    DurabilityRule(),
    SnapshotMutationRule(),
    HostSyncRule(),
    TenantPinRule(),
)
