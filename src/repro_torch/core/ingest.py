"""Automated multimodal ingestion + the O(U) incremental algorithm
(paper §3.2–§3.3).

Pipeline per document:  sniff → extract → normalize → vectorize.

Incremental algorithm (paper §3.3, kept exactly):
  1. scan the target directory,
  2. SHA-256 of each file's bitstream,
  3. compare against the metadata region M,
  4. unchanged → skip; new/changed → run the pipeline; vanished → remove.

Cost is O(U) in *updated* files — the expensive stages (extraction,
tokenization, signature construction) are only run for the delta.  The
cheap global stage (IDF re-weighting + matrix materialization) is a single
vectorized pass; it is deferred until `materialize()` so a burst of syncs
pays it once.  Every mutation is also recorded in a dirty-row change log
(`version` / `changes_since`) so the serving plane (core/engine.py) can
patch its device-resident arrays incrementally instead of rebuilding.

Modality frontends: text/CSV/JSON extractors are real; PDF/image/DOCX are
**stubs** per the task rules (the paper uses ONNX OCR — a model frontend
we intentionally do not ship).  The sniffing/routing layer itself is real
and tested.
"""
from __future__ import annotations

import contextlib
import csv
import hashlib
import io
import json
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import signature as sigmod
from repro_torch.core.postings import PostingsIndex
from repro_torch.core.container import (
    Container,
    append_journal_record,
    decode_texts,
    encode_texts,
    journal_size,
    read_journal,
    reset_journal,
    write_container,
)
from repro_torch.core.tokenizer import TermCounts
from repro_torch.core.vectorizer import HashedTfIdf
from repro_torch.obs import trace as obs_trace

# --------------------------------------------------------------------------
# modality sniffing (paper §3.2 "magic-byte analysis")
# --------------------------------------------------------------------------

MAGIC_TABLE = [
    (b"%PDF-", "pdf"),
    (b"\x89PNG", "image"),
    (b"\xff\xd8\xff", "image"),
    (b"GIF8", "image"),
    (b"PK\x03\x04", "zip"),  # docx/xlsx/zip
]

# bytes of file head handed to the sniffer: wide enough that leading
# whitespace (pretty-printed / BOM-ish JSON) cannot push the first
# structural byte out of the probe window (a 16-byte head used to
# misroute JSON with >15 leading whitespace bytes to "text")
SNIFF_WINDOW = 512

_EXTENSION_HINTS = {".csv": "csv", ".json": "json", ".jsonl": "json"}


def sniff_modality(head: bytes, path: str = "") -> str:
    """Route a file head to a modality frontend (paper §3.2).

    Precedence: binary magic bytes → extension hints → structural
    probe.  Extension hints must outrank the ``{``/``[`` probe: a CSV
    whose first cell starts with ``[`` is CSV, not JSON.
    """
    for magic, kind in MAGIC_TABLE:
        if head.startswith(magic):
            return kind
    hint = _EXTENSION_HINTS.get(os.path.splitext(path)[1].lower())
    if hint is not None:
        return hint
    stripped = head.lstrip()
    if stripped[:1] in (b"{", b"["):
        return "json"
    return "text"


# --------------------------------------------------------------------------
# extractors (normalize heterogeneous sources to text, paper §3.2)
# --------------------------------------------------------------------------

def _extract_text(data: bytes) -> str:
    return data.decode("utf-8", errors="replace")


def _extract_json(data: bytes) -> str:
    """Flatten JSON into `key: value` lines (structure-preserving)."""
    try:
        obj = json.loads(data.decode("utf-8", errors="replace"))
    except json.JSONDecodeError:
        return _extract_text(data)
    lines: list[str] = []

    def walk(prefix: str, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else str(k), v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(f"{prefix}[{i}]", v)
        else:
            lines.append(f"{prefix}: {node}")

    walk("", obj)
    return "\n".join(lines)


def _extract_csv(data: bytes) -> str:
    """Row serialization with headers as context keys (paper §3.2:
    'preserving column headers as context keys')."""
    text = data.decode("utf-8", errors="replace")
    reader = csv.reader(io.StringIO(text))
    rows = list(reader)
    if not rows:
        return ""
    header = rows[0]
    out = []
    for row in rows[1:]:
        cells = [f"{h}={v}" for h, v in zip(header, row)]
        # rows longer than the header used to lose their tail to zip
        # truncation; keep overflow cells under positional colN keys
        cells += [
            f"col{j}={v}"
            for j, v in enumerate(row[len(header):], start=len(header))
        ]
        out.append(", ".join(cells))
    return "\n".join(out)


def _extract_stub(kind: str):
    def extract(data: bytes) -> str:
        # Modality frontend stub: production would run the ONNX OCR /
        # docx parser here.  We surface a deterministic marker so tests
        # can verify routing without shipping a vision model.
        digest = hashlib.sha256(data).hexdigest()[:12]
        return f"[{kind}-frontend-stub content={digest} bytes={len(data)}]"

    return extract


EXTRACTORS = {
    "text": _extract_text,
    "json": _extract_json,
    "csv": _extract_csv,
    "pdf": _extract_stub("pdf"),
    "image": _extract_stub("image"),
    "zip": _extract_stub("zip"),
}


def extract(data: bytes, path: str = "") -> tuple[str, str]:
    kind = sniff_modality(data[:SNIFF_WINDOW], path)
    return EXTRACTORS[kind](data), kind


# --------------------------------------------------------------------------
# knowledge base (in-memory state behind a container)
# --------------------------------------------------------------------------

@dataclass
class IngestStats:
    scanned: int = 0
    skipped: int = 0
    added: int = 0
    updated: int = 0
    removed: int = 0
    seconds: float = 0.0

    @property
    def processed(self) -> int:
        return self.added + self.updated


@dataclass
class DocRecord:
    path: str
    sha256: str
    modality: str
    mtime: float
    size: int = -1      # -1 = unknown (pre-size containers, add_text docs)
    mtime_ns: int = -1  # ns mtime for the O(stat) quick check; -1 = unarmed


@dataclass
class KnowledgeBase:
    """The live object behind a knowledge container.

    Regions: M = `records`, C = `texts`, V = `term_counts` (+ the
    materialized matrix), I = signatures (+ df inside the vectorizer).
    """

    dim: int = 4096
    sig_words: int = sigmod.DEFAULT_WIDTH_WORDS
    vectorizer: HashedTfIdf = None
    records: dict[str, DocRecord] = field(default_factory=dict)
    texts: dict[str, str] = field(default_factory=dict)
    term_counts: dict[str, TermCounts] = field(default_factory=dict)
    signatures: dict[str, np.ndarray] = field(default_factory=dict)
    _dirty: bool = True
    _matrix: np.ndarray | None = None
    _doc_ids: list[str] | None = None
    _sig_matrix: np.ndarray | None = None
    _postings: PostingsIndex | None = None
    # dirty-row change log for incremental query-plane refresh
    # (core/engine.py): doc id → version of the mutation that last
    # touched it.  ``version`` increases on every add/update/remove.
    _version: int = 0
    _changed_at: dict[str, int] = field(default_factory=dict)
    _removed_at: dict[str, int] = field(default_factory=dict)
    # metadata-only changes (re-armed stat fast-path keys on docs whose
    # content did not change): invisible to changes_since — the engine
    # has nothing to re-vectorize — but save_delta persists them so the
    # O(stat) sync win survives a restart
    _meta_changed_at: dict[str, int] = field(default_factory=dict)
    # clustered-index state (src/repro/index/): an opaque dict of raw
    # arrays + scalars the engine writes via ``set_index_state`` after
    # training/maintaining its IVF index.  Persisted as ``ivf_*``
    # container segments + ``meta["index"]`` so a loaded KB serves
    # queries without a cold retrain; ``_index_rev`` vs
    # ``_index_persisted_rev`` decides whether a delta record must
    # carry it.
    index_state: dict | None = None
    _index_rev: int = 0
    _index_persisted_rev: int = 0
    # centroid digest of the last persisted index state: delta records
    # omit the ivf_centroids segment (the dominant byte term, ~√N·D·4)
    # when the chain already carries it — centroids only change on
    # retrain, while assignments/bounds move on every reassign
    _index_persisted_centroid_sha: str | None = None
    # single-writer guard (see _single_writer below)
    _write_lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )
    # ---- persistence chain (save/save_delta/load bookkeeping) ----------
    # container generation of the last save/save_delta/load; -1 = never
    # persisted.  save()/save_delta() default to continuing it
    # monotonically, and load() restores it (it used to be parsed by
    # Container.open and then dropped, resetting the lineage the serving
    # plane pins snapshots against).
    loaded_generation: int = -1
    _persisted_version: int = -1     # KB version covered by the last save
    _persisted_ids: set[str] = field(default_factory=set)
    _persisted_path: str | None = None  # abspath of the journal chain's base
    _base_uid: str | None = None     # data_sha256 of the base container
    # observability: perf_counter stamp of the oldest mutation no
    # snapshot publish has absorbed yet (-1 = nothing pending); read +
    # cleared by serving/snapshot.py to gauge publish lag
    _pending_first_t: float = field(default=-1.0, repr=False, compare=False)

    def __post_init__(self):
        if self.vectorizer is None:
            self.vectorizer = HashedTfIdf(dim=self.dim)

    # ---- single-writer contract -----------------------------------------
    #
    # A KnowledgeBase is NOT a concurrent data structure.  The serving
    # plane (serving/snapshot.py) relies on exactly this contract:
    #
    #   - exactly ONE thread performs mutations (``sync``/``add_text``/
    #     removal) and the subsequent engine ``refresh()``/snapshot
    #     ``publish()``;
    #   - any number of threads may read *published snapshots* — never
    #     the live dicts/arrays here — concurrently with that writer.
    #
    # ``version``/``changes_since`` are safe for the writer thread to
    # interleave with its own mutations (they are how the engine's
    # refresh discovers the delta) but are only meaningful to other
    # threads via the generation a snapshot was pinned at.  The guard
    # below turns a second concurrent writer — a latent torn-index bug —
    # into an immediate, attributable error instead of silent corruption
    # of df counts / change-log ordering.

    @contextlib.contextmanager
    def _single_writer(self, op: str):
        if not self._write_lock.acquire(blocking=False):
            raise RuntimeError(
                f"concurrent KnowledgeBase.{op}: mutations follow a "
                "single-writer contract (one ingest thread; readers go "
                "through serving snapshots — docs/ARCHITECTURE.md §7)"
            )
        try:
            yield
        finally:
            self._write_lock.release()

    # ---- pipeline for a single document --------------------------------

    def _ingest_doc(self, path: str, data: bytes, digest: str, mtime: float,
                    size: int = -1, mtime_ns: int = -1):
        with obs_trace.span("extract") as sp:
            text, kind = extract(data, path)
            sp.set(modality=kind, bytes=len(data))
        if path in self.term_counts:  # changed file: retire old stats
            self.vectorizer.remove_doc(self.term_counts[path])
        tc = TermCounts.from_text(text)
        self.vectorizer.add_doc(tc)
        self.records[path] = DocRecord(path, digest, kind, mtime, size,
                                       mtime_ns)
        self.texts[path] = text
        self.term_counts[path] = tc
        self.signatures[path] = sigmod.signature_of_text(
            text, width_words=self.sig_words
        )
        self._version += 1
        self._changed_at[path] = self._version
        self._removed_at.pop(path, None)
        self._meta_changed_at.pop(path, None)  # superseded by full change
        self._dirty = True
        self._note_mutation()

    # Removal-log bound: entries beyond this are dropped oldest-first.
    # Consumers must treat the removed list as advisory (the engine
    # derives actual removals from the doc-id set, see core/engine.py);
    # only removal *stats* can undercount for consumers further than
    # this many deletions behind.
    REMOVED_LOG_MAX = 4096

    def _remove_doc(self, path: str):
        self.vectorizer.remove_doc(self.term_counts.pop(path))
        self.records.pop(path)
        self.texts.pop(path)
        self.signatures.pop(path)
        self._version += 1
        self._changed_at.pop(path, None)
        self._meta_changed_at.pop(path, None)
        self._removed_at[path] = self._version
        while len(self._removed_at) > self.REMOVED_LOG_MAX:
            self._removed_at.pop(next(iter(self._removed_at)))
        self._dirty = True
        self._note_mutation()

    # ---- publish-lag accounting (read by serving/snapshot.py) -----------

    def _note_mutation(self) -> None:
        if self._pending_first_t < 0:
            self._pending_first_t = time.perf_counter()

    def take_publish_lag(self) -> float | None:
        """Seconds since the oldest mutation no snapshot publish has
        absorbed, clearing the stamp (writer thread only — the
        snapshot manager calls this right after its reference swap).
        None when nothing was pending."""
        t = self._pending_first_t
        if t < 0:
            return None
        self._pending_first_t = -1.0
        return time.perf_counter() - t

    # ---- dirty-row accounting (consumed by core/engine.py) --------------

    @property
    def version(self) -> int:
        """Monotonic mutation counter (0 = as-constructed/loaded).

        Thread-safety: exact only on the writer thread (the
        single-writer contract above).  Other threads must consume
        versions via a pinned snapshot's ``generation``, never by
        polling this property concurrently with mutations.
        """
        return self._version

    def changes_since(self, version: int) -> tuple[list[str], list[str]]:
        """(changed_ids, removed_ids) strictly after ``version``.

        Writer-thread API (single-writer contract): the engine's
        ``refresh()`` calls this between mutations it itself observed;
        calling it from a second thread mid-mutation can see a torn
        change log.

        ``changed`` covers both new and updated documents; a doc that
        was removed and re-added since ``version`` appears only in
        ``changed``.  Ids are sorted for deterministic consumption.
        ``removed`` is advisory (bounded by ``REMOVED_LOG_MAX``):
        consumers must derive authoritative removals from the current
        ``records`` key set, as core/engine.py does.
        """
        changed = sorted(
            p for p, v in self._changed_at.items() if v > version
        )
        removed = sorted(
            p for p, v in self._removed_at.items() if v > version
        )
        return changed, removed

    # ---- the paper's incremental sync ----------------------------------

    def sync(self, source_dir: str, verify_hashes: bool = False) -> IngestStats:
        """Incremental directory sync (paper §3.3).

        Unchanged files are skipped by an O(stat) quick check
        (size + nanosecond mtime, rsync-style) before falling back to
        the content hash.  On filesystems with coarse mtime granularity
        a same-size in-place edit inside one timestamp tick could evade
        the quick check — pass ``verify_hashes=True`` to force content
        hashing for every scanned file (the paper's original O(N·hash)
        scan).

        Single-writer: concurrent mutation from a second thread raises
        (see ``_single_writer``).
        """
        with self._single_writer("sync"), \
                obs_trace.span("ingest_sync") as sp:
            stats = self._sync_locked(source_dir, verify_hashes)
            sp.set(scanned=stats.scanned, added=stats.added,
                   updated=stats.updated, removed=stats.removed,
                   skipped=stats.skipped)
            return stats

    def _sync_locked(self, source_dir: str, verify_hashes: bool) -> IngestStats:
        t0 = time.perf_counter()
        stats = IngestStats()
        seen: set[str] = set()
        for root, _, files in os.walk(source_dir):
            for name in sorted(files):
                full = os.path.join(root, name)
                rel = os.path.relpath(full, source_dir)
                seen.add(rel)
                stats.scanned += 1
                rec = self.records.get(rel)
                st = os.stat(full)
                if (not verify_hashes
                        and rec is not None and rec.size >= 0
                        and rec.mtime_ns >= 0
                        and rec.size == st.st_size
                        and rec.mtime_ns == st.st_mtime_ns):
                    stats.skipped += 1  # O(stat) fast path: no read, no hash
                    continue
                with open(full, "rb") as f:
                    data = f.read()
                digest = hashlib.sha256(data).hexdigest()
                if rec is not None and rec.sha256 == digest:
                    stats.skipped += 1  # content unchanged (e.g. touch)
                    if (rec.size, rec.mtime_ns) != (st.st_size,
                                                    st.st_mtime_ns):
                        # re-arm the stat fast path AND log the metadata
                        # change so save_delta persists the new keys —
                        # otherwise every load() re-hashes this file
                        # forever (the engine sees nothing: content and
                        # vectors are untouched)
                        self._version += 1
                        self._meta_changed_at[rel] = self._version
                    rec.mtime = st.st_mtime
                    rec.size = st.st_size
                    rec.mtime_ns = st.st_mtime_ns
                    continue
                self._ingest_doc(rel, data, digest, st.st_mtime, st.st_size,
                                 st.st_mtime_ns)
                if rec is None:
                    stats.added += 1
                else:
                    stats.updated += 1
        for rel in sorted(set(self.records) - seen):
            self._remove_doc(rel)
            stats.removed += 1
        stats.seconds = time.perf_counter() - t0
        return stats

    def add_text(self, doc_id: str, text: str):
        """Direct ingestion of an already-extracted document.

        Single-writer: concurrent mutation from a second thread raises
        (see ``_single_writer``).
        """
        with self._single_writer("add_text"):
            digest = hashlib.sha256(text.encode("utf-8")).hexdigest()
            self._ingest_doc(doc_id, text.encode("utf-8"), digest, 0.0)

    # ---- materialization (cheap, vectorized, deferred) ------------------

    def materialize(self) -> tuple[np.ndarray, np.ndarray, list[str]]:
        """(doc_matrix [n,D] f32, signatures [n,W] i32, doc_ids)."""
        if self._dirty or self._matrix is None:
            ids = sorted(self.records)
            tcs = [self.term_counts[i] for i in ids]
            self._matrix = self.vectorizer.build_matrix(tcs)
            self._sig_matrix = (
                np.stack([self.signatures[i] for i in ids])
                if ids
                else np.zeros((0, self.sig_words), np.int32)
            )
            self._postings = PostingsIndex.build(tcs)
            self._doc_ids = ids
            self._dirty = False
        return self._matrix, self._sig_matrix, list(self._doc_ids)

    def postings(self) -> PostingsIndex:
        """The ⟨I⟩ region: inverted index over term hashes.

        Never returns None: a container loaded with a matrix but no
        postings segments (pre-postings format) skips the materialize
        rebuild, so build the index from term counts here.
        """
        self.materialize()
        if self._postings is None:
            self._postings = PostingsIndex.build(
                [self.term_counts[i] for i in self._doc_ids]
            )
        return self._postings

    @property
    def n_docs(self) -> int:
        return len(self.records)

    @property
    def unpersisted_changes(self) -> bool:
        """True when this KB holds state the persistence chain does not:
        mutations since the last save/save_delta, index-state movement,
        or any content on a KB that has never been persisted at all.
        The tenancy pool consults this before an eviction so unmounting
        a never-touched tenant does not write an empty container.
        Writer-thread accuracy only (single-writer contract above)."""
        if self._persisted_path is None:
            return self._version > 0 or bool(self.records)
        return (self._version != self._persisted_version
                or self._persisted_ids != set(self.records)
                or self._index_rev > self._index_persisted_rev)

    # ---- clustered-index state (written by core/engine.py) --------------

    def set_index_state(self, state: dict) -> None:
        """Adopt the serving plane's index state (writer thread — the
        engine calls this from ``refresh()``, which the single-writer
        contract puts on the same thread as mutations and publishes).
        Bumps the index revision so the next ``save_delta`` journals it
        even when no documents changed (e.g. a first train on an
        already-persisted corpus)."""
        with self._single_writer("set_index_state"):
            self.index_state = state
            self._index_rev += 1

    def _index_aligned(self) -> bool:
        """True when the index state matches the current doc layout
        (stale state — e.g. docs mutated with no live ivf engine — is
        skipped at save time; the next ivf engine retrains anyway)."""
        return (self.index_state is not None
                and len(self.index_state.get("assign", ()))
                == len(self.records))

    def _index_segments(self, include_centroids: bool = True
                        ) -> dict[str, np.ndarray]:
        st = self.index_state
        segs = {
            "ivf_sig_union": st["sig_union"],
            "ivf_radius": st["radius"],
            "ivf_assign": st["assign"],
        }
        if include_centroids:
            segs["ivf_centroids"] = st["centroids"]
        if st.get("shard_of_cluster") is not None:
            # sharded plane (index/sharded.py): the cluster→shard
            # ownership map rides as one more tiny segment so a reload
            # adopts the exact same partition — small like the
            # assignment array, so it journals with every index delta
            segs["ivf_shard_of_cluster"] = np.asarray(
                st["shard_of_cluster"], np.int32)
        return segs

    def _index_meta(self) -> dict:
        st = self.index_state
        meta = {k: st[k] for k in
                ("kind", "drift", "trained_n", "seed", "ids_sha",
                 "centroid_sha")}
        if st.get("n_shards") is not None:
            meta["n_shards"] = int(st["n_shards"])
        return meta

    @staticmethod
    def _index_state_from(segs: dict, imeta: dict | None,
                          prev: dict | None = None) -> dict | None:
        """Index state from a container image / delta record.  A record
        without the centroid segment inherits centroids from ``prev``
        (the chain's prior state) when the digests agree; a broken
        chain yields None — the next ivf engine retrains (safe)."""
        if imeta is None:
            return None
        if "ivf_centroids" in segs:
            centroids = segs["ivf_centroids"]
        elif (prev is not None
                and prev.get("centroid_sha") == imeta.get("centroid_sha")):
            centroids = prev["centroids"]
        else:
            return None
        state = {
            "kind": imeta.get("kind", "ivf"),
            "centroids": centroids,
            "sig_union": segs["ivf_sig_union"],
            "radius": segs["ivf_radius"],
            "assign": segs["ivf_assign"],
            "drift": int(imeta["drift"]),
            "trained_n": int(imeta["trained_n"]),
            "seed": int(imeta["seed"]),
            "ids_sha": imeta["ids_sha"],
            "centroid_sha": imeta.get("centroid_sha"),
        }
        if (imeta.get("n_shards") is not None
                and "ivf_shard_of_cluster" in segs):
            # the sharded plane's ownership map (absent from states
            # written by a flat-ivf engine — the sharded engine then
            # derives its deterministic partition on adoption)
            state["n_shards"] = int(imeta["n_shards"])
            state["shard_of_cluster"] = segs["ivf_shard_of_cluster"]
        return state

    # ---- container round-trip ------------------------------------------

    def _doc_meta(self, ids: list[str]) -> list[dict]:
        return [
            {
                "id": i,
                "sha256": self.records[i].sha256,
                "modality": self.records[i].modality,
                "mtime": self.records[i].mtime,
                # persist the O(stat) quick-check keys (§3.3): without
                # them the first sync() after a load re-hashes every
                # file, silently losing the incremental-sync win
                "size": self.records[i].size,
                "mtime_ns": self.records[i].mtime_ns,
            }
            for i in ids
        ]

    def _doc_segments(self, ids: list[str],
                      sigs: np.ndarray | None = None) -> dict[str, np.ndarray]:
        """Raw per-doc state (term stats, signatures, texts) + the df
        array, for ``ids`` — the schema shared by the full container and
        journal delta records.  ``sigs`` lets the full save reuse the
        signature matrix ``materialize()`` already stacked."""
        tcs = [self.term_counts[i] for i in ids]
        ptr = np.zeros((len(ids) + 1,), np.int64)
        np.cumsum([t.term_hashes.size for t in tcs], out=ptr[1:])
        if sigs is None:
            sigs = (
                np.stack([self.signatures[i] for i in ids])
                if ids else np.zeros((0, self.sig_words), np.int32)
            )
        return {
            "signatures": sigs,
            "df": self.vectorizer.df,
            "term_hashes": (
                np.concatenate([t.term_hashes for t in tcs])
                if ids else np.zeros((0,), np.uint64)
            ),
            "term_counts": (
                np.concatenate([t.counts for t in tcs])
                if ids else np.zeros((0,), np.int32)
            ),
            "term_ptr": ptr,
            "n_tokens": np.array([t.n_tokens for t in tcs], np.int64),
            **encode_texts([self.texts[i] for i in ids]),
        }

    def save(self, path: str, generation: int | None = None,
             include_matrix: bool = True) -> str:
        """Full (cold) publish: re-serializes every segment.

        ``generation=None`` (the default) continues the persisted
        lineage monotonically — ``loaded_generation + 1``, or 0 for a
        never-persisted KB — so a save/load/save round-trip never resets
        the generation the serving plane pins snapshots against.  A full
        save folds any delta journal next to ``path`` into the base and
        resets it (the stale chain could never replay anyway: the
        journal manifest pins the old base image's ``data_sha256``).

        ``include_matrix=False`` drops the materialized ⟨V⟩ dense
        matrix — it is fully derivable from the stored term counts + df,
        so edge deployments can trade first-query latency for a much
        smaller single file (see RQ3)."""
        with self._single_writer("save"), \
                obs_trace.span("container_save", cold=True):
            return self._save_locked(path, generation=generation,
                                     include_matrix=include_matrix)

    def _save_locked(self, path: str, generation: int | None = None,
                     include_matrix: bool = True) -> str:
        matrix, sigs, ids = self.materialize()
        if generation is None:
            generation = self.loaded_generation + 1
        segments = self._doc_segments(ids, sigs=sigs)
        if include_matrix:
            segments["doc_matrix"] = matrix
        segments.update(self.postings().segments())
        meta = {
            "vectorizer": self.vectorizer.state(),
            "sig_words": self.sig_words,
            "docs": self._doc_meta(ids),
        }
        if self._index_aligned():
            segments.update(self._index_segments())
            meta["index"] = self._index_meta()
            self._index_persisted_centroid_sha = \
                self.index_state.get("centroid_sha")
        digest = write_container(path, segments, meta, generation)
        reset_journal(path)
        self.loaded_generation = int(generation)
        self._persisted_version = self._version
        self._persisted_ids = set(ids)
        self._persisted_path = os.path.abspath(path)
        self._base_uid = digest
        self._index_persisted_rev = self._index_rev
        return digest

    # journal auto-compaction threshold: fold when the journal outgrows
    # this fraction of the base container (replay work stays bounded)
    DEFAULT_COMPACT_RATIO = 0.5

    def save_delta(self, path: str,
                   compact_ratio: float | None = DEFAULT_COMPACT_RATIO) -> int:
        """Durable incremental publish: O(U) bytes, not O(N).

        Appends one delta record — the docs changed/removed since the
        last save (derived from the same change log the engine's
        ``refresh()`` consumes) plus the new df state — to the
        append-only journal next to the base container, then commits it
        via the fsync'd journal manifest (core/container.py).  ``load``
        replays base + journal to a state bit-identical to a full
        ``save()`` of the same KB.  Falls back to a full save when there
        is no base container at ``path`` (or the KB's persisted lineage
        belongs to a different path); no-ops when nothing changed.
        Auto-compacts once the journal exceeds ``compact_ratio`` × base
        size (``None`` disables).  Returns the published generation.

        Single-writer: same contract as ``sync``/``add_text``.
        """
        with self._single_writer("save_delta"):
            return self._save_delta_locked(path, compact_ratio)

    def _save_delta_locked(self, path: str,
                           compact_ratio: float | None) -> int:
        apath = os.path.abspath(path)
        if (self._base_uid is None or self._persisted_path != apath
                or not os.path.exists(path)):
            with obs_trace.span("container_save", cold=True):
                self._save_locked(path)  # cold publish (re)starts the chain
            return self.loaded_generation
        changed = sorted(
            p for p, v in self._changed_at.items()
            if v > self._persisted_version and p in self.records
        )
        # authoritative removals: diff against the persisted id set (the
        # in-memory removal log is advisory/bounded — see changes_since)
        removed = sorted(self._persisted_ids - set(self.records))
        # metadata-only updates (re-armed stat keys, content untouched):
        # persisted as record metadata, no segment payload
        changed_set = set(changed)
        meta_changed = sorted(
            p for p, v in self._meta_changed_at.items()
            if v > self._persisted_version and p in self.records
            and p not in changed_set
        )
        # the clustered index journals alongside the docs: a record is
        # due when the engine trained/maintained it since the last
        # persist (possibly with zero doc changes, e.g. a first train
        # over an already-persisted corpus)
        index_changed = (self._index_rev > self._index_persisted_rev
                         and self._index_aligned())
        if not changed and not removed and not meta_changed \
                and not index_changed:
            return self.loaded_generation  # nothing new: zero bytes written
        gen = self.loaded_generation + 1
        meta = {
            "kind": "delta",
            "vectorizer": self.vectorizer.state(),
            "sig_words": self.sig_words,
            "docs": self._doc_meta(changed),
            "meta_docs": self._doc_meta(meta_changed),
            "removed": removed,
        }
        segments = self._doc_segments(changed)
        if index_changed:
            # centroids ride the record only when they actually moved
            # (train/retrain) — assignments/bounds are the O(N + √N·W)
            # small terms that change on every reassign
            csha = self.index_state.get("centroid_sha")
            segments.update(self._index_segments(
                include_centroids=csha != self._index_persisted_centroid_sha
            ))
            meta["index"] = self._index_meta()
        append_journal_record(path, segments, meta, gen, self._base_uid)
        if index_changed:
            self._index_persisted_rev = self._index_rev
            self._index_persisted_centroid_sha = \
                self.index_state.get("centroid_sha")
        self.loaded_generation = gen
        self._persisted_version = self._version
        self._persisted_ids = set(self.records)
        if (compact_ratio is not None
                and journal_size(path) > compact_ratio * os.path.getsize(path)):
            with obs_trace.span("compact", auto=True):
                self._compact_locked(path)
        return self.loaded_generation

    def compact(self, path: str) -> str:
        """Fold the delta journal back into a fresh base container.

        The rewrite publishes through the same atomic ``os.replace`` as
        any full save, then resets the journal.  A crash in between is
        safe: the new base's ``data_sha256`` no longer matches the stale
        journal manifest, so replay ignores it.  When every mutation is
        already persisted the on-disk state is equivalent, so the
        generation is retained; unpersisted changes fold in and bump it
        (the compact is then also a publish)."""
        with self._single_writer("compact"), \
                obs_trace.span("compact"):
            return self._compact_locked(path)

    def _compact_locked(self, path: str) -> str:
        fully_persisted = (self._persisted_version == self._version
                           and self._persisted_ids == set(self.records))
        gen = (self.loaded_generation
               if fully_persisted and self.loaded_generation >= 0 else None)
        return self._save_locked(path, generation=gen)

    @staticmethod
    def _record_from_meta(d: dict) -> DocRecord:
        # pre-size containers lack size/mtime_ns → -1 (fast path
        # unarmed; the first sync falls back to content hashing and
        # re-arms it)
        return DocRecord(d["id"], d["sha256"], d["modality"], d["mtime"],
                         int(d.get("size", -1)), int(d.get("mtime_ns", -1)))

    def _restore_doc_rows(self, docs_meta: list[dict], segs: dict) -> None:
        """Rebuild per-doc state from the shared container/record schema
        (used by both ``load`` and journal-delta replay)."""
        texts = decode_texts(segs["content_blob"], segs["content_offsets"])
        ptr = segs["term_ptr"]
        for j, d in enumerate(docs_meta):
            i = d["id"]
            self.records[i] = self._record_from_meta(d)
            self.texts[i] = texts[j]
            self.term_counts[i] = TermCounts(
                segs["term_hashes"][ptr[j]: ptr[j + 1]],
                segs["term_counts"][ptr[j]: ptr[j + 1]],
                int(segs["n_tokens"][j]),
            )
            self.signatures[i] = segs["signatures"][j]

    def _apply_delta_record(self, meta: dict, segs: dict) -> None:
        """Structural replay of one journal delta record (load path).

        Writes the raw per-doc state + df directly — no change-log or
        version bump: a replayed KB presents as freshly loaded (version
        0), exactly like a KB loaded from the equivalent full save."""
        for rid in meta.get("removed", []):
            self.records.pop(rid, None)
            self.texts.pop(rid, None)
            self.term_counts.pop(rid, None)
            self.signatures.pop(rid, None)
        self._restore_doc_rows(meta["docs"], segs)
        for d in meta.get("meta_docs", []):
            if d["id"] in self.records:  # stat-key refresh, content as-is
                self.records[d["id"]] = self._record_from_meta(d)
        # df/idf state is an authoritative copy from the record — bit-
        # identical to the saver's live statistics, never re-derived
        self.vectorizer.df = segs["df"]
        self.vectorizer.n_docs = int(meta["vectorizer"]["n_docs"])
        if meta.get("index") is not None:
            # later records win, replayed verbatim; centroids inherit
            # from the chain's prior state when the record omitted them
            self.index_state = self._index_state_from(
                segs, meta["index"], prev=self.index_state
            )
        if meta["docs"] or meta.get("removed"):
            self._dirty = True  # meta-only records leave ⟨V⟩/⟨I⟩ intact

    @staticmethod
    def load(path: str) -> "KnowledgeBase":
        """Open base container + replay its delta journal (if any).

        The replayed state is bit-identical to loading a full ``save()``
        of the same KB: doc order, matrix, signatures, postings and df
        all match (tests/test_persistence.py).  Restores the container
        generation into ``loaded_generation`` so subsequent saves
        continue the lineage."""
        c = Container.open(path)
        segs = c.read_all()
        meta = c.meta
        vec = HashedTfIdf.from_state(meta["vectorizer"], segs["df"])
        kb = KnowledgeBase(dim=vec.dim, sig_words=int(meta["sig_words"]),
                           vectorizer=vec)
        kb._restore_doc_rows(meta["docs"], segs)
        if "doc_matrix" in segs:
            kb._matrix = segs["doc_matrix"]
            kb._sig_matrix = segs["signatures"]
            kb._doc_ids = [d["id"] for d in meta["docs"]]
            kb._postings = PostingsIndex.from_segments(segs)
            kb._dirty = False
        # else: matrix rebuilds lazily from term counts at first query
        kb.index_state = kb._index_state_from(segs, meta.get("index"))
        kb.loaded_generation = int(c.generation)
        kb._persisted_version = 0
        kb._persisted_path = os.path.abspath(path)
        kb._base_uid = c.uid
        if c.uid is not None:
            # journal replay: committed records only; torn/corrupt tails
            # were already dropped by read_journal, and a generation gap
            # (stale chain) stops the replay at the last coherent state
            for gen, rmeta, rsegs in read_journal(path, c.uid):
                if (rmeta.get("kind") != "delta"
                        or gen != kb.loaded_generation + 1):
                    break
                kb._apply_delta_record(rmeta, rsegs)
                kb.loaded_generation = gen
        kb._persisted_ids = set(kb.records)
        if kb.index_state is not None:
            kb._index_persisted_centroid_sha = \
                kb.index_state.get("centroid_sha")
        return kb
