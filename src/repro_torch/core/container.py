"""The Single-File Knowledge Container K = ⟨M, C, V, I⟩ (paper §3.1).

One ``.ragdb`` file is a self-describing, content-hashed binary container:

    bytes 0..7    magic  b"RAGDB1\\0\\n"
    bytes 8..15   header length (uint64 LE)
    header JSON   {"generation": g, "meta": {...},          ← M region
                   "data_sha256": <digest of the data area>,
                   "segments": {name: {offset, length, sha256,
                                        dtype, shape}}}
    data          raw segment bytes (C, V, I regions as named segments)

Design goals carried over from the paper:
- **Referential integrity**: every segment's SHA-256 is in the header;
  ``load(verify=True)`` refuses corrupted containers.  A short read
  (truncated file) is reported as corruption too, in *both* verify
  modes — never as an opaque reshape error or silent wrong data.
- **ACID-by-rename**: writes go to a temp file in the same directory and
  are published with ``os.replace`` (atomic on POSIX).  Readers never see
  a torn container.
- **Right to be forgotten**: deleting the file deletes all regions.

Durable incremental persistence (docs/ARCHITECTURE.md §8): a base
container can carry an append-only **delta journal** next to it
(``kb.ragdb`` → ``kb.ragdbj``).  Each journal record is a framed,
self-verifying container image (magic + uint64 length + raw SHA-256 +
payload); a tiny fsync-then-rename **journal manifest**
(``kb.ragdbj.manifest``) is the commit point: bytes beyond its
``committed_bytes`` are a torn append and are truncated on the next
append / ignored on replay, and a per-record digest check degrades an
externally truncated or bit-flipped tail to the longest intact prefix.
The manifest also pins ``base_uid`` — the ``data_sha256`` of the base
image the journal extends — so a stale journal left beside a re-saved
base is discarded, never mis-applied.  This is what carries the paper's
O(U) incremental-ingest contract (§3.3) through to disk: a 1-doc update
appends O(doc) bytes instead of rewriting the O(N) container
(core/ingest.py ``KnowledgeBase.save_delta`` / ``compact``).

Scale-out (docs/ARCHITECTURE.md §1): a *sharded* container is a directory with a
``manifest.json`` naming content-addressed shard files.  The manifest is
itself atomically replaced, and carries a monotonically increasing
``generation`` — the WAL-mode analogue: readers pin a generation; the
ingester publishes the next one without disturbing them.  A 1-shard
container degenerates to exactly one data file, matching the paper.
``publish_sharded_delta`` appends per-shard journal records instead of
rewriting shard files (each manifest entry records the exact journal
byte window its generation sees), and every publish garbage-collects
shard/journal files no manifest within the ``gc_grace`` generation
window references — repeated publishes no longer grow the directory
without bound.

This same format backs the training checkpointer (checkpoint/).
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import tempfile
from dataclasses import dataclass

import numpy as np

from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import global_registry

MAGIC = b"RAGDB1\x00\n"


def _sha256(data: bytes | memoryview) -> str:
    return hashlib.sha256(data).hexdigest()


# --------------------------------------------------------------------------
# text <-> array codecs (the C region is "blob + offsets")
# --------------------------------------------------------------------------

def encode_texts(texts: list[str]) -> dict[str, np.ndarray]:
    blobs = [t.encode("utf-8") for t in texts]
    offsets = np.zeros((len(blobs) + 1,), dtype=np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    blob = np.frombuffer(b"".join(blobs), dtype=np.uint8).copy()
    return {"content_blob": blob, "content_offsets": offsets}


def decode_texts(blob: np.ndarray, offsets: np.ndarray) -> list[str]:
    raw = blob.tobytes()
    return [
        raw[offsets[i]: offsets[i + 1]].decode("utf-8")
        for i in range(len(offsets) - 1)
    ]


# --------------------------------------------------------------------------
# single-file container
# --------------------------------------------------------------------------

def _container_bytes(
    segments: dict[str, np.ndarray],
    meta: dict | None,
    generation: int,
) -> tuple[list[bytes], str]:
    """Serialize a container image: ([magic, hlen, header, *payloads],
    data_sha256).  Shared by file writes and journal records."""
    names = sorted(segments)
    header_segs: dict[str, dict] = {}
    offset = 0
    payloads: list[bytes] = []
    whole = hashlib.sha256()
    for name in names:
        arr = np.asarray(segments[name])
        shape = list(arr.shape)  # before ascontiguousarray (it promotes 0-d)
        arr = np.ascontiguousarray(arr)
        data = arr.tobytes()
        header_segs[name] = {
            "offset": offset,
            "length": len(data),
            "sha256": _sha256(data),
            "dtype": arr.dtype.str,
            "shape": shape,
        }
        offset += len(data)
        payloads.append(data)
        whole.update(data)
    digest = whole.hexdigest()
    header = json.dumps(
        {
            "generation": generation,
            "meta": meta or {},
            "data_sha256": digest,
            "segments": header_segs,
        },
        sort_keys=True,
    ).encode("utf-8")
    parts = [MAGIC, len(header).to_bytes(8, "little"), header, *payloads]
    return parts, digest


def parse_container_bytes(buf: bytes) -> tuple[int, dict, dict[str, np.ndarray]]:
    """Parse an in-memory container image → (generation, meta, segments).

    Used for journal-record replay; the caller has already verified the
    record's whole-payload SHA-256, so per-segment digests are not
    re-checked here.
    """
    if buf[:8] != MAGIC:
        raise ValueError("journal record: bad container-image magic")
    hlen = int.from_bytes(buf[8:16], "little")
    header = json.loads(buf[16: 16 + hlen].decode("utf-8"))
    data_start = 16 + hlen
    segs: dict[str, np.ndarray] = {}
    for name, info in header["segments"].items():
        start = data_start + info["offset"]
        data = buf[start: start + info["length"]]
        if len(data) != info["length"]:
            raise IOError(f"journal record:{name}: truncated segment")
        segs[name] = np.frombuffer(
            data, dtype=np.dtype(info["dtype"])
        ).reshape(info["shape"]).copy()
    return int(header["generation"]), header["meta"], segs


def _fsync_dir(path: str) -> None:
    """Flush directory entries to disk.  A rename-based commit is not
    power-loss durable until the directory itself is fsync'd — without
    this, a published file (or manifest rename) can vanish on power
    failure even though every data fsync succeeded."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform/filesystem without directory fsync
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write_json(path: str, obj: dict, prefix: str,
                       indent: int | None = None) -> None:
    """fsync-then-atomic-rename JSON publish (+ directory fsync).
    Cleans up the temp file if the write fails mid-way."""
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=dirname, prefix=prefix)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, sort_keys=True, indent=indent)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(tmp)
        raise
    _fsync_dir(dirname)


def write_container(
    path: str,
    segments: dict[str, np.ndarray],
    meta: dict | None = None,
    generation: int = 0,
) -> str:
    """Atomically write a container; returns the sha256 of the data area
    (also embedded in the header as ``data_sha256`` — the container's
    identity for journal chaining)."""
    parts, digest = _container_bytes(segments, meta, generation)
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(dirname, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirname, prefix=".ragdb-tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            for data in parts:
                f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic publish
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    _fsync_dir(dirname)
    return digest


@dataclass
class Container:
    path: str
    generation: int
    meta: dict
    _segments: dict[str, dict]
    _data_start: int
    uid: str | None = None  # header data_sha256 (None: pre-uid container)

    @staticmethod
    def open(path: str) -> "Container":
        with open(path, "rb") as f:
            magic = f.read(8)
            if magic != MAGIC:
                raise ValueError(f"{path}: not a RAGdb container (bad magic)")
            hlen = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(hlen).decode("utf-8"))
            data_start = 16 + hlen
        return Container(
            path=path,
            generation=int(header["generation"]),
            meta=header["meta"],
            _segments=header["segments"],
            _data_start=data_start,
            uid=header.get("data_sha256"),
        )

    def segment_names(self) -> list[str]:
        return sorted(self._segments)

    def read(self, name: str, verify: bool = True) -> np.ndarray:
        info = self._segments[name]
        with open(self.path, "rb") as f:
            f.seek(self._data_start + info["offset"])
            data = f.read(info["length"])
        if len(data) != info["length"]:
            # checked in BOTH verify modes: a short read used to surface
            # as an opaque frombuffer/reshape error (or, with a ragged
            # trailing segment, as silently wrong data under verify=False)
            raise IOError(
                f"{self.path}:{name}: truncated segment (expected "
                f"{info['length']} bytes, got {len(data)}) — file corrupt"
            )
        if verify and _sha256(data) != info["sha256"]:
            raise IOError(
                f"{self.path}:{name}: segment sha256 mismatch (corruption)"
            )
        return np.frombuffer(data, dtype=np.dtype(info["dtype"])).reshape(
            info["shape"]
        ).copy()

    def read_all(self, verify: bool = True) -> dict[str, np.ndarray]:
        return {n: self.read(n, verify) for n in self._segments}


# --------------------------------------------------------------------------
# delta journal (append-only .ragdbj next to a base container)
# --------------------------------------------------------------------------

JOURNAL_SUFFIX = ".ragdbj"
RECORD_MAGIC = b"RDJR"
_FRAME_HEAD = len(RECORD_MAGIC) + 8 + 32  # magic + uint64 length + sha256


def journal_path(base_path: str) -> str:
    """``kb.ragdb`` → ``kb.ragdbj`` (next to the base container)."""
    if base_path.endswith(".ragdb"):
        return base_path[: -len(".ragdb")] + JOURNAL_SUFFIX
    return base_path + JOURNAL_SUFFIX


def journal_manifest_path(base_path: str) -> str:
    return journal_path(base_path) + ".manifest"


def read_journal_manifest(base_path: str) -> dict | None:
    mp = journal_manifest_path(base_path)
    if not os.path.exists(mp):
        return None
    with open(mp) as f:
        return json.load(f)


def _publish_journal_manifest(base_path: str, man: dict) -> None:
    """fsync-then-atomic-rename — the journal's commit point.  The
    directory fsync inside also makes a freshly created journal file's
    directory entry durable (same directory)."""
    _atomic_write_json(journal_manifest_path(base_path), man,
                       prefix=".ragdbj-man-")


def append_journal_record(
    base_path: str,
    segments: dict[str, np.ndarray],
    meta: dict | None,
    generation: int,
    base_uid: str,
) -> dict:
    """Append one framed delta record and commit it via the manifest.

    Protocol (crash-safe at every step):
      1. truncate the journal to the last *committed* byte count — this
         drops the torn tail of a previously crashed append;
      2. append ``RECORD_MAGIC + len(payload) + sha256(payload) +
         payload`` (payload = a full container image) and fsync;
      3. publish the new manifest (fsync + atomic rename).  Only now is
         the record visible to replay.

    A crash before (3) leaves the manifest at the previous commit; the
    appended bytes are invisible garbage that step (1) of the next
    append reclaims.  Returns the new manifest dict plus
    ``appended_at`` — the byte offset the record starts at (used by
    sharded manifests to pin per-generation journal windows).
    """
    man = read_journal_manifest(base_path)
    committed, records = 0, 0
    if man is not None and man.get("base_uid") == base_uid:
        committed = int(man["committed_bytes"])
        records = int(man["records"])
    parts, _ = _container_bytes(segments, meta, generation)
    payload = b"".join(parts)
    frame = (
        RECORD_MAGIC
        + len(payload).to_bytes(8, "little")
        + hashlib.sha256(payload).digest()
        + payload
    )
    with obs_trace.span("journal_append", bytes=len(frame),
                        generation=generation):
        fd = os.open(journal_path(base_path), os.O_RDWR | os.O_CREAT, 0o644)
        with os.fdopen(fd, "r+b") as f:
            f.truncate(committed)
            f.seek(committed)
            f.write(frame)
            f.flush()
            os.fsync(f.fileno())
    man = {
        "base_uid": base_uid,
        "committed_bytes": committed + len(frame),
        "records": records + 1,
        "generation": generation,
    }
    with obs_trace.span("journal_commit", generation=generation):
        _publish_journal_manifest(base_path, man)
    reg = global_registry()
    reg.counter("ragdb_journal_bytes_total",
                "delta-record bytes appended (frame incl. header)").inc(
        len(frame))
    reg.counter("ragdb_journal_records_total",
                "delta records appended").inc()
    return {**man, "appended_at": committed}


def read_journal(
    base_path: str,
    base_uid: str | None,
    start: int = 0,
    max_bytes: int | None = None,
) -> list[tuple[int, dict, dict[str, np.ndarray]]]:
    """Replay committed journal records → [(generation, meta, segments)].

    Reads at most ``manifest.committed_bytes`` (a torn append past the
    commit point is invisible) and stops at the first frame that fails
    its magic/length/sha256 check (an externally truncated or corrupted
    tail degrades to the longest intact prefix).  ``base_uid`` mismatch
    means the journal extends a different base image — it is ignored
    wholesale.  ``start``/``max_bytes`` select the byte window a sharded
    manifest entry pinned (``start`` must be a frame boundary recorded
    at publish time).
    """
    man = read_journal_manifest(base_path)
    jp = journal_path(base_path)
    if man is None or not os.path.exists(jp):
        return []
    if base_uid is not None and man.get("base_uid") != base_uid:
        return []
    limit = int(man["committed_bytes"])
    if max_bytes is not None:
        limit = min(limit, max_bytes)
    with open(jp, "rb") as f:
        # ``start`` is a frame boundary recorded at publish time: skip
        # the prefix instead of reading bytes the window ignores
        f.seek(start)
        data = f.read(max(limit - start, 0))
    out: list[tuple[int, dict, dict[str, np.ndarray]]] = []
    off = 0
    n = len(data)
    while off + _FRAME_HEAD <= n:
        if data[off: off + 4] != RECORD_MAGIC:
            break
        plen = int.from_bytes(data[off + 4: off + 12], "little")
        p0 = off + _FRAME_HEAD
        p1 = p0 + plen
        if p1 > n:
            break  # torn tail
        payload = data[p0:p1]
        if hashlib.sha256(payload).digest() != data[off + 12: off + 44]:
            break  # corrupted record: stop at the last intact one
        out.append(parse_container_bytes(payload))
        off = p1
    return out


def reset_journal(base_path: str) -> None:
    """Drop the journal chain (after a full save folded it into the base)."""
    for p in (journal_path(base_path), journal_manifest_path(base_path)):
        with contextlib.suppress(FileNotFoundError):
            os.unlink(p)


def journal_size(base_path: str) -> int:
    """On-disk journal bytes (journal + manifest), 0 if absent."""
    total = 0
    for p in (journal_path(base_path), journal_manifest_path(base_path)):
        with contextlib.suppress(FileNotFoundError):
            total += os.path.getsize(p)
    return total


# --------------------------------------------------------------------------
# sharded container (directory + manifest)
# --------------------------------------------------------------------------

MANIFEST = "manifest.json"


def _entry_files(entry: dict) -> list[str]:
    """All directory file names a manifest shard entry depends on."""
    files = [entry["file"]]
    if entry.get("journal"):
        jp = journal_path(entry["file"])
        files += [jp, jp + ".manifest"]
    return files


def _load_manifest(root: str) -> dict | None:
    mpath = os.path.join(root, MANIFEST)
    if not os.path.exists(mpath):
        return None
    with open(mpath) as f:
        return json.load(f)


def _publish_manifest(
    root: str, gen: int, shard_entries: list[dict], meta: dict | None,
    prev: dict | None, gc_grace: int,
) -> dict:
    """Atomically publish the next-generation manifest.  ``history``
    carries the file sets of the last ``gc_grace`` generations so GC can
    spare files a recently pinned reader may still hold."""
    history = []
    if prev is not None and gc_grace > 0:
        history = list(prev.get("history", []))
        history.append({
            "generation": int(prev["generation"]),
            "files": sorted({
                f for e in prev["shards"] for f in _entry_files(e)
            }),
        })
        history = history[-gc_grace:]
    manifest = {
        "generation": gen,
        "meta": meta or {},
        "shards": shard_entries,
        "history": history,
    }
    _atomic_write_json(os.path.join(root, MANIFEST), manifest,
                       prefix=".manifest-tmp-", indent=1)
    return manifest


def _gc_shard_files(root: str, manifest: dict) -> list[str]:
    """Delete shard/journal files no retained manifest references.

    Retained = the freshly published manifest + its ``history`` window
    (the last ``gc_grace`` generations, for readers pinned on a prior
    generation).  Only ``shard-*`` data/journal files are touched; temp
    files (``.shard-*``, ``.manifest-tmp-*``) belong to in-flight
    writers.  Returns the deleted names (for tests/benchmarks).
    """
    keep: set[str] = set()
    for e in manifest["shards"]:
        keep.update(_entry_files(e))
    for h in manifest.get("history", []):
        keep.update(h["files"])
    deleted = []
    for f in sorted(os.listdir(root)):
        if not f.startswith("shard-"):
            continue
        if not (f.endswith(".ragdb") or f.endswith(JOURNAL_SUFFIX)
                or f.endswith(".manifest")):
            continue
        if f not in keep:
            with contextlib.suppress(FileNotFoundError):
                os.unlink(os.path.join(root, f))
            deleted.append(f)
    return deleted


def publish_sharded(
    root: str,
    shard_segments: list[dict[str, np.ndarray]],
    shard_metas: list[dict] | None = None,
    meta: dict | None = None,
    gc: bool = True,
    gc_grace: int = 1,
) -> int:
    """Write shard files + atomically publish the next-generation manifest.

    Shard files are content-addressed (name includes the data hash) so an
    elastic re-shard or replica copy is a pure manifest edit.  Files from
    superseded generations are garbage-collected after the publish:
    anything unreferenced by the new manifest or by the last ``gc_grace``
    generations (the grace window for readers pinned on a prior
    generation; ``gc=False`` disables collection).  Returns the
    published generation.
    """
    os.makedirs(root, exist_ok=True)
    prev = _load_manifest(root)
    gen = (int(prev["generation"]) if prev else -1) + 1
    shard_metas = shard_metas or [{} for _ in shard_segments]

    shard_entries = []
    for i, segs in enumerate(shard_segments):
        tmp_name = os.path.join(root, f".shard-{gen}-{i}.ragdb")
        digest = write_container(tmp_name, segs, shard_metas[i], generation=gen)
        final = f"shard-{digest[:16]}.ragdb"
        os.replace(tmp_name, os.path.join(root, final))
        shard_entries.append({"file": final, "sha256": digest, "index": i})

    manifest = _publish_manifest(root, gen, shard_entries, meta, prev, gc_grace)
    if gc:
        _gc_shard_files(root, manifest)
    return gen


def publish_sharded_delta(
    root: str,
    shard_patches: dict[int, dict[str, np.ndarray]],
    patch_metas: dict[int, dict] | None = None,
    meta: dict | None = None,
    gc: bool = True,
    gc_grace: int = 1,
) -> int:
    """Publish the next generation by appending per-shard journal patches.

    ``shard_patches`` maps shard index → replacement segments (whole
    segments replace or extend the shard's current view; later records
    win).  Untouched shards carry over from the previous manifest
    unchanged, so a publish writes O(patch) bytes, not O(container) —
    the sharded analogue of ``KnowledgeBase.save_delta``.  Each manifest
    entry records the exact journal byte window (``from``/``bytes``) its
    generation sees, so pinned readers are isolated from later appends
    exactly like they are from later manifests.  Fold journals back into
    fresh shard files by calling ``publish_sharded`` (full write resets
    the windows; GC reclaims the journals once they age out of the grace
    window).
    """
    prev = _load_manifest(root)
    if prev is None:
        raise FileNotFoundError(
            f"{root}: publish_sharded_delta needs a published base manifest"
        )
    gen = int(prev["generation"]) + 1
    entries = [dict(e) for e in prev["shards"]]
    patch_metas = patch_metas or {}
    for i, segs in sorted(shard_patches.items()):
        entry = entries[i]
        base = os.path.join(root, entry["file"])
        uid = Container.open(base).uid
        if uid is None:
            raise ValueError(
                f"{base}: pre-uid shard container cannot anchor a journal "
                "chain — republish it with publish_sharded first"
            )
        man = append_journal_record(
            base, segs, patch_metas.get(i, {}), gen, uid
        )
        prev_win = entry.get("journal")
        entry["journal"] = {
            # chain start: a prior windowed entry extends its chain; a
            # freshly full-written shard starts at this record
            "from": prev_win["from"] if prev_win else man["appended_at"],
            "bytes": man["committed_bytes"],
            "records": (prev_win["records"] if prev_win else 0) + 1,
        }
    manifest = _publish_manifest(root, gen, entries, meta, prev, gc_grace)
    if gc:
        _gc_shard_files(root, manifest)
    return gen


@dataclass
class PatchedShard:
    """A shard view with its pinned journal window applied (duck-types
    ``Container``'s read API).  Patched segments are served from memory;
    untouched ones fall through to the base container."""

    base: Container
    generation: int
    _patches: dict[str, np.ndarray]

    @property
    def path(self) -> str:
        return self.base.path

    @property
    def meta(self) -> dict:
        return self.base.meta

    def segment_names(self) -> list[str]:
        return sorted(set(self.base.segment_names()) | set(self._patches))

    def read(self, name: str, verify: bool = True) -> np.ndarray:
        if name in self._patches:
            return self._patches[name].copy()
        return self.base.read(name, verify)

    def read_all(self, verify: bool = True) -> dict[str, np.ndarray]:
        return {n: self.read(n, verify) for n in self.segment_names()}


@dataclass
class ShardedContainer:
    root: str
    generation: int
    meta: dict
    shards: list[dict]

    @staticmethod
    def open(root: str) -> "ShardedContainer":
        """Pin the current generation (readers are isolated from later
        publishes — the paper's WAL concurrent-reader analogue)."""
        with open(os.path.join(root, MANIFEST)) as f:
            m = json.load(f)
        return ShardedContainer(
            root=root,
            generation=int(m["generation"]),
            meta=m["meta"],
            shards=m["shards"],
        )

    def open_shard(self, i: int) -> Container | PatchedShard:
        entry = self.shards[i]
        base = Container.open(os.path.join(self.root, entry["file"]))
        win = entry.get("journal")
        if not win:
            return base
        records = read_journal(
            base.path, base.uid,
            start=int(win.get("from", 0)), max_bytes=int(win["bytes"]),
        )
        if len(records) < int(win["records"]):
            raise IOError(
                f"{base.path}: journal window truncated "
                f"({len(records)}/{win['records']} records intact)"
            )
        patches: dict[str, np.ndarray] = {}
        for _, _, segs in records:
            patches.update(segs)  # later records win
        return PatchedShard(base, self.generation, patches)

    @property
    def n_shards(self) -> int:
        return len(self.shards)
