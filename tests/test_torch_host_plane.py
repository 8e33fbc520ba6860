"""Host data plane of the PyTorch port against the JAX package: the same
hashed vectors, idf, signatures and postings from the same texts, the
same container and journal bytes, and each package loading the other's
containers (journal replay and torn-tail recovery included)."""
import os

import numpy as np
import pytest

from repro.core import container as C
from repro.core import signature as sig_ref
from repro.core.ingest import KnowledgeBase as RefKB
from repro.data.corpus import make_corpus as ref_make_corpus
from repro_torch.core import container as C_port
from repro_torch.core import signature as sig_port
from repro_torch.core.ingest import KnowledgeBase as PortKB
from repro_torch.data.corpus import make_corpus as port_make_corpus


def _texts(n=40, seed=0):
    docs, entities = ref_make_corpus(n_docs=n, n_entities=4, seed=seed)
    return {f"doc_{i:05d}.txt": d for i, d in enumerate(docs)}, entities


def _kb(cls, texts, dim=512):
    kb = cls(dim=dim)
    for name, text in texts.items():
        kb.add_text(name, text)
    return kb


def _fingerprint(kb):
    matrix, sigs, ids = kb.materialize()
    p = kb.postings()
    return {
        "ids": ids, "matrix": matrix, "sigs": sigs,
        "df": kb.vectorizer.df.copy(), "idf": kb.vectorizer.idf(),
        "texts": dict(kb.texts),
        "records": {k: vars(r).copy() for k, r in kb.records.items()},
        "post": (p.term_hashes, p.offsets, p.doc_ids),
        "generation": kb.loaded_generation,
    }


def _assert_same(a, b):
    assert a["ids"] == b["ids"]
    for key in ("matrix", "sigs", "df", "idf"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for x, y in zip(a["post"], b["post"]):
        np.testing.assert_array_equal(x, y)
    assert a["texts"] == b["texts"]
    assert a["records"] == b["records"]
    assert a["generation"] == b["generation"]


@pytest.mark.parametrize("seed", [0, 3])
def test_corpus_generator_identical(seed):
    assert ref_make_corpus(n_docs=50, n_entities=5, seed=seed) == \
        port_make_corpus(n_docs=50, n_entities=5, seed=seed)


@pytest.mark.parametrize("dim", [256, 384])
def test_vectors_idf_signatures_identical(dim):
    texts, entities = _texts()
    ref, port = _kb(RefKB, texts, dim), _kb(PortKB, texts, dim)
    _assert_same(_fingerprint(ref), _fingerprint(port))
    tcs = [port.term_counts[i] for i in sorted(port.records)]
    np.testing.assert_array_equal(
        ref.vectorizer.build_unweighted_matrix(tcs),
        port.vectorizer.build_unweighted_matrix(tcs))
    for q in list(entities) + ["quarterly revenue forecast", ""]:
        np.testing.assert_array_equal(ref.vectorizer.query_vector(q),
                                      port.vectorizer.query_vector(q))
        a = sig_ref.query_signature(q, width_words=ref.sig_words)
        b = sig_port.query_signature(q, width_words=port.sig_words)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def _mutate(kb, round_no):
    kb.add_text(f"new_{round_no}.txt", f"brand new text CODE-{round_no}")
    kb.add_text("doc_00003.txt", f"doc three rewritten r{round_no}")
    kb._remove_doc(sorted(kb.records)[round_no + 5])


def test_container_and_journal_bytes_identical(tmp_path):
    texts, _ = _texts()
    ref, port = _kb(RefKB, texts), _kb(PortKB, texts)
    pr, pp = str(tmp_path / "ref.ragdb"), str(tmp_path / "port.ragdb")
    ref.save(pr)
    port.save(pp)
    assert open(pr, "rb").read() == open(pp, "rb").read()
    for round_no in range(3):
        _mutate(ref, round_no)
        _mutate(port, round_no)
        ref.save_delta(pr, compact_ratio=None)
        port.save_delta(pp, compact_ratio=None)
        assert open(C.journal_path(pr), "rb").read() == \
            open(C_port.journal_path(pp), "rb").read()
        assert open(C.journal_manifest_path(pr), "rb").read() == \
            open(C_port.journal_manifest_path(pp), "rb").read()


@pytest.mark.parametrize("writer,reader", [(RefKB, PortKB), (PortKB, RefKB)])
def test_each_package_loads_the_others_container(tmp_path, writer, reader):
    """Base + journal written by one package replays in the other to the
    same state the writer holds."""
    texts, _ = _texts()
    kb = _kb(writer, texts)
    p = str(tmp_path / "kb.ragdb")
    kb.save(p)
    for round_no in range(2):
        _mutate(kb, round_no)
        kb.save_delta(p, compact_ratio=None)
    _assert_same(_fingerprint(writer.load(p)), _fingerprint(reader.load(p)))
    _assert_same(_fingerprint(kb), _fingerprint(reader.load(p)))


@pytest.mark.parametrize("writer,reader", [(RefKB, PortKB), (PortKB, RefKB)])
def test_torn_journal_tail_recovers_alike(tmp_path, writer, reader):
    """A torn last journal record replays to the last intact record in
    both packages."""
    texts, _ = _texts()
    kb = _kb(writer, texts)
    p = str(tmp_path / "kb.ragdb")
    kb.save(p)
    _mutate(kb, 0)
    kb.save_delta(p, compact_ratio=None)
    _mutate(kb, 1)
    kb.save_delta(p, compact_ratio=None)
    jp = C.journal_path(p)
    size = os.path.getsize(jp)
    with open(jp, "r+b") as f:
        f.truncate(size - 7)
    _assert_same(_fingerprint(writer.load(p)), _fingerprint(reader.load(p)))
