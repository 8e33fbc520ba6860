"""Plain reference of the retrieval plane and of prompt packing, in
NumPy and PyTorch, written from the paper's definitions (RAGdb §4) and
the configuration, importing nothing of the program.

    tf(t, d) = 1 + ln f(t, d)          idf(b) = ln(N / (1 + df(b))) + 1
    u_d[b]   = Σ_{t: h(t) mod D = b} tf(t, d) · sign(t)
    v_d      = normalize(u_d ⊙ idf)
    Score(Q, D) = α · cos(v_Q, v_D) + β · 1[sig(Q) ⊆ sig(D)]

with h the 64-bit FNV-1a hash of a lowercase word (runs of [a-z0-9_]),
sign(t) = −1 where the top bit of mix64(h) is set, and sig the Bloom
signature of the lowercase text's 4-byte grams (a polynomial rolling
hash in the FNV prime, mixed; two probes a gram).  The top k are taken
by score, ties to the lower document index.  Scores are computed in
float64 (``control=True``: the cosines from TF32 operands, the control
that the output check must reject).

The derived arrays (the sparse u rows, df and the signatures) are
worked out from the corpus text once per checkout and kept in the cache
directory; nothing the program made is read.
"""
from __future__ import annotations

import functools
import math
import os
import re
from pathlib import Path

import numpy as np
import torch

_TOKEN_RE = re.compile(r"[a-z0-9_]+")
_M64 = (1 << 64) - 1
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MIX = 0xFF51AFD7ED558CCD


def words(text: str) -> list[str]:
    return _TOKEN_RE.findall(text.lower())


@functools.lru_cache(maxsize=1 << 16)
def fnv1a64(word: str) -> int:
    h = _FNV_OFFSET
    for b in word.encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & _M64
    return h


def mix64(h: int) -> int:
    h ^= h >> 33
    h = (h * _MIX) & _M64
    return h ^ (h >> 33)


def _mix64_np(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint64(33))
    h = h * np.uint64(_MIX)
    return h ^ (h >> np.uint64(33))


class Hasher:
    """Word → (bucket, sign) of the hashed vector, with a cache: a
    corpus has few distinct words."""

    def __init__(self, dim: int):
        self.dim = dim
        self._cache: dict[str, tuple[int, int]] = {}

    def __call__(self, word: str) -> tuple[int, int]:
        hit = self._cache.get(word)
        if hit is None:
            h = fnv1a64(word)
            hit = (h % self.dim, -1 if mix64(h) >> 63 else 1)
            self._cache[word] = hit
        return hit


def term_rows(text: str, hasher: Hasher):
    """(buckets, values) of u for one text, and its distinct buckets."""
    counts: dict[str, int] = {}
    for w in words(text):
        counts[w] = counts.get(w, 0) + 1
    acc: dict[int, float] = {}
    for w, c in counts.items():
        b, s = hasher(w)
        acc[b] = acc.get(b, 0.0) + (1.0 + math.log(c)) * s
    return acc


def signature(text: str, sig_words: int, ngram: int = 4,
              probes: int = 2) -> np.ndarray:
    """Bloom signature, uint32 [sig_words]."""
    data = np.frombuffer(text.lower().encode("utf-8"), dtype=np.uint8)
    sig = np.zeros(sig_words, dtype=np.uint32)
    n = len(data) - ngram + 1
    if n <= 0:
        return sig
    with np.errstate(over="ignore"):
        acc = np.zeros(n, dtype=np.uint64)
        for j in range(ngram):
            power = np.uint64(pow(_FNV_PRIME, ngram - 1 - j, 1 << 64))
            acc = acc + data[j:j + n].astype(np.uint64) * power
        h = _mix64_np(acc)
        nbits = np.uint64(sig_words * 32)
        for _ in range(probes):
            pos = (h % nbits).astype(np.int64)
            np.bitwise_or.at(sig, pos >> 5,
                             (np.uint32(1) << (pos & 31).astype(np.uint32)))
            h = _mix64_np(h)
    return sig


def build_arrays(texts: list[str], dim: int, sig_words: int) -> dict:
    """The corpus's derived arrays: u as (row, col, val), df, and the
    signatures (int32 [N, W])."""
    hasher = Hasher(dim)
    rows, cols, vals = [], [], []
    df = np.zeros(dim, dtype=np.int64)
    sigs = np.zeros((len(texts), sig_words), dtype=np.uint32)
    for i, text in enumerate(texts):
        acc = term_rows(text, hasher)
        b = np.fromiter(acc.keys(), dtype=np.int64, count=len(acc))
        rows.append(np.full(len(acc), i, dtype=np.int64))
        cols.append(b)
        vals.append(np.fromiter(acc.values(), dtype=np.float64,
                                count=len(acc)))
        df[b] += 1
        sigs[i] = signature(text, sig_words)
    return {"row": np.concatenate(rows), "col": np.concatenate(cols),
            "val": np.concatenate(vals), "df": df,
            "sigs": sigs.view(np.int32), "n": np.int64(len(texts))}


def load_or_build(texts: list[str], dim: int, sig_words: int,
                  cache_dir: Path) -> dict:
    path = cache_dir / "reference_arrays.npz"
    if path.exists():
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    arrays = build_arrays(texts, dim, sig_words)
    cache_dir.mkdir(parents=True, exist_ok=True)
    tmp = cache_dir / "reference_arrays.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return arrays


class RetrievalReference:
    """HSF top-k over the corpus, on ``device``."""

    def __init__(self, arrays: dict, retrieval: dict, device):
        self.dim = int(retrieval["dim"])
        self.sig_words = int(retrieval["sig_words"])
        self.alpha = float(retrieval["alpha"])
        self.beta = float(retrieval["beta"])
        self.n = int(arrays["n"])
        self.device = torch.device(device)
        self.idf = np.log(self.n / (1.0 + arrays["df"].astype(np.float64))) + 1
        self.hasher = Hasher(self.dim)
        self._arrays = arrays
        self._docs = None
        self.sigs = torch.from_numpy(arrays["sigs"]).to(self.device)

    def docs(self) -> torch.Tensor:
        """The normalized doc matrix, float64 [N, D] on the device."""
        if self._docs is None:
            a = self._arrays
            m = torch.zeros((self.n, self.dim), dtype=torch.float64,
                            device=self.device)
            m[torch.from_numpy(a["row"]).to(self.device),
              torch.from_numpy(a["col"]).to(self.device)] = \
                torch.from_numpy(a["val"]).to(self.device)
            m *= torch.from_numpy(self.idf).to(self.device)[None, :]
            norms = m.norm(dim=1, keepdim=True)
            self._docs = torch.where(norms > 0, m / norms.clamp_min(1e-300),
                                     m)
        return self._docs

    def query_arrays(self, texts: list[str]):
        q = np.zeros((len(texts), self.dim), dtype=np.float64)
        s = np.zeros((len(texts), self.sig_words), dtype=np.uint32)
        for i, t in enumerate(texts):
            for b, v in term_rows(t, self.hasher).items():
                q[i, b] = v
            q[i] *= self.idf
            norm = np.linalg.norm(q[i])
            if norm > 0:
                q[i] /= norm
            s[i] = signature(t, self.sig_words)
        return q, s.view(np.int32)

    def top_k(self, texts: list[str], k: int, control: bool = False,
              chunk: int = 64):
        """(ids [B, k] int64, scores, cosines, indicators [B, k] float64,
        and the full score rows' cosine and indicator for looking up
        any document): numpy arrays."""
        qv, qs = self.query_arrays(texts)
        docs = self.docs()
        out = {"ids": [], "scores": [], "cos_all": [], "ind_all": []}
        for lo in range(0, len(texts), chunk):
            q = torch.from_numpy(qv[lo:lo + chunk]).to(self.device)
            qsig = torch.from_numpy(qs[lo:lo + chunk]).to(self.device)
            if control:
                cos = (tf32_round(q.float())
                       @ tf32_round(docs.float()).T).double()
            else:
                cos = q @ docs.T
            ind = torch.stack([((self.sigs & s) == s).all(dim=1)
                               for s in qsig]).to(torch.float64)
            scores = self.alpha * cos + self.beta * ind
            vals, idx = torch.sort(scores, dim=1, descending=True,
                                   stable=True)
            out["ids"].append(idx[:, :k].cpu().numpy())
            out["scores"].append(vals[:, :k].cpu().numpy())
            out["cos_all"].append(cos.cpu().numpy())
            out["ind_all"].append(ind.cpu().numpy())
        return {key: np.concatenate(v) for key, v in out.items()}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 operands rounded to TF32's 10 mantissa bits (to nearest,
    ties away), as the tensor cores read them; the product is then
    taken in float32 (TF32 off), so the control reads the same on any
    device."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def text_tokens(text: str, vocab: int) -> list[int]:
    """The generator's token ids of a text: each word's FNV-1a hash
    modulo the vocabulary."""
    return [fnv1a64(w) % vocab for w in words(text)]


def pack_prompt(question: str, doc_texts: list[str], vocab: int,
                max_context: int) -> list[int]:
    """The prompt the configuration asks for: the retrieved passages in
    rank order, each cut to what is left of ``max_context`` tokens, then
    the question, keeping the last ``max_context`` tokens."""
    packed: list[int] = []
    for text in doc_texts:
        toks = text_tokens(text, vocab)
        packed.extend(toks[:max_context - len(packed)])
        if len(packed) >= max_context:
            break
    prompt = (packed + text_tokens(question, vocab))[-max_context:]
    return prompt or [0]
