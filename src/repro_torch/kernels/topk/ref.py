"""Plain PyTorch versions of the top-k kernel (``csrc/topk.cu``).

``top_k_ref`` is the contract: a stable descending sort of the whole
vector, then the first k — the (score desc, id asc) order, with every
NaN (of either sign) first, in id order, as the JAX kernel ranks it.
Like the
kernel (and the JAX package's kernel, whose carry starts from (-inf,
sentinel) slots), a slot that holds -inf carries the sentinel id 2³¹−1
rather than the id of a -inf entry; the JAX package's ``top_k_ref``
oracle gives the entry's id there.

``radix_select`` follows the kernel's own selection step by step — the
order-preserving key, the 11-bit digit passes with their bucket choice,
the final sort of the survivors — so the CPU tests can hold that
algorithm to ``top_k_ref`` bit for bit.  It is a test aid: no wrapper
calls it.
"""
from __future__ import annotations

import torch

ID_SENTINEL = 2**31 - 1
DIGIT_BITS = 11  # the kernel's digit: 2,048 histogram bins a pass


def nan_first_order(scores: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Indices of a stable descending sort along ``dim`` with every NaN
    first, tied among themselves (so in index order).  The sort runs on
    a key whose NaNs are all one NaN: on the card ``torch.sort`` orders
    NaNs by their bit patterns (a -NaN below -inf, payloads apart)."""
    key = scores.masked_fill(torch.isnan(scores), float("nan"))
    return torch.sort(key, dim=dim, descending=True, stable=True).indices


def top_k_ref(scores: torch.Tensor, k: int):
    """(values [k] f32, ids [k] int32) of a [N] score vector; the values
    are the scores' own bits (a NaN keeps its sign and payload)."""
    x = scores.to(torch.float32)
    order = nan_first_order(x)[:k]
    vals, ids = x[order], order.to(torch.int32)
    return vals, ids.masked_fill(torch.isneginf(vals), ID_SENTINEL)


def score_keys(scores: torch.Tensor) -> torch.Tensor:
    """uint32 keys (held in int64) that sort as the f32 scores do: -0.0
    is first made +0.0, then a negative has all its bits flipped and a
    positive its sign bit set.  -inf, never a candidate, gets 0, below
    every candidate's key (> 0x007FFFFF); every NaN, whatever its sign
    and payload, gets the largest key 0xFFFFFFFF, above +inf's
    0xFF800000, so NaNs rank first and tie among themselves (the JAX
    kernel's first-match arg-max order)."""
    x = scores.to(torch.float32).contiguous()
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = bits.masked_fill(x == 0, 0)
    keys = torch.where(bits >= 2**31, bits ^ 0xFFFFFFFF, bits | 2**31)
    keys = keys.masked_fill(torch.isneginf(x), 0)
    return keys.masked_fill(torch.isnan(x), 0xFFFFFFFF)


def id_bits(n: int) -> int:
    """Bits of an id below N: the kernel's key keeps only these of its
    inverted id, whose higher bits are the same for every entry."""
    return (n - 1).bit_length()


def radix_select(scores: torch.Tensor, k: int, groups: int | None = None):
    """The kernel's selection: (values [k], ids [k], passes).

    Each candidate's key is (score key << nb) | (2^nb − 1 − id): the
    inverted id makes every key distinct, so the k-th largest is unique
    and ties need no special case.  Digit passes, most significant first,
    histogram the keys that share the prefix chosen so far and pick the
    bucket holding the k-th; they end when that bucket holds exactly the
    keys still needed — so the id bits are reached only when score ties
    span the k-th slot.  The survivors (keys ≥ the prefix) are sorted
    once; values are the floats read at their ids.  ``passes`` lists the
    low bit of each pass's digit.

    With ``groups``, keys first drop below the kernel's bound: entry i
    belongs to group i % groups (the kernel's warps), and the k-th largest
    group maximum has k keys at or above it, so the k best keys do too."""
    n = scores.shape[0]
    nb = id_bits(n)
    mask = (1 << nb) - 1
    sk = score_keys(scores)
    cand = sk != 0
    keys = (sk << nb) | (mask - torch.arange(n, dtype=torch.int64))
    if groups is not None:
        tops = torch.zeros(groups, dtype=torch.int64).scatter_reduce(
            0, torch.arange(n) % groups, keys.masked_fill(~cand, 0), "amax")
        if int((tops > 0).sum()) >= k:
            cand &= keys >= torch.sort(tops, descending=True).values[k - 1]
    prefix, shift, kk, done, passes = 0, 32 + nb, k, False, []
    while not done:
        lo = max(shift - DIGIT_BITS, 0)
        live = keys[cand & ((keys >> shift) == prefix)]
        hist = torch.bincount((live >> lo) & ((1 << (shift - lo)) - 1),
                              minlength=1 << DIGIT_BITS)
        passes.append(lo)
        if live.numel() <= kk:  # fewer candidates than k: take them all
            break
        above_incl = torch.cumsum(hist.flip(0), 0)  # from the top digit
        r = int(torch.searchsorted(above_incl, kk))
        digit = (1 << DIGIT_BITS) - 1 - r
        above = int(above_incl[r]) - int(hist[digit])
        prefix, shift, kk = (prefix << (shift - lo)) | digit, lo, kk - above
        done = int(hist[digit]) == kk
    won = torch.sort(keys[cand & ((keys >> shift) >= prefix)],
                     descending=True).values
    ids = (mask - (won & mask)).to(torch.int32)
    vals = torch.full((k,), float("-inf"), dtype=torch.float32)
    out_ids = torch.full((k,), ID_SENTINEL, dtype=torch.int32)
    vals[:won.numel()] = scores.to(torch.float32)[ids.long()]
    out_ids[:won.numel()] = ids
    return vals, out_ids, passes
