"""PH003 torch near-misses: the `out=` buffer itself holds the result, a
copy taken before the hand-off is its own storage, and what outlives a
stream loop was computed (or cloned) inside it."""
import torch


def accumulate(a, b, buf):
    torch.add(a, b, out=buf)
    return buf.sum()


def keep_a_copy(a, b, buf):
    head = buf[:4].clone()
    torch.add(a, b, out=buf)
    return head.sum()


def chunk_sums(prefetcher):
    total, kept = None, None
    for spec, ch in prefetcher.stream():
        total = ch["x"].sum()
        kept = ch["x"].clone()
    return total, kept
