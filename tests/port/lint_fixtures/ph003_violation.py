"""PH003 torch fixture: reads after a hand-off (two findings) — a view of
a buffer read after the buffer was passed as `out=`, and a chunk of a
Prefetcher stream read after the loop moved on."""
import torch


def accumulate(a, b, buf):
    head = buf[:4]
    torch.add(a, b, out=buf)
    return head.sum()


def last_chunk(prefetcher):
    for spec, ch in prefetcher.stream():
        x = ch["x"]
    return x.sum()
