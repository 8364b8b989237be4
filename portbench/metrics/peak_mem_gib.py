"""Peak device memory over the window: ``torch.cuda.max_memory_allocated``
after a reset at the window's start, in GiB.  The inputs the benchmark
holds count, as they would for a user."""


def read(rec):
    return rec.peak_bytes / 2**30 if rec.peak_bytes else None
