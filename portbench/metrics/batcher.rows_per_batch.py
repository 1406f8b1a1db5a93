"""batcher.rows_per_batch: requests over batches that
``DynamicBatcher.stats()`` counted across the window."""


def read(rec):
    b = rec.get("batcher")
    return b["n_requests"] / b["n_batches"] if b and b["n_batches"] else None
