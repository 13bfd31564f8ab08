"""The window's peak of device memory held by tensors, in GiB
(``torch.cuda.max_memory_allocated`` after a reset at the window's
start)."""


def read(record):
    peak = record.get("memory_peak_bytes")
    return peak / 2 ** 30 if peak else None
