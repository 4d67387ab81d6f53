"""``peak_gib``: the most device memory PyTorch's allocator held during
the window (``torch.cuda.max_memory_allocated`` after a reset at the
window's start), in GiB."""


def read(run):
    return run.window_peak_bytes / 2**30 if run.window_peak_bytes else None
