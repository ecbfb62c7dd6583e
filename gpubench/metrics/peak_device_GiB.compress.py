"""The allocator's peak of device memory over the window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``),
GiB."""


def read(run):
    if not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / 2**30
