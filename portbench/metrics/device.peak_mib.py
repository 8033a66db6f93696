"""device.peak_mib: ``torch.cuda.max_memory_allocated()`` over the
window, after ``reset_peak_memory_stats()`` at its start (MiB)."""


def read(w):
    return w.peak_bytes / 2 ** 20 if w.peak_bytes else None
