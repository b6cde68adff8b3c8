from finito_tpu_torch.utils.logging import write_log, set_log_level, LogLevel, cur_time_micros

_allocator_tuned = False


def tune_host_allocator() -> None:
    """Keep large allocations on the glibc heap instead of mmap/munmap.

    On hosts that service first-touch page faults slowly (microVMs:
    ~10-160 ms/MB), glibc returns mmap'd blocks (any numpy temporary
    > ~32MB) to the OS on free, so every big temporary re-faults its
    pages; raising M_MMAP_THRESHOLD / M_TRIM_THRESHOLD makes the heap
    grow once and recycle warm pages. Safe no-op where glibc is absent."""
    global _allocator_tuned
    if _allocator_tuned:
        return
    _allocator_tuned = True
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6")
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except Exception:
        pass
