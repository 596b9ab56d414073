"""peak_mem_gib: torch.cuda.max_memory_allocated over the whole process,
set-up included, read when the window closes, in GiB."""


def read(run):
    if run.memory_peak_bytes is None:
        return None
    return run.memory_peak_bytes / 2**30
