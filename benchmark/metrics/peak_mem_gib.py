"""peak_mem_gib: the most device memory allocated during the window,
resident weights included (torch.cuda.max_memory_allocated)."""


def compute(rec):
    return rec["peak_bytes"] / 2 ** 30 if rec["peak_bytes"] else None
