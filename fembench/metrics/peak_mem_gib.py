"""peak_mem_gib: the CUDA caching allocator's peak over set-up and window
(torch.cuda.max_memory_allocated), in GiB."""


def read(ctx):
    peak = ctx["host"]["peak_bytes"]
    return peak / 2**30 if peak else None
