"""Peak device memory of the run, in GiB: torch.cuda.max_memory_allocated
after a reset at the start, read when the window closes."""


def read(obs):
    return obs.memory_peak_bytes / 2 ** 30 if obs.memory_peak_bytes else None
