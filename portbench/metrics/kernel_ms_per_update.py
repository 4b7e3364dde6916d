"""kernel_ms_per_update: device time of every CUDA kernel in the traced
window (`torch.profiler`), in ms, per update applied in it."""


def read(run):
    n = run.counters.get("updates", 0)
    kernel_s = 0.0 if run.trace is None else run.trace.kernel_seconds()
    if kernel_s <= 0 or not n:
        return None
    return 1e3 * kernel_s / n
