"""launches_per_query: kernels the device ran in the traced slice over the
queries that completed in it."""


def read(ctx):
    sl = ctx.slice
    if sl is None:
        return None
    a, b = sl.to_perf(sl.start_us), sl.to_perf(sl.end_us)
    done = sum(1 for r in ctx.records if a <= r["done"] <= b)
    kernels = len(sl.kernels())
    return kernels / done if done and kernels else None
