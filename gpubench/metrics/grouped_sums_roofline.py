"""grouped_sums_roofline: the kernel's share of its roofline in the traced
slice: the sum of its launches' least times (``kernel_bytes``: bytes over
3.35 TB/s or additions over 67 TFLOP/s, from each call's live rows, the
rows of the batch it aggregates, not the capacity its buffers are padded
to) over the sum of their device times. A launch counts where the trace ties
its kernel to the runtime call that made it and that runtime call to one
recorded call: the one whose host interval holds it, or where several
calls of other threads overlap there, the one on its thread."""

import kernel_bytes


def read(ctx):
    sl = ctx.slice
    if sl is None:
        return None
    calls = ctx.kernel_calls
    bound = device = 0.0
    for k in sl.kernels():
        if "grouped_sums" not in k["name"]:
            continue
        launch = sl.launch_of(k)
        if launch is None:
            continue
        tid, t = launch
        match = [c for c in calls if c[1] <= t <= c[2]]
        if len(match) > 1:
            match = [c for c in match if tid in c[0]]
        if len(match) != 1:
            continue
        _, _, _, live, _, lanes, nseg = match[0]
        bound += kernel_bytes.grouped_sums_bound_s(live, lanes, nseg)
        device += k["dur"] / 1e6
    return 100.0 * bound / device if device > 0 else None
