"""idle_share: the traced slice's wall time minus the union of its device
events' intervals, over its wall time."""


def read(ctx):
    window = ctx.slice.window_s
    if window <= 0 or not ctx.slice.events:
        return None
    return 100.0 * (1.0 - ctx.slice.busy_s / window)
