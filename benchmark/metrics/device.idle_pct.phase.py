"""The device's idle share in the profiled job: the time no kernel,
copy or fill ran on the card over the job's length, in per cent."""


def read(ctx):
    if not ctx.window_s or ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
