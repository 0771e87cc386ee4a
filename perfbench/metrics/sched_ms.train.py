"""sched_ms.train: host milliseconds of the Chicle scheduler phase and the
batch's trip to the device (`launch.train.scheduled_batch` and
`launch.steps.to_device`), averaged over the window's steps (a mean per
step, so a faster train step that fits more steps into the window does
not read as more scheduler time)."""


def read(ctx):
    if not ctx.get("steps"):
        return None
    return 1e3 * ctx["sched_s"] / ctx["steps"]
