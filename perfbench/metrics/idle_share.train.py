"""idle_share.train: the share of the traced window in which no operation
ran on the device, in % (`pb_yardstick.device_summary`)."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or "seq_len" not in ctx:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
