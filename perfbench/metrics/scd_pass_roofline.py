"""scd_pass_roofline: the SCD passes' share of their roofline, in %: the
least time each pass could take (each input read once and each output
written once at the HBM rate, or its operations at the fp32 CUDA-core
peak, whichever is longer; `pb_yardstick.scd_work`) summed over the
window's passes, over their summed CUDA-event time."""


def read(ctx):
    its = ctx.get("iterations")
    if not its or not ctx.get("cuda"):
        return None
    y = ctx["yardstick"]
    ideal = sum(y.roofline_s(*y.scd_work(i["K"], i["M"], i["F"]))
                for i in its)
    spent = sum(i["scd_s"] for i in its)
    return 100.0 * ideal / spent if spent > 0 else None
