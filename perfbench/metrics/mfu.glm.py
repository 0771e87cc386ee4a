"""mfu.glm: the CoCoA iterations' share of the card's roofline, in %: per
iteration the larger of its model flops at the fp32 CUDA-core peak and X
read once at the HBM rate, summed over the window's iterations, over
their summed wall time.  Model flops: 6 F + 12 per row the SCD passes
visit (the dot, |x|^2 and the update) and 2 F per row for the duality
gap's X w."""


def read(ctx):
    its = ctx.get("iterations")
    if not its:
        return None
    y = ctx["yardstick"]
    n, F = ctx["n_samples"], ctx["n_features"]
    ideal = sum(max((i["samples"] * (6 * F + 12) + n * 2 * F)
                    / y.PEAK_FLOPS["float32"], 4.0 * n * F / y.HBM_BW)
                for i in its)
    return 100.0 * ideal / sum(i["wall_s"] for i in its)
