"""solver_host_ms.glm: host milliseconds of a CoCoA iteration outside its
SCD pass: each iteration's wall time (the engine's scheduler phase, the
solver's pools, gathers and alpha scatter, the merge and the duality gap)
less its SCD pass's CUDA-event time, averaged over the window's
iterations (a mean per iteration, so a faster pass that fits more
iterations into the window does not read as more host time)."""


def read(ctx):
    its = ctx.get("iterations")
    if not its or not ctx.get("cuda"):
        return None
    return 1e3 * sum(i["wall_s"] - i["scd_s"] for i in its) / len(its)
