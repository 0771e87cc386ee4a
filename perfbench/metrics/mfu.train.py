"""mfu.train: the window's model flops over the summed wall time of the
window's steps at the card's bf16 tensor-core peak, in % (the steps'
own time, so the profiler's work between steps of a traced run is left
out).  Model flops are 6 per parameter that multiplies activations per
token, plus attention's 12 head_dim per visible query-key pair per head
per layer (`pb_yardstick.lm_train_flops`); the recomputation that remat
adds is not counted."""


def read(ctx):
    steps = ctx.get("steps")
    if not steps or "seq_len" not in ctx:
        return None
    y = ctx["yardstick"]
    flops = steps * y.lm_train_flops(ctx["config"], ctx["batch"],
                                     ctx["seq_len"])
    return 100.0 * flops / (ctx["steps_s"] * y.PEAK_FLOPS["bfloat16"])
