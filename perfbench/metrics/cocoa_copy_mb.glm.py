"""cocoa_copy_mb.glm: megabytes (1e6 B) a CoCoA iteration copies between
host and card, counted by the program at its copy sites (the ``bytes`` of
the spans of `repro_torch.obs.PROGRAM_TRACER`, which records while the
profiler does): per ``engine.iteration``, idx, mask, sigma and alpha to
the card for the pass, da back, alpha again for the gap; the mean over
the traced iterations."""


def read(ctx):
    if "iterations" not in ctx:
        return None
    from repro_torch import obs
    tracer = getattr(obs, "PROGRAM_TRACER", None)
    if tracer is None:
        return None
    evs = tracer.events
    n_its = sum(e.name == "engine.iteration" for e in evs)
    if not n_its:
        return None
    total = 0
    for e in evs:
        if "bytes" not in e.args:
            continue
        up = e.parent
        while up is not None and evs[up].name != "engine.iteration":
            up = evs[up].parent
        if up is not None:
            total += e.args["bytes"]
    return total / n_its / 1e6
