"""cocoa_host_ms.glm: host milliseconds of a CoCoA iteration's host-only
phases, from the program's own spans (`repro_torch.obs.PROGRAM_TRACER`,
which records while the profiler does): per ``engine.iteration``, the
summed durations of its ``engine.schedule`` (the policies, chunk and alpha
moves), ``cocoa.pools`` (chunk ids, shuffles, idx and mask) and
``cocoa.alpha_scatter`` (``np.add.at`` and the clip) spans, and of its
``python.gc`` spans that none of those holds; the mean over the traced
iterations."""

HOST = ("engine.schedule", "cocoa.pools", "cocoa.alpha_scatter")


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
    total = 0.0
    for e in evs:
        if e.name not in HOST and e.name != "python.gc":
            continue
        up, held = e.parent, False
        while up is not None and evs[up].name != "engine.iteration":
            held = held or evs[up].name in HOST
            up = evs[up].parent
        if up is not None and not (e.name == "python.gc" and held):
            total += e.dur
    return 1e3 * total / n_its
