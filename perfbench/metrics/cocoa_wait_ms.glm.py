"""cocoa_wait_ms.glm: host milliseconds a CoCoA iteration waits on the
card, from the program's own spans (`repro_torch.obs.PROGRAM_TRACER`,
which records while the profiler does): per ``engine.iteration``, the
summed durations of its ``cat="device"`` spans (``cocoa.da_to_host``, the
blocking ``da.cpu()``; ``cocoa.gap_to_host``, the gap's launches and its
blocking ``float()``); the mean over the traced iterations."""


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
        if e.cat != "device":
            continue
        up = e.parent
        while up is not None and evs[up].name != "engine.iteration":
            up = evs[up].parent
        if up is not None:
            total += e.dur
    return 1e3 * total / n_its
