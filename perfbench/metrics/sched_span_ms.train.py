"""sched_span_ms.train: host milliseconds of the Chicle scheduler phase
and the batch's trip to the device, from the program's own spans
(`repro_torch.obs.PROGRAM_TRACER`, which records while the profiler
does): the summed ``train.schedule`` (`launch.train.scheduled_batch`) and
``train.to_device`` (`launch.steps.to_device`) durations over the number
of ``train.schedule`` spans, a mean per traced step."""


def read(ctx):
    if "seq_len" not in ctx:
        return None
    from repro_torch import obs
    tracer = getattr(obs, "PROGRAM_TRACER", None)
    if tracer is None:
        return None
    evs = tracer.events
    steps = sum(e.name == "train.schedule" for e in evs)
    if not steps:
        return None
    return 1e3 * sum(e.dur for e in evs if e.name in (
        "train.schedule", "train.to_device")) / steps
