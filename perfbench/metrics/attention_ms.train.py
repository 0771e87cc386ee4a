"""attention_ms.train: milliseconds of the train step's attention on the
card, from the program's own device spans
(`repro_torch.obs.PROGRAM_TRACER`, which records while the profiler does;
CUDA events on the card, the host clock on the CPU): the summed durations
of the ``train.attention`` spans (the flash route's forward, remat's
recomputation and backward, arg ``phase``) over the traced steps (the
``train.optimizer`` spans without a ``micro`` argument: one a step).
A program without the span reads nothing."""


def read(ctx):
    if "seq_len" not in ctx:
        return None
    from repro_torch import obs
    tracer = getattr(obs, "PROGRAM_TRACER", None)
    if tracer is None:
        return None
    evs = tracer.events
    steps = sum(e.name == "train.optimizer" and "micro" not in e.args
                for e in evs)
    spans = [e.dur for e in evs if e.name == "train.attention"]
    if not steps or not spans:
        return None
    return 1e3 * sum(spans) / steps
