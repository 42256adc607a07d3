"""Mean over the requests admitted in unprofiled steps of the engine's
fenced first-token stamp less the later of the step's call and the
previous admission's stamp in that step: one prompt's prefill and
splice."""
from bench.lib.readers import mean, unprofiled


def read(rec):
    ms = [1e3 * p for s in unprofiled(rec) for p in s["prefill_s"]]
    return mean(ms)
