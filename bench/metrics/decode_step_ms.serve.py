"""Mean wall of the unprofiled ``engine.step()`` calls that admitted
nothing (host clock; the step fences its logits)."""
from bench.lib.readers import decode_step_ms


def read(rec):
    return decode_step_ms(rec)
