"""The decode step's share of the card's memory bandwidth: over the
unprofiled steps that admitted nothing, the bytes a step needs (every
weight once in bfloat16, and the keys and values of every live slot's
prefix in bfloat16) at the data sheet's bandwidth, over the steps' wall.
Padded cache positions are not counted as needed."""
from bench.lib.readers import decode_steps


def read(rec):
    steps = decode_steps(rec)
    wall = sum(s["end"] - s["start"] for s in steps)
    if wall <= 0:
        return None
    bw = rec["peaks"]["hbm_bytes_per_s"]
    need = sum(rec["weight_bytes"] + rec["kv_bytes_per_token"]
               * s["kv_positions"] for s in steps) / bw
    return 100.0 * need / wall
