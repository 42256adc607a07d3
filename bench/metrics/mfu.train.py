"""The model FLOPs of the unprofiled steps completed in the window
(:func:`train_flops` of the configuration's reference module) over
their wall, as a share of the card's bfloat16 peak."""
from bench.lib.readers import unprofiled


def read(rec):
    steps = [s for s in unprofiled(rec) if s["end"] <= rec["window_s"]]
    wall = sum(s["end"] - s["start"] for s in steps)
    if wall <= 0:
        return None
    flops = rec["model_flops_per_step"] * len(steps)
    return 100.0 * flops / wall / rec["peaks"]["bfloat16_flops"]
