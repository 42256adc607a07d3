"""Tokens of the steps completed in the window over the time from the
window's start to the end of the last of them (host clock; each step
ends on a fenced read of its loss)."""


def read(rec):
    done = [s for s in rec["steps"] if s["end"] <= rec["window_s"]]
    if not done:
        return None
    return len(done) * rec["tokens_per_step"] / done[-1]["end"]
