"""Output tokens delivered inside the window over the window: those of
the requests due in it, and those of the requests in flight when it
opened."""
from bench.lib.readers import delivered


def read(rec):
    w = rec["window_s"]
    due = sum(len(delivered(r, w)) for r in rec["requests"])
    carried = sum(sum(t <= w for t in ts) for ts in rec.get("carried", []))
    return (due + carried) / w
