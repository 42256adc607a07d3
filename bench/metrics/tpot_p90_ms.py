"""p90 over the requests with two or more tokens by the window's close
of (last token's time - first token's time) / (tokens - 1)."""
from bench.lib.readers import delivered, percentile


def read(rec):
    w = rec["window_s"]
    per = []
    for r in rec["requests"]:
        t = delivered(r, w)
        if len(t) >= 2:
            per.append((t[-1] - t[0]) / (len(t) - 1))
    return 1e3 * percentile(per, 0.90) if per else None
