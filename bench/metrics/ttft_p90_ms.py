"""p90 over every request due in the window of its first token's time
(the engine's fenced stamp) less its scheduled arrival; a request with
no first token by the window's close enters with its wait so far."""
from bench.lib.readers import first_token_wait, percentile


def read(rec):
    w = rec["window_s"]
    waits = [first_token_wait(r, w) for r in rec["requests"]]
    return 1e3 * percentile(waits, 0.90) if waits else None
