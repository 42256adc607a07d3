"""1 - the union of the device's spans over the traced steps' wall, in
% (training: one whole step in mid-window; serving: the steps that
admitted nothing among those traced from mid-window)."""
from bench.lib.readers import idle_share


def read(rec):
    return idle_share(rec)
