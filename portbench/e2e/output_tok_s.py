"""Every output token that reached the host inside the window (the first
token of a prefill and each decode chunk's needed tokens), over the time
from the window's start to the last of those arrivals.  Tokens reach the
host in lumps, a decode chunk's at once; ending the rate's span at an
arrival keeps a lump that straddles the deadline from swinging it."""

UNIT = "tokens/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    rec = run.rec
    inside = [(t, c) for t, c in rec.arrivals if rec.start < t <= rec.deadline]
    if not inside:
        return None
    return sum(c for _, c in inside) / (inside[-1][0] - rec.start)
