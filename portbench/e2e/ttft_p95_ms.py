"""95th percentile, over every request whose first token reached the host
inside the window, of first-token time − send time (closed loop: a
request is sent when the completion it waits for comes back)."""

from portbench.stats import percentile, ttfts_ms

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return percentile(ttfts_ms(run.rec), 95)
