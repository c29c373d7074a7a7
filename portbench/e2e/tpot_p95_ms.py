"""95th percentile, over every request finished inside the window, of its
time per output token after the first."""

from portbench.stats import percentile, tpots_ms

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return percentile(tpots_ms(run.rec), 95)
