"""Process start to the window's start: imports, the kernel libraries (built
on a checkout's first run), the weights made and quantized, the engine and
its KV cache, the traffic, and the warm-up of every shape the traffic
reaches."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
