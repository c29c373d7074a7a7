"""The share of the traced segment in which no operation ran on the
device: 1 − (union of the device operations' intervals) / segment."""

UNIT = "%"
LAYER = "Device (H100)"
MOVES = "output_tok_s"
SOURCE = "device_trace"


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
