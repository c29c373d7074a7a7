"""Per-layer metric readers: metrics/<name>.py, one a metric of
BENCHMARK.json's per_layer list, each with UNIT, LAYER, MOVES, SOURCE and
read(run) → a number, or None where the run gave it nothing to read."""
