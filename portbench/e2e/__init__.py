"""End-to-end metric readers: e2e/<name>.py, one a metric of BENCHMARK.json's
end_to_end list, each with UNIT, BETTER, SOURCE and read(run)."""
