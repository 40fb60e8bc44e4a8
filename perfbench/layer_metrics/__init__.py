"""One reader a per-layer metric: `read(obs)` returns its value, or None where the run has nothing to read."""
