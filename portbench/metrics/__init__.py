"""One reader a per-layer metric: ``metrics/<name>.py`` defines ``read(r)``,
which returns the number or None where the run gives it nothing to read."""
