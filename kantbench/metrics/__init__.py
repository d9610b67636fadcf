"""One reader per metric, each named as its metric: ``read(m)`` takes the
run's measurements (see ``kantbench.harness.run_cell``) and returns the
metric's value, or None when the run holds nothing to read it from."""
