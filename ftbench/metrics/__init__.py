"""One reader a metric, `<metric name>.py`, found by name: `read(rec)`
returns the metric's value from a run's record, or None where the run
has nothing to read; `instrument(rec)`, where a reader has one, returns a
context manager that records what the reader needs during the run."""
