"""One reader a metric, ``<metric>.py``: ``read(record)`` returns the
metric's value from the run's record, or None where there is nothing to
read (the metric is then left out of the result line)."""
