"""One reader a metric, each in a file named after the metric: ``read(rec)``
takes a run's record (what the job returned) and gives the metric's value,
or None where the record holds nothing to read it from, and the harness
then leaves the metric out of the line."""
