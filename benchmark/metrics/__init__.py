"""One reader a metric: ``<name>.py`` holds ``UNIT`` and ``read(run)``,
which returns the metric's value from a finished run
(``benchmark/run.py::Run``), or None where the run holds nothing to read;
the harness then leaves the metric out of the result line."""
