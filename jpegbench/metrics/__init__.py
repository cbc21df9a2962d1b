"""One reader per metric, ``<metric name>.py``, each with ``read(run)``:
the metric's value, or None where the run has nothing for it to read.
The shared arithmetic is in ``jpegbench.layers``."""
