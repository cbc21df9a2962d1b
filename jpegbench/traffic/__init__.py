"""Traffic mixes (``<name>.json``, parameters only) and the loops that
drive them (``<loop>.py``: ``warm(run)`` and ``window(run, seconds)``)."""
