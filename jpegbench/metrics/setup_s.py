"""Process start to the first timed request: pool, imports, kernel builds, warm-up (host clock)."""


def read(run):
    return run.start_epoch - run.process_start
