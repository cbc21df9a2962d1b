"""planner: the planner of the stream cell's path (build_block_plan with pinned memory on one chunk, or plan_scans per scan group) timed alone on one thread, ms per MP."""

from jpegbench import layers


def read(run):
    return layers.plan_ms_per_mp(run) if layers.is_stream(run) else None
