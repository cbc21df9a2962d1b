"""planner: build_block_plan on one frame at a time, or build_norst_plan, timed alone on one thread over 8 upload frames, ms per MP."""

from jpegbench import layers


def read(run):
    return None if layers.is_stream(run) else layers.plan_ms_per_mp(run)
