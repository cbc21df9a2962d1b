"""planner: the prep threads' parse and plan spans for the chunks yielded in the window, in ms per MP of those chunks: contended, in the window, where parse_ms_per_mp.shard and plan_ms_per_mp.shard time one thread alone."""

from jpegbench import spans


def read(run):
    return spans.prep_ms_per_mp(run)
