"""stream: the geometry buckets of each fused chunk the window yielded (the prep threads' plan spans in the chunk's unit: one build_block_plan per bucket), per fused chunk. A window whose chunks all fell back reads None."""

from jpegbench import spans


def read(run):
    recs = spans.log(run)
    engines = [r["engine"] for r in run.records if "engine" in r]
    fused = {k for k, engine in enumerate(engines) if engine != "fallback"}
    if not recs or not fused:
        return None
    return sum(r.name == spans.PLAN and not r.mirrored and r.unit in fused for r in recs) / len(fused)
