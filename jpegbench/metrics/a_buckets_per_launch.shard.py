"""kernels: the geometry buckets each kernel-A launch of the yielded fused chunks decodes (the port's a_buckets counts: one a launch, n its buckets), on average. None where the port records no such count (one from before it) or every chunk fell back."""

from jpegbench import spans

A_BUCKETS = "a_buckets"


def read(run):
    recs = spans.log(run)
    engines = [r["engine"] for r in run.records if "engine" in r]
    fused = {k for k, engine in enumerate(engines) if engine != "fallback"}
    counts = [r.n for r in recs or () if r.name == A_BUCKETS and r.unit in fused]
    if not counts:
        return None
    return sum(counts) / len(counts)
