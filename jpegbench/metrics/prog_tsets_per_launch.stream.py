"""kernels: the Huffman table sets each launch of kernels 7-9 decodes in the chunks the window yielded, fallback chunks included (the port's prog_tsets counts: one a launch, n its sets), on average. None where the port records no such count (one from before it) or no chunk ran the progressive kernels."""

from jpegbench import spans

PROG_TSETS = "prog_tsets"


def read(run):
    recs, n = spans.log(run), spans.yielded(run)
    counts = [r.n for r in recs or () if r.name == PROG_TSETS and r.unit is not None and r.unit < n]
    if not counts:
        return None
    return sum(counts) / len(counts)
