"""kernels: kernel A's device time (profiler) in a stream of mixed sizes against the least time its counted bytes and operations need at the published peaks, in percent. Each chunk of the window launches kernel A once per geometry bucket, the buckets in order of first appearance in the chunk (the stream's and the batch ladder's order alike): launch k pairs with the k-th bucket of the window's chunks in turn, and the sums stop at the shorter list."""

from jpegbench import layers, roofline

KERNEL = "wavefront_pixels_kernel"


def _geometry(run, i):
    frame = layers._parsed(run, i).frame
    return frame.height, frame.width, tuple((c.h, c.v) for c in frame.components)


def bucket_bounds(run, launches: int):
    """The least time (ms) of each bucket's kernel-A launch, chunk by chunk
    in the window's order, until there are `launches` or the order ends."""
    cs = run.traffic["chunk_size"]
    bounds = []
    c = 0
    while len(bounds) < launches and (c + 1) * cs <= len(run.order):
        buckets = {}
        for i in run.order[c * cs:(c + 1) * cs]:
            buckets.setdefault(_geometry(run, i), []).append(i)
        for members in buckets.values():
            work = [layers._work(run, ("a", i), lambda i=i: roofline.kernel_a_work(layers._parsed(run, i)))
                    for i in members]
            bounds.append(roofline.bound(sum(b for b, _o in work), sum(o for _b, o in work))[0])
        c += 1
    return bounds


def read(run):
    if run.trace is None or not layers.is_stream(run):
        return None
    durations = run.trace.kernels(KERNEL)
    return layers._share(durations, bucket_bounds(run, len(durations)))
