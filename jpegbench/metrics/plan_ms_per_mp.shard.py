"""planner: build_block_plan (pinned on a card) once per geometry bucket of one chunk of the stream's pool, the buckets as the stream's prep threads make them (batch._bucket_key), timed alone on one thread after the window (the least of 3 passes), ms per MP."""

from jpegbench import layers


def read(run):
    if not run.records or not layers.is_stream(run):
        return None
    bs, wf = layers._port(run, "bitstream"), layers._port(run, "kernels.wavefront")
    bucket_key = layers._port(run, "parallel.batch")._bucket_key
    items = layers._layer_items(run)
    buckets = {}
    for i in items:
        jpeg = bs.parse(run.pool[i].data)
        buckets.setdefault(bucket_key(jpeg), []).append(jpeg)
    pin = run.device.startswith("cuda")
    ms = layers._timed_ms(lambda: [wf.build_block_plan(js, pin_memory=pin) for js in buckets.values()], 3)
    return ms / sum(run.pool[i].mp for i in items)
