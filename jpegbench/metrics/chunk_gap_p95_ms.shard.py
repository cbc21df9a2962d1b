"""stream: the 95th percentile of the host's clock between the chunks decode_stream yields in the window: stalls the rate smooths over."""

from jpegbench import layers


def read(run):
    gaps = layers.chunk_gaps_ms(run)
    return layers.p95(gaps) if gaps is not None else None
