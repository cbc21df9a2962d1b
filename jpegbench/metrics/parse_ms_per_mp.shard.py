"""bitstream: the port's bitstream.parse timed alone on one thread over one chunk of the stream's pool (the least of 3 passes), ms per MP."""

from jpegbench import layers


def read(run):
    return layers.parse_ms_per_mp(run) if layers.is_stream(run) else None
