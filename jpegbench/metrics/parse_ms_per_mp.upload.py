"""bitstream: the port's bitstream.parse timed alone on one thread over 8 upload frames (the least of 3 passes), ms per MP."""

from jpegbench import layers


def read(run):
    return None if layers.is_stream(run) else layers.parse_ms_per_mp(run)
