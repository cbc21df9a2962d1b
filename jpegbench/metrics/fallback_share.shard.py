"""stream: the share of the yielded chunks of a mixed-size stream whose engine is "fallback", in percent."""

from jpegbench import layers


def read(run):
    return layers.fallback_share(run)
