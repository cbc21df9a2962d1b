"""stream / batch ladder: the share of yielded chunks whose engine is "fallback", in percent."""

from jpegbench import layers


def read(run):
    return layers.fallback_share(run)
