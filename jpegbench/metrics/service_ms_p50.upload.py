"""decoder: the median of the host's clock around each decode() call of the window, queueing left out."""

import numpy as np

from jpegbench import layers


def read(run):
    svc = layers.service_ms(run)
    return float(np.median(svc)) if svc is not None and len(svc) else None
