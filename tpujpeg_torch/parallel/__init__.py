"""Batched and pipelined decode on one device.

- batch.py: many mixed JPEGs bucketed by frame geometry and color space,
  each bucket decoded in one launch chain, every image fault-isolated
  (``decode_batch_on_device``, ``decode_batch``).
- stream.py: chunks of a long sequence, host prep on worker threads
  overlapped with the device's decode of earlier chunks
  (``decode_stream``, ``decode_batch_pipelined``).

Port of ``tpujpeg/parallel/batch.py`` and ``stream.py``. The reference's
mesh sharding (``halo.py``, ``mesh.py`` and ``decode_batch``'s
``n_devices``) is not ported yet.
"""
