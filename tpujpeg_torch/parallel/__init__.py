"""Batched, pipelined and sharded decode.

- batch.py: many mixed JPEGs bucketed by frame geometry and color space,
  each bucket decoded in one launch chain, every image fault-isolated
  (``decode_batch_on_device``, ``decode_batch``; ``decode_batch`` splits
  its transforms over a mesh of devices).
- stream.py: chunks of a long sequence, host prep on worker threads
  overlapped with the device's decode of earlier chunks
  (``decode_stream``, ``decode_batch_pipelined``).
- halo.py: one giant image's MCU rows sharded over a mesh, each shard
  decoding one MCU row of its neighbours either side, and the
  DC-predictor prefix fixup (``decode_sharded``, ``sharded_transform``,
  ``shard_windows``, ``dc_prefix_fixup``).
- mesh.py: meshes (tuples of ``torch.device``, one per shard, driven
  from one process) and multi-process start-up.
- manifest.py: the resumable batch job behind ``cli batch``.

Port of ``tpujpeg/parallel/``.
"""
