"""The benchmark of tpujpeg_torch, the PyTorch and CUDA port.

``python3 -m jpegbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on a CUDA card.
Cells, configurations, traffic mixes and metric readers are files of
their own (see ``harness``); ``reference/`` is the plain decoder that
judges what the timed path produced, ``roofline`` the yardstick of the
kernels' shares, ``sweep`` and ``readings`` the one-off runs that set a
cell's rate and its correctness limits. Nothing here imports JAX or the
JAX package ``tpujpeg``, and the reference imports nothing of the port.
"""
