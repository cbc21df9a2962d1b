"""The benchmark's plain reference decoder.

Frozen copies of the port's host parser (``bitstream``), its pure-Python
Huffman oracle (``huffman``, with a faster loop for baseline segments)
and its plain int32 torch transform (``transform``), plus ``decode``,
which ties them together. It imports numpy and torch only: neither JAX,
nor ``tpujpeg``, nor anything of ``tpujpeg_torch``, and it takes nothing
the port made. ``jpegbench/tests`` holds it to PIL (libjpeg-turbo)."""
