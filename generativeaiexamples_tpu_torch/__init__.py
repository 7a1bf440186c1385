"""PyTorch / CUDA port of the serving engine, for NVIDIA Hopper (H100).

The JAX package ``generativeaiexamples_tpu`` is the reference; this
package mirrors its module names (``ops/``, ``models/``, ``engine/``,
``retrieval/``) and imports nothing of it.  The Pallas kernels on the serving path are
hand-written CUDA kernels here (``csrc/``), each with a plain PyTorch
version beside its wrapper in the matching ``ops`` module.
"""
