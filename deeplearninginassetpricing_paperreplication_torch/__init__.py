"""Deep Learning Asset Pricing in PyTorch, for one NVIDIA H100.

The PyTorch port of ``deeplearninginassetpricing_paperreplication_tpu``,
module for module under the same names. It imports no JAX: the JAX package
is the reference the port is held against, in the tests only.

Entry points run on the CUDA device unless the caller asks for the CPU
(``--device cpu`` / ``device="cpu"``). On the card the SDF network's FFN
runs in the hand-written kernel ``ops/csrc/sdf_ffn.cu``; on the CPU it runs
the kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
