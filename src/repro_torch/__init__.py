"""PyTorch / CUDA port of the ``repro`` Big/Little GAS graph engine.

Runs on an NVIDIA GPU (an H100 is the target) unless the caller passes
``device="cpu"``; the GAS kernel is hand-written CUDA C++ for ``sm_90a``
(``kernels/csrc/gas_kernel.cu``). Imports neither JAX nor the ``repro``
package. The public surface is :mod:`repro_torch.api`.
"""
