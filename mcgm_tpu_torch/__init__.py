"""PyTorch / CUDA port of the Multimodal-Controller generative models.

The JAX package ``mcgm_tpu`` is the reference this package is checked
against; nothing here imports it, nor JAX. Kernels written by hand for
Hopper (``csrc/``) are built on first use by ``kernels.build``, never when a
module is imported.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
