"""PyTorch + CUDA port of ``permuto_sdf_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module names
so the counterpart of each file is easy to find. It imports ``torch`` and
never ``jax`` or anything of ``permuto_sdf_tpu``.

Slice 1 ports the exact volumetric eval render
(:func:`permuto_sdf_tpu_torch.train.train_permuto_sdf.render_image`) with
four hand-written CUDA kernels (``kernels/csrc``), built with ``nvcc`` at
first use. Importing the package never needs a compiler.
"""

from permuto_sdf_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
