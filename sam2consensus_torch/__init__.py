"""sam2consensus on PyTorch and CUDA: SAM/SAM.gz in, one consensus FASTA
per reference out, with the device work on one NVIDIA Hopper GPU.

The JAX package ``sam2consensus_tpu`` is the reference this package is
checked against; its module names are mirrored here so each module's
counterpart is easy to find.  Nothing here imports JAX or the JAX package.
Entry points run on CUDA and raise without it; the CPU is used only when a
caller passes ``device="cpu"`` (``device.resolve_device``).
"""
