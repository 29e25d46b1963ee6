"""The JAX package's examples on the port: ``python -m
lzw_tpu_torch.examples.usage`` and ``python -m
lzw_tpu_torch.examples.compress_image_data [--device cpu]``, from the
repository root."""
