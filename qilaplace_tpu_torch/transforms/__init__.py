"""transforms of the PyTorch port (counterpart of qilaplace_tpu/transforms)."""
