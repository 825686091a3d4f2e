"""ops of the PyTorch port (counterpart of qilaplace_tpu/ops)."""
