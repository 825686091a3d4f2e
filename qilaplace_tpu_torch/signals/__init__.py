"""signals of the PyTorch port (counterpart of qilaplace_tpu/signals)."""
