"""parallel layer of the PyTorch port (mirrors smg_tpu/parallel)."""
