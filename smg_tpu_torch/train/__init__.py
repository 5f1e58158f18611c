"""train layer of the PyTorch port (mirrors smg_tpu/train)."""
