"""policy layer of the PyTorch port (mirrors smg_tpu/policy)."""
