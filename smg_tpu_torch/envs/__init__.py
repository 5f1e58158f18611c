"""envs layer of the PyTorch port (mirrors smg_tpu/envs)."""
