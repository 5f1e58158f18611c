"""utils layer of the PyTorch port (mirrors smg_tpu/utils): the CLI
configuration, the run logger, the native host library, mesh ingest,
phase timing and visualization helpers."""
