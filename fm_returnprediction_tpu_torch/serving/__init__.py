"""serving layer of the PyTorch port (mirrors fm_returnprediction_tpu/serving)."""
