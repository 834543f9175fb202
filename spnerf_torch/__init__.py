"""PyTorch/CUDA port of spnerf_tpu (see README, "PyTorch port")."""
