"""Framework-free helpers of the PyTorch port."""
