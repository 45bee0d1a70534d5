"""Serving policy of the PyTorch port: priority classes and admission
errors."""
