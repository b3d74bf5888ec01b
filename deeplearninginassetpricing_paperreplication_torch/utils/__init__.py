"""Configuration of the PyTorch port."""
