"""Model families of the PyTorch port (this slice: GPT-2)."""
