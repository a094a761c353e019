"""Parallelism of the PyTorch port: context parallelism (:mod:`.cp`)."""
