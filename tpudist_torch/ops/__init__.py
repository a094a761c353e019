"""Ops of the PyTorch port: attention and decode attention (kernels in ``tpudist_torch/csrc``)."""
