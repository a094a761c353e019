"""CUDA sources of the port's kernels and the module that builds them (:mod:`tpudist_torch.csrc.build`)."""
