"""Data pipeline of the port: the sampler, CIFAR and the device loader."""
