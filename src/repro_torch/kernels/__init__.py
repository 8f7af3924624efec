"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(``ref``) and the op layer that dispatches between them (``ops``)."""
