"""Hand-written GPU kernels and the tensor ops around them."""
