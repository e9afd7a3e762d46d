"""Data parallelism (`parallel.dist`) and the decoder's tensor parallelism
(`parallel.mesh`) over torch.distributed."""
