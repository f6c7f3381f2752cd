"""Slab decomposition over torch.distributed: one process per rank."""
