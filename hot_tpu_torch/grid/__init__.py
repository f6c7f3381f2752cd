"""Background-grid backends: the dense logical grid (``ops.transfer``) and
the block-sparse tile grid (``grid.sparse``)."""
