"""Command-line tools (counterpart of ``avatar_tpu/tools``): ``rtree_train``
and ``rtree_transfer``."""
