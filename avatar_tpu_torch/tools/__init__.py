"""Command-line tools (counterpart of ``avatar_tpu/tools``): ``rtree_train``,
``rtree_transfer``, ``rtree_run``, ``rtree_run_dataset``, ``smplsynth``,
``demo``, ``live_demo`` and ``data_recording``."""
