"""Command-line tools (counterpart of ``avatar_tpu/tools``): ``rtree_train``,
``rtree_transfer``, ``rtree_run``, ``rtree_run_dataset``, ``smplsynth``,
``demo``, ``live_demo``, ``data_recording``, ``optim_tool``, ``smpltrim``,
``smpl_viewer``, ``scratch`` and ``face_landmark_tracking``."""
