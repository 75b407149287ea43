"""Forest training (counterpart of ``avatar_tpu/train``): the synthetic
frame generator (``synth``) and the breadth-first trainer (``forest``)."""
