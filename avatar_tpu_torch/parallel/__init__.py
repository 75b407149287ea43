"""Multi-device training and multi-stream tracking over a
``torch.distributed`` process group (``training.py``)."""
