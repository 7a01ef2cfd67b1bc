"""The host wall-clock timer (a copy of ``cmcfs_tpu/utils/timer.py``)."""
