"""The plain reference that decides ``correct``: ``grid`` (NumPy) works
out a configuration's grid and line classes, ``adi`` (PyTorch) the ADI
step.  It imports nothing of the measured port."""
