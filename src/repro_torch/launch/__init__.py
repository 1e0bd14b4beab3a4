"""Launchers of the port: the device mesh over a process group
(``mesh.py``) and the training command line (``train.py``)."""
