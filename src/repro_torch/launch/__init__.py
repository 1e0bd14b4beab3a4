"""Launchers of the port: the device mesh over a process group
(``mesh.py``), the training command line (``train.py``) and the dry run
(``specs.py``, ``dryrun.py``, ``report.py``)."""
