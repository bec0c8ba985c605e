"""Multi-device scoring of the port: the ("pixels", "formulas") mesh
(``mesh.py``), mesh-sharded scoring (``sharded.py``) and the multi-process
runtime (``distributed.py``)."""
