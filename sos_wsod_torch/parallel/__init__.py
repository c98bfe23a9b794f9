"""Data parallelism: one process per GPU under ``torch.distributed``
(``comm.py``), started by ``engine/launch.py``."""
