"""One per-layer metric a file, ``<metric>.py``, each with ``read(rec)``
returning the number or None when the run has nothing to read."""
