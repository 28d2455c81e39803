"""Datasets (``data``, simplex_gp_tpu/utils/data.py plus ``load_dataset``), the Adam loop
(``training``) and the entry points' ``--device`` argument (``device``)."""
