"""Serving metrics: the port's own Prometheus registry
(``exposition.py``), the serving engine's families
(``serving_metrics.py``) and the live roofline (``roofline.py``)."""
