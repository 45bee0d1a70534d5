"""Serving policy of the PyTorch port: priority classes and the
weighted-fair queues (qos.py), admission control and its structured
rejects (admission.py), and the per-class latency SLO tracker (slo.py)."""
