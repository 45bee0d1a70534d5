"""Serving policy of the PyTorch port: priority classes and the
weighted-fair queues (qos.py), admission control and its structured
rejects (admission.py), the per-class latency SLO tracker (slo.py), the
tiered KV and its handoff (kvtier.py, handoff.py), and the multi-replica
plane: the router (router.py), the disaggregated cluster (cluster.py) and
the elastic fleet controller (fleet.py)."""
