"""The fleet topology plane's metrics vocabulary (``metrics``: a copy of
dynamo_tpu/topology/metrics.py).  The plane itself (cards, the map and its
watcher, the prober) comes with the transfer plane; until then the port runs
as the reference does at ``DYN_TOPO=0``."""
