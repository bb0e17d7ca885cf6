"""Traffic kinds: one driver a kind, each reading its cell's parameters
from ``bench/workloads/<cell>.json`` and its configuration's sizes."""
