"""Sharded and multi-process search: offset shards over a list of devices
(mesh.py) and process groups joined over Gloo (multihost.py)."""
