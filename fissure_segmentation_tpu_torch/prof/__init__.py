"""Measurement entry points of the port on an NVIDIA card (probes.py: the
counterparts of the Pallas probes under scripts/prof/)."""
