"""Launchers of the port: the device mesh and the serving driver."""
