"""Launchers of the port: the device mesh, the serving driver and the
training driver."""
