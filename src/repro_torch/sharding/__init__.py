"""Training's sharding helpers: the logical-axis rules (`rules`) and
arrays placed block by block over a named mesh (`array`)."""
