"""The plain reference that decides ``correct``: torch, numpy and scipy only,
nothing of the port."""
