"""Launchers of the port: device meshes (``launch/mesh.py``) and the LM
training launcher (``python -m repro_torch.launch.train``)."""
