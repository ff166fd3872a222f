"""Data parallelism of the port over ``torch.distributed``: process helpers
(dist.py) and the mesh, the model wrappers and the full state dict
(mesh.py)."""
