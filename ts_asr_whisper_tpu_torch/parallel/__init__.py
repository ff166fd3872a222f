"""Data and tensor parallelism of the port over ``torch.distributed``:
process helpers (dist.py), the mesh, the model wrappers and the full state
dict (mesh.py), and the ``model`` axis's sharding and collectives
(tensor.py)."""
