"""Tensor and expert parallelism of the port over ``torch.distributed``:
the reference's sharding rules (``sharding``), the active mesh and the
collectives at the model's seams (``ctx``), and the ranks' launcher
(``launch``).  Meshes are ``launch/mesh.py``'s."""
