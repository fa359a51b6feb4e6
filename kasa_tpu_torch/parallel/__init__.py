"""The multi-GPU mesh on torch.distributed: dist.py (process groups, the
(dp, ip) mesh and its collectives), turbo_mesh.py (the fused identify on
the mesh), mesh.py (the classic engine on the mesh) and launch.py (N
ranks on one host without torchrun)."""
